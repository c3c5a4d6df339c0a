"""The PyTorch port's import closure reaches none of ``jax``, ``yaml``,
``pandas``, ``sklearn`` and ``matplotlib``, no port file imports the JAX
package, ``chip_smoke.py`` fails without a GPU or without the
repository around it, and ``mma_tf32_ceiling.py`` fails without a GPU."""

import ast
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "imagined_speech_decoding_tpu_torch")
BLOCKED = ("jax", "yaml", "pandas", "sklearn", "matplotlib")  # the card's machine promises none
FORBIDDEN = BLOCKED + ("imagined_speech_decoding_tpu",)

SERVE_ONE_REQUEST = r"""
import os, sys, tempfile
for name in ("jax", "yaml", "pandas", "sklearn", "matplotlib"):
    sys.modules[name] = None   # any import of these now raises
import numpy as np, torch
torch.set_num_threads(1)
import imagined_speech_decoding_tpu_torch
import imagined_speech_decoding_tpu_torch.serving
import imagined_speech_decoding_tpu_torch.cli.train_fast
import imagined_speech_decoding_tpu_torch.explain.attribution
from imagined_speech_decoding_tpu_torch.train import artifacts, cv, engine, metrics, schedule
from imagined_speech_decoding_tpu_torch.data import arrays, synthetic
from imagined_speech_decoding_tpu_torch.cli.serve import build_parser, build_server
import chip_smoke  # noqa: F401  (main() does not run on import)
from imagined_speech_decoding_tpu_torch.config import FASTConfig
from imagined_speech_decoding_tpu_torch.server import DecoderClient
from imagined_speech_decoding_tpu_torch.train.checkpoint import save_model_npz
from imagined_speech_decoding_tpu_torch.transplant import init_jax_layout_params

with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, "FAST", "sub-01", "best_subject.npz")
    save_model_npz(path, init_jax_layout_params(FASTConfig.default(), 0), {"head": {}})
    server = build_server(build_parser().parse_args(["--checkpoint", path, "--port", "0"]),
                          device="cpu")
    with server, DecoderClient(*server.address) as client:
        post = client.decode(np.random.default_rng(0).normal(size=(1, 64, 800)).astype(np.float32))
assert post.shape == (1, 5) and abs(float(post.sum()) - 1.0) < 1e-5, post
# the training CLI's default config falls back to built-in defaults without PyYAML
from imagined_speech_decoding_tpu_torch.cli.train_fast import build_parser as train_parser, resolve_config
os.chdir(os.path.dirname(os.path.abspath(chip_smoke.__file__)))
assert resolve_config(train_parser().parse_args([]), {}).train.max_epochs == 200
blocked = {"jax", "yaml", "pandas", "sklearn", "matplotlib"}
loaded = sorted(m for m in sys.modules if m.split(".")[0] in blocked | {"imagined_speech_decoding_tpu"})
assert loaded == sorted(blocked), loaded  # only the blocking None entries
print("SERVED", post.tolist())
"""


def _run(args, cwd, timeout=240):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout)


def test_port_imports_and_serves_without_jax_or_yaml():
    proc = _run([sys.executable, "-c", SERVE_ONE_REQUEST], ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SERVED" in proc.stdout


def test_port_serves_without_the_jax_package_beside_it(tmp_path):
    """A copy of the port package and ``chip_smoke.py`` alone: nothing
    under ``imagined_speech_decoding_tpu/`` is there to be opened."""
    shutil.copytree(PORT, tmp_path / "imagined_speech_decoding_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    assert not (tmp_path / "imagined_speech_decoding_tpu").exists()
    proc = _run([sys.executable, "-c", SERVE_ONE_REQUEST], str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SERVED" in proc.stdout


LAZY_ONLY = ("yaml",)  # PyYAML may be imported inside a function (reading --config), never at import


def _imported_modules(path):
    """``(module, inside_a_function)`` for every absolute import in ``path``."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    lazy = {id(n) for fn in ast.walk(tree)
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) for n in ast.walk(fn)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from ((alias.name, id(node) in lazy) for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, id(node) in lazy


def test_no_port_file_imports_jax_yaml_or_the_jax_package():
    files = [os.path.join(ROOT, n) for n in ("chip_smoke.py", "mma_tf32_ceiling.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    found = [
        (os.path.relpath(f, ROOT), m, lazy)
        for f in files for m, lazy in _imported_modules(f)
        if m.split(".")[0] in FORBIDDEN
    ]
    bad = [(f, m) for f, m, lazy in found if not (lazy and m.split(".")[0] in LAZY_ONLY)]
    assert not bad, bad
    assert {f for f, _, _ in found} <= {os.path.join("imagined_speech_decoding_tpu_torch", p)
                                        for p in ("config.py", os.path.join("cli", "train_fast.py"))}


def test_chip_smoke_fails_without_a_gpu():
    proc = _run([sys.executable, "chip_smoke.py"], ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "needs a CUDA GPU" in proc.stderr


def test_mma_ceiling_fails_without_a_gpu():
    proc = _run([sys.executable, "mma_tf32_ceiling.py"], ROOT)
    assert proc.returncode != 0
    assert "TFLOP/s" not in proc.stdout
    assert "needs a CUDA GPU" in proc.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run([sys.executable, "chip_smoke.py"], str(tmp_path))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
