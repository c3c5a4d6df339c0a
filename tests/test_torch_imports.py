"""The PyTorch port's import closure reaches neither ``jax`` nor ``yaml``,
no port file imports the JAX package, and ``chip_smoke.py`` fails
without a GPU or without the repository around it."""

import ast
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "imagined_speech_decoding_tpu_torch")
FORBIDDEN = ("jax", "yaml", "imagined_speech_decoding_tpu")

SERVE_ONE_REQUEST = r"""
import os, sys, tempfile
sys.modules["jax"] = None   # any import of jax or yaml now raises
sys.modules["yaml"] = None
import numpy as np, torch
torch.set_num_threads(1)
import imagined_speech_decoding_tpu_torch
import imagined_speech_decoding_tpu_torch.serving
from imagined_speech_decoding_tpu_torch.cli.serve import build_parser, build_server
import chip_smoke  # noqa: F401  (main() does not run on import)
from imagined_speech_decoding_tpu_torch.config import FASTConfig
from imagined_speech_decoding_tpu_torch.server import DecoderClient
from imagined_speech_decoding_tpu_torch.train.checkpoint import save_model_npz
from imagined_speech_decoding_tpu_torch.transplant import init_jax_layout_params

with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, "FAST", "sub-01", "best_subject.npz")
    save_model_npz(path, init_jax_layout_params(FASTConfig.default(), 0), {"head": {}})
    server = build_server(build_parser().parse_args(["--checkpoint", path, "--port", "0"]))
    with server, DecoderClient(*server.address) as client:
        post = client.decode(np.random.default_rng(0).normal(size=(1, 64, 800)).astype(np.float32))
assert post.shape == (1, 5) and abs(float(post.sum()) - 1.0) < 1e-5, post
loaded = sorted(m for m in sys.modules if m.split(".")[0] in {"jax", "yaml", "imagined_speech_decoding_tpu"})
assert loaded == ["jax", "yaml"], loaded  # only the blocking None entries
print("SERVED", post.tolist())
"""


def _run(args, cwd, timeout=240):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout)


def test_port_imports_and_serves_without_jax_or_yaml():
    proc = _run([sys.executable, "-c", SERVE_ONE_REQUEST], ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SERVED" in proc.stdout


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_port_file_imports_jax_yaml_or_the_jax_package():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    bad = [
        (os.path.relpath(f, ROOT), m)
        for f in files for m in _imported_modules(f)
        if m.split(".")[0] in FORBIDDEN
    ]
    assert not bad, bad


def test_chip_smoke_fails_without_a_gpu():
    proc = _run([sys.executable, "chip_smoke.py"], ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "needs a CUDA GPU" in proc.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run([sys.executable, "chip_smoke.py"], str(tmp_path))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
