"""The PyTorch port's import closure (the batch-norm heads, TSception, the
augmentation, the feature baselines and their CLIs, profiling, multi-rank
training among it) reaches none of ``jax``, ``yaml``,
``pandas``, ``sklearn`` and ``matplotlib``, no port file imports the JAX
package, matplotlib is imported only inside the drawing functions of the
files that draw, ``sklearn`` and ``joblib`` only inside functions of the
CSP + SVM baseline, the attribution and QC CLIs compute without
matplotlib or sklearn and the SVM CLI raises ``ImportError`` naming
sklearn, the real-data modules import and run without ``h5py`` (which
they import only inside the functions that open HDF5 files),
``chip_smoke.py`` fails without a GPU or without the repository around
it, and ``mma_tf32_ceiling.py`` fails without a GPU."""

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
import imagined_speech_decoding_tpu_torch._native
import imagined_speech_decoding_tpu_torch.ringbuf
import imagined_speech_decoding_tpu_torch.ops.cuda.library
from imagined_speech_decoding_tpu_torch.cli import export_decoder
import imagined_speech_decoding_tpu_torch.explain.attribution
from imagined_speech_decoding_tpu_torch.train import artifacts, cv, engine, metrics, schedule
from imagined_speech_decoding_tpu_torch.data import arrays, synthetic
from imagined_speech_decoding_tpu_torch.cli.serve import build_parser, build_server
import chip_smoke  # noqa: F401  (main() does not run on import)
from imagined_speech_decoding_tpu_torch.config import FASTConfig
from imagined_speech_decoding_tpu_torch.server import DecoderClient
from imagined_speech_decoding_tpu_torch.train.checkpoint import save_model_npz
from imagined_speech_decoding_tpu_torch.transplant import init_jax_layout_params
from imagined_speech_decoding_tpu_torch.train import ensemble, loso, sweep
from imagined_speech_decoding_tpu_torch.cli import sweep as cli_sweep, zero_shot
from imagined_speech_decoding_tpu_torch.data import fastcache
from imagined_speech_decoding_tpu_torch.models import api, heads, tsception
from imagined_speech_decoding_tpu_torch.ops import augment, norm
from imagined_speech_decoding_tpu_torch.cli import train_tsception
from imagined_speech_decoding_tpu_torch.models.fast import FAST
from imagined_speech_decoding_tpu_torch.serving import make_online_decoder
from imagined_speech_decoding_tpu_torch.transplant import init_jax_layout

with tempfile.TemporaryDirectory() as d:
    # the sweep, LOSO and zero-shot helpers without sklearn, pandas or matplotlib
    tr, va = loso.build_loso_index_stack(np.random.default_rng(0).integers(0, 5, (3, 20)))
    assert tr.shape == (3, 35) and va.shape == (3, 5)
    hyper, meta = sweep.hyper_grid([1.0, 2.0], [0.0, 1.0])
    report = sweep.SweepReport(lr=np.array([5e-4]), wd=np.array([0.01]),
                               fold_val_acc=np.array([[0.5, 0.7]]), mean_val_acc=np.array([0.6]),
                               std_val_acc=np.array([0.1]), best_index=0, history={}, meta=[(1.0, 1.0)])
    csv_path, png, best = cli_sweep.save_artifacts(os.path.join(d, "sweep"), report, [1.0], [1.0])
    assert png is None and os.path.exists(csv_path) and os.path.exists(best)
    zs_csv, zs_png = zero_shot.save_artifacts(os.path.join(d, "zs"), np.eye(2, dtype=np.float32),
                                              ["01", "02"])
    assert zs_png is None and os.path.exists(zs_csv)
    arr = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    with fastcache.FastCache(fastcache.write_cache(os.path.join(d, "c.eegc"), arr)) as c:
        assert np.array_equal(c.read_all(), arr)
    assert ensemble.member_seed(42, 1) == 42 + 7919
    path = os.path.join(d, "FAST", "sub-01", "best_subject.npz")
    save_model_npz(path, init_jax_layout_params(FASTConfig.default(), 0), {"head": {}})
    server = build_server(build_parser().parse_args(["--checkpoint", path, "--port", "0"]),
                          device="cpu")
    x = np.random.default_rng(0).normal(size=(1, 64, 800)).astype(np.float32)
    with server, DecoderClient(*server.address) as client:
        post = client.decode(x)
    # the fleet and the exported artifact, from the CPU
    save_model_npz(os.path.join(d, "FAST", "sub-02", "best_subject.npz"),
                   init_jax_layout_params(FASTConfig.default(), 1), {"head": {}})
    server = build_server(build_parser().parse_args(
        ["--checkpoint-dir", os.path.join(d, "FAST"), "--port", "0"]), device="cpu")
    with server, DecoderClient(*server.address) as client:
        rows = client.decode_all(x)
    art = export_decoder.main(["--checkpoint", path, "--out", os.path.join(d, "decoder.pt2")])
    server = build_server(build_parser().parse_args(["--artifact", art, "--port", "0"]),
                          device="cpu")
    with server, DecoderClient(*server.address) as client:
        art_post = client.decode(x)
# a batch-norm head's decoder carries its running statistics; TSception's stack builds
import dataclasses
cv_cfg = dataclasses.replace(FASTConfig.default(), head="CVBlock")
stateful = make_online_decoder(FAST(cv_cfg), *init_jax_layout(cv_cfg, 0))
assert stateful(x).shape == (1, 5)
ts = api.make_tsception_model(64, 800)
assert ts.build(2).bn_t.mean.shape == (2, 45)
assert post.shape == (1, 5) and abs(float(post.sum()) - 1.0) < 1e-5, post
assert rows.shape == (2, 1, 5) and np.allclose(rows[0], post, rtol=1e-4, atol=1e-5), rows
assert np.array_equal(art_post, post), (art_post, post)
# the training CLI's default config falls back to built-in defaults without PyYAML
from imagined_speech_decoding_tpu_torch.cli.train_fast import build_parser as train_parser, resolve_config
os.chdir(os.path.dirname(os.path.abspath(chip_smoke.__file__)))
assert resolve_config(train_parser().parse_args([]), {}).train.max_epochs == 200
# the feature baselines: featurizers, spectral ops and their CLI, without the blocked packages
from imagined_speech_decoding_tpu_torch import pipelines
from imagined_speech_decoding_tpu_torch.ops import filters, spectral, windowing
from imagined_speech_decoding_tpu_torch.models import eegnet, mlp, rnn
from imagined_speech_decoding_tpu_torch.cli import train_baselines
assert pipelines.bandpower_featurize(torch.from_numpy(x)).shape == (1, 320)
assert pipelines.stft_image_featurize(torch.from_numpy(x)).shape == (1, 5, 64, 101)
assert filters.bandpass_filter(torch.from_numpy(x), 250.0, 4.0, 40.0, method="fir").shape == x.shape
with tempfile.TemporaryDirectory() as d:
    res = train_baselines.main(["--pipeline", "stft_eegnet", "--synthetic", "1",
                                "--synthetic_trials", "10", "--epochs", "1", "--output_dir", d],
                               device="cpu")
    assert os.path.exists(os.path.join(d, "sub-01", "best_subject.npz"))
# multi-rank training: the mesh helpers, the data-parallel step and the dry run
from imagined_speech_decoding_tpu_torch import parallel
from imagined_speech_decoding_tpu_torch.parallel import dp, dryrun, mesh
assert parallel.make_mesh is mesh.make_mesh and "DPTrainState" not in vars(parallel)
assert mesh.mesh_shape("2d", 8) == (("model", "data"), (4, 2))
assert mesh.StackShard(mesh.Mesh(("model",), (4,), 3), 5, "model").rows == (6, 8)
assert dp.DPTrainState._fields == ("params", "model_state", "opt_state", "step")
assert dryrun.dryrun_config().n_channels == 64
# profiling: a Chrome trace of an annotated range, the step timer
from imagined_speech_decoding_tpu_torch import profiling
with tempfile.TemporaryDirectory() as d:
    with profiling.trace(d), profiling.annotate("imports-check"):
        profiling.sync_scalar(torch.ones(2, 2) @ torch.ones(2, 2))
    assert os.path.exists(os.path.join(d, profiling.TRACE_FILE))
assert profiling.StepTimer(warmup=0).lap() is None
blocked = {"jax", "yaml", "pandas", "sklearn", "matplotlib"}
loaded = sorted(m for m in sys.modules if m.split(".")[0] in blocked | {"imagined_speech_decoding_tpu"})
assert loaded == sorted(blocked), loaded  # only the blocking None entries
print("SERVED", post.tolist())
"""


REAL_DATA_WITHOUT_H5PY = r"""
import os, sys, tempfile
for name in ("jax", "yaml", "pandas", "sklearn", "matplotlib", "h5py"):
    sys.modules[name] = None   # any import of these now raises
import numpy as np, torch
torch.set_num_threads(1)
sys.path.insert(0, "tests")
from bcic_fixture import SUBJECTS, write_tree
from imagined_speech_decoding_tpu_torch import utils
from imagined_speech_decoding_tpu_torch.cli import benchmark, preprocess, train_fast
from imagined_speech_decoding_tpu_torch.data import cache, ingest
from imagined_speech_decoding_tpu_torch.ops.filters import filter_corpus
from imagined_speech_decoding_tpu_torch.train import checkpoint, cv, engine
from imagined_speech_decoding_tpu_torch.train.artifacts import save_predictions_csv

with tempfile.TemporaryDirectory() as d:
    expected = write_tree(d, SUBJECTS[:1], (3, 2, 2), test_files=False)
    x, y = ingest.load_subject_train_val(d, "01", strict=True)
    assert x.shape == (5, 64, 800) and y.dtype == np.uint8
    labels = ingest.load_excel_labels(ingest.resolve_excel_path(d), strict=True)
    assert len(labels) == 15
    out = filter_corpus(torch.from_numpy(x), 60.0, (4.0, 40.0))
    assert out.shape == x.shape and torch.isfinite(out).all()
    for call in (lambda: cache.build_official_cache(d, os.path.join(d, "c.h5")),
                 lambda: preprocess.main(["--data_folder", d, "--output", os.path.join(d, "c.h5")],
                                         device="cpu")):
        try:
            call()
        except ImportError as e:
            assert "c.h5: reading or writing HDF5 needs h5py" in str(e), e
        else:
            raise AssertionError("an HDF5 write without h5py did not raise")
    save_predictions_csv(os.path.join(d, "res", "FAST", "sub-01", "test_predictions.csv"),
                         np.arange(10) % 5, np.arange(10) % 5)
    (summary,) = benchmark.main(["--results_dir", os.path.join(d, "res")])
    assert summary["Acc_Mean"] == 1.0
blocked = {"jax", "yaml", "pandas", "sklearn", "matplotlib", "h5py"}
loaded = sorted(m for m in sys.modules if m.split(".")[0] in blocked | {"imagined_speech_decoding_tpu"})
assert loaded == sorted(blocked), loaded
print("REAL DATA OK")
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


def test_real_data_modules_run_without_h5py_or_pandas():
    """Ingest of the v5 splits and the answer sheet, the corpus filter and
    the benchmark CLI need neither; an HDF5 cache raises ``ImportError``
    naming the file."""
    proc = _run([sys.executable, "-c", REAL_DATA_WITHOUT_H5PY], ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "REAL DATA OK" in proc.stdout


LAZY_ONLY = ("yaml",)  # PyYAML may be imported inside a function (reading --config), never at import
# matplotlib only inside the functions that draw an optional plot, in these files
PLOTS = ("matplotlib",)
PLOTTING_FILES = {os.path.join("imagined_speech_decoding_tpu_torch", *p)
                  for p in (("cli", "sweep.py"), ("cli", "zero_shot.py"),
                            ("train", "artifacts.py"), ("explain", "plots.py"),
                            ("explain", "topomap.py"), ("cli", "explain_fast.py"),
                            ("cli", "global_explain.py"), ("cli", "artifact_analysis.py"))}
# scikit-learn (the SVC / LDA and the folds) and joblib (the pipeline's file) only
# inside the functions of the CSP + SVM baseline that need them
SKLEARN = ("sklearn", "joblib")
SKLEARN_FILES = {os.path.join("imagined_speech_decoding_tpu_torch", *p)
                 for p in (("models", "classical.py"), ("cli", "svm_baseline.py"))}
FILE_READERS = ("h5py", "scipy.io")  # imported only by the functions that open such files


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


def test_ops_and_models_do_not_import_the_train_layer():
    """The ops and models layers take ``parallel.mesh``'s collectives, and
    ``parallel/__init__`` imports nothing else, so neither layer pulls in
    ``train`` (``parallel.dp`` imports it)."""
    script = (
        "import sys\n"
        "import imagined_speech_decoding_tpu_torch.ops.norm\n"
        "import imagined_speech_decoding_tpu_torch.models.heads\n"
        "import imagined_speech_decoding_tpu_torch.models.fast\n"
        "import imagined_speech_decoding_tpu_torch.ops.augment\n"
        "bad = [m for m in sys.modules if m.startswith(('imagined_speech_decoding_tpu_torch.train',"
        " 'imagined_speech_decoding_tpu_torch.parallel.dp'))]\n"
        "assert not bad, bad\n"
    )
    proc = _run([sys.executable, "-c", script], ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]


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
    bad = [(f, m) for f, m, lazy in found
           if not (lazy and (m.split(".")[0] in LAZY_ONLY
                             or (m.split(".")[0] in PLOTS and f in PLOTTING_FILES)
                             or (m.split(".")[0] in SKLEARN and f in SKLEARN_FILES)))]
    assert not bad, bad
    joblib_users = [(os.path.relpath(f, ROOT), lazy) for f in files
                    for m, lazy in _imported_modules(f) if m.split(".")[0] == "joblib"]
    assert joblib_users and all(lazy and f in SKLEARN_FILES for f, lazy in joblib_users), \
        joblib_users
    assert {f for f, m, _ in found if m.split(".")[0] in LAZY_ONLY} <= {
        os.path.join("imagined_speech_decoding_tpu_torch", p)
        for p in ("config.py", os.path.join("cli", "train_fast.py"))}
    eager_readers = [(os.path.relpath(f, ROOT), m) for f in files for m, lazy in _imported_modules(f)
                     if not lazy and any(m == r or m.startswith(r + ".") for r in FILE_READERS)]
    assert not eager_readers, eager_readers


EXPLAIN_AND_QC_WITHOUT_PLOTS = r"""
import os, sys, tempfile
for name in ("jax", "yaml", "pandas", "sklearn", "matplotlib", "joblib"):
    sys.modules[name] = None   # any import of these now raises
import numpy as np, torch
torch.set_num_threads(1)
import imagined_speech_decoding_tpu_torch.explain
from imagined_speech_decoding_tpu_torch.cli import (
    artifact_analysis, explain_fast, global_explain, svm_baseline)
from imagined_speech_decoding_tpu_torch.models import classical
from imagined_speech_decoding_tpu_torch.ops import csp, ica

with tempfile.TemporaryDirectory() as d:
    out = explain_fast.main(["--synthetic", "--n_background", "4", "--n_test", "3",
                             "--n_grad_samples", "1", "--output_dir", os.path.join(d, "ef")],
                            device="cpu")
    assert os.listdir(out) == []
    out = global_explain.main(["--synthetic", "--n_synth_subjects", "1", "--n_bg", "4",
                               "--n_test", "4", "--n_grad_samples", "1",
                               "--model_dir", os.path.join(d, "none"),
                               "--output_dir", os.path.join(d, "ge")], device="cpu")
    assert os.listdir(out) == []
    out = artifact_analysis.main(["--synthetic", "--n_trials", "4", "--n_components", "3",
                                  "--output_dir", os.path.join(d, "qc")], device="cpu")
    assert os.listdir(out) == ["psd.npz"]
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(20, 8, 300)).astype(np.float32))
    model = csp.csp_fit(x, torch.arange(20) % 2, 2, 4)
    pipe = classical.CSPClassifierPipeline(n_classes=2, n_components=4, device="cpu")
    assert pipe.features(x.numpy(), (np.arange(20) % 2)).shape == (20, 4)
    try:
        pipe.fit(x.numpy(), np.arange(20) % 2)
    except ImportError as e:
        assert "sklearn" in str(e), e
    else:
        raise AssertionError("the pipeline fitted without sklearn")
    try:
        svm_baseline.main(["--synthetic", "1", "--output_dir", os.path.join(d, "svm")],
                          device="cpu")
    except ImportError as e:
        assert "sklearn" in str(e), e
    else:
        raise AssertionError("cli.svm_baseline ran without sklearn")
blocked = {"jax", "yaml", "pandas", "sklearn", "matplotlib", "joblib"}
loaded = sorted(m for m in sys.modules if m.split(".")[0] in blocked | {"imagined_speech_decoding_tpu"})
assert loaded == sorted(blocked), loaded
print("EXPLAIN AND QC OK")
"""


def test_explain_and_qc_compute_without_matplotlib_or_sklearn():
    """The attribution and QC CLIs finish their computation with matplotlib
    and sklearn blocked (one line says the plots were skipped; ``psd.npz``
    is written); CSP runs; the SVM fit and CLI raise ``ImportError`` naming
    sklearn, with no fallback."""
    proc = _run([sys.executable, "-c", EXPLAIN_AND_QC_WITHOUT_PLOTS], ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "EXPLAIN AND QC OK" in proc.stdout
    assert proc.stdout.count("plots skipped: matplotlib is not installed") == 3


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


def test_train_fast_runs_the_ported_campaign_flags(tmp_path, monkeypatch):
    """``--loso-pretrain``, ``--ensemble 2`` and ``--hyperparams`` pass the
    refusal and reach the device (here: no card), and ``--ensemble`` with
    ``--loso-pretrain`` is a parser error (exit 2), as in the JAX CLI."""
    import pytest
    import torch

    from imagined_speech_decoding_tpu_torch.cli import train_fast

    best = tmp_path / "best.json"
    best.write_text('{"learning_rate": 0.002, "weight_decay": 0.1, "warmup_epochs": 3}')
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for flags in (["--loso-pretrain"], ["--ensemble", "2"], ["--hyperparams", str(best)]):
        args = train_fast.build_parser().parse_args(["--synthetic", "1", *flags])
        train_fast.refuse_unported(args)
        with pytest.raises(RuntimeError, match="is_available"):
            train_fast.main(["--synthetic", "1", *flags, "--output_dir", str(tmp_path)])
    args = train_fast.build_parser().parse_args(["--hyperparams", str(best), "--weight_decay", "0.5"])
    assert train_fast.build_overrides(args) == {"learning_rate": 0.002, "weight_decay": 0.5,
                                                "warmup_epochs": 3}
    with pytest.raises(SystemExit) as e:
        train_fast.main(["--synthetic", "1", "--ensemble", "2", "--loso-pretrain",
                         "--output_dir", str(tmp_path)])
    assert e.value.code == 2
