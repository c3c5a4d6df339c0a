"""The port's attribution CLIs (``cli.explain_fast``, ``cli.global_explain``)
against the JAX CLIs on the CPU, the device rule of every CLI this slice
adds, and the ``isd-torch-*`` console scripts.

Both packages explain the same checkpoints (saved by the JAX package at
``FASTConfig.default()``) on the same ``synthetic_trials`` /
``synthetic_corpus`` trials. The JAX CLI's arrays are what it hands its
plot functions (wrapped here, so they still draw); the port's computing
functions get JAX's draws, recomputed from ``jax.random.PRNGKey(seed)``
as JAX's ``expected_gradients`` makes them. Tolerance: rtol 1e-4, atol
1e-4 * max|ref| (the attribution tolerance of tests/test_torch_explain.py).
"""

import os
import re

import jax
import numpy as np
import pytest
import torch

import imagined_speech_decoding_tpu.explain as jax_explain
import imagined_speech_decoding_tpu_torch.explain as port_explain
from imagined_speech_decoding_tpu.cli import explain_fast as jax_explain_fast
from imagined_speech_decoding_tpu.cli import global_explain as jax_global_explain
from imagined_speech_decoding_tpu.config import FASTConfig as JaxFASTConfig
from imagined_speech_decoding_tpu.models.api import make_fast_model
from imagined_speech_decoding_tpu.train.checkpoint import save_model_npz as jax_save_model_npz
from imagined_speech_decoding_tpu_torch.cli import (
    _scriptmain,
    artifact_analysis,
    explain_fast,
    global_explain,
    svm_baseline,
)
from imagined_speech_decoding_tpu_torch.config import FASTConfig
from imagined_speech_decoding_tpu_torch.data.constants import CLASSES
from imagined_speech_decoding_tpu_torch.data.synthetic import synthetic_corpus, synthetic_trials

torch.set_num_threads(1)

RTOL = 1e-4
PLOTS = ("plot_attribution_heatmap", "save_topomap", "plot_zone_importance",
         "plot_class_topomaps", "plot_zone_time_heatmap", "plot_band_heatmap")
EF_ARGS = ["--synthetic", "--n_background", "6", "--n_test", "6", "--n_grad_samples", "3",
           "--n_sample_plots", "6", "--seed", "1"]
GE_ARGS = ["--synthetic", "--n_synth_subjects", "2", "--n_bg", "6", "--n_test", "10",
           "--n_grad_samples", "2", "--seed", "0"]


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=RTOL, atol=RTOL * np.abs(ref).max())


def _jax_draws(seed, n_samples, n_trials, n_bg):
    """The draws of JAX's ``expected_gradients`` (its ``:70-73``)."""
    kb, ka = jax.random.split(jax.random.PRNGKey(seed))
    return (torch.from_numpy(np.array(jax.random.randint(kb, (n_samples, n_trials), 0, n_bg))),
            torch.from_numpy(np.array(jax.random.uniform(ka, (n_samples, n_trials)))))


def _jax_checkpoint(path, key):
    model = make_fast_model(JaxFASTConfig.default())
    params, state = model.init(jax.random.PRNGKey(key))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    jax_save_model_npz(path, params, state)
    return path


def _run_capturing(module, main, argv):
    """``main(argv)`` with ``module``'s plot functions wrapped: ``{file
    name: positional arguments}`` of every plot it drew, and the titles."""
    calls, titles = {}, []
    with pytest.MonkeyPatch.context() as mp:
        for name in PLOTS:
            def wrapped(*a, _orig=getattr(module, name), **kw):
                calls[os.path.basename(a[0])] = a[1:]
                titles.append(kw.get("title", ""))
                return _orig(*a, **kw)

            mp.setattr(module, name, wrapped)
        main(argv)
    return calls, titles


@pytest.fixture(scope="module")
def explain_fast_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("explain_fast")
    ckpt = _jax_checkpoint(str(d / "sub-01" / "best_subject.npz"), 1)
    out = str(d / "jax")
    calls, _ = _run_capturing(jax_explain, jax_explain_fast.main,
                              EF_ARGS + ["--checkpoint", ckpt, "--output_dir", out])
    return d, ckpt, out, calls


def test_explain_fast_arrays_match_jax(explain_fast_run):
    """Attributions, predictions, zone importance, the correct-only and
    errors-only class means, the zone x time matrix and the band heatmap
    of ``explain_arrays`` on JAX's draws equal what the JAX CLI plots."""
    _, ckpt, _, calls = explain_fast_run
    args = explain_fast.build_parser().parse_args(EF_ARGS)
    x, y = synthetic_trials(args.seed, args.n_background + args.n_test, 64, 800)
    bg, xt, yt = explain_fast.split_trials(x, y, args.n_background, args.n_test, args.seed)
    model = explain_fast.load_fast(FASTConfig.default(), ckpt, "cpu")
    arrays = explain_fast.explain_arrays(model, bg, xt, yt,
                                         *_jax_draws(args.seed, args.n_grad_samples, len(xt),
                                                     len(bg)))
    tags = sorted(k[: -len("_heatmap.png")] for k in calls if k.endswith("_heatmap.png")
                  and k.startswith("sample"))
    assert len(tags) == args.n_test
    for tag in tags:
        i, pred, true = map(int, re.fullmatch(r"sample(\d+)_pred(\d+)_true(\d+)", tag).groups())
        assert (pred, true) == (arrays["preds"][i], yt[i])
        _close(arrays["attr"][i], calls[f"{tag}_heatmap.png"][0])
        _close(arrays["attr"][i].mean(-1), calls[f"{tag}_topomap.png"][0])
        _close(arrays["zone_importance"][i], calls[f"{tag}_zones.png"][0])
    for name, per_class in arrays["class_means"].items():
        key = f"class_topomaps_{name}.png"
        assert (key in calls) == bool(per_class)
        if per_class:
            assert list(per_class) == list(calls[key][0])
            for cname, v in per_class.items():
                _close(v, calls[key][0][cname])
    _close(arrays["zone_time"], calls["zone_time.png"][0])
    bands, names, times = calls["band_heatmap.png"][:3]
    assert arrays["band_names"] == tuple(names)
    np.testing.assert_array_equal(arrays["band_times"], times)
    _close(arrays["bands"], bands)


def test_explain_fast_writes_the_jax_files(explain_fast_run):
    """The port's CLI on its own draws writes the same file names as the
    JAX CLI: the predictions, and so the tags, are the same."""
    d, ckpt, out, _ = explain_fast_run
    got = explain_fast.main(EF_ARGS + ["--checkpoint", ckpt, "--output_dir", str(d / "port")],
                            device="cpu")
    assert got == str(d / "port")
    assert sorted(os.listdir(got)) == sorted(os.listdir(out))
    assert all(os.path.getsize(os.path.join(got, f)) > 0 for f in os.listdir(got))


@pytest.fixture(scope="module")
def global_explain_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("global_explain")
    for sid, key in ((0, 1), (1, 2)):
        _jax_checkpoint(str(d / "models" / f"sub-{sid}" / "best_subject.npz"), key)
    out = str(d / "jax")
    calls, _ = _run_capturing(jax_explain, jax_global_explain.main,
                              GE_ARGS + ["--model_dir", str(d / "models"), "--output_dir", out])
    return d, out, calls


def test_global_explain_arrays_match_jax(global_explain_run):
    """Each subject's per-class topomap vector, zone x time matrix and band
    heatmap, and the count-weighted pools, equal the JAX CLI's."""
    d, _, calls = global_explain_run
    args = global_explain.build_parser().parse_args(GE_ARGS)
    X, Y = synthetic_corpus(args.seed, n_subjects=2, n_trials=args.n_bg + args.n_test,
                            n_samples=800)
    results = []
    for sid in range(2):
        model = explain_fast.load_fast(
            FASTConfig.default(), str(d / "models" / f"sub-{sid}" / "best_subject.npz"), "cpu")
        bg, xt, yt = explain_fast.split_trials(X[sid], Y[sid].astype(int), args.n_bg,
                                               args.n_test, args.seed)
        res = global_explain.explain_subject(
            model, bg, xt, yt, *_jax_draws(args.seed, args.n_grad_samples, len(xt), len(bg)))
        results.append(res)
        for k, cname in enumerate(CLASSES):
            tag = f"Sub{sid}_Class{k}_{cname}"
            assert (k in res["classes"]) == (f"{tag}_Topomap.png" in calls), tag
            if k not in res["classes"]:
                continue
            c = res["classes"][k]
            assert c["n"] == int((yt == k).sum())
            _close(c["topomap"], calls[f"{tag}_Topomap.png"][0])
            _close(c["zone_time"], calls[f"{tag}_ZoneMatrix.png"][0])
            _close(c["bands"], calls[f"{tag}_FreqBands.png"][0])
    assert sum(len(r["classes"]) for r in results) >= 4
    pooled = global_explain.pool_subjects(results)
    group = calls["group_class_topomaps.png"][0]
    assert [CLASSES[k] for k in pooled["topomaps"]] == list(group)
    for k, v in pooled["topomaps"].items():
        _close(v, group[CLASSES[k]])
    _close(pooled["zone_time"], calls["group_zone_time.png"][0])
    _close(pooled["bands"], calls["group_band_heatmap.png"][0])


def test_global_explain_writes_the_jax_files(global_explain_run, capsys):
    d, out, _ = global_explain_run
    got = global_explain.main(GE_ARGS + ["--model_dir", str(d / "models"),
                                         "--output_dir", str(d / "port")], device="cpu")
    assert sorted(os.listdir(got)) == sorted(os.listdir(out))
    assert "Analysis Complete! (2 subjects" in capsys.readouterr().out


def test_global_explain_stamps_untrained_and_needs_a_cache(tmp_path, capsys):
    """``--synthetic`` without checkpoints stamps every title
    ``[UNTRAINED]``; without ``--synthetic`` a missing ``--cache`` is a
    parser error (exit 2), as in the JAX CLI."""
    _, titles = _run_capturing(
        port_explain, lambda argv: global_explain.main(argv, device="cpu"),
        ["--synthetic", "--n_synth_subjects", "1", "--n_bg", "4", "--n_test", "6",
         "--n_grad_samples", "1", "--model_dir", str(tmp_path / "none"),
         "--output_dir", str(tmp_path / "out")])
    assert titles and all("[UNTRAINED]" in t for t in titles), titles
    with pytest.raises(SystemExit) as e:
        global_explain.main(["--output_dir", str(tmp_path / "out2")], device="cpu")
    assert e.value.code == 2
    assert "--cache is required" in capsys.readouterr().err


@pytest.mark.parametrize("cli", [explain_fast, global_explain, artifact_analysis, svm_baseline])
def test_new_clis_need_the_card(cli, tmp_path, monkeypatch):
    """Each CLI runs on the card unless the caller names the CPU: with no
    card visible it raises, and never falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["--synthetic", *(["2"] if cli is svm_baseline else []),
                  "--output_dir", str(tmp_path)])


def _scripts(prefix):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "pyproject.toml")) as f:
        block = re.search(r"\[project\.scripts\]\n(.*?)(?=\n\[|\Z)", f.read(), re.S).group(1)
    return dict(re.findall(rf'^{prefix}([\w-]+)\s*=\s*"([\w.]+:\w+)"', block, re.M))


def test_every_jax_script_has_a_torch_sibling(monkeypatch):
    """``isd-torch-<name>`` beside each ``isd-<name>``, on the port's
    ``_scriptmain`` wrapper of the same CLI; each wrapper drops its CLI's
    return value."""
    jax_scripts = {k: v for k, v in _scripts("isd-").items() if not k.startswith("torch-")}
    torch_scripts = _scripts("isd-torch-")
    assert len(jax_scripts) == 13 and set(torch_scripts) == set(jax_scripts)
    for name, target in torch_scripts.items():
        mod, attr = target.split(":")
        assert mod == "imagined_speech_decoding_tpu_torch.cli._scriptmain"
        assert attr == jax_scripts[name].split(":")[1] == name.replace("-", "_")
        cli = __import__(f"imagined_speech_decoding_tpu_torch.cli.{attr}", fromlist=["main"])
        monkeypatch.setattr(cli, "main", lambda: {"a result": 1})
        assert getattr(_scriptmain, attr)() is None
