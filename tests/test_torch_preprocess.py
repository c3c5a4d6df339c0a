"""The port's preprocessing CLI (``cli/preprocess.py``, the filters through
kernel B1's plain version on the CPU) against the JAX CLI with the same
flags on the same fixture tree: the notch alone, the band-pass alone and
both on the official splits and both stages on the per-subject groups,
at rtol 1e-4 and atol 1e-4 * max|ref| (B1's tolerance); labels equal.
Strict mode refuses the fixture's short test split in both, with the same
message."""

import os

import numpy as np
import pytest
import torch

from bcic_fixture import SUBJECTS, write_tree
from imagined_speech_decoding_tpu.cli import preprocess as jax_preprocess
from imagined_speech_decoding_tpu.data import ingest as jax_ingest
from imagined_speech_decoding_tpu_torch.cli import preprocess
from imagined_speech_decoding_tpu_torch.data import ingest
from imagined_speech_decoding_tpu_torch.ops.cuda.iir import sosfiltfilt_chain

torch.set_num_threads(1)

h5py = pytest.importorskip("h5py")
RTOL = 1e-4  # atol = RTOL * max|ref|


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("bcic"))
    write_tree(base, SUBJECTS, (2, 2, 2), seed=7)  # every subject: the per-subject layout
    return base


def _read(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda n, o: out.__setitem__(n, o[()]) if isinstance(o, h5py.Dataset)
                     else None)
    return out


def test_parser_matches_jax():
    def options(parser):
        return {a.dest: (a.option_strings, a.default, a.nargs, a.choices)
                for a in parser._actions if a.dest != "help"}

    assert options(preprocess.build_parser()) == options(jax_preprocess.build_parser())


BOTH = ["--notch", "60", "--bandpass", "4", "40"]


@pytest.mark.parametrize("layout,flags", [
    ("official", ["--notch", "60"]), ("official", ["--bandpass", "4", "40"]),
    ("official", BOTH), ("subjects", BOTH)], ids=["notch", "bandpass", "both", "subjects"])
def test_filtered_cache_matches_jax(tree, tmp_path, layout, flags):
    argv = ["--data_folder", tree, "--layout", layout, "--no-strict", *flags]
    launches = sosfiltfilt_chain.launches
    ours = _read(preprocess.main(argv + ["--output", str(tmp_path / "port.h5")], device="cpu"))
    assert sosfiltfilt_chain.launches == launches  # the CPU runs the plain version
    ref = _read(jax_preprocess.main(argv + ["--output", str(tmp_path / "jax.h5")]))
    raw = _read(preprocess.main(["--data_folder", tree, "--layout", layout, "--no-strict",
                                 "--output", str(tmp_path / "raw.h5")], device="cpu"))
    assert sorted(ours) == sorted(ref) == sorted(raw)
    for name, r in ref.items():
        assert ours[name].dtype == r.dtype and ours[name].shape == r.shape, name
        if name.split("/")[-1].startswith("X"):
            assert not np.array_equal(r, raw[name]), name  # it was filtered
            np.testing.assert_allclose(ours[name], r, rtol=RTOL,
                                       atol=RTOL * float(np.abs(r).max()), err_msg=name)
        else:
            np.testing.assert_array_equal(ours[name], r, err_msg=name)


def test_strict_refuses_the_short_fixture_like_jax(tree, tmp_path):
    argv = ["--data_folder", tree, "--notch", "60", "--no-compress"]
    errors = []
    for name, call in (("port", lambda a: preprocess.main(a, device="cpu")),
                       ("jax", jax_preprocess.main)):
        out = str(tmp_path / f"{name}.h5")
        err = ingest.SchemaError if name == "port" else jax_ingest.SchemaError
        with pytest.raises(err) as info:
            call(argv + ["--output", out])
        errors.append(str(info.value).replace(out, "<cache>"))
    assert errors[0] == errors[1] and "2 test trials but the answer sheet has 50" in errors[0]


def test_filtering_needs_the_card_unless_told(tree, tmp_path, monkeypatch):
    """With a filter and no card the CLI raises before it reads a file; a
    cache without filters needs no device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "c.h5")
    with pytest.raises(RuntimeError, match="is_available"):
        preprocess.main(["--data_folder", tree, "--notch", "60", "--output", out])
    assert not os.path.exists(out)
    timings = {}
    preprocess.main(["--data_folder", tree, "--no-strict", "--output", out], timings=timings)
    assert os.path.exists(out)
    assert {"ingest_s", "write_s"} <= set(timings)
