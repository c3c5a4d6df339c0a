"""Console-script wrappers for the ``isd-torch-*`` entry points.

The CLI ``main()`` functions return their results (paths, summary rows,
matrices) for tests and notebook callers, but a setuptools console script
runs ``sys.exit(main())``, and ``sys.exit`` of a value that is neither
None nor an int prints it and exits with status 1. These wrappers drop
the return value, so a successful run exits 0. Each runs its CLI on the
card, as ``main()`` does by default.
"""

from __future__ import annotations

from importlib import import_module


def _wrap(module_name: str):
    def run() -> None:
        import_module(f"{__package__}.{module_name}").main()

    run.__name__ = module_name
    run.__qualname__ = module_name
    run.__doc__ = f"Console-script wrapper for ``cli.{module_name}.main``."
    return run


preprocess = _wrap("preprocess")
train_fast = _wrap("train_fast")
train_tsception = _wrap("train_tsception")
benchmark = _wrap("benchmark")
explain_fast = _wrap("explain_fast")
global_explain = _wrap("global_explain")
artifact_analysis = _wrap("artifact_analysis")
svm_baseline = _wrap("svm_baseline")
zero_shot = _wrap("zero_shot")
export_decoder = _wrap("export_decoder")
serve = _wrap("serve")
sweep = _wrap("sweep")
train_baselines = _wrap("train_baselines")
