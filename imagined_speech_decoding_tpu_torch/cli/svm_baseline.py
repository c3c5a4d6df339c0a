"""CSP + SVM (or shrinkage LDA) classical baseline.

Counterpart of ``imagined_speech_decoding_tpu/cli/svm_baseline.py`` with
the same parser and file names. Per subject: stratified K-fold CV
accuracy on the training and validation pool, then a fit on the whole
pool, saved, and its accuracy on the official test split::

    <out>/sub-{sid}_pipeline.joblib
    <out>/sub-{sid}/test_predictions.csv      Predicted,True
    <out>/svm_baseline_summary.csv            Subject,CV_Acc_Mean,CV_Acc_Std,Test_Acc

The band-pass and CSP run on the device (``models.classical``), the
classifier and the folds on the host through scikit-learn, which this
CLI needs: without it the run raises ``ImportError``. The device is the
GPU: without one the run raises ``RuntimeError``; a Python caller runs
on the CPU with ``main(argv, device="cpu")``. ``main`` returns the
summary rows as dicts.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

SUMMARY_COLUMNS = ("Subject", "CV_Acc_Mean", "CV_Acc_Std", "Test_Acc")


def build_parser():
    p = argparse.ArgumentParser(description="CSP + SVM/LDA classical baseline")
    p.add_argument("--data_folder", type=str, default="BCIC2020Track3")
    p.add_argument("--excel_path", type=str, default=None)
    p.add_argument("--classifier", choices=["svm", "lda"], default="svm")
    p.add_argument("--n_components", type=int, default=10)
    p.add_argument("--l_freq", type=float, default=4.0)
    p.add_argument("--h_freq", type=float, default=40.0)
    p.add_argument("--filter_method", choices=["fir", "iir"], default="fir")
    p.add_argument("--filterbank", action="store_true",
                   help="use a 4-band filterbank CSP instead of one band")
    p.add_argument("--n_folds", type=int, default=5)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output_dir", type=str, default="results/svm_baseline")
    p.add_argument("--synthetic", type=int, default=0, metavar="N_SUBJECTS")
    p.add_argument("--synthetic_trials", type=int, default=60)
    p.add_argument(
        "--no-strict", action="store_true",
        help="disable strict schema validation of raw dataset files "
        "(strict is the default: a present-but-deviating .mat/.xlsx "
        "fails loudly with the expected schema)",
    )
    return p


def main(argv=None, device="cuda"):
    args = build_parser().parse_args(argv)
    try:
        from sklearn.model_selection import StratifiedKFold
    except ImportError as e:
        raise ImportError("cli.svm_baseline needs scikit-learn (sklearn) for its classifier "
                          "and folds") from e

    from ..data.constants import SUBJECTS
    from ..devices import require_device
    from ..models.classical import CSPClassifierPipeline
    from ..train.artifacts import save_predictions_csv, write_csv

    device = str(require_device(device))
    if args.synthetic:
        from ..data.synthetic import synthetic_corpus

        subjects = [f"{i + 1:02d}" for i in range(args.synthetic)]
        X, Y = synthetic_corpus(2, args.synthetic, args.synthetic_trials, 64, 800)
        data = {sid: (X[i], Y[i]) for i, sid in enumerate(subjects)}
        test = {sid: (X[i][:15], Y[i][:15]) for i, sid in enumerate(subjects)}
    else:
        from ..data.ingest import (
            load_subject_train_val,
            load_test_set_per_subject,
            resolve_data_folder,
            resolve_excel_path,
        )

        base = resolve_data_folder(args.data_folder)
        excel = resolve_excel_path(base, args.excel_path)
        test = load_test_set_per_subject(base, excel, strict=not args.no_strict)
        data = {sid: load_subject_train_val(base, sid, strict=not args.no_strict)
                for sid in SUBJECTS}
        subjects = list(SUBJECTS)

    os.makedirs(args.output_dir, exist_ok=True)
    bands = [(4, 8), (8, 13), (13, 30), (30, 40)] if args.filterbank else None

    def make_pipe():
        return CSPClassifierPipeline(
            n_classes=5, l_freq=args.l_freq, h_freq=args.h_freq,
            filter_method=args.filter_method, bands=bands,
            n_components=args.n_components, classifier=args.classifier, device=device,
        )

    rows = []
    for sid in subjects:
        x, y = data[sid]
        skf = StratifiedKFold(n_splits=args.n_folds, shuffle=True, random_state=args.seed)
        cv_accs = [make_pipe().fit(x[tr], y[tr]).score(x[va], y[va]) for tr, va in skf.split(x, y)]
        pipe = make_pipe().fit(x, y)
        pipe.save(os.path.join(args.output_dir, f"sub-{sid}_pipeline.joblib"))
        test_acc = np.nan
        if sid in test:
            xt, yt = test[sid]
            y_pred = pipe.predict(xt)
            test_acc = float(np.mean(y_pred == np.asarray(yt)))
            save_predictions_csv(os.path.join(args.output_dir, f"sub-{sid}", "test_predictions.csv"),
                                 y_pred, np.asarray(yt).astype(int))
        rows.append([sid, float(np.mean(cv_accs)), float(np.std(cv_accs)), test_acc])
        print(f"Subject {sid}: CV acc {np.mean(cv_accs):.4f} ± {np.std(cv_accs):.4f}"
              + (f" | test {test_acc:.4f}" if test_acc == test_acc else ""))

    write_csv(os.path.join(args.output_dir, "svm_baseline_summary.csv"), SUMMARY_COLUMNS, rows)
    means = np.array([r[1] for r in rows])
    tests = np.array([r[3] for r in rows])
    # pandas' Series.std (ddof 1) and its NaN-skipping mean
    print(f"\nmean CV acc {means.mean():.4f} ± {means.std(ddof=1) if len(means) > 1 else np.nan:.4f}; "
          f"mean test acc {np.nanmean(tests) if np.isfinite(tests).any() else np.nan:.4f}")
    return [dict(zip(SUMMARY_COLUMNS, r)) for r in rows]


if __name__ == "__main__":
    main()
