#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving (live, fleet, artifact,
streaming), training, attribution, real-data and campaign (sweep, LOSO,
ensemble, zero-shot, native cache) paths, of the models with batch-norm
state (the CVBlock, EEGNet_Encoder and HeadConv_Paper_Version heads,
TSception) with their decoders and train-time augmentation, of the
feature baselines (band-power MLP, STFT EEGNet, CNN-BiLSTM), of the
explain and QC programs (attribution maps, PSD and FastICA, the CSP
pipeline), of multi-GPU training (the ``--mesh`` strategies) and of the
head's general-geometry kernels (FAST at 2-second windows), on one NVIDIA
GPU.

    python3 chip_smoke.py        # from the repository root, on a machine with a card

1. Prints the card (``nvidia-smi`` name and power limit) and versions.
2. Builds the hand-written CUDA kernels from ``csrc/`` and prints the
   build time and, for the tensor-core kernels B2f, B2w and B2x and the
   bf16 instantiations B2f-bf16, B2w-bf16 and B2x-bf16, their registers
   and spills (``-Xptxas -v``), shared memory per block and the count of
   tensor-core instructions of their route in their SASS (``cuobjdump``,
   where the toolkit has it): HMMA (``mma.sync``), or HGMMA (``wgmma``)
   for B2f-bf16, B2w-bf16 and B2x-bf16 (which must have no HMMA); a count
   of 0 fails the run.
3. Holds each kernel against its plain PyTorch version on the card, in
   f32 with TF32 off, at the main paths' shapes, and times both with
   CUDA events (B1 also by the profiler's device time), beside the kernel's bound (the least time for its work:
   bytes at 3.35 TB/s, or its products as three TF32 tensor-core passes
   at 495 TFLOP/s, the fastest f32-accurate route):
     B1 (IIR cascade): the chain entry, 60 Hz notch then 4-40 Hz
        band-pass zero-phase in one launch, on (B, 64, 800) for B = 1, 8,
        64, 350 and on the corpus's 336,000 rows (there also with 8 and 16
        lanes a row), and the device time at the preprocessing splits'
        288,000 and 48,000 rows (the real-data path reads it); the causal entry on the band-pass's padded length,
        y and zf; tolerance rtol 1e-4, atol 1e-4 * max|ref| (the JAX
        package's Pallas IIR tolerance, tests/test_pallas.py). Bounds: x
        read and y written once, or the f32 FMAs of both passes.
     B2f (Conv4Layers head forward, through the model-axis entry at
        M = 1) at full width; rtol 1e-4, atol 1e-5.
     B2w / B2x (head weight / input gradients) at full width, M = 2,
        B = 8 and M = 1, B = 64, against the plain autograd backward;
        rtol 1e-4, atol 1e-4 * max|ref| per tensor (sums over B*N*t1
        terms). B2x also at M = 1, B = 16 and 100 (the attribution CLIs'
        batches), against its plain version alone (autograd w.r.t. x with
        the weights held out), timed also by the profiler's device time,
        with its share of the bound and of the ``mma.sync`` TF32 floor.
        Then all three at the training run's M = 75 and its
        batch sizes 64, 24 (the ragged tail) and 35 (validation): the
        full launches' outputs for models 0, 37 and 74 against the plain
        version on those models' operands, at the same tolerances; B2f,
        B2w and B2x are timed alone at M = 75, B = 64, with their rates and
        their shares of the bound and of the ``mma.sync`` TF32 floor.
     B2f-bf16 / B2w-bf16 (the training path's default precision: bf16 x,
        f32 weights, f32 outputs) at (M, B) = (2, 8), (1, 64) and the
        training run's M = 75 at 64, 24 and 35 (models 0, 37, 74), against
        the plain bf16 versions: |err| <= 3e-4 (features) and 1e-3 (weight
        gradients) x max|ref| per tensor (tests/test_torch_cuda.py says
        why); B2f-bf16's two runs at M = 75, B = 64 bit-identical; timed
        by CUDA events, with their bound (x at 2 bytes a sample; one bf16
        tensor-core pass at 989 TFLOP/s) and their share of their route's
        floor (``wgmma`` m64n32k16 for both, B2f-bf16's on its own work:
        the first conv once per trial); B2f-bf16's cycles a (trial, zone)
        item and B2w-bf16's a (trial, window, zone) unit by phase at M = 75,
        B = 64 (their debug instantiations, ``b2f_timing.py``'s and
        ``b2w_timing.py``'s splits).
     B2x-bf16 (a bf16 x's input gradient, dx in bf16) at (M, B) = (2, 8),
        (1, 16) and (1, 100) (the attribution CLIs' batches), against the
        plain bf16 backward's dx within 2e-3 in relative L2, a rerun
        bit-identical; timed by CUDA events and device time beside its
        bound (one bf16 tensor-core pass) and its ``wgmma`` floor.
     Head geometries the kernels are not built for, which the wrappers
        launch on zero-padded or split operands: dim_cnn = 8 trained in
        f32 and bf16 and a bf16 forward at T = 1001 (N = 7 windows: two
        B2f-bf16 groups), against the CPU, with the kernels' launches and
        the adapted calls counted; bf16 geometries B2w-bf16 has no plan for
        (C = 72 and 68) on the f32 route, one B2w launch on the bf16
        operands, within 1e-2 in relative L2 of the plain bf16 backward;
        windows of 280 at C = 64 on B2w-bf16's column tiles, at the bf16
        kernels' 1e-3 x max|ref|; C = 128, where neither tuned plan fits,
        runs on B2f-g bf16 (section 14) against the plain bf16 forward.
   B2f also at the fleet's M = 15, B = 1 and 8, on one window broadcast
   to every model, with its device time.
4. Serving path: full-width FAST weights from a numpy seed are written
   as a checkpoint, the port's ``cli.serve`` serves it over TCP, and a
   ``DecoderClient`` sends INFO, DECODE at B = 1 and B = 8, RELOAD to a
   second checkpoint, and DECODE again. The posteriors must be finite,
   sum to 1 and match the port's plain CPU forward of the same weights
   (rtol 1e-4, atol 1e-5). The decoder captures one CUDA graph a
   captured batch size: its eager decodes must each have made one B1
   chain launch and one B2f launch (the launch counts), each capture
   recorded one of each (the capture counts, apart: a capture runs
   nothing), the other decodes be replays.
   Graphs: the live decoder and a fleet of 15 (rows and ensemble) at
   B = 1 and 8, a replay equal to the un-captured chain bit for bit,
   host p50 replayed and eager, device busy time, the CUDA-event span
   and the device's idle share of it, device events and
   ``cudaLaunchKernel`` / ``cudaGraphLaunch`` calls a decode (profiler,
   which must show one B1 and one B2f kernel a decode); after
   ``swap_weights`` replays equal a fresh decoder's bit for bit.
   Streaming: a producer thread pushes 125-sample chunks into the native
   ring while ``decode_latest`` runs; every window decoded must be the
   stream's samples at its end index (untorn) and its posteriors a
   direct decode's; ``decode_latest`` p50. After the f32 training run,
   its 15 ``best_subject.npz`` are served by ``cli.serve
   --checkpoint-dir`` (DECODE_ALL and the ensemble's DECODE at B = 1 and
   8, p50 / p90 / p99): every row against its checkpoint's single
   decoder, the first requests against the plain CPU fleet (rtol 1e-4,
   atol 1e-5), the ensemble against the rows' mean. One checkpoint goes
   through ``cli.export_decoder`` and ``cli.serve --artifact``: its
   posteriors must equal the live decoder's bit for bit; loaded alone in a
   child process that imports torch and ``ops/cuda/library.py`` only, the
   profiler must show B1's and B2f's kernels and none of the plain
   versions' ops (``aten::unfold``, ``aten::flip``).
5. Training path: the port's ``cli.train_fast`` on a 15-subject x 350-trial
   synthetic corpus, 75 stacked full-width models, 2 epochs, at its
   default precision (bf16: B2f-bf16 and B2w-bf16 must have launched, and
   no f32 head kernel) and with ``--precision f32`` (B2f and B2w, no
   bf16 one); B2x never. The history must be finite, the result tree
   complete, and one subject's ``best_subject.npz`` must reproduce its
   ``test_predictions.csv`` on the card, with logits that match the plain
   CPU forward (f32: rtol 1e-4, atol 1e-5; bf16: 3e-3 in relative L2).
   Every path at the shipped geometry (serving, training in each
   precision, the bf16 trajectory, attribution) must launch the head's
   kernels on its operands as they are (``adapted`` 0).
   Then one step at M = 75, B = 64 in each precision under the profiler,
   in a child process of its own (``--step-profile-child``)
   (the bf16 one must run B2f-bf16 and B2w-bf16 and no f32 head kernel),
   and a 2-subject x 10-trial run on the card against the same run on the
   CPU (plain path), in each precision.
6. Attribution path, on a trained checkpoint, every input gradient
   through B2x (and none through B2w): integrated gradients (8 trials x
   16 steps) against the plain CPU path; expected gradients at the
   global-explain CLI's shape (100 trials x 16 samples, 200 background
   trials), its host seconds and B2x's share of its device time, against
   the CPU on 4 trials with the same draws; ``attribution_for_predictions``
   at the explain CLI's shape (16 trials x 32 samples, 64 background
   trials), its predictions against the CPU's.

7. Real-data path, on a raw tree at the documented schema that
   ``tests/bcic_fixture.py`` writes (15 subjects, 300 / 50 / 50 trials of
   64 x 795 samples, v5 ``.mat`` files, an ``.xlsx`` answer sheet; the v7.3
   test files only where h5py imports): the preprocessing CLI's work
   (``cli.preprocess`` with h5py; without it the functions it calls:
   ingest of the v5 splits, ``filter_corpus`` a split) with the 60 Hz
   notch and the 4-40 Hz band-pass, one B1 chain launch a split, each
   split's first and last 8 trials against the plain chain (B1's
   tolerance), timed by CUDA events beside the byte bound and the device
   time that step 3 takes at its shape with its filters on random data; ``cli.train_fast`` on the tree in its own process, bf16, 30
   epochs in two segments, once through, and once killed (SIGKILL) in
   its second segment and run again with ``--resume``: history, best
   epochs, ``summary_per_subject.csv`` and a ``best_subject.npz`` must
   equal the uninterrupted run's bit for bit, B2f-bf16 and B2w-bf16 must
   launch and nothing be adapted; then ``cli.benchmark`` over the result
   tree, whose ``Acc_Mean`` must be the subjects' mean test accuracy.

8. Campaign programs, at full width on the training path's 15 x 350
   corpus (synthetic, cli.train_fast's): the head kernels at their new
   shapes against their plain versions (B2f-bf16 / B2w-bf16 at LOSO's
   M = 15, B = 64 and 58, B2f-bf16 also at 62 and 56; f32 B2f at
   zero-shot's M = 15, B = 50); ``cv_sweep`` on one subject with the
   CLI's default 5 lr x 3 wd grid x 5 folds (75 models, bf16, 2 epochs),
   B2f-bf16 and B2w-bf16 launched exactly as its batches count them; a
   grid of one (lr, wd) twice, whose rows must be equal bit for bit; an
   f32 2-config sweep against plain fits at the rebuilt learning rates and
   weight decays (history rtol 1e-4 / atol 1e-5, parameters within twice
   the summed lr); ``pretrain_loso`` over the 15 subjects (bf16, 2
   epochs; its launches counted exactly at B = 64 / 58 / 62 / 56; every
   row leaves its subject out; a second call launches nothing and returns
   the saved rows bit for bit; a CV warm start begins at them exactly);
   ``cli.train_fast --ensemble 2`` in a child process (member 0 equals
   the bf16 training run bit for bit; every subject's decision is the
   argmax of the members' mean posterior from their best checkpoints);
   the zero-shot matrix over the real-data run's 15 checkpoints on the
   fixture's test split (f32, one B2f launch a target; two targets'
   columns against the plain CPU forward, where a flipped prediction
   must sit inside B2f's tolerance); the corpus through the native cache
   (bit for bit, the read's GB/s); and one bf16 step of the sweep (M =
   75, ``RowAdamW``) and of LOSO (M = 15) beside the CV step, by device
   time and CUDA-event span.

9. The models with batch-norm state, which run no hand-written kernel
   but B1 in front of a decoder (cuDNN convolutions and plain tensor code;
   none of the kernels' launch counts may move in their training runs):
   (a) the CVBlock, EEGNet_Encoder and HeadConv_Paper_Version heads at full
   width in bf16 on the training path's corpus (75 models, batch 64, 2
   epochs), CVBlock through ``cli.train_fast --head CVBlock`` and the two
   others through ``train_per_subject_cv`` on the same corpus: the
   history finite, the tree complete with the running statistics in every
   ``best_subject.npz``, the last subject's file (weights and state)
   reproducing its test predictions, the fit's peak device memory;
   (b) ``cli.train_tsception --synthetic 15 --synthetic_trials 350
   --epochs 2 --subject_group 15`` (75 models, f32, batch 32), likewise;
   (c) ``cli.train_fast --augment`` (bf16, Conv4Layers): B2f-bf16 and
   B2w-bf16 launched exactly as the batches count them, nothing adapted,
   and an evaluation of the trained stack on the f32 corpus cast per batch
   equal to the un-augmented evaluation on the bf16 corpus bit for bit;
   (d) a live decoder and a 15-model fleet over (a)'s CVBlock checkpoints:
   replays equal the eager chain bit for bit, one B1 chain launch an eager
   decode and one a capture, the posteriors against the plain CPU
   decoders (rtol 1e-4, atol 1e-5), and after ``swap_weights(params,
   state)`` replays equal fresh decoders bit for bit. In the step-profile
   child, one step of each head (M = 75, B = 64, bf16) and of TSception
   (M = 75, B = 32, f32): CUDA-event span, device time, idle share, peak
   allocated memory. Card against CPU, f32 with TF32 off, 2 subjects x 10
   trials, 2 epochs, dropout off, for each head and TSception: the
   history at rtol 1e-4 / atol 1e-5, the running statistics after the
   first step at the same tolerance, the parameters within twice the
   summed learning rate; the final statistics are printed beside them
   (``phase_trajectory_stateful`` says why they are not held to 1e-4).

10. The feature baselines (BASELINE.json configs #1, #3, #4), each through
   ``cli.train_baselines --pipeline <p> --synthetic 15 --synthetic_trials
   350 --epochs 2`` at full width (75 models, batch 64, bf16, the training
   path's corpus): the band-power featurizer's notch and 8-70 Hz band-pass
   as B1 chain launches (exactly two: the corpus and the test sets; B1 held
   against the plain chain at that shape and timed there), its features
   and the STFT planes of subject 01 against the CPU's plain featurizer
   (rtol 1e-4, atol 1e-5; the stop band's Delta log power atol 1e-2: there
   the two filters part by their f32 roundings); no other kernel launched; the history finite,
   the tree complete with the state in every ``best_subject.npz``, and the
   last subject's reproducing its test predictions. In the step-profile
   child, one bf16 step of each model (M = 75, B = 64) and an f32 step of
   the CNN-BiLSTM (in subject groups if the stack does not fit): span,
   device time, idle share, peak memory; and, in a step-profile child of
   its own, each featurizer over the corpus on the card: host seconds and
   device time. Card against CPU, f32
   with TF32 off, 2 subjects x 10 trials, 2 epochs, dropout off, on the
   CPU's features: the history at rtol 1e-4 / atol 1e-5, the running
   statistics at the same tolerance, the parameters within twice the
   summed learning rate.

11. The training engine's remaining paths: (a) ``cli.train_fast
   --synthetic 15 --synthetic_trials 70 --head CVBlock --loso-pretrain
   --loso-epochs 1 --epochs 1 --augment --profile <dir>`` in a child
   process (bf16; the parent corpus's first 70 trials a subject handed
   over as ``.npy``): no
   hand-written kernel launched in LOSO or the CV, every LOSO row leaves
   its subject out, the ``Pretrain_excludes`` files hold no running
   statistics, the CV begins at the LOSO rows and at a fresh draw's
   running statistics, a second LOSO call trains nothing and returns the
   saved rows bit for bit, ``<dir>/trace.json`` loads and holds kernel
   records and the CLI's fit range; LOSO's host seconds and peak memory,
   and (step-profile child) its CVBlock step at M = 15 by device time;
   (b) ``cv_sweep`` of CVBlock on one subject (2 lr x 1 wd x 5 folds,
   bf16, 2 epochs), and a grid of one (lr, wd) twice whose rows' parameters,
   best snapshots, running statistics and history are equal bit for bit;
   (c) in the step-profile child, one bf16 step (M = 75, B = 64) of
   ``train_transformer`` (B2f-bf16 once, B2w-bf16 never; the head's
   weights move by the weight decay alone, ``DECAY_REL``) and of
   ``train_head`` (each once), by device time beside the default step;
   (d) early stopping on the Conv4Layers stack (75 models, bf16, threshold
   0, 3 epochs): every row stops after epoch 1 and epochs 2-3 leave
   parameters, AdamW moments and best snapshots bit for bit, the head
   kernels launched as all 3 epochs' batches count them; (e) dense tokens,
   ``forward_head(step_override=25)`` (23 windows) at M = 1, B = 64 through
   B2f (one launch) and B2f-bf16 (groups of the windows its plan holds)
   against their plain versions, timed beside their bounds, and
   ``batched_forward_head`` over 256 trials equal to one call bit for bit.
12. Explain and QC: ``cli.explain_fast``'s ``explain_arrays`` at the CLI's
   defaults (16 trials x 32 samples against 64, f32) on the f32 run's
   checkpoint, held against the CPU on the same draws (attributions,
   predictions, zone importance, class means, zone x time, band heatmap),
   B2x 32 launches, B2f 33, B2w none; ``cli.global_explain`` at its
   defaults on 3 synthetic subjects over the f32 run's first checkpoints
   (B2x and B2f 16 launches a subject), its device time, B2x's share and
   idle share, one subject's pooled arrays (its first GE_CPU_TRIALS test
   trials) against the CPU;
   ``cli.artifact_analysis`` on 100 synthetic trials (its PSD against the
   CPU's ``welch_psd``) and ``fast_ica`` of its (80,000 x 64) input on the
   card against the CPU in f32 and f64, with iterations and seconds; the
   CSP pipeline's ``fir`` and ``iir`` band-passes, ``csp_fit`` and
   ``csp_transform`` on one 350-trial subject against the CPU (the ``iir``
   route one B1 chain launch), by device time. The SVC is not run (the
   card's machine has no scikit-learn).
13. Multi-GPU (``parallel``): (a) ``dryrun_multichip`` over the visible
   cards, one rank a card on NCCL (its five sections held to the
   unsharded run at the JAX dry run's bounds); (b) two ranks sharing the
   card over gloo with CUDA tensors (``chip_smoke.py --mesh-child``, the
   parent's corpus handed over as ``.npy``) run ``cli.train_fast
   --synthetic 15 --synthetic_trials 350 --epochs 2`` under ``--mesh
   model``, ``data`` and ``2d`` in bf16 and ``data`` in f32, each held to
   the training path's unsharded run of its precision (``MESH_LOSS_TOL``),
   with each rank's wall time, peak memory and launches, and one profiled
   bf16 step at its local shapes (M = 38, B = 64 under ``model``; M = 75,
   B = 32 under a data axis); (c) the head kernels at the ranks' local
   shapes against their plain versions (bf16 at M = 38, B = 64 / 24 / 35
   and M = 75, B = 32 / 12 / 18 / 17; f32 at the data axis's), each
   precision's B2f and B2w timed beside their bounds at the full batches.
   The ``kernels`` line's
   ``launches_mesh`` counts (b)'s launches, over both ranks and every run.

14. The general-geometry head kernels B2f-g, B2w-g and B2x-g (f32 and bf16;
   ``csrc/conv4head_general.cu``) and the tuned kernels' column tiles, on
   FAST at 2-second windows (``window_len=500, slide_step=150``: 3 windows,
   64 channels, 8 zones, dim 32), past the tuned f32 kernels' whole-window
   plans: (a) ``train_per_subject_cv`` with 75 models at batch 64 on the
   corpus's first 70 trials a subject, 2 epochs, in f32 (B2f and B2w in
   column tiles) and
   bf16 (B2f-bf16, B2w-bf16 in column tiles), and at dim 64 on 2 subjects, 1
   epoch, in f32 (B2f-g, B2w-g) and bf16 (B2f-g bf16, B2w-g bf16), every
   head launch as the batches count them, and the
   2 x 10 card-against-CPU trajectory at that geometry in each precision
   (the training tolerances of the shipped geometry's); (b) a live decoder
   of (a)'s f32 model 0: one DECODE replayed equal to eager bit for bit,
   B2f's column tiles launched and captured; (c) integrated and expected
   gradients of the shipped FAST in bf16 (B2f-bf16, B2x-bf16), integrated
   gradients of (a)'s f32 model (B2f and B2x in column tiles), of FAST at
   dim 64 at the same windows in f32 (B2f-g, B2x-g f32) and of FAST on one
   800-sample window
   in bf16 (B2f-bf16 and B2x-bf16 in column tiles), 100 trials each, and of
   FAST at dim 64 at windows of 500 in bf16 (B2f-g bf16, B2x-g bf16) on 4,
   against the CPU on 4 (bf16: in relative L2 under the bf16-vs-f32 gap);
   the counts set to 0
   before (b) and read after (c), held to what the calls imply, and every
   general kernel launched on the path; (d) each general kernel launched
   directly at M = 2, B = 8 against its plain version, f32 and bf16, on C =
   80 and 128 at windows of 250, C = 64 at windows of 500 and 800 and O = 64
   at the shipped geometry, reruns bit-identical; each timed by CUDA events
   beside its bound and its plain version, B2x-g bf16 also at M = 1, B = 100
   by device time, and one step of (a) in each precision by device time;
   then at the path's shapes, where a block walks several units in its
   workspace slot: B2f-g and B2w-g at (a)'s step (M = 75, B = 64), f32 and
   bf16, models 0, 37 and 74, reruns bit-identical, and so B2f's, B2w's and
   B2w-bf16's column tiles (also timed at M = 2, B = 8); B2x-g at (c)'s M =
   1, B = 100 (bf16 on one 800-sample window, f32 at windows of 500) and
   B2x-bf16's and B2x's column tiles there, on every trial, the tiles'
   reruns bit-identical; (e)
   B2x's column tiles launched directly against the plain input gradient
   at M = 2, B = 8, windows of 285, 500 and 800, C = 13 and 64, SZ = 1, 2
   and 8, reruns bit-identical, and timed at M = 1, B = 100, windows of 500
   (CUDA events and device time) beside their bound and B2x-g f32 launched
   directly; (f) B2x-bf16's column tiles on the same grid in bf16 against
   the plain bf16 input gradient, reruns bit-identical, timed at M = 1, B =
   100 on one 800-sample window and at windows of 500 beside their bound
   and B2x-g bf16 launched directly; (g) B2f-bf16's column tiles launched
   directly against the plain bf16 forward at M = 2, B = 8 (C = 64 at
   windows of 581, 600 and 800, 72 at 500, 104 at 300, 106 at 800), reruns
   bit-identical, and timed at M = 1, B = 100 on one 800-sample window
   (CUDA events and device time) beside its bound and B2f-g bf16 launched
   directly. The f32 step's profile prints B2f's and B2w's shares of its
   device time.

The line before the last is a JSON object of the kernels; the last line
is ``{"ok": true, "device": {...}}``. Any failed phase raises, and the
script exits non-zero. Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.distributed as dist
from scipy.signal import tf2sos
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule

from imagined_speech_decoding_tpu_torch import pipelines
from imagined_speech_decoding_tpu_torch.cli import export_decoder, train_baselines, train_fast
from imagined_speech_decoding_tpu_torch.cli.serve import build_parser, build_server
from imagined_speech_decoding_tpu_torch.config import FASTConfig, TrainConfig
from imagined_speech_decoding_tpu_torch.data.constants import SFREQ
from imagined_speech_decoding_tpu_torch.data.synthetic import synthetic_corpus, synthetic_trials
from imagined_speech_decoding_tpu_torch.explain.attribution import (
    attribution_for_predictions,
    expected_gradients,
    expected_gradients_from_draws,
    integrated_gradients,
)
from imagined_speech_decoding_tpu_torch.models.fast import FAST, FORWARD_MODES
from imagined_speech_decoding_tpu_torch.models.modules import SharedRowsGenerator
from imagined_speech_decoding_tpu_torch.ops.cuda import _lib
from imagined_speech_decoding_tpu_torch.ops.cuda.conv4head import (
    BWD_W_BF16_PHASES,
    FWD_BF16_PHASES,
    GENERAL_OPS,
    KERNEL_TAPS,
    _fwd_bf16_windows_built,
    _launch_bwd_w,
    _launch_bwd_x,
    _launch_fwd,
    _general_slots,
    _launch_general,
    conv4head_bwd_bf16_plain,
    conv4head_bwd_plain,
    conv4head_bwd_w,
    conv4head_bwd_x,
    conv4head_bwd_x_plain,
    fused_conv4_head,
    fused_conv4_head_plain,
    bwd_x_bf16_col_tiles,
    fwd_bf16_block_plan,
    fwd_bf16_col_tiles,
    bwd_x_bf16_plan,
    bwd_x_col_tiles,
    general_plan,
)
from imagined_speech_decoding_tpu_torch.ops.cuda.iir import (
    _launch_causal,
    _launch_chain,
    lanes_for,
    prepare_filter,
    sosfilt_time_major,
    sosfilt_time_major_plain,
    sosfiltfilt_chain,
    sosfiltfilt_chain_plain,
)
from imagined_speech_decoding_tpu_torch.ops.filters import butter_sos, corpus_filters, notch_ba
from imagined_speech_decoding_tpu_torch.server import DecoderClient
from imagined_speech_decoding_tpu_torch.serving import (
    StreamingDecoder,
    make_fleet_decoder,
    make_online_decoder,
    stack_checkpoints,
)
from imagined_speech_decoding_tpu_torch.train import checkpoint, engine
from imagined_speech_decoding_tpu_torch.train import loso as loso_module
from imagined_speech_decoding_tpu_torch.train.artifacts import load_predictions_csv
from imagined_speech_decoding_tpu_torch.train.checkpoint import load_model_npz, save_model_npz
from imagined_speech_decoding_tpu_torch.train.cv import (
    build_cv_index_stack,
    stacked_init,
    train_per_subject_cv,
)
from imagined_speech_decoding_tpu_torch.train.loso import (
    build_loso_index_stack,
    pretrain_loso,
    stack_pretrained_for_cv,
)
from imagined_speech_decoding_tpu_torch.train.sweep import cv_sweep, hyper_grid
from imagined_speech_decoding_tpu_torch.models.api import (
    make_augmented_model,
    make_fast_model,
    make_tsception_model,
)
from imagined_speech_decoding_tpu_torch.parallel.dryrun import dryrun_multichip
from imagined_speech_decoding_tpu_torch.parallel.mesh import (StackShard, free_port, init_world,
                                                              mesh_strategy)
from imagined_speech_decoding_tpu_torch.profiling import TRACE_FILE
from imagined_speech_decoding_tpu_torch.transplant import (
    from_jax_params,
    init_jax_layout,
    init_jax_layout_params,
    stack_trees,
    to_jax_params,
)

SEED = 0
IIR_RTOL = 1e-4  # atol = IIR_RTOL * max|ref|
HEAD_RTOL, HEAD_ATOL = 1e-4, 1e-5
POST_RTOL, POST_ATOL = 1e-4, 1e-5
BWD_RTOL = 1e-4  # atol = BWD_RTOL * max|ref| per gradient tensor
TRAJ_RTOL, TRAJ_ATOL = 1e-4, 1e-5  # card vs CPU training trajectory
TRAJ_NOISE_SHARE = 1e-4  # parameter elements allowed past it, each within the summed lr
MAIN_BATCH = 8  # the serving path's largest request; the JSON line's forward shapes
FLEET_MODELS = 15  # one best_subject.npz a subject (bench.py's N_SUBJECTS)
REQUESTS = 100  # timed DECODE requests per batch size
TRAIN_SUBJECTS, TRAIN_TRIALS, TRAIN_EPOCHS = 15, 350, 2  # 75 models, 280 + 70 trials each
TRAIN_BATCH = 64
# The head's batch sizes in that run: 280 train trials at batch 64 are
# 4 x 64 + a 24-trial tail; 70 validation trials are 2 x 35.
TRAIN_STEP_BATCHES = (TRAIN_BATCH, TRAIN_TRIALS * 4 // 5 % TRAIN_BATCH,
                      engine.eval_batch_size_for(TRAIN_TRIALS // 5, TRAIN_BATCH))
BWD_SHAPES = ((2, 8), (1, 64))  # (M, B) of the B2w comparisons; JSON line: the first
# (M, B) of B2x's: the attribution CLIs' batches too; JSON line: the last,
# expected gradients' batch in the attribution phase.
X_SHAPES = ((2, 8), (1, 16), (1, 64), (1, 100))
IG_TRIALS, IG_STEPS = 8, 16
EG_TRIALS, EG_SAMPLES, EG_BACKGROUND = 100, 16, 200  # cli/global_explain.py's defaults
EG_CPU_TRIALS = 4  # trials of expected gradients held against the CPU
AFP_TRIALS, AFP_SAMPLES, AFP_BACKGROUND = 16, 32, 64  # cli/explain_fast.py's defaults
B2X_KERNELS = "conv4head_bwd_x_kernel|sum_partials_kernel"  # B2x and its partial pass

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, 700 W):
TF32_FLOPS = 495e12  # tensor cores, TF32
F32_FLOPS = 67e12  # CUDA cores, f32
HBM_BYTES_S = 3.35e12
# The rate of mma.sync m16n8k8 TF32 on an H100 80GB HBM3 at 700 W, measured by
# mma_tf32_ceiling.py: the floor of B2f's and B2w's route (three passes per product).
MMA_SYNC_TF32_FLOPS = 323.2e12
BF16_FLOPS = 989e12  # tensor cores, bf16 dense
# The rate of mma.sync m16n8k16 bf16 on an H100 80GB HBM3 at 700 W, measured by
# mma_tf32_ceiling.py --mode bf16: the floor of B2f-bf16's route (one pass).
MMA_SYNC_BF16_FLOPS = 642.3e12
# The rate of wgmma m64n32k16 bf16 with both operands in shared memory, on the same card,
# measured by mma_tf32_ceiling.py --mode wgmma: the floor of B2w-bf16's and B2f-bf16's route.
WGMMA_N32_FLOPS = 653.0e12
BF16_FWD_REL, BF16_BWD_REL = 3e-4, 1e-3  # atol = REL * max|ref| per tensor (bf16 kernels)
BF16_LOGITS_L2 = 3e-3  # bf16 logits and gradients, card vs CPU, relative L2
# A weight that only decays, p <- p - lr*wd*p, against that product in f64:
# two f32 roundings (the factor and the product), relative to |p|.
DECAY_REL = 2.5e-7
BF16_SHAPES = ((2, 8), (1, 64))  # (M, B) of the bf16 kernel comparisons; JSON line: the last
IIR_FMA_PER_SECTION = 5  # per sample: csrc/iir.cu's transposed direct form II


def bound_ms(nbytes: float, flops: float, flops_s: float):
    """Least time the card could take for the work, and what sets it:
    each input read once and each output written once at the memory rate,
    or the operations at the peak of their route."""
    by_bytes, by_ops = 1e3 * nbytes / HBM_BYTES_S, 1e3 * flops / flops_s
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def iir_bound(rows: int, t_len: int = 854, sections: int = 4):
    """B1's causal entry on (t_len, rows): x, zi read and y, zf written; f32 FMAs."""
    nbytes = 4 * 2 * rows * (t_len + 2 * sections)
    return bound_ms(nbytes, 2 * IIR_FMA_PER_SECTION * sections * t_len * rows, F32_FLOPS)


def chain_bound(rows: int, filters, t_len: int = 800):
    """B1's chain entry on (rows, t_len): x read and y written once; f32
    FMAs of both passes of every filter at its extended length (the
    kernel's fix-up work does not count)."""
    flops = sum(2 * 2 * IIR_FMA_PER_SECTION * f.n_sections * (t_len + 2 * f.padlen)
                for f in filters)
    return bound_ms(4 * 2 * rows * t_len, flops * rows, F32_FLOPS)


HEAD_WEIGHT_FLOATS = 256 * 320 + 256 + 2 * 8 * 32 * 160  # w12, b12, w3, w4 of one model


def head_bound(fma_per_unit: int, m: int, b: int, n_out_floats: int, reads_g: bool = True,
               windows: int = 5):
    """A head kernel at full width (C = 64, T = 800, 8 zones, O = 32, K =
    5; 5 windows, or ``windows`` at a dense step) on M models of B trials.
    The fastest f32-accurate route for its products is three TF32
    tensor-core passes: 3 x 2 FLOPs per FMA at the TF32 peak. Reads x, the
    weights and (backward) the cotangent g; writes ``n_out_floats``."""
    n_in = m * b * 64 * 800 + m * HEAD_WEIGHT_FLOATS + reads_g * m * b * windows * 256
    return bound_ms(4 * (n_in + n_out_floats), 3 * 2 * fma_per_unit * m * b * windows * 8,
                    TF32_FLOPS)


def head_bound_bf16(fma_per_unit: int, m: int, b: int, n_out_floats: int,
                    reads_g: bool = True, windows: int = 5):
    """``head_bound`` for a bf16 kernel: x at 2 bytes a sample, the f32
    weights, cotangent and outputs at 4; its products as one bf16
    tensor-core pass at the bf16 peak."""
    nbytes = 2 * m * b * 64 * 800 + 4 * (m * HEAD_WEIGHT_FLOATS
                                         + reads_g * m * b * windows * 256 + n_out_floats)
    return bound_ms(nbytes, 2 * fma_per_unit * m * b * windows * 8, BF16_FLOPS)


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call between CUDA events on the current stream."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel: str, iters: int) -> float:
    """Mean device time per call of the kernels whose name matches the
    regular expression ``kernel`` (profiler): the kernels' own time,
    without the host's time between back-to-back calls, which ``cuda_ms``
    includes."""
    fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(iters):
            fn()

    total = sum(e.self_device_time_total for e in profiled(calls, need=(kernel,))
                if re.search(kernel, e.key))
    return total / 1e3 / iters


def profiled(fn, cpu: bool = False, need=()):
    """``fn()`` under the profiler (the device's activity, and the host's if
    ``cpu``): its ``key_averages()``. ``need`` holds regular expressions of
    kernels that ``fn`` launches. The profiler now and then loses device
    records: a whole session's (seen once on the H100, after a run of
    sessions), or one kernel's (B2f-bf16 in the bf16 training step, seen once
    on an H100 whose launch counter showed the launch). A session without
    device time, or without a record of each kernel in ``need``, is profiled
    again, up to three times."""
    return _profile(fn, cpu, need).key_averages()


def _profile(fn, cpu: bool, need):
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    for _ in range(3):
        with profile(activities=activities) as prof:
            fn()
            torch.cuda.synchronize()
        timed = [e.key for e in prof.key_averages() if e.self_device_time_total > 0]
        if timed and all(any(re.search(k, key) for key in timed) for k in need):
            return prof
    raise RuntimeError(f"{PROFILER_LOST}, or none of {list(need)}, "
                       "in three sessions")


def profiled_step(fn, what: str, need=()):
    """``profiled(fn)`` (the device's activity only, so that the host runs
    at its own pace) with CUDA events around ``fn`` inside the session:
    ``(events, span_ms, union_ms)``, the span of the profiled call itself
    and the length of the union of the device's kernel and copy records on
    the profiler's clock. Records of two streams may overlap (a training
    step's sum of records exceeds its span), so the device's busy share is
    the union's; a union longer than the span by more than 1% (the two
    clocks, and the events' own records) means records that do not belong
    to the call, and raises."""
    box = {}

    def timed():
        box["span"] = cuda_ms(fn, 1, warmup=0)

    prof = _profile(timed, False, need)
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type != DeviceType.CPU and not e.is_user_annotation)
    union, reach = 0.0, float("-inf")
    for a, b in spans:
        if b > reach:
            union += b - max(a, reach)
            reach = b
    union /= 1e3
    if union > 1.01 * box["span"]:
        raise RuntimeError(f"{what}: the device's records cover {union:.2f} ms of a "
                           f"{box['span']:.2f} ms call")
    return prof.key_averages(), box["span"], union


def device_records(events):
    """The device's kernel and copy records among ``key_averages()``'s
    events. A ``record_function`` range (``Optimizer.step#AdamW.step``, the
    schedule's ``ProfilerStep#N``) also comes back as a device-side user
    annotation spanning its kernels, which a sum of device time would count
    twice; it is left out."""
    return [e for e in events if e.device_type != DeviceType.CPU and not e.is_user_annotation]


def check_close(name: str, got: torch.Tensor, ref: torch.Tensor, rtol: float, atol: float) -> float:
    err = float((got - ref).abs().max())
    torch.testing.assert_close(got, ref, rtol=rtol, atol=atol, msg=lambda m: f"{name}: {m}")
    return err


CORPUS_ROWS = TRAIN_SUBJECTS * TRAIN_TRIALS * 64  # 336,000 rows: the corpus's preprocessing
CHAIN_LANES = (8, 16, 32)  # lanes a row, compared at the corpus size


def decode_chain():
    """The online decoder's filters: the 60 Hz notch, then the 4-40 Hz band-pass."""
    return [prepare_filter(tf2sos(*notch_ba(SFREQ, 60.0))),
            prepare_filter(butter_sos(SFREQ, 4.0, 40.0))]


def phase_iir(dev, rng):
    """B1 against its plain version. The chain entry (the decode's notch +
    band-pass, zero-phase, one launch) at B = 1, 8, 64 and 350 trials of 64
    channels and at the corpus's 336,000 rows, there also with 8 and 16
    lanes a row; the causal entry alone on the band-pass's padded length,
    y and zf. ``ms`` is the CUDA-event time a call over back-to-back calls,
    as for every kernel; ``device_ms`` the profiler's device time a launch."""
    chain = decode_chain()
    pads = tuple(f.padlen for f in chain)
    band = chain[1].sos
    rows = {}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for b in (1, MAIN_BATCH, 64, 350, CORPUS_ROWS // 64):
        if b * 64 == CORPUS_ROWS:  # 1.07 GB: drawn on the card
            x = torch.randn((b, 64, 800), generator=gen, device=dev)
        else:
            x = torch.tensor(rng.normal(size=(b, 64, 800)).astype(np.float32), device=dev)
        ref = sosfiltfilt_chain_plain(chain, x)
        scale = IIR_RTOL * float(ref.abs().max())
        err = check_close(f"B1 chain R={b * 64}", sosfiltfilt_chain(chain, x), ref, IIR_RTOL, scale)
        bound, bound_by = chain_bound(b * 64, chain)
        big = b * 64 == CORPUS_ROWS
        row = rows[b] = {
            "bound_ms": bound, "bound_by": bound_by, "max_abs_err": err,
            "ms": cuda_ms(lambda: sosfiltfilt_chain(chain, x), 5 if big else 50),
            "device_ms": device_ms(lambda: sosfiltfilt_chain(chain, x),
                                   "sosfiltfilt_chain_kernel", 5 if big else 50),
            "plain_ms": cuda_ms(lambda: sosfiltfilt_chain_plain(chain, x), 1,
                                warmup=0 if big else 1),
        }
        print(f"B1 chain R={b * 64:<6} (B={b}) notch + band-pass zero-phase, one launch, "
              f"{lanes_for(b * 64)} lanes a row: kernel {row['ms']:.4f} ms a call back to back "
              f"(CUDA events), {row['device_ms']:.4f} ms on the device (profiler), plain "
              f"{row['plain_ms']:.3f} ms, max|err| {err:.3g}, bound {bound:.4f} ms ({bound_by}, "
              f"{bound / row['ms']:.1%} reached; {bound / row['device_ms']:.1%} of the device "
              f"time)", flush=True)
        if big:
            for lanes in CHAIN_LANES:
                check_close(f"B1 chain R={b * 64} lanes={lanes}",
                            _launch_chain(chain, x, pads, lanes), ref, IIR_RTOL, scale)
                ms = device_ms(lambda: _launch_chain(chain, x, pads, lanes),
                               "sosfiltfilt_chain_kernel", 5)
                print(f"B1 chain R={b * 64} with {lanes:>2} lanes a row: {ms:.4f} ms on the "
                      f"device ({bound / ms:.1%} of the bound)", flush=True)
            del x, ref
            torch.cuda.empty_cache()
            continue
        xt = torch.tensor(rng.normal(size=(854, b * 64)).astype(np.float32), device=dev)
        zi = torch.tensor(rng.normal(size=(8, b * 64)).astype(np.float32), device=dev)
        y_ref, zf_ref = sosfilt_time_major_plain(band, xt, zi)
        y, zf = sosfilt_time_major(band, xt, zi)
        k_err = max(check_close(f"B1 causal R={b * 64} {name}", got, want, IIR_RTOL,
                                IIR_RTOL * float(want.abs().max()))
                    for name, got, want in (("y", y, y_ref), ("zf", zf, zf_ref)))
        c_bound, c_bound_by = iir_bound(b * 64)
        row["causal"] = {
            "bound_ms": c_bound, "bound_by": c_bound_by, "max_abs_err": k_err,
            "ms": cuda_ms(lambda: sosfilt_time_major(band, xt, zi), 50),
            "device_ms": device_ms(lambda: sosfilt_time_major(band, xt, zi),
                                   "sosfilt_time_major_kernel", 50),
            "plain_ms": cuda_ms(lambda: sosfilt_time_major_plain(band, xt, zi), 2),
        }
        c = row["causal"]
        chain_alt = {g: device_ms(lambda: _launch_chain(chain, x, pads, g),
                                  "sosfiltfilt_chain_kernel", 20) for g in (16, 32)}
        causal_alt = {g: device_ms(lambda: _launch_causal(band, xt, zi, g),
                                   "sosfilt_time_major_kernel", 20) for g in (1, 16, 32)}
        print(f"B1 R={b * 64} lanes a row -> device ms: chain "
              f"{json.dumps({g: round(v, 4) for g, v in chain_alt.items()})}, causal "
              f"{json.dumps({g: round(v, 4) for g, v in causal_alt.items()})}", flush=True)
        print(f"B1 causal (854, {b * 64}) band-pass pass with zi and zf, "
              f"{lanes_for(b * 64, causal=True)} lanes a row: kernel {c['ms']:.4f} ms a call back "
              f"to back (CUDA events), {c['device_ms']:.4f} ms on the device (profiler), plain "
              f"{c['plain_ms']:.3f} ms, max|err| {k_err:.3g} (y and zf), bound {c_bound:.4f} ms "
              f"({c_bound_by}, {c_bound / c['ms']:.1%} reached; {c_bound / c['device_ms']:.1%} of "
              f"the device time)", flush=True)
    # The preprocessing CLI's splits (one chain launch each, its own filters) on
    # random data, timed here: late in the run the profiler has lost these
    # records (PERF.md section 7).
    corpus = corpus_filters(SFREQ, REAL_NOTCH, REAL_BAND)
    rows["preprocessing"] = {}
    for n_rows in sorted({n * TRAIN_SUBJECTS * 64 for n in REAL_TRIALS}):
        x = torch.randn(n_rows // 64, 64, 800, device=dev)
        rows["preprocessing"][n_rows] = device_ms(lambda: sosfiltfilt_chain(corpus, x),
                                                  "sosfiltfilt_chain_kernel", 3)
        print(f"B1 chain R={n_rows} (a preprocessing split's rows, corpus_filters, random "
              f"data): {rows['preprocessing'][n_rows]:.4f} ms on the device (profiler)",
              flush=True)
    return rows


def phase_head(model, dev, rng):
    """B2f against its plain version at full width, one model (M = 1)."""
    cfg = model.cfg
    ops = model.head.fused_weights()
    rows = {}
    for b in (1, MAIN_BATCH, 64):
        x = torch.tensor(rng.normal(size=(1, b, 64, 800)).astype(np.float32), device=dev)
        ref = fused_conv4_head_plain(x, *ops, cfg.window_len, cfg.slide_step)
        got = fused_conv4_head(x, *ops, cfg.window_len, cfg.slide_step)
        err = check_close(f"B2 B={b}", got, ref, HEAD_RTOL, HEAD_ATOL)
        bound, bound_by = head_bound(HEAD_FMA_FWD, 1, b, b * 5 * 256, reads_g=False)
        rows[b] = {
            "bound_ms": bound, "bound_by": bound_by,
            "ms": cuda_ms(lambda: fused_conv4_head(x, *ops, cfg.window_len, cfg.slide_step), 50),
            "plain_ms": cuda_ms(
                lambda: fused_conv4_head_plain(x, *ops, cfg.window_len, cfg.slide_step), 20),
            "max_abs_err": err,
        }
        print(f"B2 B={b:<4} head forward: kernel {rows[b]['ms']:.4f} ms, plain "
              f"{rows[b]['plain_ms']:.4f} ms, max|err| {err:.3g}, bound {bound:.4f} ms "
              f"({bound_by}, {bound / rows[b]['ms']:.1%} reached)", flush=True)
    return rows


def phase_serving(cfg, params1, params2, rng, workdir):
    """Serve checkpoints through the port's CLI and decode over TCP."""
    ckpt1 = os.path.join(workdir, "FAST", "sub-01", "best_subject.npz")
    ckpt2 = os.path.join(workdir, "FAST", "sub-02", "best_subject.npz")
    save_model_npz(ckpt1, params1, {"head": {}})
    save_model_npz(ckpt2, params2, {"head": {}})
    server = build_server(build_parser().parse_args(["--checkpoint", ckpt1, "--port", "0"]))
    # One untimed warm-up request per batch size, then REQUESTS timed ones.
    sizes = [1, MAIN_BATCH] + [1] * REQUESTS + [MAIN_BATCH] * REQUESTS
    batches = [rng.normal(size=(b, 64, 800)).astype(np.float32) for b in sizes]

    reset_launches()
    latencies, posts = [], []
    with server, DecoderClient(*server.address) as client:
        info = client.info()
        for x in batches:
            t0 = time.perf_counter()
            posts.append(client.decode(x))
            latencies.append(time.perf_counter() - t0)
        client.reload(ckpt2)
        post_reloaded = client.decode(batches[-1])
    launches = read_launches()
    print(f"serving path: INFO {json.dumps(info)}", flush=True)
    print(f"serving path: kernel launches during the requests {launches}", flush=True)
    require_graphed({"DECODE": server.decoders[0]}, len(batches) + 1, launches, "serving")
    launches["replays"] = server.decoders[0].replays
    require_unadapted(launches, "serving")
    if info["device"] != "cuda" or info["n_channels"] != 64 or info["n_classes"] != cfg.n_classes:
        raise RuntimeError(f"unexpected INFO {info}")

    verify_against_cpu(cfg, params1, params2, batches, posts, post_reloaded)
    for b in (1, MAIN_BATCH):
        ms = [1e3 * t for t, x in zip(latencies[2:], batches[2:]) if x.shape[0] == b]
        p50, p90, p99 = np.percentile(ms, [50, 90, 99])
        print(f"serving path: DECODE B={b} over TCP, closed loop, one client, host clock: "
              f"p50 {p50:.3f} ms, p90 {p90:.3f} ms, p99 {p99:.3f} ms, max {max(ms):.3f} ms "
              f"({len(ms)} requests)", flush=True)
    print("serving path: posteriors finite, sum to 1, match the plain CPU forward "
          f"(rtol {POST_RTOL}, atol {POST_ATOL}); RELOAD swapped the weights", flush=True)
    return launches


def verify_against_cpu(cfg, params1, params2, batches, posts, post_reloaded) -> None:
    """The served posteriors against the port's plain path on the CPU with
    the same weights and inputs, all requests' trials in one batch (trials
    never interact); the RELOADed ones against the second weights."""
    cpu_decode = make_online_decoder(FAST(cfg, device="cpu"), params1)
    check_posteriors(np.concatenate(posts), cpu_decode(np.concatenate(batches)))
    cpu_decode.swap_weights(params2)
    check_posteriors(post_reloaded, cpu_decode(batches[-1]))
    if np.allclose(post_reloaded, posts[-1]):
        raise RuntimeError("RELOAD did not change the served posteriors")


def check_posteriors(post: np.ndarray, ref: np.ndarray) -> None:
    if post.shape != ref.shape or not np.isfinite(post).all():
        raise RuntimeError(f"bad posteriors: shape {post.shape}, finite {np.isfinite(post).all()}")
    np.testing.assert_allclose(post.sum(-1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(post, ref, rtol=POST_RTOL, atol=POST_ATOL)


def require_graphed(decoders, decodes: int, launches: dict, path: str) -> None:
    """Each graphed decoder of a path (``decoders``: request name -> decoder)
    served ``decodes`` decodes: its eager ones (each one B1 chain launch and
    one B2f launch, counted) and its replays (each a graph that holds one
    of each, as ``profile_decode`` shows); each capture records one of each
    in the capture counts and runs nothing."""
    runs = sum(d.eager for d in decoders.values())
    captures = sum(len(d.graphs) for d in decoders.values())
    for what, d in decoders.items():
        if d.eager + d.replays != decodes:
            raise RuntimeError(f"the {path} path's {what} made {d.eager} eager decodes and "
                               f"{d.replays} replays for {decodes} decodes")
        print(f"{path} path, {what}: {decodes} decodes = {d.eager} eager + {d.replays} replays "
              f"of {len(d.graphs)} CUDA graphs (shapes {sorted(d.graphs)})", flush=True)
    if (launches["iir_chain"], launches["conv4head_fwd"], launches["iir"]) != (runs, runs, 0):
        raise RuntimeError(f"the {path} path's eager decodes ({runs}) must each make one B1 "
                           f"chain launch and one B2f launch, and no causal B1 one: {launches}")
    if (launches["iir_chain_captures"], launches["conv4head_fwd_captures"]) != (captures,) * 2:
        raise RuntimeError(f"the {path} path's {captures} captures must each record one B1 "
                           f"chain launch and one B2f launch: {launches}")
    require_unadapted(launches, path)


DECODE_KERNELS = ("sosfiltfilt_chain_kernel", "conv4head_fwd_kernel")  # B1, B2f: in every decode


def event_span_ms(fn, calls: int = 20) -> float:
    """p50 of a decode's CUDA-event span: from an event recorded before
    ``fn()`` to one recorded after it (each decode ends in a device-to-host
    copy), so host work between the decode's launches counts in it."""
    spans = []
    for _ in range(calls):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        spans.append(start.elapsed_time(end))
    return float(np.median(spans))


def profile_decode(fn, what: str, calls: int = 5) -> dict:
    """``fn()`` (one decode) ``calls`` times under the profiler: device busy
    time (kernels and copies) and device events a decode, the host's
    ``cudaLaunchKernel`` (+ ``cudaLaunchKernelExC``) and ``cudaGraphLaunch``
    calls a decode; the device's records must hold one B1 and one B2f
    kernel a decode. Each session first runs one decode in a warm-up cycle
    whose records it drops: late in a run the profiler has lost one B1
    record of 5 replayed decodes (4 of 5 with every replay bit-identical;
    on an H100, three sessions in a row), while a session in a fresh
    process recorded all. A session that lost a record all the same is
    profiled again, up to three times. Then the decode's CUDA-event span
    (``event_span_ms``) and the device's idle share of it, 1 - busy / span."""
    for _ in range(3):
        got = {}
        with profile(activities=[ProfilerActivity.CUDA, ProfilerActivity.CPU],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: got.update(events=p.key_averages())) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
        events = got["events"]
        device = device_records(events)
        seen = {k: sum(e.count for e in device if k in e.key) / calls for k in DECODE_KERNELS}
        if all(n == 1 for n in seen.values()):
            break
        print(f"{what}: the profiler recorded {seen} a decode; profiling again", flush=True)
    else:
        raise RuntimeError(f"{what}: not one B1 and one B2f kernel a decode in three "
                           f"profiler sessions: {seen}")
    host = {e.key: e.count / calls for e in events if e.device_type == DeviceType.CPU}
    row = {
        "busy_ms": sum(e.self_device_time_total for e in device) / 1e3 / calls,
        "device_events": sum(e.count for e in device) / calls,
        "launch_kernel": host.get("cudaLaunchKernel", 0) + host.get("cudaLaunchKernelExC", 0),
        "graph_launch": host.get("cudaGraphLaunch", 0),
        "span_ms": event_span_ms(fn),
    }
    row["idle"] = 1 - row["busy_ms"] / row["span_ms"]
    print(f"{what}: device busy {row['busy_ms']:.4f} ms a decode over {row['device_events']:.0f} "
          f"kernels and copies; CUDA-event span p50 {row['span_ms']:.4f} ms, device idle "
          f"{row['idle']:.1%} of it; {row['launch_kernel']:.0f} cudaLaunchKernel(ExC) and "
          f"{row['graph_launch']:.0f} cudaGraphLaunch calls a decode", flush=True)
    return row


def host_ms(fn, calls: int = 50) -> list:
    """Host-clock milliseconds of ``calls`` calls of ``fn`` (each ends in a
    device-to-host copy, so the device is done)."""
    out = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def eager(decode, x: np.ndarray) -> np.ndarray:
    """The un-captured chain of a graphed decoder on ``x`` (B = 1 and 8 are
    captured batch sizes: the graph runs the same batch, unpadded)."""
    with torch.inference_mode():
        return decode.fn(torch.tensor(x, device=decode.device)).cpu().numpy()


def phase_graphs(cfg, params, swap_params, fleet_params, fleet_swap, dev, rng):
    """One CUDA graph a decode, for the live decoder and the fleet (all rows
    and the ensemble) at B = 1 and 8: a replay equals the un-captured chain
    bit for bit (B1 and B2f are deterministic); each decode's host p50,
    eager and replayed; device busy time and launches a decode of each
    (profiler); after ``swap_weights``, replays equal a fresh decoder on the
    new weights bit for bit."""
    live = make_online_decoder(FAST(cfg, device=dev), params)
    fleet = make_fleet_decoder(FAST(cfg, n_models=FLEET_MODELS, device=dev), fleet_params)
    rows, xs = {}, {}
    for name, dec in (("live", live), ("fleet", fleet), ("fleet ensemble", fleet.ensemble)):
        for b in (1, MAIN_BATCH):
            x = xs.setdefault(b, rng.normal(size=(b, 64, 800)).astype(np.float32))
            first = dec(x)  # eager, then the capture
            replay = dec(x)
            if not (np.array_equal(replay, eager(dec, x)) and np.array_equal(first, replay)):
                raise RuntimeError(f"{name} B={b}: the replay differs from the un-captured chain "
                                   f"(max|diff| {np.abs(replay - eager(dec, x)).max():.3g})")
            ms_eager, ms_replay = np.median(host_ms(lambda: eager(dec, x))), \
                np.median(host_ms(lambda: dec(x)))
            print(f"graph, {name} B={b}: replay == un-captured chain bit for bit; in-process host "
                  f"p50 {ms_replay:.3f} ms replayed, {ms_eager:.3f} ms eager", flush=True)
            rows[(name, b)] = {
                "host_p50_ms": ms_replay, "eager_host_p50_ms": ms_eager,
                "replay": profile_decode(lambda: dec(x), f"graph, {name} B={b}, replayed"),
                "eager": profile_decode(lambda: eager(dec, x), f"graph, {name} B={b}, eager"),
            }
            if rows[(name, b)]["replay"]["graph_launch"] != 1:
                raise RuntimeError(f"{name} B={b}: a replayed decode is not one graph launch")
    live.swap_weights(swap_params)
    fleet.swap_weights(fleet_swap)
    fresh_live = make_online_decoder(FAST(cfg, device=dev), swap_params)
    fresh_fleet = make_fleet_decoder(FAST(cfg, n_models=FLEET_MODELS, device=dev), fleet_swap)
    for name, dec, fresh in (("live", live, fresh_live), ("fleet", fleet, fresh_fleet),
                             ("fleet ensemble", fleet.ensemble, fresh_fleet.ensemble)):
        for b, x in xs.items():
            before = dec.replays
            if not np.array_equal(dec(x), fresh(x)) or dec.replays != before + 1:
                raise RuntimeError(f"{name} B={b}: after swap_weights the replay differs from a "
                                   "fresh decoder on the new weights")
    print("graph: after swap_weights every replay equals a fresh decoder on the new weights "
          "bit for bit (live and fleet, B = 1 and 8)", flush=True)
    return rows


def percentiles(ms: list) -> str:
    p50, p90, p99 = np.percentile(ms, [50, 90, 99])
    return f"p50 {p50:.3f} ms, p90 {p90:.3f} ms, p99 {p99:.3f} ms ({len(ms)} requests)"


def phase_fleet(cfg, dev, rng, results_dir):
    """The f32 training run's 15 ``best_subject.npz`` served as one fleet by
    ``cli.serve --checkpoint-dir`` over TCP: DECODE_ALL and DECODE (the
    ensemble) at B = 1 and 8, REQUESTS each after a warm-up. Every row
    against the single-model decoder of its checkpoint and, on the first
    requests, against the plain CPU fleet (rtol 1e-4, atol 1e-5); the
    ensemble against the rows' mean."""
    paths = sorted(glob.glob(os.path.join(results_dir, "sub-*", "best_subject.npz")))
    if len(paths) != FLEET_MODELS:
        raise RuntimeError(f"{len(paths)} best_subject.npz under {results_dir}, not {FLEET_MODELS}")
    server = build_server(build_parser().parse_args(["--checkpoint-dir", results_dir,
                                                     "--port", "0"]))
    sizes = [1, MAIN_BATCH] + [1] * REQUESTS + [MAIN_BATCH] * REQUESTS
    batches = [rng.normal(size=(b, 64, 800)).astype(np.float32) for b in sizes]
    reset_launches()
    rows, ens, t_all, t_ens = [], [], [], []
    with server, DecoderClient(*server.address) as client:
        info = client.info()
        for x in batches:
            t0 = time.perf_counter()
            rows.append(client.decode_all(x))
            t1 = time.perf_counter()
            ens.append(client.decode(x))
            t_all.append(1e3 * (t1 - t0))
            t_ens.append(1e3 * (time.perf_counter() - t1))
    launches = read_launches()
    subjects = [os.path.basename(os.path.dirname(p)) for p in paths]
    if (info["mode"], info["n_models"], info["subjects"], info["device"]) != \
            ("fleet", FLEET_MODELS, subjects, dev.type):
        raise RuntimeError(f"unexpected fleet INFO {info}")
    _, decode_all = server.decoders
    print(f"fleet: kernel launches during the requests {launches}", flush=True)
    require_graphed({"DECODE_ALL": decode_all, "DECODE": decode_all.ensemble}, len(batches),
                    launches, "fleet")
    launches["replays"] = decode_all.replays + decode_all.ensemble.replays

    rows_all = np.concatenate(rows, axis=1)  # (M, all trials, K)
    x_all = np.concatenate(batches)
    single = make_online_decoder(FAST(cfg, device=dev), init_jax_layout_params(cfg, SEED))
    template = to_jax_params(FAST(cfg).state_dict())
    for i, path in enumerate(paths):
        single.swap_weights(load_model_npz(path, template, {"head": {}})[0])
        np.testing.assert_allclose(rows_all[i], single(x_all), rtol=POST_RTOL, atol=POST_ATOL,
                                   err_msg=f"fleet row {subjects[i]} vs its single decoder")
    np.testing.assert_allclose(np.concatenate(ens), rows_all.mean(axis=0), rtol=1e-6, atol=1e-7,
                               err_msg="the ensemble is not the rows' mean")
    n_cpu = 4  # the two warm-ups and the first timed request of each size
    cpu = make_fleet_decoder(FAST(cfg, n_models=FLEET_MODELS),
                             *stack_checkpoints(paths, FAST(cfg)))
    ref = cpu(np.concatenate(batches[:n_cpu]))
    got = np.concatenate(rows[:n_cpu], axis=1)
    np.testing.assert_allclose(got, ref, rtol=POST_RTOL, atol=POST_ATOL)
    print(f"fleet: INFO {json.dumps(info)}", flush=True)
    print(f"fleet: {FLEET_MODELS} rows x {x_all.shape[0]} trials match each checkpoint's single "
          f"decoder, the first {n_cpu} requests' ({got.shape[1]} trials) the plain CPU fleet "
          f"(rtol {POST_RTOL}, atol {POST_ATOL}, max|err| {np.abs(got - ref).max():.3g}); the "
          "ensemble equals the rows' mean", flush=True)
    for b in (1, MAIN_BATCH):
        pick = [i for i, x in enumerate(batches) if i >= 2 and x.shape[0] == b]
        print(f"fleet: DECODE_ALL B={b} over TCP, closed loop, one client, host clock: "
              f"{percentiles([t_all[i] for i in pick])}", flush=True)
        print(f"fleet: DECODE (ensemble) B={b} over TCP: {percentiles([t_ens[i] for i in pick])}",
              flush=True)
    return launches


def phase_fleet_head(cfg, dev, rng):
    """B2f at the fleet's M = 15 on one window broadcast to every model (the
    fleet decode's operand), B = 1 and 8, against its plain version."""
    model = FAST(cfg, n_models=FLEET_MODELS, device=dev)
    model.load_state_dict(from_jax_params(init_jax_layout_params(cfg, SEED, FLEET_MODELS)))
    geo = (cfg.window_len, cfg.slide_step)
    rows = {}
    with torch.inference_mode():
        ops = model.head.fused_weights()
        for b in (1, MAIN_BATCH):
            xb = torch.tensor(rng.normal(size=(b, 64, 800)).astype(np.float32), device=dev)
            x = xb.expand(FLEET_MODELS, *xb.shape).contiguous()
            ref = fused_conv4_head_plain(x, *ops, *geo)
            err = check_close(f"B2f M={FLEET_MODELS} B={b}", fused_conv4_head(x, *ops, *geo), ref,
                              HEAD_RTOL, HEAD_ATOL)
            bound, bound_by = head_bound(HEAD_FMA_FWD, FLEET_MODELS, b,
                                         FLEET_MODELS * b * 5 * 256, reads_g=False)
            row = rows[b] = {
                "bound_ms": bound, "bound_by": bound_by, "max_abs_err": err,
                "ms": cuda_ms(lambda: fused_conv4_head(x, *ops, *geo), 50),
                "device_ms": device_ms(lambda: fused_conv4_head(x, *ops, *geo),
                                       "conv4head_fwd_kernel", 50),
                "plain_ms": cuda_ms(lambda: fused_conv4_head_plain(x, *ops, *geo), 5),
            }
            print(f"B2f M={FLEET_MODELS} B={b} (the fleet's head): kernel {row['ms']:.4f} ms a "
                  f"call back to back (CUDA events), {row['device_ms']:.4f} ms on the device, "
                  f"plain {row['plain_ms']:.4f} ms, max|err| {err:.3g}, bound {bound:.4f} ms "
                  f"({bound_by}, {bound / row['device_ms']:.1%} of the device time)", flush=True)
    return rows


ARTIFACT_CHILD = r"""
import json, sys
import numpy as np, torch
from torch.export.passes import move_to_device_pass
from torch.profiler import ProfilerActivity, profile
from imagined_speech_decoding_tpu_torch.ops.cuda import library  # noqa: F401 (the isd:: operators)

path, x_path, out_path = sys.argv[1:4]
program = move_to_device_pass(torch.export.load(path), "cuda")
module = program.module()
x = torch.tensor(np.load(x_path), device="cuda")
with torch.inference_mode():
    module(x)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        post = module(x).cpu().numpy()
        torch.cuda.synchronize()
keys = {e.key for e in prof.key_averages()}
np.save(out_path, post)
port = sorted(m for m in sys.modules if m.startswith("imagined_speech_decoding_tpu_torch"))
print(json.dumps({"keys": sorted(keys), "modules": port}))
"""
PLAIN_ROUTE_OPS = ("aten::unfold", "aten::flip")  # the plain head's patches, the plain IIR's passes


def phase_artifact(cfg, dev, ckpt, workdir, rng):
    """``cli.export_decoder`` on one trained checkpoint, ``cli.serve
    --artifact`` over TCP against the live decoder of the same weights;
    then the artifact alone in a child process that imports torch and the
    ``isd::`` operators only, where the profiler must show B1's and B2f's
    kernels and none of the plain versions' ops."""
    out = os.path.join(workdir, "decoder.pt2")
    t0 = time.perf_counter()
    export_decoder.main(["--checkpoint", ckpt, "--out", out])
    export_s = time.perf_counter() - t0
    params = load_model_npz(ckpt, init_jax_layout_params(cfg, SEED), {"head": {}})[0]
    live = make_online_decoder(FAST(cfg, device=dev), params)
    server = build_server(build_parser().parse_args(["--artifact", out, "--port", "0"]))
    sizes = [1, MAIN_BATCH] + [1] * REQUESTS + [MAIN_BATCH] * REQUESTS
    batches = [rng.normal(size=(b, 64, 800)).astype(np.float32) for b in sizes]
    posts, times = [], []
    with server, DecoderClient(*server.address) as client:
        info = client.info()
        for x in batches:
            t1 = time.perf_counter()
            posts.append(client.decode(x))
            times.append(1e3 * (time.perf_counter() - t1))
    if (info["mode"], info["n_channels"], info["seq_len"], info["n_classes"], info["reloadable"]) \
            != ("artifact", 64, 800, cfg.n_classes, False):
        raise RuntimeError(f"unexpected artifact INFO {info}")
    # The same kernels and trunk ops on the same operands: bit for bit.
    if not all(np.array_equal(p, live(x)) for p, x in zip(posts, batches)):
        raise RuntimeError("the artifact's posteriors differ from the live decoder's")
    print(f"artifact: cli.export_decoder {export_s:.2f} s, {os.path.getsize(out) / 1e6:.2f} MB; "
          f"INFO {json.dumps(info)}; served posteriors equal the live decoder's bit for bit",
          flush=True)
    for b in (1, MAIN_BATCH):
        pick = [times[i] for i, x in enumerate(batches) if i >= 2 and x.shape[0] == b]
        print(f"artifact: DECODE B={b} over TCP, host clock: {percentiles(pick)}", flush=True)

    x_path, post_path = os.path.join(workdir, "artifact_x.npy"), os.path.join(workdir, "post.npy")
    np.save(x_path, batches[1])
    proc = subprocess.run([sys.executable, "-c", ARTIFACT_CHILD, out, x_path, post_path],
                          capture_output=True, text=True, timeout=300,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise RuntimeError(f"the artifact's child process failed:\n{proc.stderr[-3000:]}")
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    missing = [k for k in DECODE_KERNELS if not any(k in key for key in seen["keys"])]
    plain = [k for k in PLAIN_ROUTE_OPS if k in seen["keys"]]
    models = [m for m in seen["modules"] if ".models" in m or m.endswith(".serving")]
    if missing or plain or models:
        raise RuntimeError(f"the artifact alone: kernels missing {missing}, plain-route ops "
                           f"{plain}, model code imported {models}")
    if not np.array_equal(np.load(post_path), posts[1]):
        raise RuntimeError("the artifact alone differs from the served artifact")
    print(f"artifact: alone in a child process (torch and ops/cuda/library.py): the profiler "
          f"shows {', '.join(DECODE_KERNELS)} and none of {', '.join(PLAIN_ROUTE_OPS)}; "
          f"{len(seen['modules'])} port modules loaded, none of models/ or serving; its "
          "posteriors equal the server's", flush=True)


STREAM_STEP = 125  # samples a producer push: one window step (0.5 s at 250 Hz)
STREAM_PUSHES = 120


def phase_streaming(cfg, params, dev, rng):
    """The streaming decoder over the native ring: a producer thread pushes
    ``STREAM_STEP``-sample chunks while ``decode_latest`` runs. Every window
    decoded must be the stream's samples that end at its end index (no
    torn snapshot), and its posteriors a direct decode of those samples."""
    decode = make_online_decoder(FAST(cfg, device=dev), params)
    stream = rng.normal(size=(64, cfg.seq_len + STREAM_STEP * STREAM_PUSHES)).astype(np.float32)
    windows = []

    def recording(x):
        windows.append(x[0].copy())
        return decode(x)

    sd = StreamingDecoder(recording, 64, cfg.seq_len, native=True)
    sd.push(stream[:, :cfg.seq_len])
    sd.decode_latest()  # the first window: eager, then the capture
    windows.clear()

    def produce():
        for i in range(STREAM_PUSHES):
            lo = cfg.seq_len + i * STREAM_STEP
            sd.push(stream[:, lo:lo + STREAM_STEP])
            time.sleep(0.002)

    producer = threading.Thread(target=produce)
    posts, ends, times = [], [], []
    producer.start()
    try:
        while producer.is_alive():
            t0 = time.perf_counter()
            posts.append(sd.decode_latest())
            times.append(1e3 * (time.perf_counter() - t0))
            ends.append(sd.last_end)
    finally:
        producer.join(timeout=60)
        sd.close()
    if producer.is_alive() or not posts:
        raise RuntimeError("the streaming producer did not finish, or nothing was decoded")
    if any(b < a for a, b in zip(ends, ends[1:])):
        raise RuntimeError("the ring's end index went back")
    for w, post, end in zip(windows, posts, ends):
        want = stream[:, end - cfg.seq_len:end]
        if not np.array_equal(w, want):
            raise RuntimeError(f"a torn or misplaced window at end index {end}")
        if not np.array_equal(post, decode(want[None])[0]):
            raise RuntimeError(f"decode_latest at end index {end} differs from a direct decode")
    print(f"streaming: {len(posts)} decode_latest calls ({len(set(ends))} distinct windows) while "
          f"a producer pushed {STREAM_PUSHES} x {STREAM_STEP} samples into the native ring; every "
          f"window untorn and equal to a direct decode; decode_latest p50 "
          f"{np.median(times):.3f} ms, p90 {np.percentile(times, 90):.3f} ms", flush=True)
    return np.median(times)


HEAD_FMA_FWD = 5_038_080  # per (trial, window, zone) at full width: conv12 2.52 M + tails 2 x 1.26 M
# B2f-bf16's own multiply-adds per (trial, zone): the first conv once over the 746 h1 columns
# its 5 windows use (32 x 320 x 746 = 7.64 M) and the tails (5 x 2 x 1.26 M): 20% fewer than
# 5 x HEAD_FMA_FWD; with the 64-row tiles' padding it issues 640 wgmma of 32,768 (20.97 M).
FWD_BF16_FMA_ITEM = 32 * 320 * 746 + 5 * 2 * 32 * 160 * 246
FWD_BF16_FMA_TILED = 640 * 64 * 32 * 16
HEAD_FMA_BWD_W = 12_595_200  # recompute 5.04 M + dh2, dh1, dw4, dw3 1.26 M each + dw12 2.52 M
HEAD_FMA_BWD_X = 10_076_160  # recompute 5.04 M + dh2, dh1 1.26 M each + dx 2.52 M


def phase_head_backward(cfg, dev, rng):
    """B2w and B2x against their plain versions at full width, then B2f
    and B2w alone at the training step's shape."""
    geo = (cfg.window_len, cfg.slide_step)
    feat = cfg.n_zones * cfg.dim_cnn
    rows = {}
    for m, b in X_SHAPES:
        model = FAST(cfg, n_models=m, device=dev)
        model.load_state_dict(from_jax_params(init_jax_layout_params(cfg, SEED, m)))
        with torch.no_grad():
            ops = model.head.fused_weights()
        x = torch.tensor(rng.normal(size=(m, b, 64, 800)).astype(np.float32), device=dev)
        g = torch.tensor(rng.normal(size=(m, b, cfg.n_tokens, feat)).astype(np.float32),
                         device=dev)
        r = rows[(m, b)] = {}
        if (m, b) in BWD_SHAPES:
            ref = conv4head_bwd_plain(g, x, *ops, *geo)
            got = (conv4head_bwd_x(g, x, *ops, *geo), *conv4head_bwd_w(g, x, *ops, *geo))
            errs = {name: check_close(f"B2 backward M={m} B={b} {name}", a, r_, BWD_RTOL,
                                      BWD_RTOL * float(r_.abs().max()))
                    for name, a, r_ in zip(("dx", "dw12", "db12", "dw3", "dw4"), got, ref)}
            r.update(w_ms=cuda_ms(lambda: conv4head_bwd_w(g, x, *ops, *geo), 10),
                     plain_ms=cuda_ms(lambda: conv4head_bwd_plain(g, x, *ops, *geo), 3),
                     w_err=max(errs[k] for k in ("dw12", "db12", "dw3", "dw4")),
                     w_bound=head_bound(HEAD_FMA_BWD_W, m, b, m * HEAD_WEIGHT_FLOATS))
            print(f"B2w M={m} B={b:<3} weight grads: kernel {r['w_ms']:.3f} ms, max|err| "
                  f"{r['w_err']:.3g}, bound {r['w_bound'][0]:.3f} ms ({r['w_bound'][1]}, "
                  f"{r['w_bound'][0] / r['w_ms']:.1%} reached); plain autograd backward (all "
                  f"five) {r['plain_ms']:.3f} ms; per tensor "
                  f"{json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})}", flush=True)
        ref_x = conv4head_bwd_x_plain(g, x, *ops, *geo)
        r["x_err"] = check_close(f"B2x M={m} B={b}", conv4head_bwd_x(g, x, *ops, *geo), ref_x,
                                 BWD_RTOL, BWD_RTOL * float(ref_x.abs().max()))
        r["x_ms"] = cuda_ms(lambda: conv4head_bwd_x(g, x, *ops, *geo), 10)
        r["x_device_ms"] = device_ms(lambda: conv4head_bwd_x(g, x, *ops, *geo), B2X_KERNELS, 10)
        r["x_plain_ms"] = cuda_ms(lambda: conv4head_bwd_x_plain(g, x, *ops, *geo), 3)
        r["x_bound"] = head_bound(HEAD_FMA_BWD_X, m, b, m * b * 64 * 800)
        floor = 1e3 * 3 * 2 * m * b * cfg.n_tokens * cfg.n_zones * HEAD_FMA_BWD_X / MMA_SYNC_TF32_FLOPS
        bound = r["x_bound"][0]
        print(f"B2x M={m} B={b:<3} input grad: wrapper {r['x_ms']:.4f} ms a call (CUDA events: "
              f"the kernel, dxw and the overlap-add), kernel {r['x_device_ms']:.4f} ms on the "
              f"device (profiler), plain dx alone {r['x_plain_ms']:.3f} ms, max|err| "
              f"{r['x_err']:.3g}; bound {bound:.4f} ms ({r['x_bound'][1]}, {bound / r['x_ms']:.1%} "
              f"reached, {bound / r['x_device_ms']:.1%} of the device time); mma.sync floor "
              f"{floor:.4f} ms ({floor / r['x_device_ms']:.1%} of the device time)", flush=True)

    # The training run's own launches: M = 75 at its batch sizes (the
    # 64-trial steps, the ragged tail, the validation batch). The plain
    # autograd backward of all 75 models needs tens of GB, but the models
    # are independent: the full launches' outputs are held, model by model,
    # against the plain version on the first, a middle and the last
    # model's operands.
    m = TRAIN_SUBJECTS * 5
    model = FAST(cfg, n_models=m, device=dev)
    model.load_state_dict(from_jax_params(init_jax_layout_params(cfg, SEED, m)))
    with torch.no_grad():
        ops = model.head.fused_weights()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for b in TRAIN_STEP_BATCHES:
        x = torch.randn((m, b, 64, 800), generator=gen, device=dev)
        g = torch.randn((m, b, cfg.n_tokens, feat), generator=gen, device=dev)
        with torch.no_grad():
            out = fused_conv4_head(x, *ops, *geo)
        grads = (conv4head_bwd_x(g, x, *ops, *geo), *conv4head_bwd_w(g, x, *ops, *geo))
        errs = {"out": 0.0, "dx": 0.0, "dw12": 0.0, "db12": 0.0, "dw3": 0.0, "dw4": 0.0}
        for i in (0, m // 2, m - 1):
            one = [t[i : i + 1] for t in (g, x, *ops)]
            what = f"M={m} B={b} model {i}"
            ref = fused_conv4_head_plain(*one[1:], *geo)
            errs["out"] = max(errs["out"], check_close(f"B2f {what}", out[i : i + 1], ref,
                                                       HEAD_RTOL, HEAD_ATOL))
            for name, a, r in zip(("dx", "dw12", "db12", "dw3", "dw4"), grads,
                                  conv4head_bwd_plain(*one, *geo)):
                errs[name] = max(errs[name], check_close(f"B2 backward {what} {name}",
                                                         a[i : i + 1], r, BWD_RTOL,
                                                         BWD_RTOL * float(r.abs().max())))
        print(f"B2f / B2w / B2x at M={m} B={b:<3}: models 0, {m // 2} and {m - 1} of the full "
              f"launches match the plain version on their operands; max|err| "
              f"{json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})}", flush=True)
    x = torch.randn((m, TRAIN_BATCH, 64, 800), generator=gen, device=dev)
    g = torch.randn((m, TRAIN_BATCH, cfg.n_tokens, feat), generator=gen, device=dev)
    big = {"fwd_ms": cuda_ms(lambda: fused_conv4_head(x, *ops, *geo), 3),
           "w_ms": cuda_ms(lambda: conv4head_bwd_w(g, x, *ops, *geo), 3)}
    units = m * TRAIN_BATCH * cfg.n_tokens * cfg.n_zones
    fwd_bound = head_bound(HEAD_FMA_FWD, m, TRAIN_BATCH, m * TRAIN_BATCH * 5 * 256,
                           reads_g=False)
    w_bound = head_bound(HEAD_FMA_BWD_W, m, TRAIN_BATCH, m * HEAD_WEIGHT_FLOATS)
    fwd_floor, w_floor = (1e3 * 3 * 2 * units * fma / MMA_SYNC_TF32_FLOPS
                          for fma in (HEAD_FMA_FWD, HEAD_FMA_BWD_W))
    print(f"B2f / B2w alone at M={m} B={TRAIN_BATCH} (kernel only): B2f {big['fwd_ms']:.2f} ms "
          f"({units * HEAD_FMA_FWD / big['fwd_ms'] / 1e9:.2f} T FMA/s f32-equivalent; "
          f"bound {fwd_bound[0]:.2f} ms, {fwd_bound[1]}, {fwd_bound[0] / big['fwd_ms']:.1%} "
          f"reached; mma.sync floor {fwd_floor:.2f} ms, {fwd_floor / big['fwd_ms']:.1%} reached), "
          f"B2w {big['w_ms']:.2f} ms "
          f"({units * HEAD_FMA_BWD_W / big['w_ms'] / 1e9:.2f} T FMA/s f32-equivalent; bound "
          f"{w_bound[0]:.2f} ms, {w_bound[1]}, {w_bound[0] / big['w_ms']:.1%} reached; mma.sync "
          f"floor {w_floor:.2f} ms, {w_floor / big['w_ms']:.1%} reached)", flush=True)
    # B2x at the same shape: its own device time (it never runs in training).
    big["x_device_ms"] = device_ms(lambda: conv4head_bwd_x(g, x, *ops, *geo), B2X_KERNELS, 3)
    x_bound = head_bound(HEAD_FMA_BWD_X, m, TRAIN_BATCH, m * TRAIN_BATCH * 64 * 800)
    x_floor = 1e3 * 3 * 2 * units * HEAD_FMA_BWD_X / MMA_SYNC_TF32_FLOPS
    print(f"B2x alone at M={m} B={TRAIN_BATCH}: {big['x_device_ms']:.2f} ms on the device "
          f"({units * HEAD_FMA_BWD_X / big['x_device_ms'] / 1e9:.2f} T FMA/s f32-equivalent; "
          f"bound {x_bound[0]:.2f} ms, {x_bound[1]}, {x_bound[0] / big['x_device_ms']:.1%} "
          f"reached; mma.sync floor {x_floor:.2f} ms, {x_floor / big['x_device_ms']:.1%} "
          f"reached)", flush=True)
    return rows, big


def check_rel(name: str, got: torch.Tensor, ref: torch.Tensor, rel: float) -> float:
    """``check_close`` at atol ``rel * max|ref|``, rtol 0."""
    return check_close(name, got, ref, 0.0, rel * float(ref.abs().max()))


def compare_bf16(ops, x, g, geo, models, what: str) -> dict:
    """B2f-bf16 and B2w-bf16 once each on the stacked operands, their
    outputs for ``models`` held against the plain bf16 versions on those
    models' operands; the largest error per output."""
    with torch.no_grad():
        out = fused_conv4_head(x, *ops, *geo)
    dw = conv4head_bwd_w(g, x, *ops, *geo)
    errs = dict.fromkeys(("out", "dw12", "db12", "dw3", "dw4"), 0.0)
    for i in models:
        one = [t[i : i + 1] for t in (g, x, *ops)]
        errs["out"] = max(errs["out"], check_rel(
            f"B2f-bf16 {what} model {i}", out[i : i + 1],
            fused_conv4_head_plain(*one[1:], *geo), BF16_FWD_REL))
        for name, a, r in zip(("dw12", "db12", "dw3", "dw4"), dw,
                              conv4head_bwd_plain(*one, *geo)[1:]):
            errs[name] = max(errs[name], check_rel(f"B2w-bf16 {what} model {i} {name}",
                                                   a[i : i + 1], r, BF16_BWD_REL))
    return errs


def phase_bf16_kernels(cfg, dev, rng):
    """B2f-bf16 and B2w-bf16 against their plain bf16 versions at full
    width, timed; then at the training run's M = 75 and its batch sizes,
    and alone at M = 75, B = 64."""
    geo = (cfg.window_len, cfg.slide_step)
    feat = cfg.n_zones * cfg.dim_cnn
    rows = {}
    for m, b in BF16_SHAPES:
        model = FAST(cfg, n_models=m, device=dev)
        model.load_state_dict(from_jax_params(init_jax_layout_params(cfg, SEED, m)))
        with torch.no_grad():
            ops = model.head.fused_weights()
        x = torch.tensor(rng.normal(size=(m, b, 64, 800)).astype(np.float32),
                         device=dev).to(torch.bfloat16)
        g = torch.tensor(rng.normal(size=(m, b, cfg.n_tokens, feat)).astype(np.float32),
                         device=dev)
        errs = compare_bf16(ops, x, g, geo, range(m), f"M={m} B={b}")
        r = rows[(m, b)] = {
            "fwd_err": errs["out"], "w_err": max(errs[k] for k in ("dw12", "db12", "dw3", "dw4")),
            "fwd_ms": cuda_ms(lambda: fused_conv4_head(x, *ops, *geo), 20),
            "fwd_plain_ms": cuda_ms(lambda: fused_conv4_head_plain(x, *ops, *geo), 3),
            "w_ms": cuda_ms(lambda: conv4head_bwd_w(g, x, *ops, *geo), 10),
            "w_plain_ms": cuda_ms(lambda: conv4head_bwd_plain(g, x, *ops, *geo), 3),
            "fwd_bound": head_bound_bf16(HEAD_FMA_FWD, m, b, m * b * 5 * 256, reads_g=False),
            "w_bound": head_bound_bf16(HEAD_FMA_BWD_W, m, b, m * HEAD_WEIGHT_FLOATS),
        }
        for k, name in (("fwd", "B2f-bf16 forward"), ("w", "B2w-bf16 weight grads")):
            bound, by = r[f"{k}_bound"]
            print(f"{name} M={m} B={b:<3}: kernel {r[f'{k}_ms']:.4f} ms, plain bf16 "
                  f"{r[f'{k}_plain_ms']:.3f} ms, max|err| {r[f'{k}_err']:.3g}, bound {bound:.4f} ms "
                  f"({by}, {bound / r[f'{k}_ms']:.1%} reached)", flush=True)
        print(f"    per tensor max|err| {json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})}",
              flush=True)

    m = TRAIN_SUBJECTS * 5
    model = FAST(cfg, n_models=m, device=dev)
    model.load_state_dict(from_jax_params(init_jax_layout_params(cfg, SEED, m)))
    with torch.no_grad():
        ops = model.head.fused_weights()
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    for b in TRAIN_STEP_BATCHES:
        x = torch.randn((m, b, 64, 800), generator=gen, device=dev).to(torch.bfloat16)
        g = torch.randn((m, b, cfg.n_tokens, feat), generator=gen, device=dev)
        errs = compare_bf16(ops, x, g, geo, (0, m // 2, m - 1), f"M={m} B={b}")
        print(f"B2f-bf16 / B2w-bf16 at M={m} B={b:<3}: models 0, {m // 2} and {m - 1} of the full "
              f"launches match the plain bf16 version on their operands; max|err| "
              f"{json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})}", flush=True)
    x = torch.randn((m, TRAIN_BATCH, 64, 800), generator=gen, device=dev).to(torch.bfloat16)
    g = torch.randn((m, TRAIN_BATCH, cfg.n_tokens, feat), generator=gen, device=dev)
    with torch.no_grad():
        first = fused_conv4_head(x, *ops, *geo)
        if not torch.equal(fused_conv4_head(x, *ops, *geo), first):
            raise RuntimeError(f"B2f-bf16 at M={m} B={TRAIN_BATCH}: two runs differ in their bits")
    print(f"B2f-bf16 at M={m} B={TRAIN_BATCH}: two runs are bit-identical", flush=True)
    big = {"fwd_ms": cuda_ms(lambda: fused_conv4_head(x, *ops, *geo), 5),
           "w_ms": cuda_ms(lambda: conv4head_bwd_w(g, x, *ops, *geo), 5)}
    units = m * TRAIN_BATCH * cfg.n_tokens * cfg.n_zones
    items = m * TRAIN_BATCH * cfg.n_zones
    for k, fma, bound, name, route, rate in (
            ("fwd", FWD_BF16_FMA_ITEM * items / units,
             head_bound_bf16(HEAD_FMA_FWD, m, TRAIN_BATCH, m * TRAIN_BATCH * 5 * 256,
                             reads_g=False), "B2f-bf16", "wgmma m64n32k16", WGMMA_N32_FLOPS),
            ("w", HEAD_FMA_BWD_W, head_bound_bf16(HEAD_FMA_BWD_W, m, TRAIN_BATCH,
                                                  m * HEAD_WEIGHT_FLOATS), "B2w-bf16",
             "wgmma m64n32k16", WGMMA_N32_FLOPS)):
        ms = big[f"{k}_ms"]
        floor = 1e3 * 2 * units * fma / rate
        big[f"{k}_bound"], big[f"{k}_floor"] = bound, floor
        print(f"{name} alone at M={m} B={TRAIN_BATCH} (kernel only): {ms:.2f} ms "
              f"({units * fma / ms / 1e9:.2f} T FMA/s of its own work; bound {bound[0]:.2f} ms, "
              f"{bound[1]}, {bound[0] / ms:.1%} reached; {route} floor on its own work "
              f"{floor:.2f} ms, {floor / ms:.1%} reached)", flush=True)
    print(f"B2f-bf16's own work at M={m} B={TRAIN_BATCH}: {FWD_BF16_FMA_ITEM * items / 1e12:.3f} T "
          f"multiply-adds ({FWD_BF16_FMA_TILED * items / 1e12:.3f} T issued with the tiles' "
          f"padding) against the bound's {HEAD_FMA_FWD * units / 1e12:.3f} T", flush=True)
    # B2f-bf16 by phase: its debug instantiation's clock counters, per warp and (trial, zone).
    clk = torch.zeros(len(FWD_BF16_PHASES) + 2, dtype=torch.int64, device=dev)
    with torch.no_grad():
        _launch_fwd(x, *ops, *geo, clk=clk)
    c = clk.tolist()
    big["fwd_phase_cycles"] = {k: c[i] / 16 / items for i, k in enumerate(FWD_BF16_PHASES)}
    print(f"B2f-bf16 by phase at M={m} B={TRAIN_BATCH}: {c[-2] / items:.0f} cycles a (trial, "
          f"zone) item at {1e3 * c[-2] / c[-1]:.0f} MHz; cycles a warp and item: "
          f"{json.dumps({k: round(v) for k, v in big['fwd_phase_cycles'].items()})}", flush=True)
    # B2w-bf16 by phase: its debug instantiation's clock counters, per warp and unit.
    clk = torch.zeros(len(BWD_W_BF16_PHASES) + 2, dtype=torch.int64, device=dev)
    _launch_bwd_w(g, x, *ops, *geo, clk=clk)
    c = clk.tolist()
    big["w_phase_cycles"] = {k: c[i] / 16 / units for i, k in enumerate(BWD_W_BF16_PHASES)}
    print(f"B2w-bf16 by phase at M={m} B={TRAIN_BATCH}: {c[-2] / units:.0f} cycles a unit at "
          f"{1e3 * c[-2] / c[-1]:.0f} MHz; cycles a warp and unit: "
          f"{json.dumps({k: round(v) for k, v in big['w_phase_cycles'].items()})}", flush=True)
    return rows, big


# (M, B) of B2x-bf16's comparisons: explain_fast's and global_explain's batches too;
# JSON line: the last.
X_BF16_SHAPES = ((2, 8), (1, 16), (1, 100))
# B2x-bf16's kernel, its pre-pass (staged bf16 weights, g / t1) and its partial pass
B2X_BF16_KERNELS = "conv4head_bwd_x_bf16_|sum_partials_kernel"


def phase_bf16_input_gradient(cfg, dev, rng) -> dict:
    """B2x-bf16 (a bf16 x's input gradient) at full width against the plain
    bf16 backward's dx (``conv4head_bwd_bf16_plain``) at X_BF16_SHAPES:
    relative L2 within GEN_BF16_DX_L2 (the bf16 dx limit of every input
    gradient kernel), a rerun bit-identical, one B2x-bf16 launch a call and
    nothing else; timed by CUDA events (the wrapper: the kernel, dxw and the
    overlap-add) and by the profiler's device time (the kernel and its
    partial pass), beside its bound (``general_bound``: one bf16
    tensor-core pass at 989 TFLOP/s, or the bytes), its route's floor (the
    Pallas kernel's products at the ``wgmma`` m64n32k16 rate) and the plain
    version's time. The comparisons' launches are not counted."""
    geo = (cfg.window_len, cfg.slide_step)
    z, o = cfg.n_zones, cfg.dim_cnn
    rows = {}
    for m, b in X_BF16_SHAPES:
        model = FAST(cfg, n_models=m, device=dev)
        model.load_state_dict(from_jax_params(init_jax_layout_params(cfg, SEED, m)))
        with torch.no_grad():
            ops = model.head.fused_weights()
        x = torch.tensor(rng.normal(size=(m, b, 64, 800)).astype(np.float32),
                         device=dev).to(torch.bfloat16)
        g = torch.tensor(rng.normal(size=(m, b, cfg.n_tokens, z * o)).astype(np.float32),
                         device=dev)
        what = f"B2x-bf16 M={m} B={b}"
        with uncounted():
            before = read_launches()
            got = conv4head_bwd_x(g, x, *ops, *geo)
            again = conv4head_bwd_x(g, x, *ops, *geo)
            moved = {k: v - before[k] for k, v in read_launches().items() if v != before[k]}
        if moved != {"conv4head_bwd_x_bf16": 2}:
            raise RuntimeError(f"{what}: launches {moved}, expected 2 of B2x-bf16 alone")
        if not torch.equal(got, again):
            raise RuntimeError(f"{what}: a rerun differs in its bits")
        ref = conv4head_bwd_bf16_plain(g, x, *ops, *geo)[0]
        if got.dtype != torch.bfloat16 or got.shape != ref.shape:
            raise RuntimeError(f"{what}: dx {got.dtype} {tuple(got.shape)}")
        l2 = rel_l2(got, ref)
        if not l2 <= GEN_BF16_DX_L2:
            raise RuntimeError(f"{what}: relative L2 {l2:.3g} > {GEN_BF16_DX_L2}")
        with uncounted():
            ms = cuda_ms(lambda: conv4head_bwd_x(g, x, *ops, *geo), 10)
            dev_ms = device_ms(lambda: conv4head_bwd_x(g, x, *ops, *geo), B2X_BF16_KERNELS, 10)
        plain_ms = cuda_ms(lambda: conv4head_bwd_bf16_plain(g, x, *ops, *geo), 3)
        (bound, by), _ = general_bound("bwd_x", True, m, b, 64, 800, z, o, *geo)
        floor = (1e3 * 2 * m * b * cfg.n_tokens * z * general_fmas("bwd_x", 64, o, geo[0])
                 / WGMMA_N32_FLOPS)
        rows[(m, b)] = {"max_abs_err": float((got.float() - ref.float()).abs().max()),
                        "rel_l2": l2, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                        "bound_ms": bound, "bound_by": by, "wgmma_floor_ms": floor}
        print(f"{what} input grad: wrapper {ms:.4f} ms a call (CUDA events: the kernel, dxw and "
              f"the overlap-add), kernel {dev_ms:.4f} ms on the device (profiler), plain bf16 "
              f"{plain_ms:.3f} ms; relative L2 {l2:.3g}, max|err| "
              f"{rows[(m, b)]['max_abs_err']:.3g}, rerun bit-identical; bound {bound:.4f} ms "
              f"({by}, {bound / dev_ms:.1%} of the device time); wgmma m64n32k16 floor "
              f"{floor:.4f} ms ({floor / dev_ms:.1%})", flush=True)
        del model, ops, x, g, got, again, ref
    return rows


def phase_adapted_geometry(cfg, dev, rng):
    """Head geometries the kernels are not built for, launched on operands
    ``_adapted`` zero-pads or splits: dim_cnn = 8 (the width
    cli/zero_shot.py trains), full width otherwise, M = 2, B = 8, features
    and weight gradients in f32 and in bf16 (zones padded to 32 channels);
    and a bf16 forward of trials of T = 1001 (N = 7: two groups of windows,
    each on an even copy of its samples). Each must launch its kernels,
    count adapted calls, and match the CPU: f32 at HEAD_RTOL / HEAD_ATOL and
    BWD_RTOL, bf16 at BF16_FWD_REL and BF16_BWD_REL."""
    cfg8 = dataclasses.replace(cfg, dim_cnn=8)
    geo = (cfg8.window_len, cfg8.slide_step)
    m, b = 2, 8
    model = FAST(cfg8, n_models=m)
    model.load_state_dict(from_jax_params(init_jax_layout_params(cfg8, SEED, m)))
    with torch.no_grad():
        ops = model.head.fused_weights()
    x = torch.tensor(rng.normal(size=(m, b, 64, 800)).astype(np.float32))
    g = torch.tensor(rng.normal(size=(m, b, cfg8.n_tokens, cfg8.n_zones * 8)).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        results = {}
        for device in (dev, torch.device("cpu")):
            weights = [t.detach().to(device).requires_grad_(True) for t in ops]
            reset_launches()
            out = fused_conv4_head(x.to(device, dtype), *weights, *geo)
            (out * g.to(device)).sum().backward()
            if device.type == "cuda":
                launches = read_launches()
            results[device.type] = [out.detach().cpu()] + [p.grad.cpu() for p in weights]
        want = HEAD_KERNELS["bf16" if dtype == torch.bfloat16 else "f32"]
        if launches["adapted"] != 2 or any(launches[k] != 1 for k in want):
            raise RuntimeError(f"dim_cnn = 8 must launch {want} once each, adapted: {launches}")
        errs = {}
        for name, got, ref in zip(("out", "dw12", "db12", "dw3", "dw4"), results["cuda"],
                                  results["cpu"]):
            what = f"adapted dim_cnn=8 {dtype} {name}"
            if dtype == torch.bfloat16:
                errs[name] = check_rel(what, got, ref, BF16_FWD_REL if name == "out" else
                                       BF16_BWD_REL)
            elif name == "out":
                errs[name] = check_close(what, got, ref, HEAD_RTOL, HEAD_ATOL)
            else:
                errs[name] = check_close(what, got, ref, BWD_RTOL,
                                         BWD_RTOL * float(ref.abs().max()))
        print(f"head at dim_cnn=8 ({str(dtype).split('.')[-1]}), M={m} B={b}: zones padded to 32 "
              f"channels, launches {json.dumps({k: launches[k] for k in want})}, "
              f"{launches['adapted']} adapted calls; matches the CPU, max|err| "
              f"{json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})}", flush=True)
    z, o, k = cfg.n_zones, cfg.dim_cnn, KERNEL_TAPS
    ops32 = [torch.tensor(rng.normal(scale=sc, size=shape).astype(np.float32), device=dev)
             for shape, sc in (((1, z * o, k * 64), (k * 64) ** -0.5), ((1, z * o, 1), 0.1),
                               ((1, z, o, k * o), (k * o) ** -0.5),
                               ((1, z, o, k * o), (k * o) ** -0.5))]
    x = torch.tensor(rng.normal(size=(1, 16, 64, 1001)).astype(np.float32)).to(torch.bfloat16)
    geo = (cfg.window_len, cfg.slide_step)
    reset_launches()
    with torch.no_grad():
        got = fused_conv4_head(x.to(dev), *ops32, *geo)
    launches = read_launches()
    if launches["adapted"] != 1 or launches["conv4head_fwd_bf16"] != 2:
        raise RuntimeError(f"T = 1001 must take two B2f-bf16 launches, adapted: {launches}")
    err = check_rel("adapted bf16 forward T=1001", got.cpu(),
                    fused_conv4_head_plain(x, *(t.cpu() for t in ops32), *geo), BF16_FWD_REL)
    print(f"bf16 head forward at T=1001 (N=7), M=1 B=16: two B2f-bf16 launches (5 and 2 "
          f"windows), 1 adapted call; matches the CPU, max|err| {err:.3g}", flush=True)


F32_ROUTE_REL_L2 = 1e-2  # bf16 geometries on the f32 kernels (tests/test_torch_conv4head_route.py)


def phase_bf16_f32_route(dev, rng) -> dict:
    """bf16 head geometries that B2w-bf16 has no plan for, on the f32 route
    (``_adapted``): C = 72 and 68 at windows of 250 (its weight-gradient
    tiles). One B2w launch on the bf16 kernel's operands, counted adapted,
    within ``F32_ROUTE_REL_L2`` in relative L2 of the plain bf16 backward on
    the CPU. Windows of 280 at C = 64, on that route before column tiles,
    run B2w-bf16 (one launch, unadapted), within BF16_BWD_REL x max|ref|
    per tensor: the bf16 roundings of h1, h2 and the cotangents where the
    Pallas kernel makes them. C = 128, where the f32 plan does not fit
    either, runs on B2f-g bf16 (section 14), unadapted, within
    ``BF16_FWD_REL`` of the plain bf16 forward."""
    from imagined_speech_decoding_tpu_torch.ops.cuda.conv4head import conv4head_bwd_bf16_plain

    errs = {}
    for c, w, step in ((72, 250, 125), (68, 250, 125), (64, 280, 130)):
        n = (800 - w) // step + 1
        shapes = (((1, 8 * 32, 5 * c), (5 * c) ** -0.5), ((1, 8 * 32, 1), 0.1),
                  ((1, 8, 32, 160), 160 ** -0.5), ((1, 8, 32, 160), 160 ** -0.5))
        ops = [torch.tensor(rng.normal(scale=sc, size=sh).astype(np.float32)) for sh, sc in shapes]
        x = torch.tensor(rng.normal(size=(1, 16, c, 800)).astype(np.float32)).to(torch.bfloat16)
        g = torch.tensor(rng.normal(size=(1, 16, n, 256)).astype(np.float32))
        reset_launches()
        got = conv4head_bwd_w(g.to(dev), x.to(dev), *[t.to(dev) for t in ops], w, step)
        launches = read_launches()
        tiles = c <= 64
        want = (0, 1, 0) if tiles else (1, 0, 1)
        if (launches["conv4head_bwd_w"], launches["conv4head_bwd_w_bf16"],
                launches["adapted"]) != want:
            raise RuntimeError(f"bf16 C={c} W={w}: (B2w, B2w-bf16, adapted) launches must be "
                               f"{want}: {launches}")
        ref = conv4head_bwd_bf16_plain(g, x, *ops, w, step)[1:]
        errs[(c, w)] = max(float((a.cpu() - r).norm() / r.norm()) for a, r in zip(got, ref))
        if tiles:
            errs[(c, w, "max")] = max(check_rel(f"bf16 C={c} W={w} on B2w-bf16", a.cpu(), r,
                                                BF16_BWD_REL) for a, r in zip(got, ref))
        elif errs[(c, w)] > F32_ROUTE_REL_L2:
            raise RuntimeError(f"bf16 C={c} W={w} on the f32 route: relative L2 "
                               f"{errs[(c, w)]:.3g} > {F32_ROUTE_REL_L2}")
    shapes = (((1, 256, 640), 640 ** -0.5), ((1, 256, 1), 0.1), ((1, 8, 32, 160), 160 ** -0.5),
              ((1, 8, 32, 160), 160 ** -0.5))
    w128 = [torch.tensor(rng.normal(scale=sc, size=sh).astype(np.float32)) for sh, sc in shapes]
    x = torch.tensor(rng.normal(size=(1, 2, 128, 800)).astype(np.float32)).to(torch.bfloat16)
    reset_launches()
    with torch.no_grad():
        got = fused_conv4_head(x.to(dev), *(t.to(dev) for t in w128), 250, 125)
    launches = read_launches()
    if (launches["conv4head_fwd_general_bf16"], launches["conv4head_fwd_bf16"],
            launches["conv4head_fwd"], launches["adapted"]) != (1, 0, 0, 0):
        raise RuntimeError(f"bf16 C=128: neither tuned plan fits, so B2f-g bf16 must run once, "
                           f"unadapted: {launches}")
    err = check_rel("bf16 C=128 on B2f-g bf16", got.cpu(),
                    fused_conv4_head_plain(x, *w128, 250, 125), BF16_FWD_REL)
    route = {f"C={k[0]} W={k[1]}": float(f"{v:.3g}") for k, v in errs.items() if k[0] > 64}
    print(f"bf16 head geometries on the f32 route (B2w on the bf16 operands, one launch, "
          f"adapted): relative L2 against the plain bf16 backward {json.dumps(route)} "
          f"(<= {F32_ROUTE_REL_L2}); C=64 W=280 on B2w-bf16 (column tiles, unadapted): relative "
          f"L2 {errs[(64, 280)]:.3g}, max|err| {errs[(64, 280, 'max')]:.3g} (atol {BF16_BWD_REL} "
          f"x max|ref|); C=128, where neither tuned plan fits, runs on B2f-g bf16 "
          f"(one launch, unadapted), max|err| {err:.3g} against the plain bf16 forward",
          flush=True)
    return errs


TC_KERNELS = (  # the tensor-core kernels: (name, entry function, its smem bytes at full width
    # from the library, the tensor-core instruction of its route in SASS: mma.sync is HMMA,
    # wgmma HGMMA)
    ("B2f", "conv4head_fwd_kernel", lambda lib, c: lib.isd_conv4head_smem_bytes(
        64, c.window_len, c.dim_cnn, KERNEL_TAPS), "HMMA"),
    ("B2w", "conv4head_bwd_w_kernel", lambda lib, c: lib.isd_conv4head_bwd_w_smem_bytes(
        64, c.window_len, c.dim_cnn, KERNEL_TAPS), "HMMA"),
    ("B2x", "conv4head_bwd_x_kernel", lambda lib, c: lib.isd_conv4head_bwd_x_smem_bytes(
        64, c.window_len, c.dim_cnn, KERNEL_TAPS), "HMMA"),
    ("B2f-bf16", "conv4head_fwd_bf16_kernel", lambda lib, c: lib.isd_conv4head_fwd_bf16_smem_bytes(
        64, c.window_len, c.slide_step, c.n_tokens, c.dim_cnn, KERNEL_TAPS), "HGMMA"),
    ("B2w-bf16", "conv4head_bwd_w_bf16_kernel", lambda lib, c: (
        lib.isd_conv4head_bwd_w_bf16_smem_bytes(64, c.window_len, c.dim_cnn, KERNEL_TAPS)),
     "HGMMA"),
    ("B2x-bf16", "conv4head_bwd_x_bf16_kernel", lambda lib, c: (
        lib.isd_conv4head_bwd_x_bf16_smem_bytes(64, c.window_len, c.dim_cnn, KERNEL_TAPS)),
     "HGMMA"),
)
DEBUG_INSTANTIATION = "Lb1EE"  # B2f-bf16's and B2w-bf16's phase counters (kClock): not counted


def report_iir_build(info) -> None:
    """B1's registers and spills per entry, from this run's ``-Xptxas -v`` log."""
    for block in info["log"].split("Compiling entry function")[1:]:
        for entry in ("sosfiltfilt_chain_kernel", "sosfilt_time_major_kernel"):
            if entry in block.splitlines()[0]:
                lines = [ln.strip() for ln in block.split("Compile time")[0].splitlines()
                         if re.search(r"registers|spill", ln)]
                print(f"B1 ptxas {entry}: {' | '.join(lines)}", flush=True)


def report_tc_build(info, cfg) -> None:
    """The tensor-core kernels' registers and spills (each instantiation)
    from the ``-Xptxas -v`` log of this run's build, their dynamic shared
    memory per block at full width, and the count of tensor-core
    instructions of each one's route (HMMA, or HGMMA for B2w-bf16's wgmma)
    in the SASS of its shipped and generic instantiations; raises if any
    has none."""
    log = info["log"]
    if not log:
        print("ptxas: no build log (the library was already built)", flush=True)
    lib = _lib.library()
    for what, entry, smem_fn, _ in TC_KERNELS:
        for block in log.split("Compiling entry function")[1:]:
            if entry in block.splitlines()[0]:
                name = re.search(entry + r"ILi(\d+)ELi(\d+)ELi(n?\d+)ELi(n?\d+)E", block)
                lines = [ln.strip() for ln in block.split("Compile time")[0].splitlines()
                         if re.search(r"registers|spill", ln)]
                print(f"{what} ptxas <O, K, C, W> = <{', '.join(name.groups()) if name else '?'}>: "
                      f"{' | '.join(lines)}", flush=True)
        print(f"{what} shared memory: {smem_fn(lib, cfg)} bytes per block (dynamic)", flush=True)
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(cuobjdump):
        print("SASS: cuobjdump is missing; HMMA / HGMMA counts not read", flush=True)
        return
    sass = subprocess.run([cuobjdump, "-sass", info["path"]], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
        elif name is not None and DEBUG_INSTANTIATION not in name:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\b", ln):
                    counts[(name, op)] = counts.get((name, op), 0) + 1
    for what, entry, _, op in TC_KERNELS:
        n_op = sum(v for (k, o), v in counts.items() if entry in k and o == op)
        n_hmma = sum(v for (k, o), v in counts.items() if entry in k and o == "HMMA")
        if n_op == 0:
            raise RuntimeError(f"{what}'s SASS has no {op} instruction: "
                               "it does not run on the tensor cores by its route")
        if op == "HGMMA" and n_hmma:
            raise RuntimeError(f"{what} runs on wgmma, yet its SASS has {n_hmma} HMMA")
        print(f"{what} SASS: {n_op} {op} instructions (cuobjdump -sass)"
              + (", no HMMA" if op == "HGMMA" else ""), flush=True)


def reset_launches() -> None:
    for fn in (sosfiltfilt_chain, sosfilt_time_major, fused_conv4_head, conv4head_bwd_w,
               conv4head_bwd_x):
        fn.launches = fn.captures = 0
    fused_conv4_head.launches_bf16 = conv4head_bwd_w.launches_bf16 = 0
    conv4head_bwd_x.launches_bf16 = 0
    for fn in HEAD_WRAPPERS:
        fn.adapted = fn.launches_general = fn.launches_general_bf16 = 0


# The general kernels' launch-count keys: B2f-g, B2w-g, B2x-g, f32 then bf16.
GENERAL_KEYS = tuple(f"conv4head_{op}_general{p}" for p in ("", "_bf16") for op in GENERAL_OPS)


def read_launches() -> dict:
    torch.cuda.synchronize()
    general = {f"conv4head_{op}_general{p}": getattr(fn, f"launches_general{p}")
               for op, fn in zip(GENERAL_OPS, HEAD_WRAPPERS) for p in ("", "_bf16")}
    return {"iir_chain": sosfiltfilt_chain.launches, "iir": sosfilt_time_major.launches,
            "conv4head_fwd": fused_conv4_head.launches,
            "conv4head_bwd_w": conv4head_bwd_w.launches,
            "conv4head_bwd_x": conv4head_bwd_x.launches,
            "conv4head_fwd_bf16": fused_conv4_head.launches_bf16,
            "conv4head_bwd_w_bf16": conv4head_bwd_w.launches_bf16,
            "conv4head_bwd_x_bf16": conv4head_bwd_x.launches_bf16, **general,
            "adapted": sum(fn.adapted for fn in HEAD_WRAPPERS),
            "iir_chain_captures": sosfiltfilt_chain.captures,
            "conv4head_fwd_captures": fused_conv4_head.captures}


HEAD_WRAPPERS = (fused_conv4_head, conv4head_bwd_w, conv4head_bwd_x)  # each counts adapted


def require_unadapted(launches: dict, path: str) -> None:
    """The shipped geometry runs every head call on its operands as they
    are, on the tuned kernels: nothing adapted, no general kernel."""
    if launches["adapted"]:
        raise RuntimeError(f"the {path} path padded or split the head's operands "
                           f"{launches['adapted']} times at the shipped geometry")
    general = {k: launches[k] for k in GENERAL_KEYS if launches.get(k)}
    if general:
        raise RuntimeError(f"the {path} path launched a general head kernel at the shipped "
                           f"geometry: {general}")


@contextlib.contextmanager
def uncounted():
    """Launches made inside (a comparison's own runs) leave every launch
    counter as it was."""
    fns = (sosfiltfilt_chain, sosfilt_time_major) + HEAD_WRAPPERS
    saved = {(fn, a): v for fn in fns for a, v in vars(fn).items()
             if a.startswith(("launches", "captures", "adapted"))}
    try:
        yield
    finally:
        torch.cuda.synchronize()
        for (fn, a), v in saved.items():
            setattr(fn, a, v)


HEAD_KERNELS = {"f32": ("conv4head_fwd", "conv4head_bwd_w"),
                "bf16": ("conv4head_fwd_bf16", "conv4head_bwd_w_bf16")}  # launch-count keys


@contextlib.contextmanager
def corpus_made(X, Y):
    """``synthetic_corpus`` answers a call for ``cli.train_fast``'s corpus
    (``--synthetic TRAIN_SUBJECTS --synthetic_trials TRAIN_TRIALS``) with
    copies of ``X, Y``, that corpus made once already: the CLI draws it
    anew, 16-21 s of numpy a run on an H100 machine's host. Any other call
    draws."""
    from imagined_speech_decoding_tpu_torch.data import synthetic

    draw = synthetic.synthetic_corpus

    def made(*args, **kwargs):
        if args == (0, TRAIN_SUBJECTS, TRAIN_TRIALS, 64, 800) and not kwargs:
            return X.copy(), Y.copy()
        return draw(*args, **kwargs)

    synthetic.synthetic_corpus = made
    try:
        yield
    finally:
        synthetic.synthetic_corpus = draw


def phase_training(cfg, dev, workdir, precision: str, X, Y):
    """The training CLI on the full synthetic corpus: 75 stacked models, at
    the CLI's default precision (bf16: no ``--precision``) or f32; its
    corpus ``X, Y`` made by the caller (``corpus_made``)."""
    out = os.path.join(workdir, f"train_{precision}")
    argv = ["--synthetic", str(TRAIN_SUBJECTS), "--synthetic_trials", str(TRAIN_TRIALS),
            "--epochs", str(TRAIN_EPOCHS)]
    argv += [] if precision == "bf16" else ["--precision", precision]
    argv += ["--output_dir", out]
    print(f"training path ({precision}): cli.train_fast {' '.join(argv[:-1])} <tmp>", flush=True)
    reset_launches()
    with corpus_made(X, Y):
        result = train_fast.main(argv)
    launches = read_launches()
    print(f"training path ({precision}): kernel launches during the run {launches}", flush=True)
    other = "f32" if precision == "bf16" else "bf16"
    if any(launches[k] < 1 for k in HEAD_KERNELS[precision]):
        raise RuntimeError(f"the {precision} training path never launched {HEAD_KERNELS[precision]}")
    if any(launches[k] for k in HEAD_KERNELS[other]) or launches["conv4head_bwd_x"]:
        raise RuntimeError(f"the {precision} training path launched a head kernel of the other "
                           f"precision or B2x: {launches}")
    require_unadapted(launches, f"{precision} training")
    for k, v in result.fit.history.items():
        if v.shape != (TRAIN_SUBJECTS * 5, TRAIN_EPOCHS) or not np.isfinite(v).all():
            raise RuntimeError(f"history {k}: shape {v.shape}, finite {np.isfinite(v).all()}")
    subjects = [f"{i + 1:02d}" for i in range(TRAIN_SUBJECTS)]
    expected = [os.path.join(out, n) for n in
                ("summary_per_subject.csv", "global_test_predictions.csv")]
    for sid in subjects:
        expected += [os.path.join(out, f"sub-{sid}", n) for n in
                     [f"fold-{k}_history.csv" for k in range(5)]
                     + ["fold_metrics.csv", "best_subject.npz", "test_predictions.csv"]]
    missing = [p for p in expected if not os.path.isfile(p)]
    if missing:
        raise RuntimeError(f"result tree incomplete: {missing[:5]}")

    # One subject's best checkpoint, loaded as the serving layout (M = 1),
    # reproduces its test predictions (unfiltered: the training data is),
    # in the run's precision.
    dtype = TrainConfig(precision=precision).compute_dtype
    si = TRAIN_SUBJECTS - 1
    ckpt = os.path.join(out, f"sub-{subjects[si]}", "best_subject.npz")
    params, _, _ = load_model_npz(ckpt, init_jax_layout_params(cfg, SEED), {"head": {}})
    model = FAST(cfg, device=dev)
    model.load_state_dict(from_jax_params(params))
    subject = synthetic_trials(1000 * si, TRAIN_TRIALS, 64, 800)
    x_test = torch.tensor(subject[0][: TRAIN_TRIALS // 3]).to(dtype)
    y_pred = engine.predict(model, x_test.to(dev), TRAIN_BATCH)
    saved, _ = load_predictions_csv(os.path.join(out, f"sub-{subjects[si]}", "test_predictions.csv"))
    if not np.array_equal(y_pred, saved):
        raise RuntimeError("the best checkpoint does not reproduce test_predictions.csv")
    cpu = FAST(cfg)
    cpu.load_state_dict(from_jax_params(params))
    with torch.no_grad():
        logits = model.eval()(x_test.to(dev)).cpu().float()
        ref = cpu.eval()(x_test).float()
    if precision == "f32":
        logit_err = check_close("best checkpoint logits, card vs CPU", logits, ref, POST_RTOL,
                                POST_ATOL)
        how = f"max|err| {logit_err:.3g}"
    else:
        logit_err = float((logits - ref).norm() / ref.norm())
        if not logit_err <= BF16_LOGITS_L2:
            raise RuntimeError(f"bf16 checkpoint logits, card vs CPU: relative L2 {logit_err:.3g} "
                               f"> {BF16_LOGITS_L2}")
        how = f"relative L2 {logit_err:.3g} (max|err| {float((logits - ref).abs().max()):.3g})"

    t = result.timings
    m, n_train = TRAIN_SUBJECTS * 5, TRAIN_TRIALS * 4 // 5
    print(f"training path ({precision}): all {len(expected)} result files written; "
          f"sub-{subjects[si]}'s best_subject.npz reproduces its {len(saved)} test predictions; "
          f"its logits match the plain CPU forward, {how}", flush=True)
    print(f"training path ({precision}), host clock: corpus (a copy of the one made) "
          f"{t['data_s']:.2f} s, fit "
          f"{t['fit_s']:.2f} s, artifacts + test eval {t['artifacts_s']:.2f} s", flush=True)
    for ep, (tr, va) in enumerate(zip(t["train_s"], t["val_s"])):
        print(f"  epoch {ep}: train pass {tr:.3f} s ({t['steps_per_epoch']} steps, "
              f"{1e3 * tr / t['steps_per_epoch']:.1f} ms/step, "
              f"{m * n_train * cfg.n_tokens / tr:.0f} train trial-windows/s), validation "
              f"{va:.3f} s, epoch {tr + va:.3f} s", flush=True)
    acc = [row["Test_Acc"] for row in result.summary]
    print(f"  mean val_acc {result.fit.history['val_acc'][:, -1].mean():.4f}, mean test acc "
          f"{np.mean(acc):.4f} after {TRAIN_EPOCHS} epochs", flush=True)
    return launches, t, (ckpt, subject), result.fit


def phase_train_step_profile(cfg, dev, dtype, m=TRAIN_SUBJECTS * 5, sweep=False,
                             forward_mode="default"):
    """One training step of an M-model stack (the CV run's 75 by default) at
    batch 64 on a ``dtype`` batch: CUDA-event span, profiler device time by
    kernel, device idle share, and the peak of allocated device memory
    from the model's construction on. ``sweep``: the sweep's step,
    ``RowAdamW`` at a learning rate and weight decay per row (the default
    grid's). ``forward_mode``: the model's mode (``FAST(forward_mode=)``).
    A step of the Conv4Layers head must launch its precision's forward
    kernel once and its weight-gradient kernel once, none under
    ``train_transformer`` (the head runs outside autograd, and there its
    weights must move by the weight decay alone), and no other head
    kernel; a batch-norm head's step runs no head kernel (its convolutions
    are cuDNN's)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = FAST(cfg, n_models=m, device=dev, forward_mode=forward_mode)
    model.load_state_dict(from_jax_params(*init_jax_layout(cfg, SEED, m)))
    model.train()
    lr = 1e-4
    if sweep:
        hyper, _ = hyper_grid(SWEEP_LR, SWEEP_WD)
        rows = lambda v: torch.as_tensor(np.repeat(v, m // len(v)), device=dev)  # noqa: E731
        opt = engine.RowAdamW(model.parameters(), torch.zeros(m, device=dev),
                              0.01 * rows(hyper["wd_scale"]))
        lr = 1e-4 * rows(hyper["lr_scale"])
    else:
        opt = engine.make_optimizer(model.parameters())
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((m, TRAIN_BATCH, 64, 800), generator=gen, device=dev).to(dtype)
    y = torch.randint(0, cfg.n_classes, (m, TRAIN_BATCH), generator=gen, device=dev)

    def step():
        engine.train_step(model, opt, x, y, lr, cfg.n_classes, gen)

    name = ("bf16" if dtype == torch.bfloat16 else "f32")
    what = f"{'sweep' if sweep else 'train'} step {name}" + (
        f" {forward_mode}" if forward_mode != "default" else "")
    frozen_head = forward_mode == "train_transformer"
    head0 = {k: p.detach().clone() for k, p in model.named_parameters() if k.startswith("head.")}
    reset_launches()
    step()
    one = read_launches()  # the first step alone: each head kernel's launches a step
    if frozen_head and cfg.head == "Conv4Layers":
        decay = 1 - lr * opt.param_groups[0]["weight_decay"]
        worst = max(float(((p.detach().double() - head0[k].double() * decay).abs()
                           / head0[k].double().abs().clamp_min(1e-30)).max())
                    for k, p in model.named_parameters() if k in head0)
        if not worst <= DECAY_REL:
            raise RuntimeError(f"{what}: the head's weights moved by more than the weight decay "
                               f"(relative {worst:.3g} > {DECAY_REL})")
        print(f"{what}: the head's weights moved by -lr*wd*p alone (relative max|err| "
              f"{worst:.3g})", flush=True)
    # a batch-norm head's step takes ~2 s: one timed step is enough
    span = cuda_ms(step, 3 if cfg.head == "Conv4Layers" else 1, warmup=0)
    if cfg.head != "Conv4Layers":
        return stateful_step_row(f"{what} {cfg.head}", step, span, m, TRAIN_BATCH)
    other = "f32" if name == "bf16" else "bf16"
    fwd, bwd_w = HEAD_KERNELS[name]
    want = {fwd: 1, bwd_w: 0 if frozen_head else 1}
    if any(one[k] != v for k, v in want.items()) or any(one[k] for k in HEAD_KERNELS[other]) \
            or one["conv4head_bwd_x"]:
        raise RuntimeError(f"{what}: one step must launch {want} and no other head kernel: "
                           f"{one}")
    require_unadapted(one, what)
    # Which head kernels ran is read from the launch counters; the profiler
    # is asked only for their times, and profiles again where it lost one.
    kernels = {"f32": ("conv4head_fwd_kernel", "conv4head_bwd_w_kernel"),
               "bf16": ("conv4head_fwd_bf16_kernel", "conv4head_bwd_w_bf16_kernel")}
    events, p_span, union = profiled_step(step, what,
                                          need=kernels[name][:1 if frozen_head else 2])
    by_device = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                        for e in device_records(events)), reverse=True)
    busy = sum(ms for ms, _, _ in by_device)
    print(f"{what} M={m} B={TRAIN_BATCH}: CUDA-event span {span:.2f} ms; profiler "
          f"device time {busy:.2f} ms over {sum(c for _, c, _ in by_device)} kernels and copies "
          f"(device idle {1 - union / p_span:.1%} of the profiled step's {p_span:.2f} ms span, "
          f"busy {union:.2f} ms)", flush=True)
    for ms, calls, key in by_device[:10]:
        print(f"    device {ms:10.3f} ms {100 * ms / busy:5.1f}%  {calls:4d} calls  {key[:60]}",
              flush=True)
    if any(re.search(k, key) for k in kernels[other] for _, _, key in by_device) or (
            frozen_head and any(kernels[name][1] in key for _, _, key in by_device)):
        raise RuntimeError(f"the {what}'s profile holds a head kernel it must not run")
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"    peak allocated device memory {peak:.2f} GB; one step's head launches "
          f"{fwd} {one[fwd]}, {bwd_w} {one[bwd_w]}", flush=True)
    return {"step_ms": span, "busy_ms": busy, "peak_gb": peak, "idle": 1 - union / p_span,
            "launches": {k: one[k] for k in HEAD_KERNELS[name]}}


CONV4_KERNEL_NAMES = "conv4head_"  # every Conv4Layers head kernel's name starts so


def stateful_step_row(what: str, step, span: float, m: int, b: int) -> dict:
    """A batch-norm model's training step (``step``, already run and timed:
    ``span``) under the profiler: device time by kernel, idle share of the
    profiled step's span, peak allocated memory; no head kernel of
    Conv4Layers and no B1 launch."""
    reset_launches()
    events, p_span, union = profiled_step(step, what)
    launches = read_launches()
    if any(v for k, v in launches.items() if k != "adapted"):
        raise RuntimeError(f"{what}: a hand-written kernel launched: {launches}")
    by_device = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                        for e in device_records(events)), reverse=True)
    if not by_device or any(CONV4_KERNEL_NAMES in key for _, _, key in by_device):
        raise RuntimeError(f"{what}: no device records, or a Conv4Layers head kernel ran")
    busy = sum(ms for ms, _, _ in by_device)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"{what} M={m} B={b}: CUDA-event span {span:.2f} ms; profiler device time "
          f"{busy:.2f} ms over {sum(c for _, c, _ in by_device)} kernels and copies, whose "
          f"union is {union:.2f} ms (device idle {1 - union / p_span:.1%} of the profiled "
          f"step's {p_span:.2f} ms span); peak allocated device memory {peak:.2f} GB",
          flush=True)
    for ms, calls, key in by_device[:8]:
        print(f"    device {ms:10.3f} ms {100 * ms / busy:5.1f}%  {calls:4d} calls  {key[:60]}",
              flush=True)
    return {"step_ms": span, "busy_ms": busy, "peak_gb": peak, "idle": 1 - union / p_span}


def tsception_step_profile(dev) -> dict:
    """One TSception training step of the CLI's stack of 15 subjects x 5
    folds at its batch of 32, f32: span, device time, idle share, peak."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    m = TRAIN_SUBJECTS * 5
    mdef = make_tsception_model(64, 800)
    model = mdef.build(m, dev)
    mdef.load(model, *mdef.init(SEED, m))
    model.train()
    opt = engine.make_optimizer(model.parameters(), 0.0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((m, TS_BATCH, 64, 800), generator=gen, device=dev)
    y = torch.randint(0, 5, (m, TS_BATCH), generator=gen, device=dev)

    def step():
        engine.train_step(model, opt, x, y, 1e-3, 5, gen)

    step()
    return stateful_step_row("train step f32 TSception", step, cuda_ms(step, 1, warmup=0), m,
                             TS_BATCH)


STEP_PROFILE_FLAG = "--step-profile-child"  # chip_smoke.py runs itself with it: the step profiles


def step_profile_child(out: str, group: str = "campaign") -> None:
    """The training steps' profiles in a process of their own: f32 and bf16
    CV steps (M = 75), the sweep's (M = 75, ``RowAdamW``) and LOSO's (M = 15),
    at B = 64, the batch-norm models' and the baselines' (``group``
    "campaign"); or (``group`` "engine") the bf16 steps of the
    ``train_head`` and ``train_transformer`` modes and CVBlock's LOSO step
    at M = 15; or (``group`` "featurize") the band-power and STFT
    featurizers over the 15-subject corpus; or (``group`` "general")
    section 14's f32 and bf16 steps at windows of 500 (M = 75): f32 on B2f's
    and B2w's column tiles, bf16 on B2f-bf16 and B2w-bf16's. The profiler has lost whole
    sessions' records late in a long run (on an H100: three sessions in a
    row after the campaign phases; the featurizers' after the engine's steps
    joined this child; and the featurizers' again, three sessions in a row,
    at the end of the campaign child), and a fresh process recorded them
    all. Writes the rows to ``out``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg, dev = FASTConfig.default(), torch.device("cuda")
    if group == "general":
        cfg500 = dataclasses.replace(cfg, **GEN_GEOMETRY)
        rows = {f"general {p}": general_step_profile(cfg500, dev, d)
                for p, d in (("f32", torch.float32), ("bf16", torch.bfloat16))}
        with open(out, "w") as f:
            json.dump(rows, f)
        return
    if group == "featurize":
        rows = {f"featurize {name}": featurize_profile(dev, name) for name in BASELINES[:2]}
        with open(out, "w") as f:
            json.dump(rows, f)
        return
    if group == "engine":
        rows = {mode: phase_train_step_profile(cfg, dev, torch.bfloat16, forward_mode=mode)
                for mode in FORWARD_MODES[1:]}
        rows["loso CVBlock"] = phase_train_step_profile(
            dataclasses.replace(cfg, head="CVBlock"), dev, torch.bfloat16, m=FLEET_MODELS)
        with open(out, "w") as f:
            json.dump(rows, f)
        return
    rows = {"f32": phase_train_step_profile(cfg, dev, torch.float32),
            "cv": phase_train_step_profile(cfg, dev, torch.bfloat16),
            "sweep": phase_train_step_profile(cfg, dev, torch.bfloat16, sweep=True),
            "loso": phase_train_step_profile(cfg, dev, torch.bfloat16, m=FLEET_MODELS)}
    for head in BN_HEADS:
        rows[head] = phase_train_step_profile(dataclasses.replace(cfg, head=head), dev,
                                              torch.bfloat16)
    rows["TSception"] = tsception_step_profile(dev)
    for name in BASELINES:
        rows[f"baseline {name}"] = baseline_step_profile(dev, name, torch.bfloat16)
    # The CNN-BiLSTM in f32: its frontend's activations are twice bf16's; a
    # stack that does not fit runs in subject groups (--subject_group).
    for group in (TRAIN_SUBJECTS, 10, 5):
        try:
            rows["baseline cnn_bilstm f32"] = {
                **baseline_step_profile(dev, "cnn_bilstm", torch.float32, group),
                "subject_group": group}
            break
        except torch.cuda.OutOfMemoryError as e:
            print(f"train step f32 cnn_bilstm at {group} subjects: out of memory ({e})",
                  flush=True)
    with open(out, "w") as f:
        json.dump(rows, f)


PROFILER_LOST = "the profiler recorded no device time"  # _profile's error, after three sessions


def phase_step_profiles() -> dict:
    """``step_profile_child`` in four child processes, one a group; their
    output is printed here, and each child's host seconds in
    ``rows["child_seconds"]``. A child whose profiler lost records (``_profile``
    gave up after three sessions) is run once more, in a fresh process; any
    other failure, or a second loss, fails the run. The bf16 sweep and LOSO
    steps beside the CV step, and the forward modes' steps beside the
    default one."""
    torch.cuda.empty_cache()
    rows, seconds = {}, {}
    with tempfile.TemporaryDirectory() as workdir:
        for group in ("featurize", "campaign", "engine", "general"):
            out = os.path.join(workdir, f"steps_{group}.json")
            log = os.path.join(workdir, f"steps_{group}.log")
            cmd = [sys.executable, os.path.abspath(__file__), STEP_PROFILE_FLAG, out, group]
            t0 = time.perf_counter()
            for attempt in (1, 2):
                try:
                    _run_child(cmd, log)
                    break
                except RuntimeError as e:
                    if attempt == 2 or PROFILER_LOST not in str(e):
                        raise
                    print(f"step profiles ({group}): the profiler lost records in three "
                          "sessions; the child runs once more in a fresh process", flush=True)
                finally:
                    with open(log) as f:
                        print(f.read(), end="", flush=True)
            seconds[group] = time.perf_counter() - t0
            with open(out) as f:
                rows.update(json.load(f))
    rows["child_seconds"] = seconds
    cv, sweep, loso = rows["cv"], rows["sweep"], rows["loso"]
    print(f"forward modes, bf16 steps at M=75, B={TRAIN_BATCH}, device time / CUDA-event span "
          f"(B2f-bf16, B2w-bf16 launches a step): default {cv['busy_ms']:.2f} / "
          f"{cv['step_ms']:.2f} ms {tuple(cv['launches'].values())}, "
          + ", ".join(f"{mode} {rows[mode]['busy_ms']:.2f} / {rows[mode]['step_ms']:.2f} ms "
                      f"{tuple(rows[mode]['launches'].values())}" for mode in FORWARD_MODES[1:]),
          flush=True)
    bn = rows["loso CVBlock"]
    print(f"LOSO step CVBlock bf16 M={FLEET_MODELS} B={TRAIN_BATCH}: device {bn['busy_ms']:.2f} ms "
          f"/ span {bn['step_ms']:.2f} ms (the CV step M=75: {rows['CVBlock']['busy_ms']:.2f} ms), "
          f"peak {bn['peak_gb']:.2f} GB", flush=True)
    print(f"steps bf16 at B={TRAIN_BATCH}, device time / CUDA-event span: CV M=75 "
          f"{cv['busy_ms']:.2f} / {cv['step_ms']:.2f} ms, sweep M=75 "
          f"{sweep['busy_ms']:.2f} / {sweep['step_ms']:.2f} ms "
          f"({sweep['busy_ms'] / cv['busy_ms'] - 1:+.1%} device), LOSO M=15 "
          f"{loso['busy_ms']:.2f} / {loso['step_ms']:.2f} ms "
          f"({loso['busy_ms'] / cv['busy_ms']:.1%} of the CV step's device time)", flush=True)
    return rows


def phase_trajectory(cfg, dev, label: str = "trajectory"):
    """2 subjects x 10 trials (10 models, 8 + 2 trials, batch 8), dropout 0,
    2 epochs: the engine on the card against the engine on the CPU, from
    the same weights and the same CPU-generator permutations. ``label``
    names the run in what it prints."""
    cfg0 = dataclasses.replace(cfg, dropout=0.0)
    x, y = synthetic_corpus(SEED, 2, 10, 64, 800)
    tidx, vidx, _ = build_cv_index_stack(2, 10, 5, 42)
    m = tidx.shape[0]
    p0 = from_jax_params(*stacked_init(cfg0, 42, m))
    runs, models = {}, {}
    for device, d in (("card", dev), ("cpu", torch.device("cpu"))):
        model = models[device] = FAST(cfg0, n_models=m, device=d)
        model.load_state_dict(p0)
        fit = engine.make_fit(model, cfg.n_classes, epochs=2, batch_size=8, n_train=8, n_val=2,
                              learning_rate=1e-3, warmup_epochs=0)
        t0 = time.perf_counter()
        runs[device] = fit(tidx, vidx, torch.as_tensor(x.reshape(-1, 64, 800), device=d),
                           torch.as_tensor(y.reshape(-1).astype(np.int64), device=d), seed=43)
        print(f"{label}: {device} fit {time.perf_counter() - t0:.2f} s", flush=True)
    gpu, cpu = runs["card"], runs["cpu"]
    for k in engine.HISTORY_KEYS:
        np.testing.assert_allclose(gpu.history[k], cpu.history[k], rtol=TRAJ_RTOL, atol=TRAJ_ATOL,
                                   err_msg=k)
    np.testing.assert_array_equal(gpu.best_epoch, cpu.best_epoch)
    np.testing.assert_allclose(gpu.best_val_acc, cpu.best_val_acc, rtol=TRAJ_RTOL)
    # The last step's gradients, per tensor, as the kernels are held (BWD_RTOL).
    for (k, a), b in zip(models["card"].named_parameters(), models["cpu"].parameters()):
        check_close(f"{label} last-step gradient {k}", a.grad.cpu(), b.grad, BWD_RTOL,
                    BWD_RTOL * float(b.grad.abs().max()))
    # Parameters. Adam moves an element by ~lr whatever its gradient's size, so
    # an element whose gradient is at the rounding-noise level moves
    # differently on the two devices: the key part of the attention
    # in-projection bias (its exact gradient is 0, softmax being
    # shift-invariant along the keys) and a few others. Every element must
    # stay within the summed learning rate, and all but TRAJ_NOISE_SHARE of
    # the others within rtol TRAJ_RTOL, atol TRAJ_ATOL.
    budget = float(np.sum(fit.lr_table))
    d = cfg.dim_token
    far, total, worst = {}, 0, 0.0
    for which in ("params", "best_params"):
        a_all, b_all = getattr(gpu, which), getattr(cpu, which)
        for k in a_all:
            a, b = a_all[k].cpu(), b_all[k]
            torch.testing.assert_close(a, b, rtol=0, atol=budget,
                                       msg=lambda msg, k=k: f"{which} {k}: {msg}")
            worst = max(worst, float((a - b).abs().max()))
            if k.endswith("attn.in_proj.bias"):
                a, b = torch.cat([a[:, :d], a[:, 2 * d :]], 1), torch.cat([b[:, :d], b[:, 2 * d :]], 1)
            n_far = int(((a - b).abs() > TRAJ_ATOL + TRAJ_RTOL * b.abs()).sum())
            if n_far:
                far[f"{which}.{k}"] = n_far
            total += b.numel()
    n_far = sum(far.values())
    print(f"{label}: {n_far} of {total} parameter elements (the key bias aside) beyond rtol "
          f"{TRAJ_RTOL}, atol {TRAJ_ATOL}: {json.dumps(dict(sorted(far.items(), key=lambda kv: -kv[1])[:6]))}",
          flush=True)
    if n_far > TRAJ_NOISE_SHARE * total:
        raise RuntimeError(f"{label}: {n_far} of {total} parameter elements differ beyond "
                           f"rtol {TRAJ_RTOL}, atol {TRAJ_ATOL}")
    moved = max(float((gpu.params[k].cpu() - p0[k]).abs().max()) for k in p0)
    print(f"{label}: card and CPU agree over 2 epochs: history (rtol {TRAJ_RTOL}, atol "
          f"{TRAJ_ATOL}), best epochs, last-step gradients (rtol {BWD_RTOL}, atol {BWD_RTOL} * "
          f"max|ref|), final and best parameters ({n_far} of {total} elements beyond rtol "
          f"{TRAJ_RTOL}, atol {TRAJ_ATOL}; max|card - CPU| {worst:.3g} <= summed lr {budget:.3g}) "
          f"while the parameters moved up to {moved:.3g}", flush=True)


BF16_TRAJ_LOSS_RTOL = 1e-2  # bf16 card vs CPU: train and validation losses
BF16_TRAJ_GRAD_L2 = 1e-2  # bf16 card vs CPU: the last step's gradients, all parameters, relative L2
BF16_TRAJ_WEIGHT_DECAY = 0.01  # AdamW's decay in that run (make_fit's default)


def phase_trajectory_bf16(cfg, dev, label: str = "trajectory bf16",
                          want=("conv4head_fwd_bf16", "conv4head_bwd_w_bf16"), shipped=True):
    """``phase_trajectory``'s run in bf16, the corpus held in bf16 as
    ``train.cv`` holds it: the card (B2f-bf16, B2w-bf16, the cuBLAS bf16
    trunk) against the CPU (the plain bf16 head, the same trunk). bf16
    rounds every activation, and an element whose f32 sum lies near a
    rounding boundary rounds one ulp apart on the two devices, so the
    losses are held at rtol 1e-2 and the last step's gradients (all
    parameters together) at 1e-2 in relative L2. Far more elements than
    in f32 have gradients at the rounding-noise level (the key part of the
    attention in-projection bias, whose exact gradient is 0, always), and
    Adam moves each by up to lr a step whatever its size, in its own
    direction on each device. So every parameter is held to two such
    walks apart: 2 x the summed lr x (1.01 + weight decay x max|p|), the
    bias-corrected m / sqrt(v) of the run's first two steps being at most
    1.0014 (Cauchy-Schwarz over Adam's weights) and the decay pulling
    each walk by at most lr x wd x |p| more. Accuracies (2 validation
    trials a model: steps of 0.5) and best epochs follow from the losses
    and are printed, not held."""
    cfg0 = dataclasses.replace(cfg, dropout=0.0)
    x, y = synthetic_corpus(SEED, 2, 10, 64, 800)
    tidx, vidx, _ = build_cv_index_stack(2, 10, 5, 42)
    m = tidx.shape[0]
    p0 = from_jax_params(*stacked_init(cfg0, 42, m))
    runs, models = {}, {}
    for device, d in (("card", dev), ("cpu", torch.device("cpu"))):
        model = models[device] = FAST(cfg0, n_models=m, device=d)
        model.load_state_dict(p0)
        fit = engine.make_fit(model, cfg.n_classes, epochs=2, batch_size=8, n_train=8, n_val=2,
                              learning_rate=1e-3, warmup_epochs=0,
                              weight_decay=BF16_TRAJ_WEIGHT_DECAY)
        reset_launches()
        runs[device] = fit(tidx, vidx,
                           torch.as_tensor(x.reshape(-1, 64, 800), dtype=torch.bfloat16, device=d),
                           torch.as_tensor(y.reshape(-1).astype(np.int64), device=d), seed=43)
        launches = read_launches()
        if device == "card" and any(launches[k] < 1 for k in want):
            raise RuntimeError(f"the {label} run did not launch {want}: {launches}")
        if device == "card" and shipped:
            require_unadapted(launches, label)
    gpu, cpu = runs["card"], runs["cpu"]
    loss_err = max(float(np.abs(gpu.history[k] / cpu.history[k] - 1).max())
                   for k in ("loss", "val_loss"))
    g_card = torch.cat([p.grad.detach().cpu().flatten() for p in models["card"].parameters()])
    g_cpu = torch.cat([p.grad.detach().flatten() for p in models["cpu"].parameters()])
    grad_err = float((g_card - g_cpu).norm() / g_cpu.norm())
    p_max = max(float(v.abs().max()) for v in p0.values())
    budget = 2 * float(np.sum(fit.lr_table)) * (1.01 + BF16_TRAJ_WEIGHT_DECAY * p_max)
    diffs = {f"{which}.{k}": float((getattr(gpu, which)[k].cpu() - getattr(cpu, which)[k])
                                   .abs().max())
             for which in ("params", "best_params") for k in gpu.params}
    worst = max(diffs, key=diffs.get)
    acc_diff = max(float(np.nanmax(np.abs(gpu.history[k] - cpu.history[k])))
                   for k in ("acc", "val_acc"))
    print(f"{label}: card against CPU over 2 epochs: losses within {loss_err:.3g} "
          f"relative (rtol {BF16_TRAJ_LOSS_RTOL}), last-step gradients {grad_err:.3g} in relative "
          f"L2 (<= {BF16_TRAJ_GRAD_L2}), parameters max|card - CPU| {diffs[worst]:.3g} at "
          f"{worst} (<= two Adam walks, {budget:.4g}); accuracies differ by up to "
          f"{acc_diff:.3g}, best epochs "
          f"{'equal' if np.array_equal(gpu.best_epoch, cpu.best_epoch) else 'differ'}",
          flush=True)
    if not (loss_err <= BF16_TRAJ_LOSS_RTOL and grad_err <= BF16_TRAJ_GRAD_L2
            and diffs[worst] <= budget):
        raise RuntimeError(f"{label}: the card and the CPU disagree beyond the bounds above")


def phase_explain(cfg, dev, ckpt, subject):
    """Attributions of a trained checkpoint on its subject's trials
    ``subject = (x, y)``; every input gradient runs through B2x. Against
    the same attributions on the CPU (plain path)."""
    params, _, _ = load_model_npz(ckpt, init_jax_layout_params(cfg, SEED), {"head": {}})
    model = FAST(cfg, device=dev)
    model.load_state_dict(from_jax_params(params))
    cpu = FAST(cfg)
    cpu.load_state_dict(from_jax_params(params))
    x_all, y_all = subject
    x = torch.tensor(x_all[:IG_TRIALS], device=dev)
    with torch.no_grad():
        target = model.eval()(x).argmax(-1)
    reset_launches()
    t0 = time.perf_counter()
    attr = integrated_gradients(model, x, target, n_steps=IG_STEPS)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    print(f"attribution path: integrated gradients, {IG_TRIALS} trials x {IG_STEPS} steps, "
          f"{host_s:.3f} s", flush=True)
    ref = integrated_gradients(cpu, x.cpu(), target.cpu(), n_steps=IG_STEPS)
    err = check_close("integrated gradients", attr.cpu(), ref, BWD_RTOL,
                      BWD_RTOL * float(ref.abs().max()))
    print(f"attribution path: integrated gradients match the plain CPU path, max|err| {err:.3g} "
          f"(max|attr| {float(ref.abs().max()):.3g})", flush=True)

    # Expected gradients as cli/global_explain.py runs them: a seeded
    # permutation into 200 background and 100 explained trials, the true
    # labels as targets, 16 samples.
    perm = np.random.default_rng(SEED).permutation(len(x_all))
    bg = torch.tensor(x_all[perm[:EG_BACKGROUND]], device=dev)
    sel = perm[EG_BACKGROUND:EG_BACKGROUND + EG_TRIALS]
    xt = torch.tensor(x_all[sel], device=dev)
    yt = torch.tensor(np.asarray(y_all)[sel].astype(np.int64), device=dev)

    def eg():
        return expected_gradients(model, xt, bg, yt, torch.Generator().manual_seed(SEED),
                                  EG_SAMPLES)

    eg()  # warm-up: the first call at these shapes sets up allocations and cuBLAS plans
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    attr = eg()
    torch.cuda.synchronize()
    eg_s = time.perf_counter() - t0
    by_device = [(e.self_device_time_total / 1e3, e.key)
                 for e in device_records(profiled(eg, cpu=True))]
    busy = sum(ms for ms, _ in by_device)
    b2x = sum(ms for ms, key in by_device if re.search(B2X_KERNELS, key))
    b2f = sum(ms for ms, key in by_device if "conv4head_fwd_kernel" in key)
    gen = torch.Generator().manual_seed(SEED)  # expected_gradients' draws, in its order
    bg_idx = torch.randint(0, EG_BACKGROUND, (EG_SAMPLES, EG_TRIALS), generator=gen)
    alphas = torch.rand((EG_SAMPLES, EG_TRIALS), generator=gen)
    k = EG_CPU_TRIALS
    ref = expected_gradients_from_draws(cpu, xt[:k].cpu(), bg.cpu(), yt[:k].cpu(), bg_idx[:, :k],
                                        alphas[:, :k])
    eg_err = check_close("expected gradients", attr[:k].cpu(), ref, BWD_RTOL,
                         BWD_RTOL * float(ref.abs().max()))
    if attr.shape != xt.shape or not bool(torch.isfinite(attr).all()):
        raise RuntimeError(f"expected gradients: shape {tuple(attr.shape)} or non-finite values")
    print(f"attribution path: expected gradients, {EG_TRIALS} trials x {EG_SAMPLES} samples "
          f"against {EG_BACKGROUND} background trials: {eg_s:.3f} s on the host clock (after a "
          f"warm-up call); profiler device time {busy:.2f} ms (device idle "
          f"{max(0.0, 1 - busy / (1e3 * eg_s)):.0%} of the host time), B2x {b2x:.2f} ms "
          f"({b2x / busy:.1%}), B2f {b2f:.2f} ms "
          f"({b2f / busy:.1%}); the first {k} trials match the CPU on the same draws, max|err| "
          f"{eg_err:.3g} (max|attr| {float(ref.abs().max()):.3g})", flush=True)

    # attribution_for_predictions as cli/explain_fast.py runs it.
    bg = torch.tensor(x_all[perm[:AFP_BACKGROUND]], device=dev)
    xt = x_all[perm[AFP_BACKGROUND:AFP_BACKGROUND + AFP_TRIALS]]
    attr, preds = attribution_for_predictions(model, torch.tensor(xt, device=dev), bg,
                                              torch.Generator().manual_seed(SEED), AFP_SAMPLES)
    with torch.no_grad():
        cpu_preds = cpu.eval()(torch.from_numpy(xt)).argmax(-1)
    if not torch.equal(preds.cpu(), cpu_preds) or not bool(torch.isfinite(attr).all()):
        raise RuntimeError("attribution_for_predictions: predictions differ from the CPU's or "
                           "attributions are not finite")
    launches = read_launches()
    print(f"attribution path: attribution_for_predictions, {AFP_TRIALS} trials x {AFP_SAMPLES} "
          f"samples against {AFP_BACKGROUND}: predictions equal the CPU's; kernel launches in "
          f"the phase {launches}", flush=True)
    want = IG_STEPS + 3 * EG_SAMPLES + AFP_SAMPLES
    if launches["conv4head_bwd_x"] != want or launches["conv4head_bwd_w"] != 0:
        raise RuntimeError(f"the attribution path must launch B2x {want} times and B2w never")
    require_unadapted(launches, "attribution")
    return launches


# --- 12. Explain and QC: the attribution CLIs' computing functions, the artifact CLI's
# PSD and FastICA, the CSP pipeline's device work ---------------------------------------

GE_SUBJECTS = 3  # cli/global_explain.py's --n_synth_subjects
# Subject 0's test trials whose pooled maps the CPU recomputes (global_explain's CLI
# run takes all EG_TRIALS): the CPU's expected gradients take ~0.3 s a trial.
GE_CPU_TRIALS = 25
QC_TRIALS = 100  # cli/artifact_analysis.py's synthetic --n_trials: an (80,000 x 64) ICA input
QC_COMPONENTS = 15
PSD_RTOL = 1e-4  # atol = PSD_RTOL * max|ref|: cuFFT against pocketfft, f32
# FastICA card vs CPU, atol = REL * max|ref|: the float32 and float64 tolerances that
# tests/test_torch_ica.py holds against sklearn on this input.
ICA_F32_REL, ICA_F64_REL = 5e-4, 1e-6
# CSP filters and features card vs CPU, atol = CSP_REL * max|ref|: the eigenvectors
# amplify the band-passed trials' rounding, where B1 and its plain chain part at up to
# IIR_RTOL.
CSP_REL = 1e-3


def check_rel_np(name: str, got, ref, rel: float, rtol: float = 0.0) -> float:
    """``check_close`` of arrays (or CPU tensors) in f64 at atol ``rel * max|ref|``:
    max|got - ref| / max|ref|."""
    got, ref = (torch.as_tensor(np.asarray(a)).double() for a in (got, ref))
    scale = float(ref.abs().max())
    return check_close(name, got, ref, rtol, rel * scale) / scale


def idle_share(fn, what: str, need=()):
    """``fn`` once under the profiler: ``(device ms, CUDA-event span ms, device idle share,
    events)``, the device's busy time as the union of its records."""
    events, span, union = profiled_step(fn, what, need)
    return union, span, max(0.0, 1 - union / span), events


def phase_explain_cli(cfg, dev, ckpt, subject, results_dir, x_csp, y_csp) -> dict:
    """The attribution CLIs' computing functions at their defaults on the f32
    run's checkpoints, the artifact CLI (PSD, FastICA) on 100 synthetic trials,
    and the CSP pipeline's band-pass and CSP on one 350-trial subject, each
    held against the CPU; returns the launches of the counted runs."""
    from imagined_speech_decoding_tpu_torch.cli import (
        artifact_analysis,
        explain_fast,
        global_explain,
    )
    from imagined_speech_decoding_tpu_torch.explain.attribution import draw_samples
    from imagined_speech_decoding_tpu_torch.models.classical import CSPClassifierPipeline
    from imagined_speech_decoding_tpu_torch.ops.ica import fast_ica
    from imagined_speech_decoding_tpu_torch.ops.spectral import welch_psd

    t_phase = time.perf_counter()
    counted = {}
    # (a) explain_fast's arrays: 64 background and 16 explained trials, 32 samples.
    x_all, y_all = subject
    bg, xt, yt = explain_fast.split_trials(x_all, y_all, AFP_BACKGROUND, AFP_TRIALS, SEED)
    draws = draw_samples(torch.Generator().manual_seed(SEED), AFP_SAMPLES, AFP_TRIALS,
                         AFP_BACKGROUND)
    model = explain_fast.load_fast(cfg, ckpt, dev)
    reset_launches()
    t0 = time.perf_counter()
    arrays = explain_fast.explain_arrays(model, bg, xt, yt, *draws)
    torch.cuda.synchronize()
    ef_s = time.perf_counter() - t0
    launches = read_launches()
    if (launches["conv4head_bwd_x"], launches["conv4head_fwd"], launches["conv4head_bwd_w"]) \
            != (AFP_SAMPLES, AFP_SAMPLES + 1, 0):
        raise RuntimeError(f"explain_fast must launch B2x {AFP_SAMPLES}, B2f {AFP_SAMPLES + 1} "
                           f"and B2w 0 times: {launches}")
    require_unadapted(launches, "explain_fast")
    counted["explain_fast"] = launches
    busy, span, idle, events = idle_share(
        lambda: explain_fast.explain_arrays(model, bg, xt, yt, *draws), "explain_fast",
        (B2X_KERNELS,))
    b2x = sum(e.self_device_time_total for e in device_records(events)
              if re.search(B2X_KERNELS, e.key)) / 1e3
    t0 = time.perf_counter()
    ref = explain_fast.explain_arrays(explain_fast.load_fast(cfg, ckpt, "cpu"), bg, xt, yt,
                                      *draws)
    cpu_s = time.perf_counter() - t0
    if not np.array_equal(arrays["preds"], ref["preds"]):
        raise RuntimeError("explain_fast: predictions differ from the CPU's")
    errs = {k: check_rel_np(f"explain_fast {k}", arrays[k], ref[k], BWD_RTOL, BWD_RTOL)
            for k in ("attr", "zone_importance", "zone_time", "bands")}
    for name, per_class in ref["class_means"].items():
        if list(per_class) != list(arrays["class_means"][name]):
            raise RuntimeError(f"explain_fast {name}: classes differ from the CPU's")
        for cname, v in per_class.items():
            errs[f"{name} {cname}"] = check_rel_np(f"explain_fast {name} {cname}",
                                                   arrays["class_means"][name][cname], v,
                                                   BWD_RTOL, BWD_RTOL)
    print(f"explain and QC: explain_fast's arrays at its defaults ({AFP_TRIALS} trials x "
          f"{AFP_SAMPLES} samples against {AFP_BACKGROUND}, f32) on "
          f"{os.path.basename(os.path.dirname(ckpt))}'s checkpoint: {ef_s:.3f} s on the host clock (first call), device {busy:.2f} ms of a "
          f"{span:.2f} ms CUDA-event span (device idle {idle:.1%}; B2x {b2x:.2f} ms); CPU "
          f"{cpu_s:.2f} s; predictions equal the CPU's (accuracy {arrays['accuracy']:.3f}), "
          f"max|err| / max|ref| attributions {errs['attr']:.3g}, zone importance "
          f"{errs['zone_importance']:.3g}, class means "
          f"{max(v for k, v in errs.items() if '_only' in k):.3g}, zone x time "
          f"{errs['zone_time']:.3g}, bands {errs['bands']:.3g}; launches {launches}", flush=True)

    # (b) global_explain at its defaults on 3 synthetic subjects, the f32 run's first
    # three checkpoints laid out as sub-{index}/best_subject.npz.
    with tempfile.TemporaryDirectory() as d:
        for i in range(GE_SUBJECTS):
            os.symlink(os.path.join(results_dir, f"sub-{i + 1:02d}"), os.path.join(d, f"sub-{i}"))
        argv = ["--synthetic", "--n_synth_subjects", str(GE_SUBJECTS), "--n_bg",
                str(EG_BACKGROUND), "--n_test", str(EG_TRIALS), "--n_grad_samples",
                str(EG_SAMPLES), "--model_dir", d, "--output_dir", os.path.join(d, "out"),
                "--seed", str(SEED)]
        reset_launches()
        t0 = time.perf_counter()
        global_explain.main(argv, device=dev)
        torch.cuda.synchronize()
        ge_s = time.perf_counter() - t0
        launches = read_launches()
        want = GE_SUBJECTS * EG_SAMPLES
        if (launches["conv4head_bwd_x"], launches["conv4head_fwd"], launches["conv4head_bwd_w"]) \
                != (want, want, 0):
            raise RuntimeError(f"global_explain must launch B2x and B2f {want} times and B2w "
                               f"never: {launches}")
        require_unadapted(launches, "global_explain")
        counted["global_explain"] = launches
        busy, span, idle, events = idle_share(lambda: global_explain.main(argv, device=dev),
                                              "global_explain", (B2X_KERNELS,))
        b2x = sum(e.self_device_time_total for e in device_records(events)
                  if re.search(B2X_KERNELS, e.key)) / 1e3
    X, Y = synthetic_corpus(SEED, n_subjects=1, n_trials=EG_BACKGROUND + EG_TRIALS)
    bg, xt, yt = explain_fast.split_trials(X[0], Y[0].astype(int), EG_BACKGROUND, EG_TRIALS, SEED)
    draws = draw_samples(torch.Generator().manual_seed(SEED), EG_SAMPLES, EG_TRIALS, EG_BACKGROUND)
    n_cpu = GE_CPU_TRIALS
    xt, yt, draws = xt[:n_cpu], yt[:n_cpu], [d[:, :n_cpu] for d in draws]
    ckpt0 = os.path.join(results_dir, "sub-01", "best_subject.npz")
    res = global_explain.explain_subject(explain_fast.load_fast(cfg, ckpt0, dev), bg, xt, yt,
                                         *draws)
    t0 = time.perf_counter()
    ref = global_explain.explain_subject(explain_fast.load_fast(cfg, ckpt0, "cpu"), bg, xt, yt,
                                         *draws)
    cpu_s = time.perf_counter() - t0
    pooled, pooled_ref = (global_explain.pool_subjects([r]) for r in (res, ref))
    if list(pooled["topomaps"]) != list(pooled_ref["topomaps"]):
        raise RuntimeError("global_explain: the classes differ from the CPU's")
    pairs = [("attributions", res["attr"], ref["attr"])]
    pairs += [(f"topomap {k}", v, pooled_ref["topomaps"][k]) for k, v in pooled["topomaps"].items()]
    pairs += [(k, pooled[k], pooled_ref[k]) for k in ("zone_time", "bands")]
    ge_err = max(check_rel_np(f"global_explain {k}", got, want, BWD_RTOL, BWD_RTOL)
                 for k, got, want in pairs)
    print(f"explain and QC: global_explain at its defaults ({GE_SUBJECTS} subjects x "
          f"{EG_TRIALS} trials x {EG_SAMPLES} samples against {EG_BACKGROUND}): {ge_s:.2f} s on "
          f"the host clock (first call, corpus generation included); under the profiler device "
          f"{busy:.2f} ms of a {span:.2f} ms CUDA-event span (device idle {idle:.1%}), B2x "
          f"{b2x:.2f} ms ({b2x / busy:.1%} of the device time); launches {launches}; subject 0's "
          f"pooled arrays over {n_cpu} trials match the CPU's ({cpu_s:.2f} s there), max|err| / "
          f"max|ref| "
          f"{ge_err:.3g}", flush=True)

    # (c) artifact_analysis on 100 synthetic trials: PSD, then FastICA, card against CPU.
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        artifact_analysis.main(["--synthetic", "--n_trials", str(QC_TRIALS), "--n_components",
                                str(QC_COMPONENTS), "--seed", str(SEED), "--output_dir", d],
                               device=dev)
        torch.cuda.synchronize()
        qc_s = time.perf_counter() - t0
        psd = np.load(os.path.join(d, "psd.npz"))
        x, _ = synthetic_trials(SEED, QC_TRIALS, 64, 800)
        freqs, pxx = welch_psd(torch.from_numpy(x), fs=SFREQ, nperseg=256)
        psd_err = check_close("artifact_analysis PSD", torch.from_numpy(psd["pxx"]),
                              pxx.mean(0), PSD_RTOL, PSD_RTOL * float(pxx.abs().max()))
        if not np.array_equal(psd["freqs"], freqs):
            raise RuntimeError("artifact_analysis: PSD frequencies differ from the CPU's")
    cont = np.transpose(x, (1, 0, 2)).reshape(64, -1).T
    cont = cont - cont.mean(0)
    ica_rows = {}
    for dtype, rel in ((np.float32, ICA_F32_REL), (np.float64, ICA_F64_REL)):
        xc = torch.from_numpy(cont.astype(dtype))
        fast_ica(xc.to(dev), QC_COMPONENTS, seed=SEED)  # warm-up: cuSOLVER's set-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fast_ica(xc.to(dev), QC_COMPONENTS, seed=SEED)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = fast_ica(xc, QC_COMPONENTS, seed=SEED)
        cpu_s = time.perf_counter() - t0
        if dtype == np.float64 and got.n_iter != ref.n_iter:
            raise RuntimeError(f"fast_ica f64: {got.n_iter} iterations on the card, {ref.n_iter} "
                               "on the CPU")
        err = max(check_rel_np(f"fast_ica {dtype.__name__} {k}", getattr(got, k).cpu(),
                            getattr(ref, k), rel) for k in ("mixing", "components", "sources"))
        ica_rows[dtype.__name__] = {"s": card_s, "cpu_s": cpu_s, "n_iter": got.n_iter,
                                    "cpu_n_iter": ref.n_iter, "err": err}
    f32 = ica_rows["float32"]
    print(f"explain and QC: artifact_analysis on {QC_TRIALS} synthetic trials {qc_s:.2f} s on the "
          f"host clock (first call); PSD matches the CPU's welch_psd, max|err| {psd_err:.3g}; "
          f"fast_ica ({cont.shape[0]:,} x {cont.shape[1]}, {QC_COMPONENTS} components) on the "
          f"card: f32 {f32['n_iter']} iterations in {f32['s']:.3f} s (CPU {f32['cpu_n_iter']} in "
          f"{f32['cpu_s']:.3f} s), max|err| / max|ref| {f32['err']:.3g}; f64 "
          f"{ica_rows['float64']['n_iter']} iterations in {ica_rows['float64']['s']:.3f} s, "
          f"{ica_rows['float64']['err']:.3g}", flush=True)

    # (d) The CSP pipeline's device work at full width: one subject's 350 trials, each
    # band-pass, CSP fit and transform (5 classes, 10 components), card against CPU.
    csp_rows = {}
    for method in ("fir", "iir"):
        def features(device):
            pipe = CSPClassifierPipeline(filter_method=method, device=device)
            return pipe.features(x_csp, y_csp), pipe.csp_models[0]

        reset_launches()
        t0 = time.perf_counter()
        feats, csp_model = features(str(dev))
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        launches = read_launches()
        chain = launches["iir_chain"]
        if chain != (method == "iir") or launches["iir"]:
            raise RuntimeError(f"the CSP pipeline's {method} band-pass made {chain} B1 chain "
                               f"launches: {launches}")
        counted[f"csp_{method}"] = launches
        busy, span, idle, _ = idle_share(lambda: features(str(dev)), f"csp {method}")
        t0 = time.perf_counter()
        ref_feats, ref_model = features("cpu")
        cpu_s = time.perf_counter() - t0
        err = max(check_rel_np(f"CSP {method} filters", csp_model.filters.cpu(), ref_model.filters,
                            CSP_REL),
                  check_rel_np(f"CSP {method} features", feats, ref_feats, CSP_REL))
        csp_rows[method] = busy
        print(f"explain and QC: CSP pipeline, {method} band-pass + csp_fit + csp_transform on "
              f"{x_csp.shape[0]} x {x_csp.shape[1]} x {x_csp.shape[2]}: {host_s:.3f} s on the host "
              f"clock (first call), device {busy:.2f} ms of a {span:.2f} ms span (device idle "
              f"{idle:.1%}), B1 chain launches {chain}; CPU {cpu_s:.2f} s; filters and features "
              f"max|err| / max|ref| {err:.3g}", flush=True)
    why = ("the smoke drives the device work only" if importlib.util.find_spec("sklearn")
           else "scikit-learn is not installed on this machine")
    print(f"explain and QC: the SVC / LDA of cli.svm_baseline is not run here: {why}", flush=True)
    print(f"explain and QC: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counted


SWEEP_LR, SWEEP_WD = (0.25, 0.5, 1.0, 2.0, 4.0), (0.0, 1.0, 10.0)  # cli/sweep.py's default grid
SWEEP_F32_LR, SWEEP_F32_WD = (0.5, 2.0), (10.0,)  # the f32 sweep held against plain fits
CAMPAIGN_EPOCHS = 2
LOSO_TRAIN, LOSO_VAL = 4410, 490  # 15 x 350 trials: the 14 others' 4,900, 10% held out
LOSO_BATCHES = (TRAIN_BATCH, LOSO_TRAIN % TRAIN_BATCH,
                engine.eval_batch_size_for(LOSO_VAL, TRAIN_BATCH),
                LOSO_VAL % engine.eval_batch_size_for(LOSO_VAL, TRAIN_BATCH))  # 64, 58, 62, 56
ZS_BATCH = 50  # the real-data fixture's test trials a subject: one chunk a target
ZS_CPU_TARGETS = (0, FLEET_MODELS - 1)  # the targets whose columns the CPU recomputes
CAMPAIGN_MODELS = (0, FLEET_MODELS // 2, FLEET_MODELS - 1)  # held against the plain versions


def campaign_launches(key: str, training: dict, sweep: dict, loso: dict, ensemble: dict,
                      augment: dict) -> dict:
    """A bf16 head kernel's launches on the training, sweep, LOSO, ensemble
    and augmented training paths, each counted from 0 over its own run,
    and their sum."""
    parts = {"training": training[key], "sweep": sweep["launches"][key],
             "loso": loso["launches"][key], "ensemble": ensemble["launches"][key],
             "augment": augment[key]}
    return {"launches": sum(parts.values()), **{f"launches_{k}": v for k, v in parts.items()}}


def expected_head_launches(epochs: int, n_train: int, n_val: int, batch: int):
    """(B2f, B2w) launches of a fit with validation every epoch: a forward a
    training step and a validation batch, a weight gradient a step."""
    steps = -(-n_train // batch)
    evals = -(-n_val // engine.eval_batch_size_for(n_val, batch))
    return epochs * (steps + evals), epochs * steps


def require_bf16_launches(launches: dict, want, path: str) -> None:
    """A bf16 path's head launches: exactly ``want`` = (B2f-bf16, B2w-bf16),
    no f32 head kernel, no B2x, nothing adapted."""
    got = (launches["conv4head_fwd_bf16"], launches["conv4head_bwd_w_bf16"])
    if got != tuple(want) or launches["conv4head_fwd"] or launches["conv4head_bwd_w"] \
            or launches["conv4head_bwd_x"]:
        raise RuntimeError(f"the {path} path's head launches {launches}, expected (B2f-bf16, "
                           f"B2w-bf16) = {tuple(want)} and no other head kernel")
    require_unadapted(launches, path)


def phase_campaign_kernels(cfg, dev, rng):
    """The head kernels at the campaign programs' new shapes, against their
    plain versions on models 0, 7 and 14, timed by CUDA events beside their
    bounds: B2f-bf16 and B2w-bf16 at LOSO's M = 15, B = 64 and its 58-trial
    tail, B2f-bf16 also at its validation batches 62 and 56; f32 B2f at
    zero-shot's M = 15, B = 50 on one chunk broadcast to every model."""
    geo = (cfg.window_len, cfg.slide_step)
    feat = cfg.n_zones * cfg.dim_cnn
    m = FLEET_MODELS
    model = FAST(cfg, n_models=m, device=dev)
    model.load_state_dict(from_jax_params(init_jax_layout_params(cfg, SEED + 2, m)))
    with torch.no_grad():
        ops = model.head.fused_weights()
    rows = {}
    for b in LOSO_BATCHES:
        x = torch.tensor(rng.normal(size=(m, b, 64, 800)).astype(np.float32),
                         device=dev).to(torch.bfloat16)
        g = torch.tensor(rng.normal(size=(m, b, cfg.n_tokens, feat)).astype(np.float32),
                         device=dev)
        train_batch = b in LOSO_BATCHES[:2]
        if train_batch:
            errs = compare_bf16(ops, x, g, geo, CAMPAIGN_MODELS, f"LOSO M={m} B={b}")
        else:
            with torch.no_grad():
                out = fused_conv4_head(x, *ops, *geo)
            errs = {"out": max(check_rel(f"B2f-bf16 LOSO M={m} B={b} model {i}", out[i : i + 1],
                                         fused_conv4_head_plain(x[i : i + 1],
                                                                *[t[i : i + 1] for t in ops],
                                                                *geo), BF16_FWD_REL)
                               for i in CAMPAIGN_MODELS)}
        r = rows[f"bf16_m{m}_b{b}"] = {
            "fwd_err": errs["out"], "fwd_ms": cuda_ms(lambda: fused_conv4_head(x, *ops, *geo), 10),
            "fwd_plain_ms": cuda_ms(lambda: fused_conv4_head_plain(x, *ops, *geo), 1),
            "fwd_bound": head_bound_bf16(HEAD_FMA_FWD, m, b, m * b * 5 * 256, reads_g=False)}
        if train_batch:
            r.update({"w_err": max(errs[k] for k in ("dw12", "db12", "dw3", "dw4")),
                      "w_ms": cuda_ms(lambda: conv4head_bwd_w(g, x, *ops, *geo), 10),
                      "w_plain_ms": cuda_ms(lambda: conv4head_bwd_plain(g, x, *ops, *geo), 1),
                      "w_bound": head_bound_bf16(HEAD_FMA_BWD_W, m, b, m * HEAD_WEIGHT_FLOATS)})
        for k, name in (("fwd", "B2f-bf16 forward"), ("w", "B2w-bf16 weight grads")):
            if f"{k}_ms" in r:
                bound, by = r[f"{k}_bound"]
                print(f"{name} LOSO M={m} B={b:<3}: kernel {r[f'{k}_ms']:.4f} ms, plain bf16 "
                      f"{r[f'{k}_plain_ms']:.3f} ms, max|err| {r[f'{k}_err']:.3g} (models "
                      f"{CAMPAIGN_MODELS}), bound {bound:.4f} ms ({by}, "
                      f"{bound / r[f'{k}_ms']:.1%} reached)", flush=True)
    with torch.inference_mode():
        xb = torch.tensor(rng.normal(size=(ZS_BATCH, 64, 800)).astype(np.float32), device=dev)
        x = xb.expand(m, *xb.shape).contiguous()  # the head's operand (heads.py materialises it)
        out = fused_conv4_head(x, *ops, *geo)
        err = max(check_close(f"B2f zero-shot M={m} B={ZS_BATCH} model {i}", out[i : i + 1],
                              fused_conv4_head_plain(xb[None], *[t[i : i + 1] for t in ops], *geo),
                              HEAD_RTOL, HEAD_ATOL) for i in CAMPAIGN_MODELS)
        bound, by = head_bound(HEAD_FMA_FWD, m, ZS_BATCH, m * ZS_BATCH * 5 * 256, reads_g=False)
        r = rows[f"f32_m{m}_b{ZS_BATCH}"] = {
            "fwd_err": err, "fwd_bound": (bound, by),
            "fwd_ms": cuda_ms(lambda: fused_conv4_head(x, *ops, *geo), 10),
            "fwd_plain_ms": cuda_ms(lambda: fused_conv4_head_plain(x, *ops, *geo), 1)}
    print(f"B2f (f32) zero-shot M={m} B={ZS_BATCH}: kernel {r['fwd_ms']:.4f} ms, plain "
          f"{r['fwd_plain_ms']:.3f} ms, max|err| {err:.3g} (models {CAMPAIGN_MODELS}), bound "
          f"{bound:.4f} ms ({by}, {bound / r['fwd_ms']:.1%} reached)", flush=True)
    return rows


def _hold_rows_to_plain_fits(cfg, dev, report, x, y):
    """The f32 sweep's rows against plain fits rebuilt at each config's
    learning rate and weight decay, on the same folds, initial weights and
    draws: history at the f32 trajectory phase's rtol / atol, parameters
    within twice the summed learning rate. Returns the largest parameter
    difference and its budget."""
    tr, va, _ = build_cv_index_stack(1, TRAIN_TRIALS, 5, 42)
    worst, budget = 0.0, 0.0
    for h, (c, w) in enumerate(report.meta):
        model = FAST(cfg, n_models=5, device=dev)
        model.load_state_dict(from_jax_params(*stacked_init(cfg, 42, 5)))
        fit = engine.make_fit(model, cfg.n_classes, epochs=CAMPAIGN_EPOCHS,
                              batch_size=TRAIN_BATCH, n_train=tr.shape[1], n_val=va.shape[1],
                              learning_rate=5e-4 * c, weight_decay=0.01 * w)
        ref = fit(tr, va, x, y, seed=43)
        rows = slice(5 * h, 5 * h + 5)
        for k in engine.HISTORY_KEYS:
            np.testing.assert_allclose(report.fit.history[k][rows], ref.history[k],
                                       rtol=TRAJ_RTOL, atol=TRAJ_ATOL,
                                       err_msg=f"sweep row {h} (lr x{c}, wd x{w}) {k}")
        budget = max(budget, 2 * float(np.sum(fit.lr_table)))
        for which in ("params", "best_params"):
            for k, v in getattr(report.fit, which).items():
                d = float((v[rows] - getattr(ref, which)[k]).abs().max())
                worst = max(worst, d)
                if d > 2 * float(np.sum(fit.lr_table)):
                    raise RuntimeError(f"sweep row {h} {which} {k}: {d:.3g} from the plain fit, "
                                       "over twice the summed lr")
    return worst, budget


def phase_sweep(cfg, dev, x, y):
    """``train.sweep.cv_sweep`` on one synthetic subject's 350 trials: the
    CLI's default 5 lr x 3 wd grid x 5 folds = 75 models, bf16, 2 epochs,
    with B2f-bf16 and B2w-bf16 launched exactly as its batches count them
    and nothing adapted; a 2-config grid of one (lr, wd) twice, whose rows
    must be equal bit for bit; an f32 2-config sweep held against plain fits
    at the rebuilt learning rates and weight decays."""
    kw = dict(n_trials=TRAIN_TRIALS, n_folds=5, epochs=CAMPAIGN_EPOCHS, batch_size=TRAIN_BATCH,
              seed=42, device=dev)
    reset_launches()
    t0 = time.perf_counter()
    report = cv_sweep(cfg, cfg.n_classes, x, y, lr_scales=SWEEP_LR, wd_scales=SWEEP_WD,
                      data_dtype=torch.bfloat16, **kw)
    wall = time.perf_counter() - t0
    launches = read_launches()
    n_train, n_val = TRAIN_TRIALS * 4 // 5, TRAIN_TRIALS // 5
    want = expected_head_launches(CAMPAIGN_EPOCHS, n_train, n_val, TRAIN_BATCH)
    require_bf16_launches(launches, want, "sweep")
    h = len(SWEEP_LR) * len(SWEEP_WD)
    for k, v in report.history.items():
        if v.shape != (h, 5, CAMPAIGN_EPOCHS) or not np.isfinite(v).all():
            raise RuntimeError(f"sweep history {k}: shape {v.shape}, finite {np.isfinite(v).all()}")
    b = report.best
    print(f"sweep: {len(SWEEP_LR)} lr x {len(SWEEP_WD)} wd x 5 folds = {h * 5} models, bf16, "
          f"{CAMPAIGN_EPOCHS} epochs in {wall:.2f} s (host clock); launches B2f-bf16 "
          f"{want[0]}, B2w-bf16 {want[1]} as counted, adapted 0; best lr {b['learning_rate']:g} "
          f"wd {b['weight_decay']:g}, mean val_acc {b['mean_val_acc']:.4f}", flush=True)

    dup = cv_sweep(cfg, cfg.n_classes, x, y, lr_scales=(1.0, 1.0), wd_scales=(1.0,),
                   data_dtype=torch.bfloat16, **kw)
    for which in ("params", "best_params"):
        for k, v in getattr(dup.fit, which).items():
            if not torch.equal(v[:5], v[5:]):
                raise RuntimeError(f"sweep: two configs of one (lr, wd) differ in {which} {k}")
    for k, v in dup.history.items():
        if not np.array_equal(v[0], v[1], equal_nan=True):
            raise RuntimeError(f"sweep: two configs of one (lr, wd) differ in history {k}")
    print("sweep: two grid rows of one (lr, wd), 5 folds each, bf16 with dropout, trained bit "
          "for bit alike (parameters, best snapshots, history)", flush=True)

    xf = torch.as_tensor(x, device=dev)
    yf = torch.as_tensor(y.astype(np.int64), device=dev)
    f32 = cv_sweep(cfg, cfg.n_classes, xf, yf, lr_scales=SWEEP_F32_LR, wd_scales=SWEEP_F32_WD, **kw)
    worst, budget = _hold_rows_to_plain_fits(cfg, dev, f32, xf, yf)
    print(f"sweep f32: {len(f32.meta)} configs x 5 folds against plain fits at lr / wd "
          f"{[(5e-4 * c, 0.01 * w) for c, w in f32.meta]}: history within rtol {TRAJ_RTOL}, atol "
          f"{TRAJ_ATOL}; parameters max|sweep - plain| {worst:.3g} <= twice the summed lr "
          f"{budget:.3g}", flush=True)
    return {"launches": launches, "wall_s": wall, "best": b}


def phase_loso(cfg, dev, X, Y, workdir):
    """``train.loso.pretrain_loso`` over 15 synthetic subjects x 350 trials,
    bf16, 2 epochs: B2f-bf16 and B2w-bf16 launched exactly as LOSO's batches
    (64 x 68 + 58 a training epoch, 62 x 7 + 56 a validation pass) count
    them, nothing adapted; every row's indices leave its subject out; a
    second call launches nothing and returns the saved rows bit for bit; a
    CV run warm-started from ``stack_pretrained_for_cv`` begins at them
    exactly (a 0-learning-rate epoch ends where it began)."""
    subjects = [f"{i + 1:02d}" for i in range(TRAIN_SUBJECTS)]
    save = os.path.join(workdir, "loso")
    kw = dict(epochs=CAMPAIGN_EPOCHS, batch_size=TRAIN_BATCH, data_dtype=torch.bfloat16,
              device=dev, verbose=False, checkpoint_dir=os.path.join(save, "checkpoints"))
    reset_launches()
    t0 = time.perf_counter()
    pre, res = pretrain_loso(cfg, X, Y, subjects, cfg.n_classes, save, return_result=True, **kw)
    wall = time.perf_counter() - t0
    launches = read_launches()
    want = expected_head_launches(CAMPAIGN_EPOCHS, LOSO_TRAIN, LOSO_VAL, TRAIN_BATCH)
    require_bf16_launches(launches, want, "LOSO")
    tr, va = build_loso_index_stack(Y, seed=42)
    n = TRAIN_TRIALS
    if tr.shape != (TRAIN_SUBJECTS, LOSO_TRAIN) or va.shape != (TRAIN_SUBJECTS, LOSO_VAL) or any(
            ((np.r_[tr[s], va[s]] >= s * n) & (np.r_[tr[s], va[s]] < (s + 1) * n)).any()
            for s in range(TRAIN_SUBJECTS)):
        raise RuntimeError("LOSO: a row's indices include its own subject, or sizes differ")
    for k, v in res.history.items():
        if v.shape != (TRAIN_SUBJECTS, CAMPAIGN_EPOCHS) or not np.isfinite(v).all():
            raise RuntimeError(f"LOSO history {k}: shape {v.shape}")
    print(f"LOSO: {TRAIN_SUBJECTS} exclusions x ({LOSO_TRAIN} + {LOSO_VAL}) trials, bf16, "
          f"{CAMPAIGN_EPOCHS} epochs in {wall:.2f} s (host clock); launches B2f-bf16 {want[0]}, "
          f"B2w-bf16 {want[1]} as counted at B = {LOSO_BATCHES}, adapted 0; every row leaves its "
          f"subject out; mean best val_acc {res.best_val_acc.mean():.4f}", flush=True)

    reset_launches()
    again = pretrain_loso(cfg, X, Y, subjects, cfg.n_classes, save, **kw)
    quiet = read_launches()
    if any(quiet[k] for k in ("conv4head_fwd", "conv4head_fwd_bf16", "conv4head_bwd_w",
                              "conv4head_bwd_w_bf16", "conv4head_bwd_x")):
        raise RuntimeError(f"LOSO's second call launched {quiet}")
    for a, b in zip(pre, again):
        fa, fb = checkpoint._flatten(a), checkpoint._flatten(b)
        if fa.keys() != fb.keys() or any(not np.array_equal(fa[k], fb[k]) for k in fa):
            raise RuntimeError("LOSO's second call returned other rows than the saved ones")

    tc = TrainConfig(max_epochs=1, learning_rate=0.0, batch_size=TRAIN_BATCH)
    warm = stack_pretrained_for_cv(pre, tc.n_folds)
    cv_res = train_per_subject_cv(cfg, tc, X, Y, subjects, cfg.n_classes, warm_start=warm,
                                  device=dev, verbose=False)
    got = checkpoint._flatten(to_jax_params(cv_res.fit.params))
    for k, v in checkpoint._flatten(warm).items():
        if not np.array_equal(got[k], v):
            raise RuntimeError(f"the CV warm start does not begin at the LOSO rows: {k}")
    print("LOSO: a second call launched nothing and returned the saved rows bit for bit; a CV "
          f"run of {TRAIN_SUBJECTS * tc.n_folds} models warm-started from "
          "stack_pretrained_for_cv begins at them exactly", flush=True)
    return {"launches": launches, "wall_s": wall}


def phase_ensemble(cfg, dev, workdir, X):
    """``cli.train_fast --synthetic 15 --ensemble 2`` at 2 epochs in a child
    process: its member-0 tree equals the bf16 training phase's run (the
    same flags) bit for bit; the root decision of every subject equals the
    argmax of the mean of the members' posteriors, recomputed from their
    best checkpoints on the card and voted on the host, and, on the last
    subject's first 16 test trials, on the CPU (a disagreement only where
    the mean posterior's top two are within 1e-2)."""
    out = os.path.join(workdir, "ensemble")
    cmd = [sys.executable, os.path.abspath(__file__), CHILD_FLAG, "", "--synthetic",
           str(TRAIN_SUBJECTS), "--synthetic_trials", str(TRAIN_TRIALS), "--epochs",
           str(TRAIN_EPOCHS), "--ensemble", "2", "--output_dir", out]
    wall = _run_child(cmd, os.path.join(workdir, "ensemble.log"))
    with open(os.path.join(out, "child.json")) as f:
        child = json.load(f)
    launches = child["launches"]
    if any(launches[k] < 1 for k in HEAD_KERNELS["bf16"]) or \
            any(launches[k] for k in HEAD_KERNELS["f32"]) or launches["conv4head_bwd_x"]:
        raise RuntimeError(f"the ensemble run's head launches: {launches}")
    require_unadapted(launches, "ensemble training")
    plain = os.path.join(workdir, "train_bf16")
    for rel in ("summary_per_subject.csv", "global_test_predictions.csv"):
        with open(os.path.join(out, "member-0", rel), "rb") as f, \
                open(os.path.join(plain, rel), "rb") as g:
            if f.read() != g.read():
                raise RuntimeError(f"the ensemble's member-0/{rel} differs from a plain run's")
    template = init_jax_layout_params(cfg, SEED)
    single, cpu = FAST(cfg, device=dev), FAST(cfg)
    n_test = TRAIN_TRIALS // 3
    for si in range(TRAIN_SUBJECTS):
        sid = f"{si + 1:02d}"
        x = torch.as_tensor(X[si, :n_test], dtype=torch.bfloat16)
        trees = [load_model_npz(os.path.join(out, f"member-{e}", f"sub-{sid}", "best_subject.npz"),
                                template, {"head": {}})[0] for e in range(2)]
        probs = []
        for tree in trees:
            single.load_state_dict(from_jax_params(tree))
            probs.append(engine.predict_proba(single, x.to(dev), TRAIN_BATCH))
        mean = np.mean(np.stack(probs), axis=0)
        pred, _ = load_predictions_csv(os.path.join(out, f"sub-{sid}", "test_predictions.csv"))
        if not np.array_equal(pred, mean.argmax(-1)):
            raise RuntimeError(f"the ensemble's sub-{sid} decision is not the argmax of the "
                               "members' mean posterior")
    cpu_probs = []
    for tree in trees:  # the last subject's, on the CPU
        cpu.load_state_dict(from_jax_params(tree))
        cpu_probs.append(engine.predict_proba(cpu, x[:16], 16))
    cpu_mean = np.mean(np.stack(cpu_probs), axis=0)
    top2 = np.sort(cpu_mean, axis=-1)[:, -2:]
    flips = np.flatnonzero(cpu_mean.argmax(-1) != pred[:16])
    if (top2[flips, 1] - top2[flips, 0] > 1e-2).any():
        raise RuntimeError(f"the CPU's vote differs from the card's on trials {flips.tolist()} "
                           "beyond a near-tie")
    print(f"ensemble: cli.train_fast --synthetic {TRAIN_SUBJECTS} --ensemble 2 in a child process "
          f"({wall:.2f} s wall); member-0's summary_per_subject.csv and "
          "global_test_predictions.csv equal the plain bf16 run's bit for bit; every subject's "
          "decision is the argmax of the members' mean posterior from their best checkpoints; "
          f"on the CPU, sub-{sid}'s first 16 trials vote alike but for {len(flips)} near-ties "
          f"(max |CPU - card| posterior {np.abs(cpu_mean - mean[:16]).max():.3g}); launches "
          f"{launches}", flush=True)
    return {"launches": launches, "wall_s": wall}


def phase_zero_shot(cfg, dev, results_dir, tests):
    """``cli.zero_shot.transfer_matrix`` in f32 over the real-data run's 15
    ``best_subject.npz`` on the fixture's test split (15 x 50 trials): one
    f32 B2f launch a target at M = 15, B = 50, nothing adapted; the columns
    of ``ZS_CPU_TARGETS`` recomputed by the plain CPU forward, where a trial
    whose prediction differs must have a top-2 logit margin inside B2f's
    tolerance."""
    from imagined_speech_decoding_tpu_torch.cli.zero_shot import transfer_matrix

    paths = [os.path.join(results_dir, f"sub-{i + 1:02d}", "best_subject.npz")
             for i in range(FLEET_MODELS)]
    stacked, stacked_state = stack_checkpoints(paths, FAST(cfg))
    model = FAST(cfg, n_models=FLEET_MODELS, device=dev)
    model.load_state_dict(from_jax_params(stacked, stacked_state))
    reset_launches()
    t0 = time.perf_counter()
    matrix = transfer_matrix(model, tests)
    wall = time.perf_counter() - t0
    launches = read_launches()
    if launches["conv4head_fwd"] != len(tests) or launches["conv4head_fwd_bf16"]:
        raise RuntimeError(f"zero-shot made {launches} head launches, one f32 B2f a target expected")
    require_unadapted(launches, "zero-shot")
    cpu = FAST(cfg, n_models=FLEET_MODELS).eval()
    cpu.load_state_dict(from_jax_params(stacked))
    flips = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        for t in ZS_CPU_TARGETS:
            x, y = tests[t]
            xb = torch.as_tensor(np.asarray(x, np.float32))
            y = torch.as_tensor(np.asarray(y).astype(np.int64))
            ref = cpu(xb.expand(FLEET_MODELS, *xb.shape))
            got = model(xb.to(dev).expand(FLEET_MODELS, *xb.shape)).cpu()
            if not np.array_equal(matrix[:, t], (got.argmax(-1) == y).float().mean(-1).numpy()):
                raise RuntimeError(f"zero-shot: column {t + 1:02d} is not its logits' accuracy")
            differ = (ref.argmax(-1) != got.argmax(-1)).nonzero().tolist()
            for i, j in differ:
                top = ref[i, j].topk(2).values
                margin = float(top[0] - top[1])
                print(f"  zero-shot: model {i + 1:02d} on target {t + 1:02d} trial {j}: card and "
                      f"CPU predictions differ at a top-2 logit margin {margin:.3g}", flush=True)
                if margin > HEAD_ATOL + HEAD_RTOL * float(top[0].abs()):
                    raise RuntimeError("zero-shot: a prediction differs beyond B2f's tolerance")
            cpu_col = (ref.argmax(-1) == y).float().mean(-1).numpy()
            if not differ and not np.array_equal(matrix[:, t], cpu_col):
                raise RuntimeError(f"zero-shot: column {t + 1:02d} differs from the plain CPU's")
            flips += len(differ)
    cpu_s = time.perf_counter() - t0
    diag = np.diag(matrix)
    off = matrix[~np.eye(FLEET_MODELS, dtype=bool)]
    print(f"zero-shot: {FLEET_MODELS} x {FLEET_MODELS} transfer matrix, f32, {wall:.3f} s (host "
          f"clock); {launches['conv4head_fwd']} B2f launches at M={FLEET_MODELS} B={ZS_BATCH}, "
          f"adapted 0; columns {[t + 1 for t in ZS_CPU_TARGETS]} against the plain CPU forward "
          f"({cpu_s:.1f} s): {flips} predictions differ; diagonal mean {diag.mean():.4f}, off-diagonal mean "
          f"{off.mean():.4f}", flush=True)
    return {"launches": launches, "wall_s": wall, "diag": float(diag.mean()),
            "off_diag": float(off.mean())}


def phase_native_cache(X, workdir):
    """The 15 x 350 x 64 x 800 f32 corpus through the port's native cache
    (``data/fastcache.py``): written, read back bit for bit (all of it with
    8 threads, and one subject's rows), with the read's rate on the host."""
    from imagined_speech_decoding_tpu_torch.data import fastcache

    path = os.path.join(workdir, "corpus.eegc")
    flat = X.reshape(-1, *X.shape[2:])
    t0 = time.perf_counter()
    fastcache.write_cache(path, flat)
    write_s = time.perf_counter() - t0
    with fastcache.FastCache(path) as c:
        t0 = time.perf_counter()
        back = c.read_all(n_threads=8)
        read_s = time.perf_counter() - t0
        rows = c.read_rows(TRAIN_TRIALS, TRAIN_TRIALS)
    same = (np.array_equal(back.view(np.uint32), flat.view(np.uint32))
            and np.array_equal(rows.view(np.uint32), flat[TRAIN_TRIALS : 2 * TRAIN_TRIALS].view(np.uint32)))
    os.remove(path)
    if not same:
        raise RuntimeError("the native cache did not read the corpus back bit for bit")
    gb = flat.nbytes / 1e9
    print(f"native cache: {flat.shape} f32 ({gb:.2f} GB) written in {write_s:.2f} s, read back "
          f"bit for bit in {read_s:.3f} s ({gb / read_s:.2f} GB/s, 8 threads, page cache warm "
          f"from the write), one subject's rows too", flush=True)
    return {"gb": gb, "write_s": write_s, "read_s": read_s, "read_gb_s": gb / read_s}


REAL_TRIALS = (300, 50, 50)  # train, validation, test trials a subject (the dataset's)
REAL_EPOCHS = 30  # two segments of 15 (train.cv's _segment_length(30, 25))
REAL_CHECK_TRIALS = 8  # the first and last trials of each split, held against the plain chain
REAL_NOTCH, REAL_BAND = 60.0, (4.0, 40.0)  # cli/preprocess.py --notch 60 --bandpass 4 40
SPLIT_ORDER = ("test", "train", "valid")  # the preprocessing CLI's order (its HDF5 visit)
CHILD_FLAG = "--real-data-child"  # chip_smoke.py runs itself with it: one training run


def _tree_bytes(base: str) -> int:
    return sum(os.path.getsize(os.path.join(d, n)) for d, _, names in os.walk(base)
               for n in names)


def real_data_preprocess(base, workdir, written, have_h5py, dev, device_ms_at):
    """The preprocessing CLI's work on the fixture tree, on the card: with
    h5py, ``cli.preprocess`` itself; without, the functions it calls on
    the v5 splits (``load_training_set``, ``load_validation_set``) and on
    the test split's arrays, then ``filter_corpus`` a split, as its
    ``filter_h5`` does. Each split is held against the plain chain on its
    first and last trials, and timed by CUDA events; ``device_ms_at``
    holds the chain's device time at each split's row count, with the same
    filters on random data (phase_iir)."""
    from imagined_speech_decoding_tpu_torch.cli import preprocess
    from imagined_speech_decoding_tpu_torch.data import ingest
    from imagined_speech_decoding_tpu_torch.data.cache import check_split_shape
    from imagined_speech_decoding_tpu_torch.data.constants import SUBJECTS
    from imagined_speech_decoding_tpu_torch.ops.filters import filter_corpus

    filters = corpus_filters(SFREQ, REAL_NOTCH, REAL_BAND)
    raw_test = np.concatenate([ingest._edge_pad_time(written[("Test set", sid)][0])
                               for sid in SUBJECTS])
    reset_launches()
    if have_h5py:
        from imagined_speech_decoding_tpu_torch.data.cache import load_official_h5

        cache = os.path.join(workdir, "BCIC2020Track3.h5")
        timings = {}
        preprocess.main(["--data_folder", base, "--output", cache, "--layout", "official",
                         "--notch", str(REAL_NOTCH), "--bandpass", *map(str, REAL_BAND),
                         "--no-compress"], timings=timings)
        launches = read_launches()
        filtered = {k: torch.as_tensor(v[0]) for k, v in load_official_h5(cache).items()}
        raw = {"train": ingest.load_training_set(base, verbose=False)[0],
               "valid": ingest.load_validation_set(base, verbose=False)[0], "test": raw_test}
        event_ms = {s: timings[f"X_{s}/filter_ms"] for s in SPLIT_ORDER}
    else:
        t0 = time.perf_counter()
        splits = {"train": ingest.load_training_set(base, verbose=False, strict=True),
                  "valid": ingest.load_validation_set(base, verbose=False, strict=True)}
        labels = ingest.load_excel_labels(ingest.resolve_excel_path(base), strict=True)
        splits["test"] = (raw_test, np.concatenate([labels[sid] for sid in SUBJECTS]))
        timings = {"ingest_s": time.perf_counter() - t0}
        for split, (x, y) in splits.items():
            check_split_shape("the fixture's arrays", split, x.shape, y.shape)
        raw = {k: v[0] for k, v in splits.items()}
        filtered, event_ms = {}, {}
        for split in SPLIT_ORDER:
            t0 = time.perf_counter()
            x = torch.from_numpy(raw[split]).to(dev)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            y = filter_corpus(x, REAL_NOTCH, REAL_BAND)
            end.record()
            end.synchronize()
            event_ms[split] = start.elapsed_time(end)
            filtered[split] = y.cpu()
            timings[f"X_{split}"] = time.perf_counter() - t0
        launches = read_launches()
    if launches["iir_chain"] < 3:
        raise RuntimeError(f"the preprocessing path made {launches['iir_chain']} B1 chain "
                           "launches, one a split expected")
    print(f"real-data path, preprocessing: B1 chain launches {launches['iir_chain']} "
          f"(h5py {'present: cli.preprocess' if have_h5py else 'absent: its functions'}); "
          f"ingest {timings['ingest_s']:.2f} s (scipy loadmat of the v5 splits"
          + (", h5py of the test split" if have_h5py else "") + ")"
          + (f", cache write {timings['write_s']:.2f} s" if have_h5py else ""), flush=True)
    out = {"launches": launches["iir_chain"], "splits": {}}
    for split in SPLIT_ORDER:
        x, y = raw[split], filtered[split]
        n = x.shape[0]
        idx = np.r_[0:REAL_CHECK_TRIALS, n - REAL_CHECK_TRIALS:n]
        ref = sosfiltfilt_chain_plain(filters, torch.from_numpy(x[idx]).to(dev))
        err = check_close(f"preprocessing {split} split, B1 vs plain", y[idx].to(dev), ref,
                          IIR_RTOL, IIR_RTOL * float(ref.abs().max()))
        rows = n * 64
        x_dev = torch.from_numpy(x).to(dev)
        steady_ms = cuda_ms(lambda: sosfiltfilt_chain(filters, x_dev), 3)
        dev_ms = device_ms_at[rows]
        bound, by = chain_bound(rows, filters)
        out["splits"][split] = {"rows": rows, "path_ms": event_ms[split], "ms": steady_ms,
                                "device_ms": dev_ms, "bound_ms": bound, "bound_by": by,
                                "max_abs_err": err, "host_s": timings[f"X_{split}"]}
        print(f"  {split}: R = {rows} rows x 800: the path's call {event_ms[split]:.4f} ms by "
              f"CUDA events (filter design included); 3 more launches on the split "
              f"{steady_ms:.4f} ms by events; {dev_ms:.4f} ms device time (B1 phase, same shape "
              f"and filters, random data); bound {bound:.4f} ms "
              f"({by}): {bound / dev_ms:.1%} of it; host {timings[f'X_{split}']:.2f} s with the "
              f"copies; first and last {REAL_CHECK_TRIALS} trials vs plain max|err| {err:.3g}",
              flush=True)
        del x_dev
    return out


def real_data_child(argv) -> None:
    """One training run in its own process (so that a run can be killed):
    ``cli.train_fast`` with ``argv``, on the fixture tree (the real-data
    path) or synthetic data (the ensemble phase). Without h5py the fixture's
    test split comes from the arrays that ``test_npz`` holds (the v7.3 files
    need h5py), labelled by the answer sheet. Writes ``child.json``
    (launches, timings) and ``fit.npz`` (history, best epochs and
    accuracies; an ensemble's member 0's) into the output directory."""
    test_npz, argv = argv[0], argv[1:]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if test_npz:
        from imagined_speech_decoding_tpu_torch.data import ingest

        def test_split(base, excel, verbose=True, strict=False):
            labels = ingest.load_excel_labels(excel, strict=strict)
            with np.load(test_npz) as f:
                return {sid: (ingest._edge_pad_time(f[sid]), labels[sid]) for sid in f.files}

        ingest.load_test_set_per_subject = test_split
    t0 = time.perf_counter()
    result = train_fast.main(argv)
    wall = time.perf_counter() - t0
    out = argv[argv.index("--output_dir") + 1]
    first = result.members[0] if hasattr(result, "members") else result  # an ensemble's member 0
    t = {**first.timings, **result.timings}
    with open(os.path.join(out, "child.json"), "w") as f:
        json.dump({"launches": read_launches(), "wall_s": wall,
                   "timings": {k: t[k] for k in ("data_s", "fit_s", "artifacts_s",
                                                 "checkpoint_write_s", "checkpoint_bytes",
                                                 "train_s")}}, f)
    np.savez(os.path.join(out, "fit.npz"), best_epoch=first.fit.best_epoch,
             best_val_acc=first.fit.best_val_acc,
             **{f"history_{k}": v for k, v in first.fit.history.items()})


def _child(base, out, test_npz, resume=False):
    """The command of one real-data training run."""
    argv = ["--data_folder", base, "--epochs", str(REAL_EPOCHS), "--output_dir", out]
    return [sys.executable, os.path.abspath(__file__), CHILD_FLAG, test_npz, *argv] + \
        (["--resume"] if resume else [])


def _run_child(cmd, log):
    t0 = time.perf_counter()
    with open(log, "w") as f:
        proc = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT, timeout=600)
    if proc.returncode:
        with open(log) as f:
            tail = f.read()[-3000:]
        raise RuntimeError(f"training run {' '.join(cmd[-6:])} failed ({proc.returncode}):\n{tail}")
    return time.perf_counter() - t0


def real_data_training(base, workdir, test_npz):
    """``cli.train_fast`` on the fixture tree, bf16, 30 epochs in two
    segments of 15: once uninterrupted; once killed (SIGKILL) in its
    second segment after the first segment's checkpoint is in place, then
    run again with ``--resume``. The resumed run must equal the
    uninterrupted one bit for bit."""
    import signal

    full = os.path.join(workdir, "results", "FAST")
    killed = os.path.join(workdir, "killed")
    wall_full = _run_child(_child(base, full, test_npz), os.path.join(workdir, "full.log"))
    carry = os.path.join(killed, "checkpoints", "segment_carry.npz")
    t0 = time.perf_counter()
    with open(os.path.join(workdir, "killed.log"), "w") as log:
        proc = subprocess.Popen(_child(base, killed, test_npz), stdout=log,
                                stderr=subprocess.STDOUT)
        try:
            while not os.path.exists(carry):
                if proc.poll() is not None:
                    raise RuntimeError(f"the run to be killed ended ({proc.returncode}) before "
                                       "its first segment checkpoint")
                if time.perf_counter() - t0 > 600:
                    raise RuntimeError("no segment checkpoint after 600 s")
                time.sleep(0.01)
            proc.send_signal(signal.SIGKILL)
            proc.wait()
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall_killed = time.perf_counter() - t0
    with np.load(carry) as f:
        at = (int(f["meta.next_segment"]), int(f["carry.epoch"]))
    if proc.returncode != -signal.SIGKILL or at != (1, REAL_EPOCHS // 2) \
            or os.path.exists(os.path.join(killed, "summary_per_subject.csv")):
        raise RuntimeError(f"the kill did not land in the second segment: rc {proc.returncode}, "
                           f"checkpoint at segment {at[0]}, epoch {at[1]}")
    wall_resumed = _run_child(_child(base, killed, test_npz, resume=True),
                              os.path.join(workdir, "resumed.log"))

    runs = {}
    for name, out in (("uninterrupted", full), ("resumed", killed)):
        with open(os.path.join(out, "child.json")) as f:
            runs[name] = json.load(f)
        launches = runs[name]["launches"]
        if any(launches[k] < 1 for k in HEAD_KERNELS["bf16"]) or \
                any(launches[k] for k in HEAD_KERNELS["f32"]) or launches["conv4head_bwd_x"]:
            raise RuntimeError(f"the {name} real-data run's head launches: {launches}")
        require_unadapted(launches, f"real-data training ({name})")
    with np.load(os.path.join(full, "fit.npz")) as a, np.load(os.path.join(killed, "fit.npz")) as b:
        for k in a.files:
            if not np.array_equal(a[k], b[k], equal_nan=True):
                raise RuntimeError(f"resumed run differs from the uninterrupted one in {k}")
        history = a["history_val_acc"]
    if history.shape != (75, REAL_EPOCHS) or not np.isfinite(history).all():
        raise RuntimeError(f"real-data history: shape {history.shape}")
    for rel in ("summary_per_subject.csv", "global_test_predictions.csv",
                "sub-07/fold-3_history.csv"):
        with open(os.path.join(full, rel)) as f, open(os.path.join(killed, rel)) as g:
            if f.read() != g.read():
                raise RuntimeError(f"resumed run's {rel} differs from the uninterrupted run's")
    with np.load(os.path.join(full, "sub-15", "best_subject.npz")) as a, \
            np.load(os.path.join(killed, "sub-15", "best_subject.npz")) as b:
        if sorted(a.files) != sorted(b.files) or \
                any(not np.array_equal(a[k], b[k]) for k in a.files):
            raise RuntimeError("resumed run's sub-15/best_subject.npz differs")
    u, r = runs["uninterrupted"], runs["resumed"]
    ut, rt = u["timings"], r["timings"]
    print(f"real-data path, training: 75 models, {REAL_EPOCHS} epochs in 2 segments, bf16; the "
          f"run killed (SIGKILL) in segment 2 after {wall_killed:.2f} s and resumed from epoch "
          f"{REAL_EPOCHS // 2} equals the uninterrupted run bit for bit (history, best epochs and "
          f"accuracies, "
          f"summary_per_subject.csv, global predictions, sub-15/best_subject.npz); adapted 0; "
          f"launches (uninterrupted) {u['launches']}", flush=True)
    print(f"  carry {ut['checkpoint_bytes']} bytes ({ut['checkpoint_bytes'] / 1e6:.1f} MB); "
          f"checkpoint writes (background thread): uninterrupted "
          + ", ".join(f"{w:.3f}" for w in ut["checkpoint_write_s"]) + " s; resumed "
          + ", ".join(f"{w:.3f}" for w in rt["checkpoint_write_s"]) + " s", flush=True)
    print(f"  wall (process start to exit): uninterrupted {wall_full:.2f} s (data {ut['data_s']:.2f},"
          f" fit {ut['fit_s']:.2f}, artifacts + test {ut['artifacts_s']:.2f}); killed "
          f"{wall_killed:.2f} s + resumed {wall_resumed:.2f} s (data {rt['data_s']:.2f}, fit "
          f"{rt['fit_s']:.2f} for {len(rt['train_s'])} epochs, artifacts + test "
          f"{rt['artifacts_s']:.2f}); mean val_acc {history[:, -1].mean():.4f}", flush=True)
    return {"uninterrupted": u, "resumed": r, "wall_s": (wall_full, wall_killed, wall_resumed)}


def real_data_benchmark(workdir) -> None:
    """``cli.benchmark`` over the uninterrupted run's result tree."""
    import csv

    from imagined_speech_decoding_tpu_torch.cli import benchmark

    def read_csv(path):
        with open(path, newline="") as f:
            rows = list(csv.reader(f))
        return {c: [r[i] for r in rows[1:]] for i, c in enumerate(rows[0])}

    results = os.path.join(workdir, "results")
    (summary,) = benchmark.main(["--results_dir", results, "--models", "FAST"])
    for name in ("FAST_Subject_Metrics.csv", "Model_Summary.csv"):
        if not os.path.isfile(os.path.join(results, name)):
            raise RuntimeError(f"cli.benchmark wrote no {name}")
    rows = read_csv(os.path.join(results, "FAST", "summary_per_subject.csv"))
    acc = np.mean([float(v) for v in rows["Test_Acc"]])
    written = read_csv(os.path.join(results, "Model_Summary.csv"))
    if abs(float(written["Acc_Mean"][0]) - acc) > 1e-12 or summary["Acc_Mean"] != \
            float(written["Acc_Mean"][0]):
        raise RuntimeError(f"Acc_Mean {written['Acc_Mean'][0]} is not the mean of the subjects' "
                           f"test accuracies, {acc}")
    print(f"real-data path, benchmark: FAST_Subject_Metrics.csv and Model_Summary.csv written; "
          f"Acc_Mean {summary['Acc_Mean']:.4f} = mean of summary_per_subject.csv's Test_Acc; "
          f"global acc {summary['Global_Acc']:.4f}, one-sided p {summary['P_Value_OneSided']:.3g}",
          flush=True)


def phase_real_data(dev, device_ms_at):
    """The real-data path: a raw tree at the documented schema (15
    subjects, 300 / 50 / 50 trials of 64 x 795 samples, an ``.xlsx``
    answer sheet), preprocessed on the card, trained with a kill and a
    resume, benchmarked, and its 15 best checkpoints' zero-shot transfer
    matrix on the test split."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from bcic_fixture import SUBJECTS, write_tree

    try:
        import h5py  # noqa: F401
        have_h5py = True
    except ImportError:
        have_h5py = False
        print("h5py: absent; the v7.3 test split and the HDF5 caches are held on the CPU "
              "tier only", flush=True)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        base = os.path.join(workdir, "BCIC2020Track3")
        t0 = time.perf_counter()
        written = write_tree(base, SUBJECTS, REAL_TRIALS, test_files=have_h5py)
        test_npz = ""
        if not have_h5py:
            test_npz = os.path.join(workdir, "test_split.npz")
            np.savez(test_npz, **{sid: written[("Test set", sid)][0] for sid in SUBJECTS})
        print(f"real-data path: fixture tree of {len(SUBJECTS)} subjects x {REAL_TRIALS} trials "
              f"x 64 x 795 written in {time.perf_counter() - t0:.2f} s "
              f"({_tree_bytes(base) / 1e9:.2f} GB)", flush=True)
        pre = real_data_preprocess(base, workdir, written, have_h5py, dev, device_ms_at)
        from imagined_speech_decoding_tpu_torch.data import ingest

        labels = ingest.load_excel_labels(ingest.resolve_excel_path(base), strict=True)
        tests = [(ingest._edge_pad_time(written[("Test set", sid)][0]), labels[sid])
                 for sid in SUBJECTS]
        del written
        train = real_data_training(base, workdir, test_npz)
        real_data_benchmark(workdir)
        zero = phase_zero_shot(FASTConfig.default(), dev, os.path.join(workdir, "results", "FAST"),
                               tests)
    print(f"real-data path: {time.perf_counter() - t_phase:.1f} s in all", flush=True)
    return pre, train, zero


BN_HEADS = ("CVBlock", "EEGNet_Encoder", "HeadConv_Paper_Version")
BN_FIRST = {"CVBlock": "bn1", "EEGNet_Encoder": "bn1", "HeadConv_Paper_Version": "norm1"}
TS_BATCH = 32  # cli.train_tsception's batch
KERNEL_KEYS = ("iir_chain", "iir", "conv4head_fwd", "conv4head_bwd_w", "conv4head_bwd_x",
               "conv4head_fwd_bf16", "conv4head_bwd_w_bf16", "conv4head_bwd_x_bf16") + GENERAL_KEYS


def check_result_tree(out: str, subjects, state_keys, what: str) -> None:
    """The CLI's result tree under ``out``, every ``best_subject.npz`` with
    the model state's keys (``state.head.bn1.mean`` ...) beside the weights."""
    expected = [os.path.join(out, n) for n in
                ("summary_per_subject.csv", "global_test_predictions.csv")]
    for sid in subjects:
        expected += [os.path.join(out, f"sub-{sid}", n) for n in
                     [f"fold-{k}_history.csv" for k in range(5)]
                     + ["fold_metrics.csv", "best_subject.npz", "test_predictions.csv"]]
    missing = [p for p in expected if not os.path.isfile(p)]
    if missing:
        raise RuntimeError(f"{what}: result tree incomplete: {missing[:5]}")
    for sid in subjects:
        with np.load(os.path.join(out, f"sub-{sid}", "best_subject.npz")) as f:
            lacking = set(state_keys) - set(f.files)
            if lacking or not all(np.isfinite(f[k]).all() for k in state_keys):
                raise RuntimeError(f"{what}: sub-{sid}'s best_subject.npz lacks or has "
                                   f"non-finite state {sorted(lacking)[:4]}")


def reproduce_predictions(mdef, out: str, sid: str, x_test: np.ndarray, dtype, dev,
                          batch: int, what: str) -> int:
    """``sub-<sid>/best_subject.npz`` (weights and state) in one model on the
    card reproduces the subject's ``test_predictions.csv``."""
    sd = mdef.build(None).state_dict()
    template = mdef.dump(sd)
    params, state, had_state = load_model_npz(os.path.join(out, f"sub-{sid}", "best_subject.npz"),
                                              *template)
    if not had_state:
        raise RuntimeError(f"{what}: sub-{sid}'s checkpoint has no state")
    model = mdef.build(None, dev)
    mdef.load(model, params, state)
    y_pred = engine.predict(model, torch.tensor(x_test, dtype=dtype, device=dev), batch)
    saved, _ = load_predictions_csv(os.path.join(out, f"sub-{sid}", "test_predictions.csv"))
    if not np.array_equal(y_pred, saved):
        raise RuntimeError(f"{what}: sub-{sid}'s best_subject.npz (weights and state) does not "
                           "reproduce its test_predictions.csv")
    return len(saved)


def report_fit(what: str, result, wall: float, peak_gb: float) -> dict:
    t = result.timings
    acc = [row["Test_Acc"] for row in result.summary]
    for ep, (tr, va) in enumerate(zip(t.get("train_s", []), t.get("val_s", []))):
        print(f"  {what} epoch {ep}: train pass {tr:.3f} s, validation {va:.3f} s", flush=True)
    print(f"{what}: {wall:.2f} s in all (fit {t['fit_s']:.2f} s, artifacts + test eval "
          f"{t['artifacts_s']:.2f} s); peak allocated device memory {peak_gb:.2f} GB; mean val_acc "
          f"{np.nanmean(result.fit.history['val_acc'][:, -1]):.4f}, mean test acc "
          f"{np.mean(acc):.4f}", flush=True)
    return {"wall_s": wall, "fit_s": t["fit_s"], "peak_gb": peak_gb}


def phase_bn_heads(cfg, dev, X, Y, workdir):
    """(a) The batch-norm heads at full width in bf16 (the default): 15 x 350
    trials, 75 models, batch 64, 2 epochs. CVBlock through
    ``cli.train_fast --head CVBlock`` (its ``load_data`` handed the corpus
    it would generate, which the caller made once), EEGNet_Encoder and
    HeadConv_Paper_Version through ``train_per_subject_cv`` on the same
    corpus and test split. No hand-written kernel runs (the heads are
    cuDNN convolutions and plain tensor code); the history is finite, the
    tree complete with the state in every ``best_subject.npz``, and the
    last subject's reproduces its test predictions."""
    from imagined_speech_decoding_tpu_torch.models.api import make_fast_model

    subjects = [f"{i + 1:02d}" for i in range(TRAIN_SUBJECTS)]
    n_test = TRAIN_TRIALS // 3
    test = {sid: (X[i, :n_test], Y[i, :n_test]) for i, sid in enumerate(subjects)}
    rows, outs = {}, {}
    for head in BN_HEADS:
        hcfg = dataclasses.replace(cfg, head=head)
        out = outs[head] = os.path.join(workdir, f"heads_{head}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        if head == "CVBlock":
            argv = ["--synthetic", str(TRAIN_SUBJECTS), "--synthetic_trials", str(TRAIN_TRIALS),
                    "--epochs", str(TRAIN_EPOCHS), "--head", head, "--output_dir", out]
            print(f"heads: cli.train_fast {' '.join(argv[:-1])} <tmp>", flush=True)
            load_data = train_fast.load_data
            train_fast.load_data = lambda args: (X, Y, subjects, test)
            try:
                result = train_fast.main(argv)
            finally:
                train_fast.load_data = load_data
        else:
            print(f"heads: train_per_subject_cv, {head}, bf16, the same corpus", flush=True)
            result = train_per_subject_cv(hcfg, TrainConfig(max_epochs=TRAIN_EPOCHS), X, Y,
                                          subjects, cfg.n_classes, test_per_subject=test,
                                          save_dir=out, device=dev, verbose=False,
                                          checkpoint_dir=os.path.join(out, "checkpoints"))
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        launches = read_launches()
        if any(launches[k] for k in KERNEL_KEYS):
            raise RuntimeError(f"heads {head}: a hand-written kernel launched: {launches}")
        for k, v in result.fit.history.items():
            if v.shape != (TRAIN_SUBJECTS * 5, TRAIN_EPOCHS) or not np.isfinite(v).all():
                raise RuntimeError(f"heads {head}: history {k} {v.shape}")
        bn1 = BN_FIRST[head]
        first = result.fit.best_model_state[f"head.{bn1}.mean"]
        if not torch.isfinite(first).all() or not first.abs().max() > 0:
            raise RuntimeError(f"heads {head}: the best snapshot's running mean did not move")
        check_result_tree(out, subjects, (f"state.head.{bn1}.mean", f"state.head.{bn1}.var"),
                          f"heads {head}")
        si = TRAIN_SUBJECTS - 1
        n = reproduce_predictions(make_fast_model(hcfg), out, subjects[si], X[si, :n_test],
                                  torch.bfloat16, dev, TRAIN_BATCH, f"heads {head}")
        print(f"heads {head}: no hand-written kernel launched; history finite; the tree and "
              f"every best_subject.npz's state written; sub-{subjects[si]}'s reproduces its "
              f"{n} test predictions", flush=True)
        rows[head] = report_fit(f"heads {head} (bf16, M={TRAIN_SUBJECTS * 5})", result, wall, peak)
        del result
    return rows, outs


def phase_tsception(dev, X, Y, workdir):
    """(b) ``cli.train_tsception --synthetic 15 --synthetic_trials 350
    --epochs 2 --subject_group 15``: all 75 models of the 15 subjects in
    one stack (the CLI's default of 1 subject a group would run 15 stacks
    of 5), f32, batch 32; the tree with the state, the last subject's
    checkpoint reproducing its predictions, the peak memory. The CLI's
    ``load_data`` is handed the training path's corpus (its own synthetic
    corpus has seed 1; the shapes and the test split's rule, each
    subject's first 20 trials, are its own), saving the ~15 s of numpy
    that generating it takes."""
    from imagined_speech_decoding_tpu_torch.cli import train_tsception

    subjects = [f"{i + 1:02d}" for i in range(TRAIN_SUBJECTS)]
    test = {sid: (X[i, :20], Y[i, :20]) for i, sid in enumerate(subjects)}

    out = os.path.join(workdir, "tsception")
    argv = ["--synthetic", str(TRAIN_SUBJECTS), "--synthetic_trials", str(TRAIN_TRIALS),
            "--epochs", str(TRAIN_EPOCHS), "--subject_group", str(TRAIN_SUBJECTS),
            "--output_dir", out]
    print(f"tsception: cli.train_tsception {' '.join(argv[:-1])} <tmp>", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    load_data = train_tsception.load_data
    train_tsception.load_data = lambda args: (X, Y, subjects, test)
    try:
        t0 = time.perf_counter()
        result = train_tsception.main(argv)
        wall = time.perf_counter() - t0
    finally:
        train_tsception.load_data = load_data
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = read_launches()
    if any(launches[k] for k in KERNEL_KEYS):
        raise RuntimeError(f"tsception: a hand-written kernel launched: {launches}")
    for k, v in result.fit.history.items():
        if v.shape != (TRAIN_SUBJECTS * 5, TRAIN_EPOCHS) or not np.isfinite(v).all():
            raise RuntimeError(f"tsception: history {k} {v.shape}")
    check_result_tree(out, subjects, ("state.bn_t.mean", "state.bn_t.var", "state.bn_s.mean",
                                      "state.bn_s.var"), "tsception")
    si = TRAIN_SUBJECTS - 1
    n = reproduce_predictions(make_tsception_model(64, 800), out, subjects[si], X[si, :20],
                              torch.float32, dev, TS_BATCH, "tsception")
    print(f"tsception: history finite; the tree and every best_subject.npz's state written; "
          f"sub-{subjects[si]}'s reproduces its {n} test predictions", flush=True)
    return report_fit(f"tsception (f32, M={TRAIN_SUBJECTS * 5})", result, wall, peak)


def phase_augment(cfg, dev, X, Y, workdir) -> dict:
    """(c) ``cli.train_fast --augment`` (its ``load_data`` handed the same
    corpus), bf16, Conv4Layers, 2 epochs: B2f-bf16 and B2w-bf16 launch as
    the batches count them (plus the test predictions' forwards), nothing
    adapted; an evaluation of the trained stack on the f32 corpus cast per
    batch equals the un-augmented evaluation on the bf16 corpus bit for
    bit."""
    subjects = [f"{i + 1:02d}" for i in range(TRAIN_SUBJECTS)]
    n_test = TRAIN_TRIALS // 3
    test = {sid: (X[i, :n_test], Y[i, :n_test]) for i, sid in enumerate(subjects)}
    out = os.path.join(workdir, "augment")
    argv = ["--synthetic", str(TRAIN_SUBJECTS), "--synthetic_trials", str(TRAIN_TRIALS),
            "--epochs", str(TRAIN_EPOCHS), "--augment", "--output_dir", out]
    print(f"augment: cli.train_fast {' '.join(argv[:-1])} <tmp>", flush=True)
    reset_launches()
    load_data = train_fast.load_data
    train_fast.load_data = lambda args: (X, Y, subjects, test)
    try:
        t0 = time.perf_counter()
        result = train_fast.main(argv)
        wall = time.perf_counter() - t0
    finally:
        train_fast.load_data = load_data
    launches = read_launches()
    n_train, n_val = TRAIN_TRIALS * 4 // 5, TRAIN_TRIALS // 5
    fwd, bwd = expected_head_launches(TRAIN_EPOCHS, n_train, n_val, TRAIN_BATCH)
    fwd += TRAIN_SUBJECTS * -(-n_test // TRAIN_BATCH)  # the test predictions, one model a subject
    require_bf16_launches(launches, (fwd, bwd), "augment")
    for k, v in result.fit.history.items():
        if not np.isfinite(v).all():
            raise RuntimeError(f"augment: history {k} not finite")
    m = TRAIN_SUBJECTS * 5
    model = FAST(cfg, n_models=m, device=dev)
    model.load_state_dict(result.fit.params)
    _, vidx, _ = build_cv_index_stack(TRAIN_SUBJECTS, TRAIN_TRIALS, 5, 42)
    x32 = torch.as_tensor(X.reshape(-1, 64, 800), device=dev)
    y = torch.as_tensor(Y.reshape(-1).astype(np.int64), device=dev)
    idx = torch.as_tensor(vidx, device=dev)
    eb = engine.eval_batch_size_for(n_val, TRAIN_BATCH)
    got = engine.evaluate(model, x32, y, idx, eb, cfg.n_classes, torch.bfloat16)
    want = engine.evaluate(model, x32.to(torch.bfloat16), y, idx, eb, cfg.n_classes)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise RuntimeError("augment: the evaluation of the f32 corpus cast per batch differs "
                           "from the un-augmented evaluation of the bf16 corpus")
    print(f"augment: {wall:.2f} s; B2f-bf16 / B2w-bf16 launched {fwd} / {bwd} times as the "
          f"batches count them, nothing adapted; the evaluation (val loss "
          f"{float(got[0].mean()):.4f}) equals the un-augmented one bit for bit", flush=True)
    del x32
    return {"wall_s": wall, **{k: launches[k] for k in ("conv4head_fwd_bf16",
                                                         "conv4head_bwd_w_bf16")}}


def phase_stateful_decoders(cfg, dev, rng, results_dir) -> dict:
    """(d) A live decoder and a fleet over the 15 CVBlock checkpoints of (a)
    (f32 serving, weights and running statistics from the files): at B = 1
    and 8, a replay equals the eager chain bit for bit; the eager decodes
    each launch B1's chain once and the captures record one each, and no
    head kernel runs; the posteriors match the plain CPU decoders (rtol
    1e-4, atol 1e-5); after ``swap_weights(params, state)`` a replay
    equals a fresh decoder on the new weights and statistics."""
    from imagined_speech_decoding_tpu_torch.train.checkpoint import select_model

    hcfg = dataclasses.replace(cfg, head="CVBlock")
    paths = [os.path.join(results_dir, f"sub-{i + 1:02d}", "best_subject.npz")
             for i in range(FLEET_MODELS)]
    params, state = stack_checkpoints(paths, FAST(hcfg))
    p0, s0 = select_model(params, 0), select_model(state, 0)
    p1, s1 = select_model(params, 1), select_model(state, 1)
    reset_launches()
    live = make_online_decoder(FAST(hcfg, device=dev), p0, s0)
    fleet = make_fleet_decoder(FAST(hcfg, n_models=FLEET_MODELS, device=dev), params, state)
    cpu_live = make_online_decoder(FAST(hcfg), p0, s0)
    cpu_fleet = make_fleet_decoder(FAST(hcfg, n_models=FLEET_MODELS), params, state)
    xs = {b: rng.normal(size=(b, 64, 800)).astype(np.float32) for b in (1, MAIN_BATCH)}
    cases = (("live", live, cpu_live), ("fleet", fleet, cpu_fleet),
             ("fleet ensemble", fleet.ensemble, cpu_fleet.ensemble))
    outs = {(name, b): (dec(x), dec(x)) for name, dec, _ in cases for b, x in xs.items()}
    decoders = {"live": live, "fleet": fleet, "fleet ensemble": fleet.ensemble}
    launches = read_launches()  # the decodes' alone: the eager chains below launch B1 too
    worst = 0.0
    for name, dec, ref in cases:
        for b, x in xs.items():
            first, replay = outs[(name, b)]
            if not (np.array_equal(replay, eager(dec, x)) and np.array_equal(first, replay)):
                raise RuntimeError(f"stateful {name} B={b}: the replay differs from the eager "
                                   "chain")
            want = ref(x)
            check_posteriors(replay, want)
            worst = max(worst, float(np.abs(replay - want).max()))
    runs = sum(d.eager for d in decoders.values())
    captures = sum(len(d.graphs) for d in decoders.values())
    if (launches["iir_chain"], launches["iir_chain_captures"]) != (runs, captures) or any(
            launches[k] for k in KERNEL_KEYS if k != "iir_chain"):
        raise RuntimeError(f"stateful decoders: {runs} eager decodes and {captures} captures "
                           f"must launch / record one B1 chain each and nothing else: {launches}")
    live.swap_weights(p1, s1)
    swapped = (stack_trees([p1] + [select_model(params, i) for i in range(1, FLEET_MODELS)]),
               stack_trees([s1] + [select_model(state, i) for i in range(1, FLEET_MODELS)]))
    fleet.swap_weights(*swapped)
    fresh_live = make_online_decoder(FAST(hcfg, device=dev), p1, s1)
    fresh_fleet = make_fleet_decoder(FAST(hcfg, n_models=FLEET_MODELS, device=dev), *swapped)
    for name, dec, fresh in (("live", live, fresh_live), ("fleet", fleet, fresh_fleet),
                             ("fleet ensemble", fleet.ensemble, fresh_fleet.ensemble)):
        for b, x in xs.items():
            before = dec.replays
            if not np.array_equal(dec(x), fresh(x)) or dec.replays != before + 1:
                raise RuntimeError(f"stateful {name} B={b}: after swap_weights(params, state) "
                                   "the replay differs from a fresh decoder")
    print(f"stateful decoders (CVBlock, 15 checkpoints of the heads run): live, fleet and "
          f"ensemble at B = 1 and {MAIN_BATCH}: replays == eager bit for bit; {runs} eager decodes "
          f"= {launches['iir_chain']} B1 chain launches, {captures} captures recorded one each; "
          f"posteriors match the CPU decoders (max|err| {worst:.3g}, rtol {POST_RTOL}, atol "
          f"{POST_ATOL}); after swap_weights(params, state) replays equal fresh decoders bit for "
          "bit", flush=True)
    return {"iir_chain": launches["iir_chain"], "iir_chain_captures": captures,
            "replays": sum(d.replays for d in decoders.values())}


# The running mean that follows a bias whose exact gradient is 0, the bias,
# and the spatial conv between them: (state key, bias key, weight key).
SHIFTED_MEANS = {"CVBlock": ("head.bn2.mean", "head.bn1.bias", "head.conv2.w"),
                 "EEGNet_Encoder": ("head.bn2.mean", "head.bn1.bias", "head.spatial.w"),
                 "HeadConv_Paper_Version": ("head.norm1.mean", "head.cnn1_t.b", "head.cnn1_s.w")}


def shifted_mean_bound(name: str, params: dict, mask: torch.Tensor, lr_sum: float):
    """How far the card's and the CPU's values of ``SHIFTED_MEANS[name]``'s
    running mean may part, per element. The bias in front of a batch norm
    has an exact gradient of 0; AdamW moves it by up to lr a step whatever
    its gradient's size, so its rounding-noise gradient moves it up to
    ``lr_sum`` from the start in a direction of its own on each device:
    the two differ by at most ``2 * lr_sum``. The spatial conv carries a
    shift d of its input channel f to its output channel o as d * sum_c
    w[o, f, c] over the real rows c, and each weight is within ``lr_sum``
    of its final value, so the batch mean of o moves by at most ``2 *
    lr_sum * sum_f sum_c (|w[o, f, c]| + lr_sum)``; the running mean, a
    convex mix of its start and the batch means, moves by no more.
    ``params``: one device's final (or best) parameters; ``mask (Z, C)``."""
    _, _, wkey = SHIFTED_MEANS[name]
    w = params[wkey].cpu()
    m, z, o, f, c = w.shape[:5]  # (M, Z, O, F, C, 1); F = 1 for a depthwise conv
    rows = mask.cpu().to(w.dtype).reshape(1, z, 1, 1, c)
    per_out = ((w.reshape(m, z, o, f, c).abs() + lr_sum) * rows).sum(dim=(3, 4))
    return 2 * lr_sum * per_out  # (M, Z, O), the running mean's shape


def phase_trajectory_stateful(cfg, dev) -> dict:
    """Card against CPU for each batch-norm head and for TSception, f32 with
    TF32 off (cuBLAS and cuDNN): 2 subjects x 10 trials (10 models, 8 + 2
    trials, batch 8: one step an epoch), 2 epochs, dropout off (the
    trunk's, and the heads' and TSception's fixed rates, so that the runs
    draw nothing), the same weights and CPU-generator permutations: the
    history at rtol 1e-4 / atol 1e-5, the running statistics after the
    first step (both devices' parameters still equal) at the same
    tolerance, every parameter within twice the summed learning rate, and
    the final and best running statistics at the same tolerance, except
    the running means that follow a bias of exact gradient 0
    (``SHIFTED_MEANS``), which are held within ``shifted_mean_bound``."""
    from imagined_speech_decoding_tpu_torch.models import heads as heads_mod
    from imagined_speech_decoding_tpu_torch.models.api import make_fast_model

    x, y = synthetic_corpus(SEED, 2, 10, 64, 800)
    tidx, vidx, _ = build_cv_index_stack(2, 10, 5, 42)
    m = tidx.shape[0]
    saved = heads_mod.CVBlockHead.DROPOUT, heads_mod.EEGNetEncoderHead.DROPOUT
    heads_mod.CVBlockHead.DROPOUT = heads_mod.EEGNetEncoderHead.DROPOUT = 0.0
    rows = {}
    try:
        cases = [(h, make_fast_model(dataclasses.replace(cfg, head=h, dropout=0.0)), 0.01)
                 for h in BN_HEADS]
        cases.append(("TSception", make_tsception_model(64, 800, dropout=0.0), 0.0))
        for name, mdef, wd in cases:
            p0, s0 = mdef.init(42, m)
            runs, first = {}, {}
            t0 = time.perf_counter()
            for device, d in (("card", dev), ("cpu", torch.device("cpu"))):
                model = mdef.build(m, d)
                mdef.load(model, p0, s0)
                fit = engine.make_fit(model, cfg.n_classes, epochs=2, batch_size=8, n_train=8,
                                      n_val=2, learning_rate=1e-3, warmup_epochs=0,
                                      weight_decay=wd)
                xd = torch.as_tensor(x.reshape(-1, 64, 800), device=d)
                yd = torch.as_tensor(y.reshape(-1).astype(np.int64), device=d)
                carry = fit.init_carry(tidx, vidx, xd, seed=43)
                fit.run(carry, xd, yd, until=1)
                first[device] = {k: b.detach().cpu().clone() for k, b in carry.buffers.items()}
                runs[device] = fit.result(fit.run(carry, xd, yd, until=2))
            gpu, cpu = runs["card"], runs["cpu"]
            for k in engine.HISTORY_KEYS:
                np.testing.assert_allclose(gpu.history[k], cpu.history[k], rtol=TRAJ_RTOL,
                                           atol=TRAJ_ATOL, err_msg=f"{name} history {k}")
            if sorted(first["card"]) != sorted(first["cpu"]) or not first["card"]:
                raise RuntimeError(f"{name}: running-statistics keys {sorted(first['card'])}")
            stat_err = max(check_close(f"{name} running statistics after the first step {k}",
                                       first["card"][k], first["cpu"][k], TRAJ_RTOL, TRAJ_ATOL)
                           for k in first["card"])
            lr_sum = float(np.sum(fit.lr_table))
            budget = 2 * lr_sum
            final, shifted, bound_max = {}, SHIFTED_MEANS.get(name, (None,))[0], 0.0
            for which, pwhich in (("model_state", "params"), ("best_model_state", "best_params")):
                a_all, b_all = getattr(gpu, which), getattr(cpu, which)
                if sorted(a_all) != sorted(b_all) or not a_all:
                    raise RuntimeError(f"{name}: {which} keys {sorted(a_all)}")
                for k in a_all:
                    a, b = a_all[k].cpu(), b_all[k]
                    tol = TRAJ_ATOL + TRAJ_RTOL * b.abs()
                    if k == shifted:
                        bound = shifted_mean_bound(name, getattr(cpu, pwhich),
                                                   model.head.zone_mask, lr_sum)
                        bound_max = max(bound_max, float(bound.max()))
                        tol = tol + bound
                    far = int(((a - b).abs() > tol).sum())
                    final[f"{which}.{k}"] = (far, float((a - b).abs().max()))
                    if far:
                        raise RuntimeError(
                            f"{name}: {far} of {b.numel()} elements of the {which} {k} beyond "
                            f"rtol {TRAJ_RTOL}, atol {TRAJ_ATOL}"
                            + (" plus the bias shift's bound" if k == shifted else "")
                            + f"; max|card - CPU| {final[f'{which}.{k}'][1]:.3g}")
            worst = 0.0
            for which in ("params", "best_params"):
                a_all, b_all = getattr(gpu, which), getattr(cpu, which)
                for k in a_all:
                    worst = max(worst, float((a_all[k].cpu() - b_all[k]).abs().max()))
            if worst > budget:
                raise RuntimeError(f"{name}: parameters max|card - CPU| {worst:.3g} > twice the "
                                   f"summed lr {budget:.3g}")
            held = {k: v[1] for k, v in final.items() if shifted is None or shifted not in k}
            worst_held = max(held, key=held.get)
            worst_shift = max((v[1] for k, v in final.items() if k not in held), default=0.0)
            print(f"trajectory {name} f32 ({time.perf_counter() - t0:.1f} s): card and CPU agree "
                  f"over 2 epochs: history (rtol {TRAJ_RTOL}, atol {TRAJ_ATOL}); running "
                  f"statistics after the first step (max|err| {stat_err:.3g}), final and best "
                  f"(max|err| {held[worst_held]:.3g} at {worst_held}"
                  + (f"; {shifted} within the bias shift's bound (at most {bound_max:.3g}), "
                     f"max|err| {worst_shift:.3g}" if shifted else "")
                  + f"); parameters max|card - CPU| {worst:.3g} <= {budget:.3g}", flush=True)
            rows[name] = {"stat_err": stat_err, "param_err": worst,
                          "final_max_err": held[worst_held], "shifted_max_err": worst_shift}
    finally:
        heads_mod.CVBlockHead.DROPOUT, heads_mod.EEGNetEncoderHead.DROPOUT = saved
    return rows


BASELINES = ("bandpower_mlp", "stft_eegnet", "cnn_bilstm")
BASELINE_STATE = {"bandpower_mlp": (), "stft_eegnet": ("state.bn1.mean", "state.bn1.var"),
                  "cnn_bilstm": ("state.bn.mean", "state.bn.var")}
FEAT_RTOL, FEAT_ATOL = 1e-4, 1e-5  # the features, card vs CPU (tests/test_torch_pipelines.py)
# The band-power features' Delta band (0.5-4 Hz) lies in the 8-70 Hz band-pass's
# stop band, its power ~1e-7 of the passband's: there B1 and the plain chain part
# by their f32 roundings, a ~0.1% power difference (1.56e-3 in the log on an H100;
# 4.4e-4 with B1's walk emulated on the CPU, tests/test_torch_iir_scan.py). Its log
# is held at this atol (a 1% power difference); the other bands at FEAT_ATOL.
FEAT_DELTA_ATOL = 1e-2
# One trial's input to each baseline model at full width: 64 channels x 5
# bands, 5 band planes of 101 STFT frames, raw 64 x 800.
FEATURE_SHAPES = {"bandpower_mlp": (64 * 5,), "stft_eegnet": (5, 64, 101),
                  "cnn_bilstm": (64, 800)}


def phase_bandpower_iir(dev, X) -> dict:
    """B1 at the band-power featurizer's shape: its notch (1 section, padlen
    9) and 8-70 Hz band-pass (4 sections, padlen 27) in one chain launch
    over the training corpus's 336,000 rows of 800 samples, against the
    plain chain on the same data (B1's tolerance), timed by CUDA events
    and by the profiler's device time, beside the byte bound."""
    filters = list(pipelines.bandpower_filters(SFREQ))
    x = torch.as_tensor(X.reshape(-1, 64, 800), device=dev)
    rows = x.numel() // 800
    with torch.inference_mode():
        ref = sosfiltfilt_chain_plain(filters, x)
        err = check_close(f"B1 chain, bandpower filters, R={rows}", sosfiltfilt_chain(filters, x),
                          ref, IIR_RTOL, IIR_RTOL * float(ref.abs().max()))
        del ref
        bound, bound_by = chain_bound(rows, filters)
        row = {"rows": rows, "max_abs_err": err, "bound_ms": bound, "bound_by": bound_by,
               "ms": cuda_ms(lambda: sosfiltfilt_chain(filters, x), 5),
               "device_ms": device_ms(lambda: sosfiltfilt_chain(filters, x),
                                      "sosfiltfilt_chain_kernel", 5),
               "plain_ms": cuda_ms(lambda: sosfiltfilt_chain_plain(filters, x), 1, warmup=0)}
    print(f"B1 chain at the band-power featurizer's shape, R={rows} (the 15 x 350 corpus), "
          f"60 Hz notch + 8-70 Hz band-pass zero-phase, one launch: kernel {row['ms']:.4f} ms a "
          f"call back to back (CUDA events), {row['device_ms']:.4f} ms on the device "
          f"(profiler), plain {row['plain_ms']:.3f} ms, max|err| {err:.3g}, bound {bound:.4f} ms "
          f"({bound_by}, {bound / row['device_ms']:.1%} of the device time)", flush=True)
    del x
    torch.cuda.empty_cache()
    return row


def check_features(name: str, got: np.ndarray, ref: np.ndarray) -> dict:
    """A featurizer's output on the card against the CPU's plain featurizer,
    each feature at rtol ``FEAT_RTOL`` and atol ``FEAT_ATOL``, the band
    powers' Delta band at ``FEAT_DELTA_ATOL``: the max error and its share
    of the tolerance (<= 1), by band for the band powers."""
    if name != "bandpower_mlp":
        groups = {"planes": (got, ref, FEAT_ATOL)}
    else:
        g, r = got.reshape(-1, 5), ref.reshape(-1, 5)
        groups = {band: (g[:, i], r[:, i], FEAT_DELTA_ATOL if band == "Delta" else FEAT_ATOL)
                  for i, band in enumerate(("Delta", "Theta", "Alpha", "Beta", "Gamma"))}
    out = {}
    for what, (a, b, atol) in groups.items():
        err = np.abs(a - b)
        share = float((err / (atol + FEAT_RTOL * np.abs(b))).max())
        out[what] = [float(f"{err.max():.3g}"), float(f"{share:.3g}")]
        if share > 1.0:
            raise RuntimeError(f"baseline {name}: {what} features, card vs CPU, max|err| "
                               f"{err.max():.3g} beyond rtol {FEAT_RTOL}, atol {atol}")
    return out


def phase_baselines(dev, X, Y, workdir) -> dict:
    """(10) The feature baselines at full width, each through
    ``cli.train_baselines --pipeline <p> --synthetic 15 --synthetic_trials
    350 --epochs 2`` at its default bf16 (75 models, batch 64; its
    ``load_data`` handed the corpus it would generate). The featurization
    runs on the card: the band-power one makes exactly two B1 chain
    launches (the corpus, then all the test sets) and nothing else, the
    others none; its features for the first subject equal the CPU's plain
    featurizer's (``FEAT_RTOL`` / ``FEAT_ATOL``). The history is finite,
    the tree complete with the state in every ``best_subject.npz``, and the
    last subject's reproduces its test predictions."""
    subjects = [f"{i + 1:02d}" for i in range(TRAIN_SUBJECTS)]
    n_test = TRAIN_TRIALS // 3
    test = {sid: (X[i, :n_test], Y[i, :n_test]) for i, sid in enumerate(subjects)}
    rows = {}
    for name in BASELINES:
        pipe = pipelines.PIPELINES[name]
        out = os.path.join(workdir, f"baseline_{name}")
        argv = ["--pipeline", name, "--synthetic", str(TRAIN_SUBJECTS), "--synthetic_trials",
                str(TRAIN_TRIALS), "--epochs", str(TRAIN_EPOCHS), "--output_dir", out]
        print(f"baselines: cli.train_baselines {' '.join(argv[:-1])} <tmp>", flush=True)
        feat = {}
        featurize = pipelines.featurize_corpus

        def timed_featurize(p, xs, tests, device="cuda"):
            before = read_launches()
            t0 = time.perf_counter()
            res = featurize(p, xs, tests, device=device)
            torch.cuda.synchronize()
            feat.update(seconds=time.perf_counter() - t0, features=res,
                        launches={k: v - before[k] for k, v in read_launches().items()})
            return res

        load_data = train_fast.load_data
        train_fast.load_data = lambda args: (X, Y, subjects, test)
        pipelines.featurize_corpus = timed_featurize
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        try:
            result = train_baselines.main(argv)
        finally:
            train_fast.load_data = load_data
            pipelines.featurize_corpus = featurize
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        launches = read_launches()
        want = 2 if name == "bandpower_mlp" and dev.type == "cuda" else 0  # the CPU's: plain
        others = {k: v for k, v in launches.items() if k != "iir_chain" and v}
        if launches["iir_chain"] != want or others:
            raise RuntimeError(f"baseline {name}: kernel launches {launches}; the featurizer "
                               f"must make {want} B1 chain launches and nothing else run")
        if pipe.featurize is not None and feat["launches"]["iir_chain"] != want:
            raise RuntimeError(f"baseline {name}: the featurization made "
                               f"{feat['launches']['iir_chain']} B1 launches, not {want}")
        for k, v in result.fit.history.items():
            if v.shape != (TRAIN_SUBJECTS * 5, TRAIN_EPOCHS) or not np.isfinite(v).all():
                raise RuntimeError(f"baseline {name}: history {k} {v.shape}")
        check_result_tree(out, subjects, BASELINE_STATE[name], f"baseline {name}")
        si = TRAIN_SUBJECTS - 1
        if pipe.featurize is None:
            x_test, feat_err = X[si, :n_test], None
        else:
            Xf, testf = feat["features"]
            x_test = testf[subjects[si]][0]
            with torch.no_grad():
                cpu = pipe.featurize(torch.from_numpy(X[0])).numpy()
            feat_err = check_features(name, Xf[0], cpu)
        n = reproduce_predictions(pipe.make_model(64, 800, 5), out, subjects[si], x_test,
                                  torch.bfloat16, dev, TRAIN_BATCH, f"baseline {name}")
        print(f"baseline {name}: launches {launches['iir_chain']} B1 chain (featurization "
              f"{feat.get('seconds', 0.0):.2f} s host)"
              + ("" if feat_err is None else f"; subject 01's features, card vs CPU plain "
                 f"featurizer, max|err| {json.dumps(feat_err)}")
              + f"; history finite; the tree written; sub-{subjects[si]}'s best_subject.npz "
              f"reproduces its {n} test predictions", flush=True)
        rows[name] = {**report_fit(f"baseline {name} (bf16, M={TRAIN_SUBJECTS * 5})", result,
                                   wall, peak),
                      "launches": launches["iir_chain"], "featurize_s": feat.get("seconds"),
                      "feature_err": feat_err}
        del result, feat
    return rows


def baseline_step_profile(dev, name: str, dtype, subjects: int = TRAIN_SUBJECTS) -> dict:
    """One training step of a baseline model's stack (``subjects`` x 5 folds)
    at batch 64 on random inputs of its feature shape, in ``dtype``:
    span, device time, idle share, peak allocated memory."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    m = subjects * 5
    mdef = pipelines.PIPELINES[name].make_model(64, 800, 5)
    model = mdef.build(m, dev)
    mdef.load(model, *mdef.init(SEED, m))
    model.train()
    opt = engine.make_optimizer(model.parameters())
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((m, TRAIN_BATCH) + FEATURE_SHAPES[name], generator=gen, device=dev).to(dtype)
    y = torch.randint(0, 5, (m, TRAIN_BATCH), generator=gen, device=dev)

    def step():
        engine.train_step(model, opt, x, y, 1e-4, 5, gen)

    step()
    precision = "bf16" if dtype == torch.bfloat16 else "f32"
    return stateful_step_row(f"train step {precision} {name}", step, cuda_ms(step, 1, warmup=0),
                             m, TRAIN_BATCH)


def featurize_profile(dev, name: str) -> dict:
    """A featurizer over a 15 x 350 x 64 x 800 corpus drawn on the card, as
    ``featurize_corpus`` calls it (the band power over the whole split in
    one call, the STFT a subject a call): host seconds (synchronised),
    device time, CUDA-event span, idle share."""
    pipe = pipelines.PIPELINES[name]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((TRAIN_SUBJECTS, TRAIN_TRIALS, 64, 800), generator=gen, device=dev)

    def run():
        with torch.no_grad():
            if pipe.whole_split:
                pipe.featurize(x)
            else:
                for s in range(TRAIN_SUBJECTS):
                    pipe.featurize(x[s])

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    host = time.perf_counter() - t0
    need = ("sosfiltfilt_chain_kernel",) if name == "bandpower_mlp" else ()
    reset_launches()
    events, span, union = profiled_step(run, f"featurize {name}", need=need)
    launches = read_launches()
    if launches["iir_chain"] != (1 if name == "bandpower_mlp" else 0):
        raise RuntimeError(f"featurize {name}: B1 chain launches {launches['iir_chain']}")
    by_device = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                        for e in device_records(events)), reverse=True)
    busy = sum(ms for ms, _, _ in by_device)
    print(f"featurize {name} over {TRAIN_SUBJECTS} x {TRAIN_TRIALS} x 64 x 800 on the card: "
          f"host {host:.4f} s, CUDA-event span {span:.2f} ms, device time {busy:.2f} ms (idle "
          f"{1 - union / span:.1%})", flush=True)
    for ms, calls, key in by_device[:5]:
        print(f"    device {ms:10.3f} ms {100 * ms / busy:5.1f}%  {calls:4d} calls  {key[:60]}",
              flush=True)
    del x
    torch.cuda.empty_cache()
    return {"host_s": host, "step_ms": span, "busy_ms": busy, "idle": 1 - union / span}


def phase_trajectory_baselines(dev) -> dict:
    """Card against CPU for each baseline, f32 with TF32 off: 2 subjects x 10
    trials (10 models, 8 + 2 trials, batch 8: one step an epoch), 2 epochs,
    dropout off, the same weights, permutations and input features (the
    CPU's featurizer, so that only the training differs): the history at
    rtol 1e-4 / atol 1e-5, the running statistics after the first step at
    the same tolerance, every parameter within twice the summed learning
    rate, the final and best running statistics at the same tolerance; the
    EEGNet's ``bn2.mean`` follows ``bn1.bias``, whose exact gradient is 0
    (a depthwise conv and a batch norm follow it), and is held within
    ``2 * lr_sum * sum |spatial.w| + lr_sum``, as ``shifted_mean_bound``."""
    from imagined_speech_decoding_tpu_torch.models.api import (make_cnn_bilstm_model,
                                                               make_mlp_model,
                                                               make_stft_eegnet_model)

    x, y = synthetic_corpus(SEED, 2, 10, 64, 800)
    tidx, vidx, _ = build_cv_index_stack(2, 10, 5, 42)
    m = tidx.shape[0]
    models = {"bandpower_mlp": make_mlp_model(320, 5, dropout=0.0),
              "stft_eegnet": make_stft_eegnet_model(64, 800, 5, dropout=0.0),
              "cnn_bilstm": make_cnn_bilstm_model(64, 800, 5, dropout=0.0)}
    rows = {}
    for name in BASELINES:
        pipe, mdef = pipelines.PIPELINES[name], models[name]
        xs = x.reshape(-1, 64, 800)
        if pipe.featurize is not None:
            with torch.no_grad():
                xs = pipe.featurize(torch.from_numpy(xs)).numpy()
        p0, s0 = mdef.init(42, m)
        runs, first = {}, {}
        t0 = time.perf_counter()
        for device, d in (("card", dev), ("cpu", torch.device("cpu"))):
            model = mdef.build(m, d)
            mdef.load(model, p0, s0)
            fit = engine.make_fit(model, 5, epochs=2, batch_size=8, n_train=8, n_val=2,
                                  learning_rate=1e-3, warmup_epochs=0)
            xd = torch.as_tensor(xs, device=d)
            yd = torch.as_tensor(y.reshape(-1).astype(np.int64), device=d)
            carry = fit.init_carry(tidx, vidx, xd, seed=43)
            fit.run(carry, xd, yd, until=1)
            first[device] = {k: b.detach().cpu().clone() for k, b in carry.buffers.items()}
            runs[device] = fit.result(fit.run(carry, xd, yd, until=2))
        gpu, cpu = runs["card"], runs["cpu"]
        for k in engine.HISTORY_KEYS:
            np.testing.assert_allclose(gpu.history[k], cpu.history[k], rtol=TRAJ_RTOL,
                                       atol=TRAJ_ATOL, err_msg=f"baseline {name} history {k}")
        stat_err = max((check_close(f"baseline {name} running statistics after the first step "
                                    f"{k}", first["card"][k], first["cpu"][k], TRAJ_RTOL,
                                    TRAJ_ATOL) for k in first["card"]), default=0.0)
        lr_sum = float(np.sum(fit.lr_table))
        final_err, shift_err = 0.0, 0.0
        for which, pwhich in (("model_state", "params"), ("best_model_state", "best_params")):
            for k, b in getattr(cpu, which).items():
                a = getattr(gpu, which)[k].cpu()
                tol = TRAJ_ATOL + TRAJ_RTOL * b.abs()
                if name == "stft_eegnet" and k == "bn2.mean":
                    w = getattr(cpu, pwhich)["spatial.w"].abs()  # (M, 16, 1, C, 1)
                    tol = tol + 2 * lr_sum * (w + lr_sum).sum(dim=(2, 3, 4))
                    shift_err = max(shift_err, float((a - b).abs().max()))
                else:
                    final_err = max(final_err, float((a - b).abs().max()))
                far = int(((a - b).abs() > tol).sum())
                if far:
                    raise RuntimeError(f"baseline {name}: {far} of {b.numel()} elements of the "
                                       f"{which} {k} beyond tolerance")
        worst = max(float((getattr(gpu, w)[k].cpu() - getattr(cpu, w)[k]).abs().max())
                    for w in ("params", "best_params") for k in getattr(cpu, w))
        if worst > 2 * lr_sum:
            raise RuntimeError(f"baseline {name}: parameters max|card - CPU| {worst:.3g} > twice "
                               f"the summed lr {2 * lr_sum:.3g}")
        print(f"trajectory baseline {name} f32 ({time.perf_counter() - t0:.1f} s): card and CPU "
              f"agree over 2 epochs: history (rtol {TRAJ_RTOL}, atol {TRAJ_ATOL}); running "
              f"statistics after the first step (max|err| {stat_err:.3g}), final and best "
              f"(max|err| {final_err:.3g}"
              + (f"; bn2.mean within the bias shift's bound, max|err| {shift_err:.3g}"
                 if name == "stft_eegnet" else "")
              + f"); parameters max|card - CPU| {worst:.3g} <= {2 * lr_sum:.3g}", flush=True)
        rows[name] = {"stat_err": stat_err, "param_err": worst, "final_max_err": final_err}
    return rows


# --- 11. The engine's remaining paths: batch-norm LOSO and sweep, forward modes, early
# stopping, dense tokens -----------------------------------------------------------------

BN_LOSO_FLAG = "--bn-loso-child"  # chip_smoke.py runs itself with it: phase (a)'s CLI run
# (a)'s trials a subject: the corpus's first 70 (14 a fold), a fifth of it, so that the
# child's LOSO (15 x (882 + 98) trials) and CV keep the smoke inside its time limit
BN_LOSO_TRIALS = 70
DENSE_STEP = 25  # forward_head(step_override=25): 23 windows of 250 over 800 samples
DENSE_WINDOWS = (800 - 250) // DENSE_STEP + 1
EARLY_STOP_EPOCHS = 3


def bn_loso_child(argv) -> None:
    """``cli.train_fast`` with ``argv`` in a process of its own, on the corpus
    that the parent saved as ``<dir>/X.npy`` / ``Y.npy`` (``argv[0]``) and
    the test split ``load_data`` would cut from it. Its LOSO warm start is
    timed apart: host seconds, peak allocated memory and launches of LOSO,
    then of the CV; the warm start it hands the CV is saved as
    ``warm.npz`` (parameters and state). Writes ``child.json``."""
    src, argv = argv[0], argv[1:]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    X, Y = np.load(os.path.join(src, "X.npy")), np.load(os.path.join(src, "Y.npy"))
    subjects = [f"{i + 1:02d}" for i in range(X.shape[0])]
    n_test = X.shape[1] // 3
    train_fast.load_data = lambda args: (
        X, Y, subjects, {sid: (X[i, :n_test], Y[i, :n_test]) for i, sid in enumerate(subjects)})
    out = argv[argv.index("--output_dir") + 1]
    loso_row = {}
    warm_start = train_fast.loso_warm_start

    def timed(*a, **k):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        warm = warm_start(*a, **k)
        torch.cuda.synchronize()
        loso_row.update(wall_s=time.perf_counter() - t0, launches=read_launches(),
                        peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        params, state = warm
        np.savez(os.path.join(out, "warm.npz"),
                 **checkpoint._flatten({"params": params, "state": state}))
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        return warm

    train_fast.loso_warm_start = timed
    t0 = time.perf_counter()
    result = train_fast.main(argv)
    wall = time.perf_counter() - t0
    hist = result.fit.history
    with open(os.path.join(out, "child.json"), "w") as f:
        json.dump({"loso": loso_row, "cv": {"launches": read_launches(),
                                            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                                            "fit_s": result.timings["fit_s"]},
                   "wall_s": wall, "history_shape": list(hist["loss"].shape),
                   "history_finite": bool(all(np.isfinite(v).all() for v in hist.values()))}, f)


def phase_bn_loso(cfg, dev, X, Y, workdir) -> dict:
    """(a) ``cli.train_fast --synthetic 15 --synthetic_trials 70 --head
    CVBlock --loso-pretrain --loso-epochs 1 --epochs 1 --augment --profile
    <dir>`` in a child process (a fresh profiler), bf16, on the corpus's
    first ``BN_LOSO_TRIALS`` trials a subject: 15 LOSO models of 882 + 98
    trials at B = 64, then 75 CV models. No hand-written kernel
    launches; every LOSO row leaves its subject out; the CV begins at the
    LOSO rows (each subject's over its 5 folds) and at the initial running
    statistics of a fresh draw; a second LOSO call trains nothing and
    returns the saved rows bit for bit; the trace (``<dir>/trace.json``)
    loads and holds device kernel records and the CLI's fit range."""
    hcfg = dataclasses.replace(cfg, head="CVBlock")
    n = BN_LOSO_TRIALS
    X, Y = X[:, :n], Y[:, :n]
    subjects = [f"{i + 1:02d}" for i in range(TRAIN_SUBJECTS)]
    out, prof = os.path.join(workdir, "bn_loso"), os.path.join(workdir, "bn_loso_trace")
    os.makedirs(out, exist_ok=True)
    np.save(os.path.join(workdir, "X.npy"), X)
    np.save(os.path.join(workdir, "Y.npy"), Y)
    argv = ["--synthetic", str(TRAIN_SUBJECTS), "--synthetic_trials", str(n),
            "--head", "CVBlock", "--loso-pretrain", "--loso-epochs", "1", "--epochs", "1",
            "--augment", "--profile", prof, "--output_dir", out]
    print(f"bn LOSO: cli.train_fast {' '.join(argv[:-3])} <tmp> in a child process", flush=True)
    cmd = [sys.executable, os.path.abspath(__file__), BN_LOSO_FLAG, workdir, *argv]
    wall = _run_child(cmd, os.path.join(workdir, "bn_loso.log"))
    for name in ("X.npy", "Y.npy"):
        os.remove(os.path.join(workdir, name))
    with open(os.path.join(out, "child.json")) as f:
        child = json.load(f)
    loso_row, cv_row = child["loso"], child["cv"]
    for what, launches in (("LOSO", loso_row["launches"]), ("CV", cv_row["launches"])):
        if any(launches[k] for k in KERNEL_KEYS):
            raise RuntimeError(f"bn LOSO: the {what} run launched a hand-written kernel: "
                               f"{launches}")
    if child["history_shape"] != [TRAIN_SUBJECTS * 5, 1] or not child["history_finite"]:
        raise RuntimeError(f"bn LOSO: the CV history {child['history_shape']}, finite "
                           f"{child['history_finite']}")
    tr, va = build_loso_index_stack(Y, seed=42)
    pool = (TRAIN_SUBJECTS - 1) * n
    if tr.shape[0] != TRAIN_SUBJECTS or tr.shape[1] + va.shape[1] != pool or any(
            ((np.r_[tr[s], va[s]] >= s * n) & (np.r_[tr[s], va[s]] < (s + 1) * n)).any()
            for s in range(TRAIN_SUBJECTS)):
        raise RuntimeError("bn LOSO: a row's indices include its own subject, or sizes differ")

    save = os.path.join(out, "loso_pretrain")
    files = []
    for sid in subjects:
        with np.load(os.path.join(save, f"Pretrain_excludes_sub{sid}.npz")) as f:
            files.append({k: f[k] for k in f.files})
    if any(k.endswith((".mean", ".var")) for k in files[0]):
        raise RuntimeError("bn LOSO: a Pretrain_excludes file holds running statistics")
    with np.load(os.path.join(out, "warm.npz")) as f:
        warm = {k: f[k] for k in f.files}
    fresh = checkpoint._flatten(stacked_init(hcfg, 42, TRAIN_SUBJECTS * 5)[1])
    for si, row in enumerate(files):
        for k, v in row.items():
            got = warm[f"params.{k}"][si * 5:(si + 1) * 5]
            if not all(np.array_equal(g, v) for g in got):
                raise RuntimeError(f"bn LOSO: the CV's sub-{subjects[si]} rows do not begin at "
                                   f"its LOSO row ({k})")
    state_keys = sorted(k for k in warm if k.startswith("state."))
    if state_keys != sorted(f"state.{k}" for k in fresh) or not state_keys or any(
            not np.array_equal(warm[f"state.{k}"], v) for k, v in fresh.items()):
        raise RuntimeError("bn LOSO: the CV's running statistics are not a fresh draw's")

    mdef = make_augmented_model(make_fast_model(hcfg), 0.1, 0.1)
    def trained(*a, **k):
        raise RuntimeError("bn LOSO: the second call trained")

    fit_segmented = loso_module.fit_segmented
    loso_module.fit_segmented = trained
    reset_launches()
    try:
        again = pretrain_loso(mdef, X, Y, subjects, cfg.n_classes, save, epochs=1,
                              data_dtype=torch.bfloat16, device=dev, verbose=False)
    finally:
        loso_module.fit_segmented = fit_segmented
    quiet = read_launches()
    if any(quiet[k] for k in KERNEL_KEYS):
        raise RuntimeError(f"bn LOSO: the second call launched {quiet}")
    for a, b in zip(again, files):
        fa = checkpoint._flatten(a)
        if fa.keys() != b.keys() or any(not np.array_equal(fa[k], b[k]) for k in b):
            raise RuntimeError("bn LOSO: the second call returned other rows than the saved ones")

    trace_path = os.path.join(prof, TRACE_FILE)
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    fit = [e for e in events if e.get("name") == "cli.train_fast: fit"]
    if not kernels or not fit:
        raise RuntimeError(f"bn LOSO: the trace holds {kernels} kernel records and {len(fit)} "
                           "fit ranges")
    print(f"bn LOSO: {wall:.2f} s in the child (CLI {child['wall_s']:.2f} s); LOSO of "
          f"{TRAIN_SUBJECTS} CVBlock models x ({tr.shape[1]} + {va.shape[1]}) trials, augmented, "
          "1 "
          f"epoch: {loso_row['wall_s']:.2f} s host, peak {loso_row['peak_gb']:.2f} GB; CV of "
          f"{TRAIN_SUBJECTS * 5} models: fit {cv_row['fit_s']:.2f} s, peak {cv_row['peak_gb']:.2f}"
          f" GB; no hand-written kernel launched; every row leaves its subject out; the CV began "
          f"at the LOSO rows and at a fresh draw's running statistics; a second LOSO call "
          f"trained nothing and returned the saved rows bit for bit; trace "
          f"{os.path.getsize(trace_path) / 1e6:.1f} MB, {len(events)} events, {kernels} kernel "
          "records, the fit's range", flush=True)
    return {"wall_s": wall, "loso_s": loso_row["wall_s"], "loso_peak_gb": loso_row["peak_gb"],
            "cv_peak_gb": cv_row["peak_gb"]}


def phase_bn_sweep(cfg, dev, x, y) -> dict:
    """(b) ``cv_sweep`` of CVBlock on one subject's 350 trials, bf16: 2 lr x 1
    wd x 5 folds, 2 epochs (no hand-written kernel, history finite, running
    statistics moved); then a grid of one (lr, wd) twice, whose two
    configs' parameters, best snapshots, running statistics and history
    must be equal bit for bit (dropout on: the rows share their fold's
    draws)."""
    hcfg = dataclasses.replace(cfg, head="CVBlock")
    kw = dict(n_trials=TRAIN_TRIALS, n_folds=5, epochs=CAMPAIGN_EPOCHS, batch_size=TRAIN_BATCH,
              seed=42, data_dtype=torch.bfloat16, device=dev)
    reset_launches()
    t0 = time.perf_counter()
    report = cv_sweep(hcfg, cfg.n_classes, x, y, lr_scales=(0.5, 2.0), wd_scales=(1.0,), **kw)
    wall = time.perf_counter() - t0
    launches = read_launches()
    if any(launches[k] for k in KERNEL_KEYS):
        raise RuntimeError(f"bn sweep: a hand-written kernel launched: {launches}")
    for k, v in report.history.items():
        if v.shape != (2, 5, CAMPAIGN_EPOCHS) or not np.isfinite(v).all():
            raise RuntimeError(f"bn sweep history {k}: shape {v.shape}")
    if not report.fit.model_state["head.bn1.mean"].abs().max() > 0:
        raise RuntimeError("bn sweep: the running statistics did not move")
    dup = cv_sweep(hcfg, cfg.n_classes, x, y, lr_scales=(1.0, 1.0), wd_scales=(1.0,), **kw)
    for which in ("params", "best_params", "model_state", "best_model_state"):
        for k, v in getattr(dup.fit, which).items():
            if not torch.equal(v[:5], v[5:]):
                raise RuntimeError(f"bn sweep: two configs of one (lr, wd) differ in {which} {k}")
    for k, v in dup.history.items():
        if not np.array_equal(v[0], v[1], equal_nan=True):
            raise RuntimeError(f"bn sweep: two configs of one (lr, wd) differ in history {k}")
    print(f"bn sweep: CVBlock, 2 lr x 1 wd x 5 folds, bf16, {CAMPAIGN_EPOCHS} epochs in "
          f"{wall:.2f} s (host clock), no hand-written kernel; best lr "
          f"{report.best['learning_rate']:g}, mean val_acc {report.best['mean_val_acc']:.4f}; two "
          "grid rows of one (lr, wd) trained bit for bit alike (parameters, best snapshots, "
          "running statistics, history)", flush=True)
    return {"wall_s": wall}


def phase_early_stop(cfg, dev, X, Y) -> dict:
    """(d) Early stopping on the Conv4Layers stack (75 models, bf16, the CV
    index stack, 3 epochs, ``early_stop_threshold=0.0``): every row stops
    after epoch 1; epochs 2 and 3 run (B2f-bf16 and B2w-bf16 launched as
    the batches of all 3 epochs count them: a frozen row costs as much as a
    live one) and leave parameters, AdamW moments and best snapshots bit
    for bit at epoch 1's end; the history is finite for all 3 epochs."""
    m = TRAIN_SUBJECTS * 5
    tr, va, _ = build_cv_index_stack(TRAIN_SUBJECTS, TRAIN_TRIALS, 5, 42)
    model = FAST(cfg, n_models=m, device=dev)
    model.load_state_dict(from_jax_params(*stacked_init(cfg, 42, m)))
    fit = engine.make_fit(model, cfg.n_classes, epochs=EARLY_STOP_EPOCHS, batch_size=TRAIN_BATCH,
                          n_train=tr.shape[1], n_val=va.shape[1], early_stop_threshold=0.0,
                          compute_dtype=torch.bfloat16)
    xs = torch.as_tensor(X.reshape(-1, 64, 800), dtype=torch.bfloat16, device=dev)
    ys = torch.as_tensor(Y.reshape(-1).astype(np.int64), device=dev)
    reset_launches()
    t0 = time.perf_counter()
    carry = fit.run(fit.init_carry(tr, va, xs, seed=43), xs, ys, until=1)
    if not bool(carry.stopped.all()):
        raise RuntimeError("early stop: a row did not stop after epoch 1 at threshold 0")
    snap = {k: (p.detach().clone(), carry.opt.state[p]["exp_avg"].clone(),
                carry.opt.state[p]["exp_avg_sq"].clone(), carry.best[k].clone())
            for k, p in carry.params.items()}
    fit.run(carry, xs, ys, until=EARLY_STOP_EPOCHS)
    launches = read_launches()
    wall = time.perf_counter() - t0
    for k, p in carry.params.items():
        got = (p.detach(), carry.opt.state[p]["exp_avg"], carry.opt.state[p]["exp_avg_sq"],
               carry.best[k])
        if not all(torch.equal(a, b) for a, b in zip(got, snap[k])):
            raise RuntimeError(f"early stop: a stopped row moved in epochs 2-3 ({k})")
    res = fit.result(carry)
    if res.history["loss"].shape != (m, EARLY_STOP_EPOCHS) or not all(
            np.isfinite(v).all() for v in res.history.values()):
        raise RuntimeError("early stop: the history is not finite for all 3 epochs")
    want = expected_head_launches(EARLY_STOP_EPOCHS, tr.shape[1], va.shape[1], TRAIN_BATCH)
    require_bf16_launches(launches, want, "early stop")
    print(f"early stop: {m} models, bf16, threshold 0, {EARLY_STOP_EPOCHS} epochs in {wall:.2f} s "
          "(host clock): every row stopped after epoch 1, and epochs 2-3 left parameters, AdamW "
          f"moments and best snapshots bit for bit; launches B2f-bf16 {want[0]}, B2w-bf16 "
          f"{want[1]} as the 3 epochs' batches count them; history finite", flush=True)
    del xs
    return {k: launches[k] for k in HEAD_KERNELS["bf16"]}


def phase_dense_tokens(cfg, dev, rng) -> dict:
    """(e) Dense tokenization: ``forward_head(x, step_override=25)`` (23
    windows) of one full-width model at B = 64, f32 (B2f, one launch) and
    bf16 (B2f-bf16 in groups of the windows its plan holds), against the
    plain version on the same fused weights (f32 rtol 1e-4 / atol 1e-5,
    bf16 ``BF16_FWD_REL``), timed by CUDA events beside the bound at 23
    windows; ``batched_forward_head(micro_batch=64)`` over 256 trials
    equals one call bit for bit."""
    model = FAST(cfg, device=dev).eval()
    model.load_state_dict(from_jax_params(init_jax_layout_params(cfg, SEED + 3)))
    x32 = torch.tensor(rng.normal(size=(256, 64, 800)).astype(np.float32), device=dev)
    geo = (cfg.window_len, DENSE_STEP)
    rows = {}
    with torch.no_grad():
        ops = model.head.fused_weights()
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            x = x32.to(dtype)
            b64 = x[:TRAIN_BATCH]
            reset_launches()
            feat = model.forward_head(b64, step_override=DENSE_STEP)
            launches = read_launches()
            if feat.shape != (TRAIN_BATCH, DENSE_WINDOWS, cfg.n_zones, cfg.dim_cnn):
                raise RuntimeError(f"dense tokens {name}: shape {tuple(feat.shape)}")
            # the kernel's f32 features, of which forward_head's are the cast to x's dtype
            out = fused_conv4_head(b64[None], *ops, *geo)
            if not torch.equal(out[0].to(dtype).view(feat.shape), feat):
                raise RuntimeError(f"dense tokens {name}: forward_head is not the kernel's output")
            ref = fused_conv4_head_plain(b64[None], *ops, *geo)
            if name == "f32":
                err = check_close("B2f dense", out, ref, HEAD_RTOL, HEAD_ATOL)
                bound = head_bound(HEAD_FMA_FWD, 1, TRAIN_BATCH, TRAIN_BATCH * DENSE_WINDOWS * 256,
                                   reads_g=False, windows=DENSE_WINDOWS)
                key, want = "conv4head_fwd", (1, 0)
            else:
                err = check_rel("B2f-bf16 dense", out, ref, BF16_FWD_REL)
                bound = head_bound_bf16(HEAD_FMA_FWD, 1, TRAIN_BATCH,
                                        TRAIN_BATCH * DENSE_WINDOWS * 256, reads_g=False,
                                        windows=DENSE_WINDOWS)
                groups = -(-DENSE_WINDOWS // _fwd_bf16_windows_built(64, cfg.window_len,
                                                                     DENSE_STEP, DENSE_WINDOWS))
                key, want = "conv4head_fwd_bf16", (groups, 1)
            if (launches[key], launches["adapted"]) != want:
                raise RuntimeError(f"dense tokens {name}: launches {launches}, expected {key} "
                                   f"and adapted {want}")
            ms = cuda_ms(lambda: model.forward_head(b64, step_override=DENSE_STEP), 10)
            plain_ms = cuda_ms(lambda: fused_conv4_head_plain(b64[None], *ops, *geo), 1)
            whole = model.forward_head(x, step_override=DENSE_STEP)
            batched = model.batched_forward_head(x, step=DENSE_STEP, micro_batch=TRAIN_BATCH)
            if not torch.equal(whole, batched):
                raise RuntimeError(f"dense tokens {name}: batched_forward_head differs from one "
                                   "call")
            rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound[0], "bound_by": bound[1], "launches": launches[key],
                          "adapted": launches["adapted"]}
            print(f"dense tokens {name}: forward_head(step_override={DENSE_STEP}) M=1 "
                  f"B={TRAIN_BATCH} N={DENSE_WINDOWS}: kernel {ms:.4f} ms ({launches[key]} "
                  f"launch{'es' if launches[key] > 1 else ''}, adapted {launches['adapted']}), "
                  f"plain {plain_ms:.3f} ms, max|err| {err:.3g}, bound {bound[0]:.4f} ms "
                  f"({bound[1]}, {bound[0] / ms:.1%} reached); batched_forward_head over 256 "
                  "trials equals one call bit for bit", flush=True)
    return rows


# --- 13. Multi-GPU (``parallel``): the dry run on NCCL over the visible cards;
# ``cli.train_fast`` at full width under each --mesh strategy on two ranks that
# share the card over gloo (CUDA tensors), held to the unsharded bf16 run of the
# training path; the head kernels at the ranks' local shapes.

MESH_FLAG = "--mesh-child"  # chip_smoke.py runs itself with it: one rank of section 13
MESH_RANKS = 2
# (strategy, precision) of each CLI run; the f32 one is held to the f32 training run
MESH_RUNS = (("model", "bf16"), ("data", "bf16"), ("2d", "bf16"), ("data", "f32"))
# train_per_subject_cv's bounds in the JAX package's checks (tests/test_parallel.py):
# loss rows (rtol, atol); best val_acc within one validation trial a model. In bf16 a
# split batch rounds otherwise (bf16 GEMMs over other row counts, gradient sums in
# another order), and a model near chance turns near-tie validation trials: there at
# most MESH_BF16_MOVED of the 75 models may move, each by at most MESH_BF16_TRIALS
# trials. Both are set from mesh_drift.py's readings on an H100 (PERF.md): sound
# runs against runs with a sharding fault put in.
MESH_LOSS_TOL = {"model": (5e-3, 1e-3), "data": (1e-3, 1e-5), "2d": (1e-3, 1e-5)}
MESH_VAL = TRAIN_TRIALS // 5  # 70 validation trials a fold
MESH_BF16_MOVED, MESH_BF16_TRIALS = 4, 5
MESH_TIMEOUT_S = 420


def mesh_step_profile(cfg, dev, strategy: str) -> dict:
    """One bf16 training step of this rank's share of the 75-model stack at
    batch 64 under ``strategy`` (its rows, its part of every batch; under a
    data axis the step's collectives with the other rank), profiled: the
    CUDA-event span and the device time of this rank's kernels and copies
    (both ranks step at once on the shared card, so each time includes
    waits the card's time-slicing puts in it). The profiler is not asked
    again where it lost records (a retry on one rank alone would leave the
    other in a collective): the device time is then None."""
    m = TRAIN_SUBJECTS * 5
    mesh, stack_axis, data_axis = mesh_strategy(strategy, dev)
    shard = StackShard(mesh, m, stack_axis, data_axis)
    params, state = shard.rows_of(init_jax_layout(cfg, SEED, m))
    model = FAST(cfg, n_models=shard.m_local, device=dev)
    model.load_state_dict(from_jax_params(params, state))
    opt = engine.make_optimizer(model.parameters())
    c0, c1 = shard.batch_cols(TRAIN_BATCH)
    gen = SharedRowsGenerator(dev, (m, *shard.rows) if shard.stacked else None).manual_seed(SEED)
    draw = torch.Generator(device=dev).manual_seed(SEED + 1 + dist.get_rank())
    x = torch.randn((shard.m_local, c1 - c0, 64, 800), generator=draw, device=dev).to(
        torch.bfloat16)
    y = torch.randint(0, cfg.n_classes, (shard.m_local, c1 - c0), generator=draw, device=dev)
    data = (shard.data_group, TRAIN_BATCH) if shard.split_batch else None

    def step():
        if data is not None:
            gen.set_batch((TRAIN_BATCH, c0, c1))
        engine.train_step(model, opt, x, y, 1e-4, cfg.n_classes, gen, None, None, data)

    step()
    dist.barrier()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        span = cuda_ms(step, 1, warmup=0)
    busy = sum(e.self_device_time_total for e in device_records(prof.key_averages())) / 1e3
    dist.barrier()
    return {"m": shard.m_local, "b": c1 - c0, "span_ms": span, "busy_ms": busy or None}


def mesh_child(argv) -> None:
    """Rank ``argv[1]`` of two that share the card: joins their gloo group
    (``init_world`` from the torchrun environment the parent gave it), then
    runs ``cli.train_fast --synthetic 15 --synthetic_trials 350 --epochs 2
    --mesh <strategy>`` for each strategy on the corpus the parent saved in ``argv[0]`` (the CLI's
    own ``--synthetic`` corpus), with its wall time, peak memory and the
    head kernels' launches, then one profiled step at this rank's shapes.
    Writes ``mesh_rank<r>.json``."""
    src, rank = argv[0], int(argv[1])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = init_world("cuda", backend="gloo")  # the CLI runs on the ranks it finds
    X, Y = np.load(os.path.join(src, "X.npy")), np.load(os.path.join(src, "Y.npy"))
    subjects = [f"{i + 1:02d}" for i in range(X.shape[0])]
    n_test = X.shape[1] // 3
    train_fast.load_data = lambda args: (
        X, Y, subjects, {sid: (X[i, :n_test], Y[i, :n_test]) for i, sid in enumerate(subjects)})
    rows = {}
    for strategy, precision in MESH_RUNS:
        argv = ["--synthetic", str(TRAIN_SUBJECTS), "--synthetic_trials", str(TRAIN_TRIALS),
                "--epochs", str(TRAIN_EPOCHS), "--mesh", strategy, "--precision", precision,
                "--output_dir", os.path.join(src, f"mesh_{strategy}_{precision}")]
        dist.barrier()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        result = train_fast.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 1e9
        t = result.timings
        rows[f"{strategy} {precision}"] = {
            "wall_s": wall, "fit_s": t["fit_s"], "train_s": t["train_s"],
            "steps_per_epoch": t["steps_per_epoch"], "peak_gb": peak, "launches": launches,
            "history": {k: v.tolist() for k, v in result.fit.history.items()},
            "best_val_acc": result.fit.best_val_acc.tolist(),
            "step": (mesh_step_profile(FASTConfig.default(), dev, strategy)
                     if precision == "bf16" else None)}
        torch.cuda.synchronize()
    with open(os.path.join(src, f"mesh_rank{rank}.json"), "w") as f:
        json.dump(rows, f)
    dist.destroy_process_group()


def run_mesh_ranks(workdir: str) -> list:
    """The two ranks of ``mesh_child`` at once; both are waited for, and
    both stopped if one fails or runs past ``MESH_TIMEOUT_S``."""
    port = str(free_port())
    logs = [os.path.join(workdir, f"mesh_rank{r}.log") for r in range(MESH_RANKS)]
    procs = []
    try:
        for r, log in enumerate(logs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), MESH_FLAG, workdir, str(r)],
                    stdout=f, stderr=subprocess.STDOUT,
                    env=dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                             WORLD_SIZE=str(MESH_RANKS), MASTER_ADDR="localhost",
                             MASTER_PORT=port)))
        deadline = time.perf_counter() + MESH_TIMEOUT_S
        while any(p.poll() is None for p in procs):
            if time.perf_counter() > deadline or any(p.poll() for p in procs):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if any(p.returncode for p in procs):
        tails = []
        for r, log in enumerate(logs):
            with open(log) as f:
                tails.append(f"rank {r} ({procs[r].returncode}):\n{f.read()[-2500:]}")
        raise RuntimeError("the mesh ranks failed:\n" + "\n".join(tails))
    out = []
    for r in range(MESH_RANKS):
        with open(os.path.join(workdir, f"mesh_rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def phase_mesh(cfg, dev, X, Y, workdir, unsharded: dict) -> dict:
    """(a) ``dryrun_multichip`` over the visible cards, on NCCL: its five
    sections, each held to the unsharded run at the JAX dry run's bounds.
    (b) ``cli.train_fast`` at full width under each strategy on two ranks
    sharing the card over gloo (``MESH_RUNS``): every rank's history
    against the unsharded run of its precision (``unsharded``, the
    training path's fits), loss rows at the JAX package's bounds for the
    strategy, best val_acc as ``MESH_LOSS_TOL``'s note says; both ranks'
    histories equal; the precision's head kernels launched in every rank,
    no other, nothing adapted. Returns the launches summed over the ranks
    and runs, and the rows."""
    t0 = time.perf_counter()
    dryrun_multichip(torch.cuda.device_count())
    dry_s = time.perf_counter() - t0
    print(f"multi-GPU (a): dryrun_multichip({torch.cuda.device_count()}) on NCCL passed in "
          f"{dry_s:.2f} s (host clock; one card: its one rank in this process)", flush=True)
    np.save(os.path.join(workdir, "X.npy"), X)
    np.save(os.path.join(workdir, "Y.npy"), Y)
    t0 = time.perf_counter()
    ranks = run_mesh_ranks(workdir)
    ranks_s = time.perf_counter() - t0
    for name in ("X.npy", "Y.npy"):
        os.remove(os.path.join(workdir, name))
    total = dict.fromkeys(next(iter(ranks[0].values()))["launches"], 0)
    report = {}
    for strategy, precision in MESH_RUNS:
        key, ref = f"{strategy} {precision}", unsharded[precision]
        rtol, atol = MESH_LOSS_TOL[strategy]
        deltas = {}
        for r, rank in enumerate(ranks):
            row = rank[key]
            hist = {k: np.asarray(v) for k, v in row["history"].items()}
            for k in ("loss", "val_loss"):
                deltas[k] = float(np.max(np.abs(hist[k] - ref.history[k])))
                np.testing.assert_allclose(hist[k], ref.history[k], rtol=rtol, atol=atol,
                                           err_msg=f"--mesh {key} rank {r} {k}")
            flips = np.abs(np.asarray(row["best_val_acc"]) - ref.best_val_acc) * MESH_VAL
            deltas.update(flips_max=float(flips.max()), flips_mean=float(flips.mean()),
                          models_moved=int((flips > 0.5).sum()))
            exact = strategy == "model" or precision == "f32"
            moved, most = (len(flips), 1) if exact else (MESH_BF16_MOVED, MESH_BF16_TRIALS)
            if deltas["models_moved"] > moved or not flips.max() <= most + 1e-4:
                raise RuntimeError(f"--mesh {key} rank {r}: best val_acc moved in "
                                   f"{deltas['models_moved']} models, by "
                                   f"{flips.max():.2f} validation trials at most (bound: "
                                   f"{moved} models, {most} trials)")
            if r and row["history"] != ranks[0][key]["history"]:
                raise RuntimeError(f"--mesh {key}: the ranks' histories differ")
            got = row["launches"]
            other = "f32" if precision == "bf16" else "bf16"
            if (any(got[k] < 1 for k in HEAD_KERNELS[precision]) or got["conv4head_bwd_x"]
                    or any(got[k] for k in HEAD_KERNELS[other])):
                raise RuntimeError(f"--mesh {key} rank {r}: head launches {got}")
            require_unadapted(got, f"--mesh {key} rank {r}")
            for k in total:
                total[k] += got[k]
        report[key] = {"deltas": deltas, "ranks": [rank[key] for rank in ranks]}
        print(f"multi-GPU (b) --mesh {strategy} --precision {precision}, 2 ranks on one card "
              f"over gloo, 75 models: max |delta| vs the unsharded run: loss "
              f"{deltas['loss']:.3g}, val_loss {deltas['val_loss']:.3g}; best val_acc moved in "
              f"{deltas['models_moved']} of 75 models, by {deltas['flips_max']:.0f} validation "
              f"trials at most, {deltas['flips_mean']:.3f} on average", flush=True)
        for r, rank in enumerate(ranks):
            row, st = rank[key], rank[key]["step"]
            step = ""
            if st is not None:
                busy = "not measured" if st["busy_ms"] is None else f"{st['busy_ms']:.2f} ms"
                step = (f"; a step at M={st['m']} B={st['b']}: span {st['span_ms']:.2f} ms, "
                        f"device {busy}")
            heads = HEAD_KERNELS[precision]
            print(f"    rank {r}: CLI wall {row['wall_s']:.2f} s (fit {row['fit_s']:.2f} s; "
                  f"epoch 2 train pass {1e3 * row['train_s'][-1] / row['steps_per_epoch']:.1f} "
                  f"ms/step), peak {row['peak_gb']:.2f} GB{step}; launches {heads[0]} "
                  f"{row['launches'][heads[0]]}, {heads[1]} {row['launches'][heads[1]]}",
                  flush=True)
    print(f"multi-GPU (b): both ranks' {len(MESH_RUNS)} CLI runs and step profiles in "
          f"{ranks_s:.2f} s (wall, the ranks' start included)", flush=True)
    return {"launches": total, "report": report, "dry_s": dry_s, "ranks_s": ranks_s}


def mesh_local_shapes(m: int = TRAIN_SUBJECTS * 5) -> dict:
    """``{(M, B, precision): train?}``: the head's shapes in a rank of two in
    ``MESH_RUNS``: the model axis's M = 38 (75 padded to 76) at B = 64, its
    tail 24 and validation 35; the data axis's M = 75 at 32, 12 and 18 / 17
    (in bf16, and in f32 for the f32 run)."""
    shapes = {}
    m_local = -(-m // MESH_RANKS)
    for b in TRAIN_STEP_BATCHES:
        train = b != TRAIN_STEP_BATCHES[-1]
        shapes[(m_local, b, "bf16")] = train
        for part in {-(-b // MESH_RANKS), b // MESH_RANKS}:
            for precision in ("bf16", "f32"):
                shapes[(m, part, precision)] = shapes.get((m, part, precision), False) or train
    return shapes


def compare_f32(ops, x, g, geo, models, what: str) -> dict:
    """``compare_bf16``'s checks for B2f and B2w on an f32 x, at their
    tolerances (forward rtol 1e-4 / atol 1e-5, weight gradients rtol 1e-4 /
    atol 1e-4 * max|ref|)."""
    with torch.no_grad():
        out = fused_conv4_head(x, *ops, *geo)
    dw = conv4head_bwd_w(g, x, *ops, *geo)
    errs = dict.fromkeys(("out", "dw12", "db12", "dw3", "dw4"), 0.0)
    for i in models:
        one = [t[i : i + 1] for t in (g, x, *ops)]
        errs["out"] = max(errs["out"], check_close(
            f"B2f {what} model {i}", out[i : i + 1], fused_conv4_head_plain(*one[1:], *geo),
            HEAD_RTOL, HEAD_ATOL))
        for name, a, r in zip(("dw12", "db12", "dw3", "dw4"), dw,
                              conv4head_bwd_plain(*one, *geo)[1:]):
            errs[name] = max(errs[name], check_close(f"B2w {what} model {i} {name}",
                                                     a[i : i + 1], r, BWD_RTOL,
                                                     BWD_RTOL * float(r.abs().max())))
    return errs


def phase_mesh_kernels(cfg, dev, rng) -> dict:
    """(c) The head kernels at the ranks' local shapes
    (``mesh_local_shapes``: B2w-bf16 and B2w at the train batches), models
    0, M/2 and M - 1 against the plain versions (``compare_bf16``,
    ``compare_f32``); the forward and weight-gradient kernels of each
    precision timed by CUDA events beside their bounds at each axis's full
    batch."""
    geo = (cfg.window_len, cfg.slide_step)
    feat = cfg.n_zones * cfg.dim_cnn
    rows, head_ops = {}, {}
    for (m, b, precision), train in sorted(mesh_local_shapes().items()):
        if m not in head_ops:  # the fused head weights of an M-model stack
            model = FAST(cfg, n_models=m, device=dev)
            model.load_state_dict(from_jax_params(init_jax_layout_params(cfg, SEED + 3, m)))
            with torch.no_grad():
                head_ops[m] = model.head.fused_weights()
            del model
        ops = head_ops[m]
        bf16 = precision == "bf16"
        x = torch.tensor(rng.normal(size=(m, b, 64, 800)).astype(np.float32), device=dev)
        x = x.to(torch.bfloat16) if bf16 else x
        g = torch.tensor(rng.normal(size=(m, b, cfg.n_tokens, feat)).astype(np.float32),
                         device=dev)
        models = (0, m // 2, m - 1)
        what = f"mesh M={m} B={b}"
        if train:
            errs = (compare_bf16 if bf16 else compare_f32)(ops, x, g, geo, models, what)
        else:
            with torch.no_grad():
                out = fused_conv4_head(x, *ops, *geo)
            ref = [fused_conv4_head_plain(x[i:i + 1], *[t[i:i + 1] for t in ops], *geo)
                   for i in models]
            errs = {"out": max(
                check_rel(f"B2f-bf16 {what} model {i}", out[i:i + 1], r, BF16_FWD_REL) if bf16
                else check_close(f"B2f {what} model {i}", out[i:i + 1], r, HEAD_RTOL, HEAD_ATOL)
                for i, r in zip(models, ref))}
        r = rows[f"{precision}_m{m}_b{b}"] = {"fwd_err": errs["out"]}
        if train:
            r["w_err"] = max(errs[k] for k in ("dw12", "db12", "dw3", "dw4"))
        if train and b in (TRAIN_BATCH, TRAIN_BATCH // MESH_RANKS):  # full batches
            bound = head_bound_bf16 if bf16 else head_bound
            r.update({
                "fwd_ms": cuda_ms(lambda: fused_conv4_head(x, *ops, *geo), 5),
                "fwd_plain_ms": cuda_ms(lambda: fused_conv4_head_plain(x, *ops, *geo), 1),
                "fwd_bound": bound(HEAD_FMA_FWD, m, b, m * b * 5 * 256, reads_g=False),
                "w_ms": cuda_ms(lambda: conv4head_bwd_w(g, x, *ops, *geo), 5),
                "w_plain_ms": cuda_ms(lambda: conv4head_bwd_plain(g, x, *ops, *geo), 1),
                "w_bound": bound(HEAD_FMA_BWD_W, m, b, m * HEAD_WEIGHT_FLOATS)})
            suffix = "-bf16" if bf16 else ""
            for k, name in (("fwd", f"B2f{suffix} forward"), ("w", f"B2w{suffix} weight grads")):
                bound, by = r[f"{k}_bound"]
                print(f"multi-GPU (c) {name} {what}: kernel {r[f'{k}_ms']:.4f} ms, plain "
                      f"{r[f'{k}_plain_ms']:.3f} ms, max|err| {r[f'{k}_err']:.3g} (models "
                      f"{models}), bound {bound:.4f} ms ({by}, {bound / r[f'{k}_ms']:.1%} "
                      "reached)", flush=True)
        else:
            suffix = "-bf16" if bf16 else ""
            print(f"multi-GPU (c) {what}: B2f{suffix} max|err| {r['fwd_err']:.3g}"
                  + (f", B2w{suffix} {r['w_err']:.3g}" if train else "")
                  + f" (models {models})", flush=True)
        del x, g
    del head_ops
    torch.cuda.empty_cache()
    return rows



# --- 14. The general-geometry head kernels (B2f-g, B2w-g, B2x-g, f32 and bf16) and the tuned
# kernels' column tiles: FAST at 2-second windows trained and served, bf16 attributions, the
# kernels against their plain versions where no whole-window plan fits --------------------

GEN_GEOMETRY = dict(window_len=500, slide_step=150)  # 3 windows of 500 over 800 samples
GEN_WHOLE = dict(window_len=800)  # one window, the whole trial: past B2f-bf16's whole-window plan
GEN_TRIALS = BN_LOSO_TRIALS  # (a)'s trials a subject: the corpus's first 70, as section 11's
GEN_SHAPE = (2, 8)  # (M, B) of (d)
# (C, W, step, O) of (d), T = 800: where no tuned plan fits, or O > 32.
GEN_GRID = ((80, 250, 125, 32), (128, 250, 125, 32), (64, 500, 150, 32), (64, 800, 125, 32),
            (64, 250, 125, 64))
GEN_ENTRY = (64, 500, 150, 32)  # the kernels line's shape at (a)'s windows: general and tiles
GEN_WIDE_DIM, GEN_WIDE_SUBJECTS = 64, 2  # (a)'s fits at O > 32: B2f-g / B2w-g, f32 and bf16
GEN_KERNELS = {op: f"conv4head_{op}_general_kernel" for op in GENERAL_OPS}
# bf16 dx of B2x-g against the plain bf16 backward, relative L2, for every O. bf16
# rounds h1, h2, dh3, dh2, dh1 and dx, and two f32 sums in other orders round a few
# elements to neighbouring bf16 values; each such flip moves dx by a bf16 ulp of its
# terms. Both are equally far from the f32 dx (5.4e-3 on an H100: the rounding points
# are the same); they part by 8.0e-4 to 9.5e-4 at O = 32 and 1.2e-3 at O = 64. The
# limit sits between those readings and the f32 dx's distance.
GEN_BF16_DX_L2 = 2e-3
# (a)'s step shape: (M, B) of 75 models at the training batch.
GEN_PATH_SHAPE = (TRAIN_SUBJECTS * 5, TRAIN_BATCH)
GEN_ATTR_SHAPE = (1, EG_TRIALS)  # (M, B) of the attributions in (c)


def general_fmas(op: str, c: int, o: int, w: int, k: int = KERNEL_TAPS) -> int:
    """Multiply-adds of one (trial, window, zone) unit of ``op``'s Pallas
    kernel (``_fwd_kernel``, ``_bwd_w_kernel``, ``_bwd_x_kernel``): the
    first conv, the two 'same' convs, then the backward's products, each
    over the window's t1 columns."""
    t1 = w - k + 1
    fwd = t1 * o * (k * c + 2 * k * o)
    if op == "fwd":
        return fwd
    if op == "bwd_w":  # dw4, dh2, dw3, dh1, then dw12
        return fwd + 4 * t1 * o * k * o + t1 * o * k * c
    return fwd + 2 * t1 * o * k * o + t1 * o * k * c  # dh2, dh1, dx


def general_bound(op: str, bf16: bool, m: int, b: int, c: int, t: int, z: int, o: int, w: int,
                  step: int):
    """The least time of ``op`` on M models of B trials of this geometry:
    x (2 bytes a sample in bf16, 4 in f32), the weights and (backward) the
    cotangent read once, the output written once, at the memory rate; or
    its products at the head's rule for the precision (f32: three TF32
    tensor-core passes at the TF32 peak; bf16: one pass at the bf16 peak).
    Also the products' time at the CUDA cores' f32 peak, the general
    kernels' route."""
    n = (t - w) // step + 1
    k = KERNEL_TAPS
    weights = m * (z * o * k * c + z * o + 2 * z * o * k * o)
    xb = (2 if bf16 else 4) * m * b * c * t
    out = {"fwd": 4 * m * b * n * z * o, "bwd_w": 4 * weights, "bwd_x": xb}[op]
    nbytes = xb + 4 * weights + (4 * m * b * n * z * o if op != "fwd" else 0) + out
    fmas = general_fmas(op, c, o, w) * m * b * n * z
    bound = (bound_ms(nbytes, 2 * fmas, BF16_FLOPS) if bf16
             else bound_ms(nbytes, 3 * 2 * fmas, TF32_FLOPS))
    return bound, 1e3 * 2 * fmas / F32_FLOPS


def _general_shapes(m, b, c, t, z, o, w, step):
    """(shape, scale) of ``(g, x, w12, b12, w3, w4)``: the weights at the
    scales of a trained head."""
    n = (t - w) // step + 1
    k = KERNEL_TAPS
    return (((m, b, n, z * o), 1.0), ((m, b, c, t), 1.0), ((m, z * o, k * c), (k * c) ** -0.5),
            ((m, z * o, 1), 0.1), ((m, z, o, k * o), (k * o) ** -0.5),
            ((m, z, o, k * o), (k * o) ** -0.5))


def general_operands(dev, rng, m, b, c, t, z, o, w, step):
    """``(g, x, w12, b12, w3, w4)`` on the card, f32, from numpy's ``rng``."""
    return [torch.tensor(rng.normal(scale=sc, size=sh).astype(np.float32), device=dev)
            for sh, sc in _general_shapes(m, b, c, t, z, o, w, step)]


def general_operands_on_card(dev, m, b, c, t, z, o, w, step):
    """``general_operands`` drawn by torch's generator on the card (SEED):
    at (a)'s step shape numpy's draw would take seconds."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    return [torch.randn(sh, generator=gen, device=dev) * sc
            for sh, sc in _general_shapes(m, b, c, t, z, o, w, step)]


def general_plain(op: str, g, x, w12, b12, w3, w4, w: int, step: int):
    """``op``'s plain version in x's precision (the bf16 backward written
    out as the Pallas kernels round it)."""
    if op == "fwd":
        return fused_conv4_head_plain(x, w12, b12, w3, w4, w, step)
    if x.dtype == torch.bfloat16:
        grads = conv4head_bwd_bf16_plain(g, x, w12, b12, w3, w4, w, step)
    elif op == "bwd_x":
        return conv4head_bwd_x_plain(g, x, w12, b12, w3, w4, w, step)
    else:
        grads = conv4head_bwd_plain(g, x, w12, b12, w3, w4, w, step)
    return grads[0] if op == "bwd_x" else tuple(grads[1:])


def rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    """|got - ref| / |ref| in the L2 norm, in f32."""
    return float((got.float() - ref.float()).norm() / ref.float().norm())


def check_general(op: str, bf16: bool, got, ref, what: str) -> float:
    """A general kernel's result against its plain version: f32 features at
    HEAD_RTOL / HEAD_ATOL, gradients at BWD_RTOL (atol BWD_RTOL x max|ref|);
    bf16 features at BF16_FWD_REL, weight gradients at BF16_BWD_REL (x
    max|ref|), dx within GEN_BF16_DX_L2 in relative L2. The largest
    absolute error."""
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    errs = []
    for i, (a, r) in enumerate(zip(got, ref)):
        name = f"{what} {i}"
        if a.shape != r.shape or a.dtype != r.dtype:
            raise RuntimeError(f"{name}: {tuple(a.shape)} {a.dtype} against {tuple(r.shape)} "
                               f"{r.dtype}")
        if bf16 and op == "bwd_x":
            l2 = rel_l2(a, r)
            if not l2 <= GEN_BF16_DX_L2:
                raise RuntimeError(f"{name}: relative L2 {l2:.3g} > {GEN_BF16_DX_L2}")
            errs.append(float((a.float() - r.float()).abs().max()))
        elif bf16:
            errs.append(check_rel(name, a, r, BF16_FWD_REL if op == "fwd" else BF16_BWD_REL))
        elif op == "fwd":
            errs.append(check_close(name, a, r, HEAD_RTOL, HEAD_ATOL))
        else:
            errs.append(check_close(name, a, r, BWD_RTOL, BWD_RTOL * float(r.abs().max())))
    return max(errs)


def phase_general_training(cfg500, dev, X, Y) -> dict:
    """(a) ``train_per_subject_cv`` on FAST at 2-second windows (64
    channels, 8 zones, dim 32, 3 windows of 500, 75 models, batch 64), the
    corpus's first GEN_TRIALS trials a subject, 2 epochs, in f32 (B2f and
    B2w in column tiles) and in bf16 (B2f-bf16 a window a launch, B2w-bf16
    in column tiles); then, where only the general kernels reach, the same
    fit at dim_cnn = GEN_WIDE_DIM (O > 32) on GEN_WIDE_SUBJECTS subjects, 1
    epoch, in f32 (B2f-g, B2w-g) and in bf16 (B2f-g bf16, B2w-g bf16): the
    history finite and every head launch as the batches count them. Returns
    each run's launches and the f32 run's final weights."""
    subjects = [f"{i + 1:02d}" for i in range(TRAIN_SUBJECTS)]
    x, y = X[:, :GEN_TRIALS], Y[:, :GEN_TRIALS]
    tr, va, _ = build_cv_index_stack(TRAIN_SUBJECTS, GEN_TRIALS, 5, 42)
    fwd_calls, steps = expected_head_launches(TRAIN_EPOCHS, tr.shape[1], va.shape[1], TRAIN_BATCH)
    n = cfg500.n_tokens
    groups = -(-n // _fwd_bf16_windows_built(64, cfg500.window_len, cfg500.slide_step, n))
    wide_tr, wide_va, _ = build_cv_index_stack(GEN_WIDE_SUBJECTS, GEN_TRIALS, 5, 42)
    wide_fwd, wide_steps = expected_head_launches(1, wide_tr.shape[1], wide_va.shape[1],
                                                  TRAIN_BATCH)
    want = {"f32": {"conv4head_fwd": fwd_calls, "conv4head_bwd_w": steps},
            "bf16": {"conv4head_fwd_bf16": groups * fwd_calls, "conv4head_bwd_w_bf16": steps},
            "f32 wide": {"conv4head_fwd_general": wide_fwd,
                         "conv4head_bwd_w_general": wide_steps},
            "bf16 wide": {"conv4head_fwd_general_bf16": wide_fwd,
                          "conv4head_bwd_w_general_bf16": wide_steps}}
    if groups > 1:  # B2f-bf16 a group of windows at a time: each forward call adapted
        want["bf16"]["adapted"] = fwd_calls
    runs = {}
    for name, c_, precision, n_sub, epochs in (
            ("f32", cfg500, "f32", TRAIN_SUBJECTS, TRAIN_EPOCHS),
            ("bf16", cfg500, "bf16", TRAIN_SUBJECTS, TRAIN_EPOCHS),
            ("f32 wide", dataclasses.replace(cfg500, dim_cnn=GEN_WIDE_DIM), "f32",
             GEN_WIDE_SUBJECTS, 1),
            ("bf16 wide", dataclasses.replace(cfg500, dim_cnn=GEN_WIDE_DIM), "bf16",
             GEN_WIDE_SUBJECTS, 1)):
        reset_launches()
        t0 = time.perf_counter()
        res = train_per_subject_cv(c_, TrainConfig(max_epochs=epochs, precision=precision),
                                   x[:n_sub], y[:n_sub], subjects[:n_sub], c_.n_classes,
                                   device=dev, verbose=False)
        wall = time.perf_counter() - t0
        launches = read_launches()
        moved = {k: v for k, v in launches.items() if v and k in KERNEL_KEYS + ("adapted",)}
        if moved != want[name]:
            raise RuntimeError(f"general (a) {name}: head launches {moved}, expected "
                               f"{want[name]}")
        for k, v in res.fit.history.items():
            if v.shape != (n_sub * 5, epochs) or not np.isfinite(v).all():
                raise RuntimeError(f"general (a) {name}: history {k} {v.shape}")
        print(f"general (a): train_per_subject_cv at windows of {c_.window_len} step "
              f"{c_.slide_step} ({n} windows), dim_cnn {c_.dim_cnn}, {n_sub * 5} models, "
              f"{GEN_TRIALS} trials a subject, {precision}, {epochs} epochs in {wall:.2f} s "
              f"(host clock): history finite, head launches {json.dumps(moved)} as the batches "
              f"count them; mean best val_acc {float(np.mean(res.fit.best_val_acc)):.3f}",
              flush=True)
        runs[name] = {"launches": moved, "wall_s": wall,
                      "params": {k: v[0].detach().cpu() for k, v in res.fit.params.items()}}
        del res
    return runs


def phase_general_decoder(cfg500, dev, state_dict, rng) -> dict:
    """(b) A live decoder of (a)'s f32 model 0: one DECODE (eager, then the
    capture), a replay equal to it and to the un-captured chain bit for
    bit, and the posteriors against the plain CPU forward (rtol 1e-4, atol
    1e-5). B2f runs in the decode, in column tiles: launched twice (the
    first decode, the un-captured chain), captured once; no general kernel."""
    params = to_jax_params(state_dict)
    dec = make_online_decoder(FAST(cfg500, device=dev), params)
    x = rng.normal(size=(1, 64, 800)).astype(np.float32)
    before = (fused_conv4_head.launches, fused_conv4_head.captures,
              fused_conv4_head.launches_general)
    first = dec(x)
    replay = dec(x)
    plain = eager(dec, x)
    torch.cuda.synchronize()
    moved = (fused_conv4_head.launches - before[0], fused_conv4_head.captures - before[1],
             fused_conv4_head.launches_general - before[2])
    if not (np.array_equal(first, replay) and np.array_equal(replay, plain)) or dec.replays < 1:
        raise RuntimeError("general (b): the replayed decode differs from the eager one "
                           f"(max|diff| {np.abs(replay - plain).max():.3g})")
    if moved != (2, 1, 0):
        raise RuntimeError(f"general (b): B2f launches, captures and B2f-g launches {moved}, "
                           "expected (2, 1, 0)")
    cpu = make_online_decoder(FAST(cfg500), params)
    check_posteriors(replay, cpu(x))
    print(f"general (b): a live decoder at windows of {cfg500.window_len}: one DECODE replayed "
          f"equals the eager decode and the un-captured chain bit for bit; B2f (column tiles) "
          f"launched {moved[0]}, captured {moved[1]}; posteriors match the plain CPU forward",
          flush=True)
    return {"launches": moved[0], "captures": moved[1]}


def attribution_close(what: str, got, ref, bf16: bool, gap=None) -> float:
    """Card attributions against the CPU's on the same trials and draws:
    f32 at rtol BWD_RTOL / atol BWD_RTOL x max|ref| (``phase_explain``'s);
    bf16 (both in bf16 arithmetic, rounding at the same points, f32 sums in
    other orders) in relative L2 under ``gap``, the same attributions'
    bf16-vs-f32 difference on the card. Integrated and expected gradients
    add IG_STEPS (EG_SAMPLES) input gradients into a bf16 total that rounds
    at every add, so the input gradients' rounding flips grow there: 7.2e-3
    to 7.7e-3 on an H100 against a gap of 1.0e-2 to 1.2e-2."""
    if not bf16:
        return check_close(what, got, ref, BWD_RTOL, BWD_RTOL * float(ref.abs().max()))
    err = rel_l2(got, ref)
    if not err < gap:
        raise RuntimeError(f"{what}: relative L2 {err:.3g} against the CPU, not under the "
                           f"bf16-vs-f32 gap {gap:.3g}")
    return err


def phase_general_attribution(cfg, cfg500, dev, X, Y, state500) -> dict:
    """(c) Attributions past the shipped geometry, each on 100 trials of
    subject 01 (M = 1, B = 100), against the CPU on its first EG_CPU_TRIALS
    trials: integrated gradients (IG_STEPS steps) and expected gradients
    (EG_SAMPLES draws against EG_BACKGROUND trials) of the shipped FAST in
    bf16 (B2f-bf16, B2x-bf16); integrated gradients of (a)'s f32 model at
    windows of 500 (B2f and B2x in column tiles), of FAST at dim
    GEN_WIDE_DIM at those windows in f32 (B2f-g, B2x-g f32: O > 32) and of
    FAST on one window of the whole trial in bf16 (B2f-bf16 and B2x-bf16 in
    column tiles); and of FAST at dim GEN_WIDE_DIM at windows of 500 in
    bf16 (B2f-g bf16, B2x-g bf16) on EG_CPU_TRIALS trials only, which the
    CPU holds whole (the launches do not depend on the trials)."""
    perm = np.random.default_rng(SEED).permutation(X.shape[1])
    bg_np = X[0, perm[:EG_BACKGROUND]]
    sel = perm[EG_BACKGROUND:EG_BACKGROUND + EG_TRIALS]
    k = EG_CPU_TRIALS
    cfg800 = dataclasses.replace(cfg, **GEN_WHOLE)
    cfg_wide = dataclasses.replace(cfg500, dim_cnn=GEN_WIDE_DIM)
    runs = {}
    wide_sd = from_jax_params(init_jax_layout_params(cfg_wide, SEED))
    for name, c_, sd, dtype, trials in (
            ("shipped bf16", cfg, from_jax_params(init_jax_layout_params(cfg, SEED)),
             torch.bfloat16, sel),
            (f"windows of {cfg500.window_len} f32", cfg500, state500, torch.float32, sel),
            (f"dim {GEN_WIDE_DIM} at windows of {cfg500.window_len} f32", cfg_wide, wide_sd,
             torch.float32, sel),
            ("one window of 800 bf16", cfg800, from_jax_params(init_jax_layout_params(cfg800, SEED)),
             torch.bfloat16, sel),
            (f"dim {GEN_WIDE_DIM} at windows of {cfg500.window_len} bf16", cfg_wide, wide_sd,
             torch.bfloat16, sel[:k])):
        bf16 = dtype == torch.bfloat16
        model, cpu = FAST(c_, device=dev), FAST(c_)
        model.load_state_dict(sd)
        cpu.load_state_dict(sd)
        x = torch.tensor(X[0, trials], device=dev).to(dtype)
        with torch.no_grad():
            target = model.eval()(x).argmax(-1)
        attr = integrated_gradients(model, x, target, n_steps=IG_STEPS)
        ref = integrated_gradients(cpu, x[:k].cpu(), target[:k].cpu(), n_steps=IG_STEPS)
        gap = None
        if bf16:  # the same attributions in f32 on the card: the size of bf16's own rounding
            with uncounted():
                ref32 = integrated_gradients(model, x[:k].float(), target[:k], n_steps=IG_STEPS)
            gap = rel_l2(ref32.cpu(), ref)
        err = attribution_close(f"general (c) {name} integrated gradients", attr[:k].cpu(), ref,
                                bf16, gap)
        if attr.dtype != dtype or not bool(torch.isfinite(attr.float()).all()):
            raise RuntimeError(f"general (c) {name}: attributions {attr.dtype}, not finite")
        row = {"ig_err": err, "ig_gap": gap}
        if name == "shipped bf16":
            bg = torch.tensor(bg_np, device=dev).to(dtype)
            yt = torch.tensor(Y[0, sel].astype(np.int64), device=dev)
            attr = expected_gradients(model, x, bg, yt, torch.Generator().manual_seed(SEED),
                                      EG_SAMPLES)
            gen = torch.Generator().manual_seed(SEED)  # expected_gradients' draws, in its order
            bg_idx = torch.randint(0, EG_BACKGROUND, (EG_SAMPLES, EG_TRIALS), generator=gen)
            alphas = torch.rand((EG_SAMPLES, EG_TRIALS), generator=gen)
            ref = expected_gradients_from_draws(cpu, x[:k].cpu(), bg.cpu(), yt[:k].cpu(),
                                                bg_idx[:, :k], alphas[:, :k])
            with uncounted():
                ref32 = expected_gradients_from_draws(model, x[:k].float(), bg.float(), yt[:k],
                                                      bg_idx[:, :k].to(dev), alphas[:, :k].to(dev))
            gap = rel_l2(ref32.cpu(), ref)
            row.update(eg_err=attribution_close(f"general (c) {name} expected gradients",
                                                attr[:k].cpu(), ref, True, gap), eg_gap=gap)
        runs[name] = row
        print(f"general (c): {name}, {len(trials)} trials: integrated gradients ({IG_STEPS} steps)"
              + (f" and expected gradients ({EG_SAMPLES} x {EG_BACKGROUND})"
                 if "eg_err" in row else "")
              + f" match the CPU on {k} trials: {json.dumps({a: float(f'{v:.3g}') for a, v in row.items() if v is not None})}"
              + (" (relative L2; gap: bf16 against f32 on the card)" if bf16 else " (max|err|)"),
              flush=True)
    return runs


def general_step_profile(cfg500, dev, dtype) -> dict:
    """One training step of (a)'s 75-model stack at batch 64 by device time
    (profiler) and CUDA-event span, with the head kernels' own device time."""
    torch.cuda.empty_cache()
    m = TRAIN_SUBJECTS * 5
    model = FAST(cfg500, n_models=m, device=dev)
    model.load_state_dict(from_jax_params(*init_jax_layout(cfg500, SEED, m)))
    model.train()
    opt = engine.make_optimizer(model.parameters())
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((m, TRAIN_BATCH, 64, 800), generator=gen, device=dev).to(dtype)
    y = torch.randint(0, cfg500.n_classes, (m, TRAIN_BATCH), generator=gen, device=dev)

    def step():
        engine.train_step(model, opt, x, y, 1e-4, cfg500.n_classes, gen)

    step()
    bf16 = dtype == torch.bfloat16
    fwd = "conv4head_fwd_bf16_kernel" if bf16 else "conv4head_fwd_kernel"
    bwd_w = "conv4head_bwd_w_bf16_kernel" if bf16 else "conv4head_bwd_w_kernel"
    events, span, union = profiled_step(step, f"general step {dtype}", need=(fwd, bwd_w))
    records = device_records(events)
    busy = sum(e.self_device_time_total for e in records) / 1e3
    heads = {key: sum(e.self_device_time_total for e in records if key in e.key) / 1e3
             for key in (fwd, bwd_w)}
    b = TRAIN_BATCH
    bounds = {fwd: general_bound("fwd", bf16, m, b, 64, 800, 8, 32, cfg500.window_len,
                                 cfg500.slide_step)[0][0],
              bwd_w: general_bound("bwd_w", bf16, m, b, 64, 800, 8, 32, cfg500.window_len,
                                   cfg500.slide_step)[0][0]}
    print(f"general step {'bf16' if bf16 else 'f32'}, M={m} B={b}, windows of "
          f"{cfg500.window_len}: device time {busy:.2f} ms, CUDA-event span {span:.2f} ms (idle "
          f"{1 - union / span:.1%}); " + "; ".join(
              f"{k} {v:.2f} ms ({v / busy:.1%} of the step; bound {bounds[k]:.2f} ms, "
              f"{bounds[k] / v:.1%})" for k, v in heads.items()), flush=True)
    del model, opt, x
    return {"busy_ms": busy, "span_ms": span, "idle": 1 - union / span,
            "kernels_ms": heads, "bounds_ms": bounds}


def general_path_checks(dev) -> dict:
    """The general kernels against their plain versions at the path's own
    shapes, where each block of the persistent grid walks several units in
    its workspace slot: B2f-g and B2w-g at (a)'s step (M = 75, B = 64,
    GEN_ENTRY's windows of 500; B2w-g there takes few trial ranges a (zone,
    window), each long), f32 and bf16, models 0, M/2 and M - 1, and a second
    launch bit-identical; B2f's, B2w's and B2w-bf16's column tiles likewise
    at (a)'s step (what the route runs there); B2x-g at (c)'s M = 1, B = 100, bf16 on
    one 800-sample window and f32 at windows of 500, and B2x-bf16's and B2x's column
    tiles there (what the route runs), every trial, the tiles' reruns bit-identical.
    ``check_general``'s tolerances; the largest absolute error of each."""
    out = {}
    c, w, step, o = GEN_ENTRY
    m, b = GEN_PATH_SHAPE
    n = (800 - w) // step + 1
    models = (0, m // 2, m - 1)
    g, x32, *ops = general_operands_on_card(dev, m, b, c, 800, 8, o, w, step)
    for bf16 in (False, True):
        x = x32.to(torch.bfloat16) if bf16 else x32
        for op in ("fwd", "bwd_w"):
            plan = general_plan(op, m, b, 8, n, _general_slots(op, bf16, x.device.index))
            got = _launch_general(op, g, x, *ops, w, step)
            again = _launch_general(op, g, x, *ops, w, step)
            got, again = (r if isinstance(r, tuple) else (r,) for r in (got, again))
            what = f"general path {op} bf16={bf16} M={m} B={b} W={w}"
            if not all(torch.equal(a, r) for a, r in zip(got, again)):
                raise RuntimeError(f"{what}: a rerun differs")
            err = 0.0
            for i in models:
                one = [t[i:i + 1] for t in (g, x, *ops)]
                err = max(err, check_general(op, bf16, tuple(a[i:i + 1] for a in got),
                                             general_plain(op, *one, w, step),
                                             f"{what} model {i}"))
            out[(op, bf16)] = {"max_abs_err": err, "models": list(models),
                               "units_a_block": plan["units"] / plan["grid"],
                               "splits": plan["splits"], "shape": {"M": m, "B": b, "W": w}}
            del got, again
        del x
    # B2f's column tiles, which the route takes for (a)'s f32 forwards.
    with uncounted():
        got = _launch_fwd(x32, *ops, w, step)
        again = _launch_fwd(x32, *ops, w, step)
    what = f"B2f column tiles M={m} B={b} W={w}"
    if not torch.equal(got, again):
        raise RuntimeError(f"{what}: a rerun differs")
    err = max(check_general("fwd", False, got[i:i + 1],
                            general_plain("fwd", *[t[i:i + 1] for t in (g, x32, *ops)], w, step),
                            f"{what} model {i}") for i in models)
    out[("fwd_tiles", False)] = {"max_abs_err": err, "models": list(models),
                                 "shape": {"M": m, "B": b, "W": w}}
    del got, again
    # B2w's and B2w-bf16's column tiles, which the route takes for (a)'s weight gradients.
    for bf16 in (False, True):
        x = x32.to(torch.bfloat16) if bf16 else x32
        with uncounted():
            got = _launch_bwd_w(g, x, *ops, w, step)
            again = _launch_bwd_w(g, x, *ops, w, step)
        what = f"{'B2w-bf16' if bf16 else 'B2w'} column tiles M={m} B={b} W={w}"
        if not all(torch.equal(a, r) for a, r in zip(got, again)):
            raise RuntimeError(f"{what}: a rerun differs")
        err = max(check_general("bwd_w", bf16, tuple(a[i:i + 1] for a in got),
                                general_plain("bwd_w", *[t[i:i + 1] for t in (g, x, *ops)], w,
                                              step),
                                f"{what} model {i}") for i in models)
        out[("bwd_w_tiles", bf16)] = {"max_abs_err": err, "models": list(models),
                                      "shape": {"M": m, "B": b, "W": w}}
        del x, got, again
    del g, x32, ops
    mx, bx = GEN_ATTR_SHAPE
    for bf16, (w, step) in ((True, (GEN_WHOLE["window_len"], 125)),
                            (False, (GEN_ENTRY[1], GEN_ENTRY[2]))):
        g, x32, *ops = general_operands_on_card(dev, mx, bx, 64, 800, 8, 32, w, step)
        x = x32.to(torch.bfloat16) if bf16 else x32
        n = (800 - w) // step + 1
        plan = general_plan("bwd_x", mx, bx, 8, n, _general_slots("bwd_x", bf16, x.device.index))
        got = _launch_general("bwd_x", g, x, *ops, w, step)
        ref = general_plain("bwd_x", g, x, *ops, w, step)
        row = out[("bwd_x", bf16)] = {
            "max_abs_err": check_general("bwd_x", bf16, got, ref,
                                         f"general path bwd_x bf16={bf16} M={mx} B={bx} W={w}"),
            "trials": bx, "units_a_block": plan["units"] / plan["grid"],
            "shape": {"M": mx, "B": bx, "W": w}}
        if bf16:
            row["l2"] = rel_l2(got, ref)
        # B2x-bf16's and B2x's column tiles, which the route takes there
        with uncounted():
            tiles = _launch_bwd_x(g, x, *ops, w, step)
            again = _launch_bwd_x(g, x, *ops, w, step)
        what = f"B2x{'-bf16' if bf16 else ''} column tiles M={mx} B={bx} W={w}"
        if not torch.equal(tiles, again):
            raise RuntimeError(f"{what}: a rerun differs")
        out[("bwd_x_tiles", bf16)] = {
            "max_abs_err": check_general("bwd_x", bf16, tiles, ref, what), "trials": bx,
            "shape": {"M": mx, "B": bx, "W": w}}
        del tiles, again
        del g, x32, x, ops, got, ref
    torch.cuda.empty_cache()
    for (op, bf16), r in out.items():
        if op in ("fwd_tiles", "bwd_w_tiles", "bwd_x_tiles"):
            name = {"fwd_tiles": "B2f", "bwd_w_tiles": "B2w", "bwd_x_tiles": "B2x"}[op] + (
                "-bf16" if bf16 else "")
            print(f"{name} path check at {json.dumps(r['shape'])} "
                  f"(column tiles): max|err| {r['max_abs_err']:.3g} against plain on "
                  + (f"models {r['models']}" if "models" in r else f"all {r['trials']} trials")
                  + ", rerun bit-identical", flush=True)
            continue
        print(f"general path check {op} {'bf16' if bf16 else 'f32'} at {json.dumps(r['shape'])} "
              f"({r['units_a_block']:.2f} units a block"
              + (f", {r['splits']} trial range(s) a (model, zone, window)" if "splits" in r else "")
              + f"): max|err| {r['max_abs_err']:.3g} against plain on "
              + (f"models {r['models']}, rerun bit-identical" if "models" in r
                 else f"all {r['trials']} trials")
              + (f", relative L2 {r['l2']:.3g}" if "l2" in r else ""), flush=True)
    return out


# (e): B2x's column tiles against the plain input gradient, (C, W, step) at M = 2,
# B = 8, T = 800, each at SZ = 1, 2 and 8 zone ranges: windows past the whole
# window's plan at C = 64 (285: two tiles, the last owning 33 rows; 800: four),
# and at C = 13 the whole window at 285 (C <= 32 holds it to 436), tiles at 500
# and 800.
B2X_TILE_GRID = tuple((c, w, step) for c in (13, 64) for w, step in ((285, 128), (500, 150),
                                                                      (800, 1)))
B2X_TILE_SPLITS = (1, 2, 8)


def phase_b2x_column_tiles(dev, rng) -> dict:
    """(e) B2x's column tiles launched directly (uncounted) against
    ``conv4head_bwd_x_plain`` at B2X_TILE_GRID and B2X_TILE_SPLITS (M = 2, B
    = 8), at rtol BWD_RTOL / atol BWD_RTOL x max|ref|, each launch again
    bit-identical. Then timed at GEN_ENTRY's windows of 500 at M = 2, B = 8
    and at (c)'s M = 1, B = 100 (CUDA events; device time at M = 1, B =
    100) beside their bound and their plain version, and B2x-g f32 launched
    directly on the same operands."""
    errs = {}
    m, b = GEN_SHAPE
    with uncounted():
        for c, w, step in B2X_TILE_GRID:
            g, x, *ops = general_operands(dev, rng, m, b, c, 800, 8, 32, w, step)
            ref = conv4head_bwd_x_plain(g, x, *ops, w, step)
            for sz in B2X_TILE_SPLITS:
                what = f"B2x column tiles C={c} W={w} SZ={sz}"
                got = _launch_bwd_x(g, x, *ops, w, step, sz)
                if not torch.equal(got, _launch_bwd_x(g, x, *ops, w, step, sz)):
                    raise RuntimeError(f"{what}: a rerun differs")
                errs[(c, w, sz)] = check_close(what, got, ref, BWD_RTOL,
                                               BWD_RTOL * float(ref.abs().max()))
            del g, x, ops, ref
    print("general (e): B2x's column tiles against the plain input gradient at M=2 B=8 "
          f"(tiles a window: {json.dumps({f'C={c} W={w}': len(bwd_x_col_tiles(c, w)) for c, w, _ in B2X_TILE_GRID})}), "
          "reruns bit-identical; max|err|: " + json.dumps(
              {f"C={c} W={w} SZ={sz}": float(f"{v:.3g}") for (c, w, sz), v in errs.items()}),
          flush=True)
    _, w, step, _ = GEN_ENTRY
    rows = {}
    for m, b in (GEN_SHAPE, GEN_ATTR_SHAPE):
        g, x, *ops = general_operands(dev, rng, m, b, 64, 800, 8, 32, w, step)
        tiled = lambda: _launch_bwd_x(g, x, *ops, w, step)  # noqa: E731
        general = lambda: _launch_general("bwd_x", g, x, *ops, w, step)  # noqa: E731
        with uncounted():
            ref = conv4head_bwd_x_plain(g, x, *ops, w, step)
            row = {"max_abs_err": check_close(f"B2x column tiles M={m} B={b} W={w}", tiled(),
                                              ref, BWD_RTOL, BWD_RTOL * float(ref.abs().max())),
                   "ms": cuda_ms(tiled, 5), "plain_ms": cuda_ms(
                       lambda: conv4head_bwd_x_plain(g, x, *ops, w, step), 3),
                   "general_ms": cuda_ms(general, 3)}
            if (m, b) == GEN_ATTR_SHAPE:
                row["device_ms"] = device_ms(tiled, B2X_KERNELS, 5)
                row["general_device_ms"] = device_ms(general, GEN_KERNELS["bwd_x"], 3)
        (row["bound_ms"], row["bound_by"]), _ = general_bound("bwd_x", False, m, b, 64, 800, 8,
                                                              32, w, step)
        row["shape"] = {"M": m, "B": b, "C": 64, "T": 800, "W": w, "step": step, "O": 32, "Z": 8}
        row["tiles"] = len(bwd_x_col_tiles(64, w))
        ms = row.get("device_ms", row["ms"])
        print(f"B2x (column tiles) at {json.dumps(row['shape'])}: {row['ms']:.4f} ms (CUDA "
              f"events)" + (f", {row['device_ms']:.4f} ms device time" if "device_ms" in row
                            else "")
              + f"; bound {row['bound_ms']:.4f} ms ({row['bound_by']}; "
              f"{row['bound_ms'] / ms:.1%}); B2x-g f32 launched directly {row['general_ms']:.4f} "
              f"ms" + (f" ({row['general_device_ms']:.4f} ms device time)"
                       if "general_device_ms" in row else "")
              + f", {row.get('general_device_ms', row['general_ms']) / ms:.2f}x; plain "
              f"{row['plain_ms']:.3f} ms; max|err| {row['max_abs_err']:.3g}", flush=True)
        rows[(m, b)] = row
        del g, x, ops, ref
    return {"grid": errs, "m1_b100": rows[GEN_ATTR_SHAPE], "m2_b8": rows[GEN_SHAPE]}


# (f): B2x-bf16's column tiles on (e)'s grid (bf16 x): C = 13 and 64 at windows of
# 285, 500 and 800 (past one tile of 260 samples at every C), SZ = 1, 2 and 8.
def phase_b2x_bf16_column_tiles(dev, rng) -> dict:
    """(f) B2x-bf16's column tiles launched directly (uncounted) on a bf16 x
    against ``conv4head_bwd_bf16_plain`` at B2X_TILE_GRID and
    B2X_TILE_SPLITS (M = 2, B = 8), within GEN_BF16_DX_L2 in relative L2,
    each launch again bit-identical. Then timed at (c)'s M = 1, B = 100 on
    one 800-sample window (GEN_WHOLE: four tiles) and at windows of 500
    (GEN_ENTRY's: three windows of two tiles), by CUDA events and device
    time, beside their bound, their plain version and B2x-g bf16 launched
    directly on the same operands (its device time too)."""
    l2s = {}
    m, b = GEN_SHAPE
    with uncounted():
        for c, w, step in B2X_TILE_GRID:
            g, x, *ops = general_operands(dev, rng, m, b, c, 800, 8, 32, w, step)
            xb = x.to(torch.bfloat16)
            ref = conv4head_bwd_bf16_plain(g, xb, *ops, w, step)[0]
            for sz in B2X_TILE_SPLITS:
                what = f"B2x-bf16 column tiles C={c} W={w} SZ={sz}"
                got = _launch_bwd_x(g, xb, *ops, w, step, sz)
                if not torch.equal(got, _launch_bwd_x(g, xb, *ops, w, step, sz)):
                    raise RuntimeError(f"{what}: a rerun differs")
                check_general("bwd_x", True, got, ref, what)
                l2s[(c, w, sz)] = rel_l2(got, ref)
            del g, x, xb, ops, ref
    counts = {f"C={c} W={w}": len(bwd_x_bf16_col_tiles(bwd_x_bf16_plan(c, w)))
              for c, w, _ in B2X_TILE_GRID}
    print(f"general (f): B2x-bf16's column tiles against the plain bf16 input gradient at M=2 "
          f"B=8 (tiles a window: {json.dumps(counts)}), reruns bit-identical; relative L2: "
          + json.dumps({f"C={c} W={w} SZ={sz}": float(f"{v:.3g}")
                        for (c, w, sz), v in l2s.items()}), flush=True)
    rows = {}
    mx, bx = GEN_ATTR_SHAPE
    for w, step in ((GEN_WHOLE["window_len"], 125), (GEN_ENTRY[1], GEN_ENTRY[2])):
        g, x, *ops = general_operands(dev, rng, mx, bx, 64, 800, 8, 32, w, step)
        xb = x.to(torch.bfloat16)
        tiled = lambda: _launch_bwd_x(g, xb, *ops, w, step)  # noqa: E731
        general = lambda: _launch_general("bwd_x", g, xb, *ops, w, step)  # noqa: E731
        with uncounted():
            got, ref = tiled(), conv4head_bwd_bf16_plain(g, xb, *ops, w, step)[0]
            row = {"max_abs_err": check_general("bwd_x", True, got, ref,
                                                f"B2x-bf16 column tiles M={mx} B={bx} W={w}"),
                   "rel_l2": rel_l2(got, ref), "ms": cuda_ms(tiled, 5),
                   "device_ms": device_ms(tiled, B2X_BF16_KERNELS, 5),
                   "plain_ms": cuda_ms(lambda: conv4head_bwd_bf16_plain(g, xb, *ops, w, step),
                                       3),
                   "general_ms": cuda_ms(general, 3),
                   "general_device_ms": device_ms(general, GEN_KERNELS["bwd_x"], 3)}
        (row["bound_ms"], row["bound_by"]), _ = general_bound("bwd_x", True, mx, bx, 64, 800, 8,
                                                              32, w, step)
        row["shape"] = {"M": mx, "B": bx, "C": 64, "T": 800, "W": w, "step": step, "O": 32,
                        "Z": 8}
        row["tiles"] = len(bwd_x_bf16_col_tiles(bwd_x_bf16_plan(64, w)))
        print(f"B2x-bf16 (column tiles) at {json.dumps(row['shape'])}: {row['ms']:.4f} ms (CUDA "
              f"events), {row['device_ms']:.4f} ms device time; bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}; {row['bound_ms'] / row['device_ms']:.1%}); B2x-g bf16 "
              f"launched directly {row['general_ms']:.4f} ms ({row['general_device_ms']:.4f} ms "
              f"device time), {row['general_device_ms'] / row['device_ms']:.2f}x; plain "
              f"{row['plain_ms']:.3f} ms; relative L2 {row['rel_l2']:.3g}, max|err| "
              f"{row['max_abs_err']:.3g}", flush=True)
        rows[w] = row
        del g, x, xb, ops, got, ref
    return {"grid_rel_l2": l2s, "w800": rows[GEN_WHOLE["window_len"]],
            "w500": rows[GEN_ENTRY[1]]}


# (g): B2f-bf16's column tiles on the card tests' grid (C, W, step), T = 800: past
# its whole-window plan (580 samples at C = 64, 452 at 72, 260 at 104), odd steps
# (staged from the even column below), one window and a step of 8s (16-byte copies).
B2F_BF16_TILE_GRID = ((64, 581, 219), (64, 800, 1), (72, 500, 150), (104, 300, 125),
                      (106, 800, 1), (64, 600, 200))


def phase_b2f_bf16_column_tiles(dev, rng) -> dict:
    """(g) B2f-bf16's column tiles launched directly (uncounted) on a bf16 x
    against the plain bf16 forward at B2F_BF16_TILE_GRID (M = 2, B = 8) at
    BF16_FWD_REL x max|ref|, each launch again bit-identical. Then timed at
    (c)'s M = 1, B = 100 on one 800-sample window (GEN_WHOLE: four tiles) by
    CUDA events and device time, beside its bound, its plain version and
    B2f-g bf16 launched directly on the same operands (its device time
    too)."""
    errs = {}
    m, b = GEN_SHAPE
    with uncounted():
        for c, w, step in B2F_BF16_TILE_GRID:
            _, x, *ops = general_operands(dev, rng, m, b, c, 800, 8, 32, w, step)
            xb = x.to(torch.bfloat16)
            if not fwd_bf16_block_plan(c, w, step, (800 - w) // step + 1)["tiled"]:
                raise RuntimeError(f"B2f-bf16 at C={c} W={w}: not in column tiles")
            what = f"B2f-bf16 column tiles C={c} W={w}"
            got = _launch_fwd(xb, *ops, w, step)
            if not torch.equal(got, _launch_fwd(xb, *ops, w, step)):
                raise RuntimeError(f"{what}: a rerun differs")
            ref = fused_conv4_head_plain(xb, *ops, w, step)
            check_rel(what, got, ref, BF16_FWD_REL)
            errs[(c, w)] = float((got - ref).abs().max() / ref.abs().max())
            del x, xb, ops, got, ref
    counts = {f"C={c} W={w}": len(fwd_bf16_col_tiles(fwd_bf16_block_plan(c, w, step, 1)))
              for c, w, step in B2F_BF16_TILE_GRID}
    print(f"general (g): B2f-bf16's column tiles against the plain bf16 forward at M=2 B=8 "
          f"(tiles a window: {json.dumps(counts)}), reruns bit-identical; max|err| / max|ref|: "
          + json.dumps({f"C={c} W={w}": float(f"{v:.3g}") for (c, w), v in errs.items()}),
          flush=True)
    mx, bx = GEN_ATTR_SHAPE
    w, step = GEN_WHOLE["window_len"], 125
    _, x, *ops = general_operands(dev, rng, mx, bx, 64, 800, 8, 32, w, step)
    xb = x.to(torch.bfloat16)
    tiled = lambda: _launch_fwd(xb, *ops, w, step)  # noqa: E731
    general = lambda: _launch_general("fwd", None, xb, *ops, w, step)  # noqa: E731
    with uncounted():
        got, ref = tiled(), fused_conv4_head_plain(xb, *ops, w, step)
        row = {"max_abs_err": check_rel(f"B2f-bf16 column tiles M={mx} B={bx} W={w}", got, ref,
                                        BF16_FWD_REL),
               "ms": cuda_ms(tiled, 10), "device_ms": device_ms(tiled, "conv4head_fwd_bf16_", 10),
               "plain_ms": cuda_ms(lambda: fused_conv4_head_plain(xb, *ops, w, step), 3),
               "general_ms": cuda_ms(general, 3),
               "general_device_ms": device_ms(general, GEN_KERNELS["fwd"], 3)}
    (row["bound_ms"], row["bound_by"]), _ = general_bound("fwd", True, mx, bx, 64, 800, 8, 32, w,
                                                          step)
    row["shape"] = {"M": mx, "B": bx, "C": 64, "T": 800, "W": w, "step": step, "O": 32, "Z": 8}
    row["tiles"] = len(fwd_bf16_col_tiles(fwd_bf16_block_plan(64, w, step, 1)))
    print(f"B2f-bf16 (column tiles) at {json.dumps(row['shape'])}: {row['ms']:.4f} ms (CUDA "
          f"events), {row['device_ms']:.4f} ms device time; bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}; {row['bound_ms'] / row['device_ms']:.1%}); B2f-g bf16 launched "
          f"directly {row['general_ms']:.4f} ms ({row['general_device_ms']:.4f} ms device time), "
          f"{row['general_device_ms'] / row['device_ms']:.2f}x; plain {row['plain_ms']:.3f} ms; "
          f"max|err| {row['max_abs_err']:.3g}", flush=True)
    del x, xb, ops, got, ref
    return {"grid_rel_err": errs, "w800": row}


def phase_general_kernels(dev, rng) -> dict:
    """(d) Each general kernel, launched directly, against its plain version
    on the card at M = 2, B = 8, f32 and bf16, on GEN_GRID: C = 80 and 128 at
    windows of 250, C = 64 at windows of 500 and 800, O = 64 at the shipped
    geometry (``check_general``'s tolerances); each launch again,
    bit-identical. Then, timed by CUDA events beside its bound and its
    plain version: each kernel at GEN_ENTRY (B2x-g at the shipped geometry),
    and B2x-g bf16 at M = 1, B = 100 (global-explain's batch) also by device
    time; B2f's, B2w's and B2w-bf16's column tiles at GEN_ENTRY, which the
    route runs there; (e) B2x's column tiles (``phase_b2x_column_tiles``);
    (f) B2x-bf16's (``phase_b2x_bf16_column_tiles``); (g) B2f-bf16's
    (``phase_b2f_bf16_column_tiles``). Last,
    ``general_path_checks`` at the path's shapes."""
    m, b = GEN_SHAPE
    rows = {}
    for c, w, step, o in GEN_GRID:
        g, x32, *ops = general_operands(dev, rng, m, b, c, 800, 8, o, w, step)
        for bf16 in (False, True):
            x = x32.to(torch.bfloat16) if bf16 else x32
            for op in GENERAL_OPS:
                run = lambda: _launch_general(op, g, x, *ops, w, step)  # noqa: E731
                got = run()
                again = run()
                same = all(torch.equal(a, r) for a, r in zip(
                    got if isinstance(got, tuple) else (got,),
                    again if isinstance(again, tuple) else (again,)))
                if not same:
                    raise RuntimeError(f"general (d) {op} bf16={bf16} C={c} W={w} O={o}: a "
                                       "rerun differs")
                ref = general_plain(op, g, x, *ops, w, step)
                err = check_general(op, bf16, got, ref,
                                    f"general (d) {op} bf16={bf16} C={c} W={w} O={o}")
                rows[(op, bf16, c, w, o)] = {"err": err}
                if bf16 and op == "bwd_x":
                    rows[(op, bf16, c, w, o)]["l2"] = rel_l2(got, ref)
        del g, x32, ops
    print("general (d): every general kernel against its plain version at M=2 B=8, "
          "bit-identical reruns; max|err|: " + json.dumps(
              {f"{op}{'_bf16' if bf16 else ''} C={c} W={w} O={o}": float(f"{r['err']:.3g}")
               for (op, bf16, c, w, o), r in rows.items()}) + "; bf16 dx relative L2: "
          + json.dumps({f"C={c} W={w} O={o}": float(f"{r['l2']:.3g}")
                        for (op, bf16, c, w, o), r in rows.items() if "l2" in r}), flush=True)
    entries = {}
    for op in GENERAL_OPS:
        c, w, step, o = GEN_ENTRY if op != "bwd_x" else (64, 250, 125, 32)
        g, x32, *ops = general_operands(dev, rng, m, b, c, 800, 8, o, w, step)
        for bf16 in (False, True):
            x = x32.to(torch.bfloat16) if bf16 else x32
            ms = cuda_ms(lambda: _launch_general(op, g, x, *ops, w, step), 5)
            plain_ms = cuda_ms(lambda: general_plain(op, g, x, *ops, w, step), 3)
            err = check_general(op, bf16, _launch_general(op, g, x, *ops, w, step),
                                general_plain(op, g, x, *ops, w, step), f"general {op} entry")
            (bound, by), floor = general_bound(op, bf16, m, b, c, 800, 8, o, w, step)
            entries[(op, bf16)] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                   "bound_ms": bound, "bound_by": by, "f32_core_floor_ms": floor,
                                   "shape": {"M": m, "B": b, "C": c, "T": 800, "W": w,
                                             "step": step, "O": o, "Z": 8}}
    c, w, step, o = GEN_ENTRY  # B2w's and B2w-bf16's column tiles there, as the route runs them
    g, x32, *ops = general_operands(dev, rng, m, b, c, 800, 8, o, w, step)
    tiles = {}
    for bf16 in (True, False):
        x = x32.to(torch.bfloat16) if bf16 else x32
        name = "B2w-bf16" if bf16 else "B2w"
        with uncounted():
            row = tiles[bf16] = {
                "ms": cuda_ms(lambda: _launch_bwd_w(g, x, *ops, w, step), 5),
                "plain_ms": cuda_ms(lambda: general_plain("bwd_w", g, x, *ops, w, step), 3),
                "max_abs_err": check_general("bwd_w", bf16, _launch_bwd_w(g, x, *ops, w, step),
                                             general_plain("bwd_w", g, x, *ops, w, step),
                                             f"{name} column tiles entry")}
        (row["bound_ms"], row["bound_by"]), _ = general_bound("bwd_w", bf16, m, b, c, 800, 8, o,
                                                              w, step)
        row["shape"] = {"M": m, "B": b, "C": c, "T": 800, "W": w, "step": step, "O": o, "Z": 8}
        print(f"{name} (column tiles) at {json.dumps(row['shape'])}: {row['ms']:.4f} ms (CUDA "
              f"events), bound {row['bound_ms']:.4f} ms ({row['bound_by']}; "
              f"{row['bound_ms'] / row['ms']:.1%}), plain {row['plain_ms']:.3f} ms, max|err| "
              f"{row['max_abs_err']:.3g}", flush=True)
        del x
    with uncounted():  # B2f's column tiles there, as the route runs them for f32 forwards
        fwd = {"ms": cuda_ms(lambda: _launch_fwd(x32, *ops, w, step), 5),
               "plain_ms": cuda_ms(lambda: general_plain("fwd", g, x32, *ops, w, step), 3),
               "max_abs_err": check_general("fwd", False, _launch_fwd(x32, *ops, w, step),
                                            general_plain("fwd", g, x32, *ops, w, step),
                                            "B2f column tiles entry")}
    (fwd["bound_ms"], fwd["bound_by"]), _ = general_bound("fwd", False, m, b, c, 800, 8, o, w,
                                                          step)
    fwd["bound_share"] = fwd["bound_ms"] / fwd["ms"]
    fwd["shape"] = {"M": m, "B": b, "C": c, "T": 800, "W": w, "step": step, "O": o, "Z": 8}
    print(f"B2f (column tiles) at {json.dumps(fwd['shape'])}: {fwd['ms']:.4f} ms (CUDA events), "
          f"bound {fwd['bound_ms']:.4f} ms ({fwd['bound_by']}; {fwd['bound_share']:.1%}), plain "
          f"{fwd['plain_ms']:.3f} ms, max|err| {fwd['max_abs_err']:.3g}", flush=True)
    del g, x32, ops
    g, x32, *ops = general_operands(dev, rng, 1, 100, 64, 800, 8, 32, 250, 125)
    xb = x32.to(torch.bfloat16)
    x_ms = cuda_ms(lambda: _launch_general("bwd_x", g, xb, *ops, 250, 125), 5)
    x_dev = device_ms(lambda: _launch_general("bwd_x", g, xb, *ops, 250, 125),
                      GEN_KERNELS["bwd_x"], 5)
    x_plain = cuda_ms(lambda: general_plain("bwd_x", g, xb, *ops, 250, 125), 3)
    (x_bound, x_by), x_floor = general_bound("bwd_x", True, 1, 100, 64, 800, 8, 32, 250, 125)
    entries[("bwd_x", True)]["m1_b100"] = {"ms": x_ms, "device_ms": x_dev, "plain_ms": x_plain,
                                           "bound_ms": x_bound, "bound_by": x_by,
                                           "f32_core_floor_ms": x_floor}
    del g, x32, xb, ops
    x_tiles = phase_b2x_column_tiles(dev, rng)
    x_bf16_tiles = phase_b2x_bf16_column_tiles(dev, rng)
    fwd_bf16_tiles = phase_b2f_bf16_column_tiles(dev, rng)
    for key, r in general_path_checks(dev).items():
        if key[0] == "bwd_w_tiles":
            tiles[key[1]]["path_check"] = r
            continue
        if key[0] == "bwd_x_tiles":
            (x_bf16_tiles["w800"] if key[1] else x_tiles["m1_b100"])["path_check"] = r
            continue
        if key[0] == "fwd_tiles":
            fwd["path_check"] = r
            continue
        entries[key]["path_check"] = r
    for (op, bf16), e in entries.items():
        print(f"general {op} {'bf16' if bf16 else 'f32'} at {json.dumps(e['shape'])}: "
              f"{e['ms']:.4f} ms (CUDA events), bound {e['bound_ms']:.4f} ms ({e['bound_by']}; "
              f"{e['bound_ms'] / e['ms']:.1%}), CUDA-core f32 floor {e['f32_core_floor_ms']:.4f} "
              f"ms ({e['f32_core_floor_ms'] / e['ms']:.1%}), plain {e['plain_ms']:.3f} ms, "
              f"max|err| {e['max_abs_err']:.3g}", flush=True)
    print(f"general bwd_x bf16 (B2x-g bf16) at M=1 B=100, the shipped geometry: {x_ms:.4f} ms "
          f"(CUDA events), {x_dev:.4f} ms device time; bound {x_bound:.4f} ms ({x_by}; "
          f"{x_bound / x_dev:.1%}), CUDA-core f32 floor {x_floor:.4f} ms "
          f"({x_floor / x_dev:.1%}); plain {x_plain:.3f} ms", flush=True)
    return {"grid": rows, "entries": entries, "tiles_w500": tiles[True],
            "tiles_w500_f32": tiles[False], "fwd_tiles_w500": fwd, "x_tiles_w500": x_tiles,
            "x_bf16_tiles": x_bf16_tiles, "fwd_bf16_tiles": fwd_bf16_tiles}


def phase_general(cfg, dev, X, Y, rng) -> dict:
    """Section 14: the path (a)-(c) with every launch count set to 0 before
    it and read after it, held to the launches its batches imply; then the
    card-against-CPU trajectories at (a)'s geometry, (d) and the kernels'
    timings. (a)'s steps are profiled in the "general" step-profile child
    (``phase_step_profiles``): the profiler has lost records late in this
    long process."""
    t_sec = time.perf_counter()
    cfg500 = dataclasses.replace(cfg, **GEN_GEOMETRY)
    training = phase_general_training(cfg500, dev, X, Y)
    reset_launches()
    decoder = phase_general_decoder(cfg500, dev, training["f32"]["params"], rng)
    phase_general_attribution(cfg, cfg500, dev, X, Y, training["f32"]["params"])
    launches = read_launches()
    per_call = {"fwd": 1 + IG_STEPS, "ig": IG_STEPS, "eg": EG_SAMPLES}
    # bf16: B2f-bf16 and B2x-bf16 for the shipped FAST and (column tiles) the
    # 800-sample window, B2f-g bf16 and B2x-g bf16 for the dim-64 model.
    want = {"conv4head_fwd": decoder["launches"] + per_call["fwd"],
            "conv4head_bwd_x": per_call["ig"],
            "conv4head_fwd_general": per_call["fwd"], "conv4head_bwd_x_general": per_call["ig"],
            "conv4head_fwd_bf16": 2 * per_call["fwd"] + EG_SAMPLES,
            "conv4head_bwd_x_bf16": 2 * per_call["ig"] + EG_SAMPLES,
            "conv4head_bwd_x_general_bf16": per_call["ig"],
            "conv4head_fwd_general_bf16": per_call["fwd"], "iir_chain": 2}
    moved = {k: v for k, v in launches.items() if v and k in KERNEL_KEYS + ("adapted",)}
    if moved != want:
        raise RuntimeError(f"general (b)-(c): launches {moved}, expected {want}")
    path = {k: sum(run["launches"].get(k, 0) for run in training.values()) + moved.get(k, 0)
            for k in GENERAL_KEYS + HEAD_KERNELS["bf16"] + HEAD_KERNELS["f32"]
            + ("conv4head_bwd_x", "conv4head_bwd_x_bf16")}
    if not all(path.values()):
        raise RuntimeError(f"general: a kernel did not launch on the path: {path}")
    print(f"general (a)-(c): the general kernels', the bf16 kernels' (B2f-bf16 and B2x-bf16 in "
          f"(c), in column tiles on the 800-sample window) and B2f's, B2w's and B2x's (column tiles) "
          f"launches on the path {json.dumps(path)}", flush=True)
    t_traj = time.perf_counter()
    phase_trajectory(cfg500, dev, label="general (a) trajectory f32")
    phase_trajectory_bf16(cfg500, dev, label="general (a) trajectory bf16",
                          want=("conv4head_fwd_bf16", "conv4head_bwd_w_bf16"), shipped=False)
    t_traj = time.perf_counter() - t_traj
    kernels = phase_general_kernels(dev, rng)
    seconds = time.perf_counter() - t_sec
    print(f"general (section 14): {seconds:.1f} s in this process (host clock; the "
          f"trajectories {t_traj:.1f} s); its steps' profiles run in a step-profile child",
          flush=True)
    return {"path": path, "kernels": kernels, "seconds": seconds}


def main() -> None:
    t_main = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA GPU: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}, device {kind}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 GEMMs reduce in f32, as the JAX trunk's (train.cv sets it too).
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")

    info = _lib.build_info()
    print(f"kernels built in {info['seconds']:.2f} s -> {os.path.relpath(info['path'])}", flush=True)
    report_iir_build(info)
    report_tc_build(info, FASTConfig.default())

    cfg = FASTConfig.default()
    rng = np.random.default_rng(SEED)
    params1 = init_jax_layout_params(cfg, SEED)
    params2 = init_jax_layout_params(cfg, SEED + 1)
    model = FAST(cfg, device=dev)
    model.load_state_dict(from_jax_params(params1))

    with torch.inference_mode():
        iir = phase_iir(dev, rng)
        head = phase_head(model, dev, rng)
    fleet_head = phase_fleet_head(cfg, dev, rng)
    bwd, _ = phase_head_backward(cfg, dev, rng)
    bf16, _ = phase_bf16_kernels(cfg, dev, rng)
    bf16_x = phase_bf16_input_gradient(cfg, dev, rng)
    phase_adapted_geometry(cfg, dev, rng)
    phase_bf16_f32_route(dev, rng)
    campaign_kernels = phase_campaign_kernels(cfg, dev, rng)
    dense = phase_dense_tokens(cfg, dev, rng)
    t0 = time.perf_counter()
    X, Y = synthetic_corpus(0, TRAIN_SUBJECTS, TRAIN_TRIALS, 64, 800)  # cli.train_fast's corpus
    print(f"campaign corpus {X.shape} generated in {time.perf_counter() - t0:.2f} s (host)",
          flush=True)
    with tempfile.TemporaryDirectory() as workdir:
        serving = phase_serving(cfg, params1, params2, rng, workdir)
        phase_graphs(cfg, params1, params2, init_jax_layout_params(cfg, SEED, FLEET_MODELS),
                     init_jax_layout_params(cfg, SEED + 1, FLEET_MODELS), dev, rng)
        phase_streaming(cfg, params1, dev, rng)
        training, _, (ckpt, subject), unsharded_f32 = phase_training(cfg, dev, workdir, "f32", X, Y)
        fleet = phase_fleet(cfg, dev, rng, os.path.join(workdir, "train_f32"))
        phase_artifact(cfg, dev, ckpt, workdir, rng)
        training_bf16, _, _, unsharded = phase_training(cfg, dev, workdir, "bf16", X, Y)
        ensemble = phase_ensemble(cfg, dev, workdir, X)
        explain = phase_explain(cfg, dev, ckpt, subject)
        explain_cli = phase_explain_cli(cfg, dev, ckpt, subject,
                                        os.path.join(workdir, "train_f32"), X[0], Y[0])
        sweep = phase_sweep(cfg, dev, X[0], Y[0])
        loso = phase_loso(cfg, dev, X, Y, workdir)
        phase_native_cache(X, workdir)
        heads, head_dirs = phase_bn_heads(cfg, dev, X, Y, workdir)
        stateful = phase_stateful_decoders(cfg, dev, rng, head_dirs["CVBlock"])
        augmented = phase_augment(cfg, dev, X, Y, workdir)
        torch.cuda.empty_cache()
        bn_loso = phase_bn_loso(cfg, dev, X, Y, workdir)
        phase_bn_sweep(cfg, dev, X[0], Y[0])
        early = phase_early_stop(cfg, dev, X, Y)
        tsception = phase_tsception(dev, X, Y, workdir)
        bandpower_b1 = phase_bandpower_iir(dev, X)
        baselines = phase_baselines(dev, X, Y, workdir)
        torch.cuda.empty_cache()
        t_mesh = time.perf_counter()
        mesh = phase_mesh(cfg, dev, X, Y, workdir, {"bf16": unsharded, "f32": unsharded_f32})
        mesh["wall_s"] = time.perf_counter() - t_mesh
        torch.cuda.empty_cache()
        general = phase_general(cfg, dev, X, Y, rng)
    del X, Y
    t_mesh = time.perf_counter()
    mesh_kernels = phase_mesh_kernels(cfg, dev, rng)
    mesh["kernels_s"] = time.perf_counter() - t_mesh
    steps = phase_step_profiles()
    general["steps"] = {p: steps[f"general {p}"] for p in ("f32", "bf16")}
    general["seconds"] += steps["child_seconds"]["general"]
    phase_trajectory(cfg, dev)
    phase_trajectory_bf16(cfg, dev)
    stateful_traj = phase_trajectory_stateful(cfg, dev)
    for name in BN_HEADS + ("TSception",):
        run = tsception if name == "TSception" else heads[name]
        st = steps[name]
        traj = stateful_traj[name]
        print(f"stateful model {name}: step device {st['busy_ms']:.2f} ms / CUDA-event span "
              f"{st['step_ms']:.2f} ms (device idle {st['idle']:.1%}), step peak "
              f"{st['peak_gb']:.2f} GB, fit peak {run['peak_gb']:.2f} GB of 80 GB, fit "
              f"{run['fit_s']:.2f} s, card vs CPU running statistics max|err| "
              f"{traj['stat_err']:.3g} after the first step, {traj['final_max_err']:.3g} final",
              flush=True)
    baseline_traj = phase_trajectory_baselines(dev)
    for name in BASELINES:
        st, run, traj = steps[f"baseline {name}"], baselines[name], baseline_traj[name]
        feat = steps.get(f"featurize {name}")
        print(f"baseline {name}: bf16 step device {st['busy_ms']:.2f} ms / CUDA-event span "
              f"{st['step_ms']:.2f} ms (device idle {st['idle']:.1%}), step peak "
              f"{st['peak_gb']:.2f} GB, fit peak {run['peak_gb']:.2f} GB of 80 GB, fit "
              f"{run['fit_s']:.2f} s"
              + (f"; featurization device {feat['busy_ms']:.2f} ms, host {feat['host_s']:.4f} s"
                 if feat else "")
              + f"; card vs CPU parameters max|err| {traj['param_err']:.3g}", flush=True)
    f32 = steps.get("baseline cnn_bilstm f32")
    if f32 is None:
        raise RuntimeError("the f32 CNN-BiLSTM step ran out of memory at every subject group")
    print(f"baseline cnn_bilstm f32 step ({f32['subject_group']} subjects a group): device "
          f"{f32['busy_ms']:.2f} ms / span {f32['step_ms']:.2f} ms, peak {f32['peak_gb']:.2f} GB",
          flush=True)
    real, _, zero = phase_real_data(dev, iir["preprocessing"])

    src = "imagined_speech_decoding_tpu_torch/csrc/"
    pallas = "imagined_speech_decoding_tpu/ops/pallas/"
    b2, b2x, b16 = bwd[BWD_SHAPES[0]], bwd[X_SHAPES[-1]], bf16[BF16_SHAPES[-1]]
    # library_ms: no single PyTorch call computes the IIR cascade, the fused
    # windowed head or its gradients. launches: the wrappers' counts of
    # kernels run outside a graph; graph_captures: launches recorded into the
    # serving and fleet graphs (run nothing); graph_replays: those graphs'
    # replays, each of which runs one B1 chain and one B2f kernel.
    captures = {k: serving[k + "_captures"] + fleet[k + "_captures"]
                for k in ("iir_chain", "conv4head_fwd")}
    keys = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by")
    loso_rows = [campaign_kernels[f"bf16_m{FLEET_MODELS}_b{b}"] for b in LOSO_BATCHES]
    kernels = [
        {"name": "iir_sosfiltfilt_chain", "route": "cuda", "source": src + "iir.cu",
         "replaces": pallas + "iir.py:67",
         "launches": serving["iir_chain"] + real["launches"] + fleet["iir_chain"]
         + stateful["iir_chain"],
         "launches_serving": serving["iir_chain"], "launches_preprocessing": real["launches"],
         "launches_fleet": fleet["iir_chain"], "launches_stateful_decoders": stateful["iir_chain"],
         "graph_captures": captures["iir_chain"] + stateful["iir_chain_captures"],
         "graph_replays": serving["replays"] + fleet["replays"] + stateful["replays"],
         **{k: iir[MAIN_BATCH][k] for k in keys}, "library_ms": None},
        {"name": "iir_sosfiltfilt_chain_bandpower", "route": "cuda", "source": src + "iir.cu",
         "replaces": pallas + "iir.py:67", "launches": baselines["bandpower_mlp"]["launches"],
         "rows": bandpower_b1["rows"], **{k: bandpower_b1[k] for k in keys},
         "library_ms": None},
        {"name": "iir_sosfilt_time_major", "route": "cuda", "source": src + "iir.cu",
         "replaces": pallas + "iir.py:67", "launches": serving["iir"],
         **{k: iir[MAIN_BATCH]["causal"][k] for k in keys}, "library_ms": None},
        {"name": "conv4head_fwd", "route": "cuda", "source": src + "conv4head.cu",
         "replaces": pallas + "conv4head.py:303",
         "launches": serving["conv4head_fwd"] + training["conv4head_fwd"] + fleet["conv4head_fwd"]
         + zero["launches"]["conv4head_fwd"],
         "launches_serving": serving["conv4head_fwd"],
         "launches_training": training["conv4head_fwd"], "launches_fleet": fleet["conv4head_fwd"],
         "launches_zero_shot": zero["launches"]["conv4head_fwd"],
         "graph_captures": captures["conv4head_fwd"],
         "graph_replays": serving["replays"] + fleet["replays"],
         **head[MAIN_BATCH], "library_ms": None,
         "fleet_m15": {b: fleet_head[b] for b in (1, MAIN_BATCH)},
         "zero_shot_m15_b50": campaign_kernels[f"f32_m{FLEET_MODELS}_b{ZS_BATCH}"]},
        {"name": "conv4head_bwd_w", "route": "cuda", "source": src + "conv4head_bwd.cu",
         "replaces": pallas + "conv4head.py:323", "launches": training["conv4head_bwd_w"],
         "max_abs_err": b2["w_err"], "ms": b2["w_ms"], "plain_ms": b2["plain_ms"],
         "bound_ms": b2["w_bound"][0], "bound_by": b2["w_bound"][1], "library_ms": None},
        {"name": "conv4head_bwd_x", "route": "cuda", "source": src + "conv4head_bwd.cu",
         "replaces": pallas + "conv4head.py:351", "launches": explain["conv4head_bwd_x"],
         "max_abs_err": b2x["x_err"], "ms": b2x["x_ms"], "device_ms": b2x["x_device_ms"],
         "plain_ms": b2x["x_plain_ms"], "bound_ms": b2x["x_bound"][0],
         "bound_by": b2x["x_bound"][1], "library_ms": None},
        {"name": "conv4head_fwd_bf16", "route": "cuda", "source": src + "conv4head_fwd_bf16.cu",
         "replaces": pallas + "conv4head.py:303",
         **campaign_launches("conv4head_fwd_bf16", training_bf16, sweep, loso, ensemble,
                            augmented),
         "max_abs_err": b16["fwd_err"], "ms": b16["fwd_ms"], "plain_ms": b16["fwd_plain_ms"],
         "bound_ms": b16["fwd_bound"][0], "bound_by": b16["fwd_bound"][1], "library_ms": None,
         "loso_m15": {b: {k[4:]: v for k, v in r.items() if k.startswith("fwd_")}
                      for b, r in zip(LOSO_BATCHES, loso_rows)}},
        {"name": "conv4head_bwd_w_bf16", "route": "cuda", "source": src + "conv4head_bwd_w_bf16.cu",
         "replaces": pallas + "conv4head.py:323",
         **campaign_launches("conv4head_bwd_w_bf16", training_bf16, sweep, loso, ensemble,
                            augmented),
         "max_abs_err": b16["w_err"], "ms": b16["w_ms"], "plain_ms": b16["w_plain_ms"],
         "bound_ms": b16["w_bound"][0], "bound_by": b16["w_bound"][1], "library_ms": None,
         "loso_m15": {b: {k[2:]: v for k, v in r.items() if k.startswith("w_")}
                      for b, r in zip(LOSO_BATCHES[:2], loso_rows[:2])}},
    ]
    # B2x-bf16: a bf16 x's input gradient, launched by section 14 (c)'s bf16 attributions of
    # the shipped FAST and (column tiles) of FAST on one 800-sample window; times and errors
    # from its own phase at X_BF16_SHAPES, and (f)'s: its column tiles at M = 1, B = 100 on
    # one window of 800 and at windows of 500, and the grid at M = 2, B = 8.
    b2x16 = bf16_x[X_BF16_SHAPES[-1]]
    x16_tiles = general["kernels"]["x_bf16_tiles"]
    kernels.append(
        {"name": "conv4head_bwd_x_bf16", "route": "cuda",
         "source": src + "conv4head_bwd_x_bf16.cu", "replaces": pallas + "conv4head.py:351",
         "launches": general["path"]["conv4head_bwd_x_bf16"],
         **{k: b2x16[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                                  "bound_by")},
         "library_ms": None, "rel_l2": b2x16["rel_l2"],
         "shapes": {f"m{m}_b{b}": r for (m, b), r in bf16_x.items()},
         "w800": x16_tiles["w800"], "w500": x16_tiles["w500"],
         "grid_max_rel_l2": max(x16_tiles["grid_rel_l2"].values())})
    # The engine's remaining paths (section 11): early stopping, one step of
    # each training mode (the step-profile child), dense tokens.
    modes = {k: sum(steps[mode]["launches"][k] for mode in FORWARD_MODES[1:])
             for k in HEAD_KERNELS["bf16"]}
    for key, dense_row in (("conv4head_fwd", dense["f32"]), ("conv4head_fwd_bf16", dense["bf16"]),
                           ("conv4head_bwd_w_bf16", None)):
        entry = next(k for k in kernels if k["name"] == key)
        parts = {} if key == "conv4head_fwd" else {"early_stop": early[key],
                                                   "forward_modes": modes[key]}
        if dense_row is not None:
            parts["dense_tokens"] = dense_row["launches"]
            entry[f"dense_m1_b{TRAIN_BATCH}_n{DENSE_WINDOWS}"] = dense_row
        for part, n in parts.items():
            entry[f"launches_{part}"] = n
            entry["launches"] += n
    # Explain and QC (section 12): the attribution CLIs' computing functions and the
    # CSP pipeline's iir band-pass.
    for name, key in (("conv4head_fwd", "conv4head_fwd"), ("conv4head_bwd_x", "conv4head_bwd_x"),
                      ("iir_sosfiltfilt_chain", "iir_chain")):
        entry = next(k for k in kernels if k["name"] == name)
        entry["launches_explain_cli"] = sum(run[key] for run in explain_cli.values())
        entry["launches"] += entry["launches_explain_cli"]
    # Multi-GPU (section 13): the head kernels' launches in the ranks' CLI runs, and
    # B2f-bf16 / B2w-bf16 at the ranks' local shapes.
    mesh_keys = {"iir_sosfiltfilt_chain": "iir_chain", "iir_sosfilt_time_major": "iir"}
    for entry in kernels:
        key = mesh_keys.get(entry["name"], entry["name"])
        entry["launches_mesh"] = mesh["launches"].get(key, 0)
        entry["launches"] += entry["launches_mesh"]
    local = {"conv4head_fwd_bf16": ("bf16", "fwd_"), "conv4head_bwd_w_bf16": ("bf16", "w_"),
             "conv4head_fwd": ("f32", "fwd_"), "conv4head_bwd_w": ("f32", "w_")}
    for entry in kernels:
        if entry["name"] in local:
            precision, prefix = local[entry["name"]]
            entry["mesh_local"] = {k[len(precision) + 1:]: {n[len(prefix):]: v
                                                              for n, v in r.items()
                                                              if n.startswith(prefix)}
                                   for k, r in mesh_kernels.items()
                                   if k.startswith(precision) and f"{prefix}err" in r}
    # Section 14's path (a)-(c) runs B2f-bf16 (a window a launch) and B2w-bf16's,
    # B2f's and B2w's column tiles at windows of 500: their launches there, and (a)'s
    # step's device time and bound of each in its precision.
    for name, precision in zip(HEAD_KERNELS["bf16"] + HEAD_KERNELS["f32"],
                               ("bf16", "bf16", "f32", "f32")):
        entry = next(k for k in kernels if k["name"] == name)
        entry["launches_general_section"] = general["path"][name]
        entry["launches"] += entry["launches_general_section"]
        step = general["steps"][precision]
        entry["step_m75_b64_w500"] = {"device_ms": step["kernels_ms"][name + "_kernel"],
                                      "bound_ms": step["bounds_ms"][name + "_kernel"],
                                      "share_of_step": step["kernels_ms"][name + "_kernel"]
                                      / step["busy_ms"]}
    for name, key in (("conv4head_bwd_w_bf16", "tiles_w500"), ("conv4head_bwd_w", "tiles_w500_f32"),
                      ("conv4head_fwd", "fwd_tiles_w500")):
        next(k for k in kernels if k["name"] == name)["w500"] = general["kernels"][key]
    # B2f-bf16's column tiles: section 14 (c)'s bf16 attributions on one 800-sample
    # window, and (g)'s times and errors ("grid": M = 2, B = 8 against the plain forward).
    fwd16_tiles = general["kernels"]["fwd_bf16_tiles"]
    entry = next(k for k in kernels if k["name"] == "conv4head_fwd_bf16")
    entry["w800"] = fwd16_tiles["w800"]
    entry["grid_max_rel_err"] = max(fwd16_tiles["grid_rel_err"].values())
    # B2x's column tiles: section 14 (c)'s f32 integrated gradients at windows of 500, and
    # (e)'s times and errors ("grid": M = 2, B = 8 against the plain input gradient).
    x_tiles = general["kernels"]["x_tiles_w500"]
    entry = next(k for k in kernels if k["name"] == "conv4head_bwd_x")
    entry["launches_general_section"] = general["path"]["conv4head_bwd_x"]
    entry["launches"] += entry["launches_general_section"]
    entry["w500"] = {**x_tiles["m1_b100"], "m2_b8": x_tiles["m2_b8"],
                     "grid_max_abs_err": max(x_tiles["grid"].values())}
    # The general-geometry kernels (section 14): launches on its path (a)-(c); times
    # and errors from (d) at GEN_ENTRY (B2x-g at the shipped geometry), M = 2, B = 8;
    # "path_check": the errors at the path's shapes (``general_path_checks``).
    replaces = {"fwd": "conv4head.py:303", "bwd_w": "conv4head.py:323", "bwd_x": "conv4head.py:351"}
    for (op, bf16), e in general["kernels"]["entries"].items():
        name = f"conv4head_{op}_general" + ("_bf16" if bf16 else "")
        entry = {"name": name, "route": "cuda", "source": src + "conv4head_general.cu",
                 "replaces": pallas + replaces[op], "launches": general["path"][name],
                 **{k: e[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
                 "library_ms": None, "shape": e["shape"],
                 "f32_core_floor_ms": e["f32_core_floor_ms"]}
        step = general["steps"]["bf16" if bf16 else "f32"]
        kname = f"conv4head_{op}_general_kernel"  # (a)'s bf16 step runs B2f-bf16 and B2w-bf16
        if kname in step["kernels_ms"] and not bf16:
            entry["step_m75_b64_w500"] = {"device_ms": step["kernels_ms"][kname],
                                          "bound_ms": step["bounds_ms"][kname]}
        for k in ("m1_b100", "path_check"):
            if k in e:
                entry[k] = e[k]
        kernels.append(entry)
    f32_step = general["steps"]["f32"]
    print(f"general (section 14): {general['seconds']:.1f} s with its step-profile child; a step "
          f"at M=75 B=64, windows of "
          f"{GEN_GEOMETRY['window_len']}: f32 {f32_step['busy_ms']:.2f} ms (" + ", ".join(
              f"{name}'s column tiles {f32_step['kernels_ms'][k]:.2f} ms of it, "
              f"{f32_step['kernels_ms'][k] / f32_step['busy_ms']:.1%}"
              for name, k in (("B2f", "conv4head_fwd_kernel"), ("B2w", "conv4head_bwd_w_kernel")))
          + f"), bf16 "
          f"{general['steps']['bf16']['busy_ms']:.2f} ms of device time", flush=True)
    print(f"bn LOSO (section 11a): LOSO {bn_loso['loso_s']:.2f} s, peak "
          f"{bn_loso['loso_peak_gb']:.2f} GB; step device time "
          f"{steps['loso CVBlock']['busy_ms']:.2f} ms at M={FLEET_MODELS}", flush=True)
    print(f"multi-GPU (section 13), host clock: (a) the dry run {mesh['dry_s']:.1f} s, (b) the "
          f"ranks {mesh['ranks_s']:.1f} s, (a) and (b) with the corpus handed over "
          f"{mesh['wall_s']:.1f} s, (c) the kernels {mesh['kernels_s']:.1f} s; the smoke "
          f"{time.perf_counter() - t_main:.1f} s in all", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == [CHILD_FLAG]:
        real_data_child(sys.argv[2:])
    elif sys.argv[1:2] == [STEP_PROFILE_FLAG]:
        step_profile_child(*sys.argv[2:4])
    elif sys.argv[1:2] == [BN_LOSO_FLAG]:
        bn_loso_child(sys.argv[2:])
    elif sys.argv[1:2] == [MESH_FLAG]:
        mesh_child(sys.argv[2:])
    else:
        main()
