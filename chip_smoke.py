#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``lstm_ctc_ocr_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which stops the run with a non-zero exit when it fails:

1. The card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   and the build of every CUDA kernel from ``lstm_ctc_ocr_torch/csrc`` with
   nvcc, one process per source (its time and ptxas report).
2. Kernel phase: each of the seven kernels, and the beam search's kernel,
   against its plain PyTorch version on the card.
   ``bilstm_fwd`` (vs ``bilstm_fwd_reference``), residuals on and off, f32
   and bf16 at batch 64 with T=23 (the W=96 bucket) and T=111 (W=448),
   ragged batches of 37 with empty rows at T=23 and 7, and T=1 at batch 3;
   tolerance f32 max |difference| <= 1e-4, bf16 <= 4 bf16 ulps of the
   reference's magnitude (4 * max|ref| / 256, as tests/test_rnn_pallas.py
   defines it), and two bf16 calls bit-identical. ``bilstm_bwd`` (vs
   ``bilstm_bwd_reference``) on the same cases, plus a bf16 ragged batch of
   37 with empty rows at T=7 and T=1 at batch 3: f32 <= 1e-4 relative to
   the largest entry of each output, bf16 within 4 bf16 ulps of it, two
   calls bit-identical.
   ``lstm_fwd`` and ``lstm_bwd`` (vs ``lstm_fwd_reference`` /
   ``lstm_bwd_reference``) on the same cases and bars at the stacked head's
   H=512, ``lstm_fwd`` also at the edges of its bf16 cluster (a ragged
   batch at T=7, T=1 at batch 3 and H=256, H=136 and H=8; two calls
   bit-identical), and the two-scan BiLSTM pair on them at H=256 against
   the fused BiLSTM kernels (the A/B of the JAX package's
   tools/bench_rnn.py).
   ``ctc_fwd`` and ``ctc_bwd`` (vs ``ctc_forward_reference`` /
   ``ctc_backward_reference``) at batch 64 with T=23, L=6 and T=111, L=24,
   and (checked, not timed) with L=15/16 and L=31/32 (both sides of each
   path boundary of both kernels: one warp per example with one or two
   states a lane up to S=64, one block per example past it), L=64 and
   L=511 (one thread a state; phase 14 goes past it), L=0 alone, T=1,
   T=15/16/17 and 31/32/33 (around one and two chunks of the warp kernels'
   ring) and batch 1, each batch ragged with an empty label, an infeasible
   example and a one-frame example where it is long enough: ``ctc_fwd``'s
   logZ and alphas bit-identical to the plain version, the gradient f32
   <= 1e-5, two calls of each bit-identical. ``conv_bn``
   (``conv3x3_bn_relu`` vs its plain version and vs the unfused
   ``ConvSingle`` layer, through ``tools/bench_conv_bn``'s functions) at
   the conv4_1 and conv4_2 geometry, batch 64: f32 <= 2e-5 absolute and
   relative, bf16 <= 2e-2, two runs bit-identical. Then
   CUDA-event timings (median of 50 after warm-up) of each kernel's
   wrapper call, and the kernel's own device time from ``torch.profiler``
   (null, and no failure, where the profiler's device tracing comes back
   empty), beside its plain
   version, its bound and a library yardstick: cuDNN's ``torch.nn.LSTM`` on
   a packed sequence (bidirectional or one direction; forward, and backward
   alone), ``torch.nn.functional.ctc_loss`` forward alone (for
   ``ctc_fwd``) and forward+backward (for ``ctc_bwd``), and the
   unfused cuDNN conv + BN + ReLU layer (plain versions: median of 10).
   Yardsticks are timed here only; the port never calls them. For the
   redesigned kernels (``conv_bn``, ``lstm_bwd``, ``lstm_fwd``,
   ``bilstm_fwd`` and ``bilstm_bwd``, each in bf16, ``ctc_fwd`` and
   ``ctc_bwd``) the
   phase also prints each device kernel's registers, shared memory and
   spills from the build's ptxas report and the TFLOP/s it reached on the
   device beside its bound, for the four cluster kernels the cluster's
   shape and how many such clusters the card holds at once, and for the
   kernels of the main path the host time of a wrapper call.
   ``beam_decode`` (``csrc/beam.cu`` through the op
   ``lstm_ctc_ocr_torch::beam_decode``, vs ``beam_decode_reference``) at
   the ``crnn_longline.eval_beam`` cell's shapes, N=64, K=16, C=64 and T=79,
   95 and 111, f32 and bf16 logits at scales 1 and 10, ragged lengths with 0
   and T, ``merge_repeated`` off (and on at T=111): ids equal entry for
   entry, two calls bit-identical, one launch a call counted from 0; then
   its CUDA-event, device and host times at T=23, 111 and 1,209 (f32),
   the plain search's at T=111, and its bound (the logits read once, the
   ids written once, over HBM bandwidth).
   Kernels 1-4 at the ``htr_puigcerver.train_graphed`` cell's shapes (batch
   16, T=224, each row's own 137-222 frames, H=256, the first layer's 1,280
   features, forget bias 0), each case's launches counted from 0:
   ``bilstm_fwd`` and ``bilstm_bwd`` in f32 and bf16 at the bars above;
   two layers chained as the five-layer head chains them, layer 1's
   backward fed layer 2's input gradient (at the one-layer bar against the
   plain backward on the same inputs; the whole chain at twice it against
   the plain versions chained; two chains bit-identical); ``ctc_fwd`` /
   ``ctc_bwd`` at C=80, L=24 at the bars above; then their device times
   there. The ``kernels`` line's rows of kernels 1-4 carry these cases
   under ``htr_cell``.
3. Eval phase, the serving path: the evaluation entry point
   (``engine/test.py``, bf16, batch 64) on the tracked releases —
   ``lstm_ctc`` on ``data/val`` under ``BN_EVAL`` batch and moving and
   ``digit4`` on ``data/val_digit4`` with greedy decode; ``lstm_records`` on
   ``data/val``, ``longline`` on ``data/val_longline`` and ``scene`` on
   ``data/val_scene`` with their default beam decode (width 16). Each
   accuracy must be within 2 images of the release's recorded accuracy
   (checkpoints/README.md), ``bilstm_fwd``'s launch count must grow by
   exactly the number of decode calls, and the beam kernel's by the same
   number for a beam release (0 for a greedy one).
4. Synthetic-stream phase, the default feed of ``lstm/lstm.yml``
   (``DATA_BACKEND: synth``, ``RENDERER: native``; the GPU machine has no
   Pillow): (a) the native renderer (``native/synth.cpp``, built with g++,
   and the committed glyph atlas) regenerates all 500
   ``data/val_digit4_native`` PNGs, which the JAX package wrote, with the
   same labels from ``gen_rand`` and the same seeds — 500/500 bit-identical,
   labels and pixels; (b) host images/s of ``get_batch`` at batch 64, inline
   and with ``effective_workers(TRAIN.NUM_WORKERS)`` fork workers started
   in this process, which holds a CUDA context, beside ``os.cpu_count()``;
   (c) 60 steps of ``lstm/lstm.yml`` at full width (batch 64, bf16, Adam)
   from that stream through ``train_net`` — every loss finite, the mean of
   the last 10 below that of the first 10, ``bilstm_fwd``, ``bilstm_bwd``,
   ``ctc_fwd`` and ``ctc_bwd`` each launched once a step and ``bilstm_fwd``
   also once per validation decode on the synthetic validation batch — then
   steps/s over warm steps, CUDA-synchronised; (d) five steps through the
   training CLI with ``DATA_BACKEND pool``, ``POOL_SIZE 512``: finite
   losses, the four kernels once a step.
5. Train phase, the training path, at the full width of
   ``lstm/lstm.yml`` (batch 64, bf16, Adam) on a records file written on
   the spot from ``data/val`` (which ``DATA_DEVICE: auto`` holds on the
   device), validating on the synthetic stream with the native renderer: (a) 60 steps from a fresh init through
   ``train_net`` — every loss finite, the mean of the last 10 below that of
   the first 10, and each of the four kernels launched exactly once a step
   (``bilstm_fwd`` also once per validation decode); (b) 20 steps of
   fine-tuning from the ``lstm_ctc`` release through the training CLI, a
   snapshot, and the evaluation entry point on it: at least 470/500 on
   ``data/val`` — the data trained on, so this only shows that training
   does not wreck a good model; (c) one f32 step's parameter gradients
   with the kernels against the same step with the plain versions put in
   their place: each tensor within 1e-4 of its largest entry (or of 1e-3 of
   the largest gradient overall, for the tensors whose true gradient is
   zero); then steps/s and images/s over warm steps, CUDA-synchronised,
   printed beside the synthetic feed's in the same run.
6. Stacked-LSTM phase: the model a user gets by overriding
   ``LSTM_train.make_head`` with two stacked unidirectional LSTMs of 512
   units, at full width (conv stack 64-512, 64 classes, batch 64, bf16,
   Adam, the same records file): 60 steps from a seed through ``train_net``
   (loss falls; ``lstm_fwd`` and ``lstm_bwd`` launched once per layer per
   step, ``lstm_fwd`` also per layer per validation decode; the BiLSTM
   kernels not at all), a snapshot, ``test_net(model=...)`` on it (it runs
   and counts; no accuracy bar, the model is 60 steps old), the f32
   gradient comparison of 4(c) (zero-gradient tensors held to 1e-2 of the
   largest gradient overall), the rate and a profile with the device busy
   ms per step.
7. Serve phase: the serving export (``engine/serve.py``) and the release
   tools, batch 64, bf16. (a) Every release of the eval phase exported
   with ``export_decoder``: every release one ``torch.export`` program
   per bucket its val set falls in (a beam program holds the beam search
   as the one op ``lstm_ctc_ocr_torch::beam_decode``, so it exports in
   seconds: ``longline`` at W=320, 384 and 448, all 200 of its files), and
   the stacked-LSTM snapshot of phase 6 at ``data/val``'s buckets;
   the seconds of each bucket's export and the artifacts' MB are printed.
   (b) A fresh process that imports ``lstm_ctc_ocr_torch`` and nothing
   else of the repo (no ``jax``, no ``lstm_ctc_ocr_tpu`` in its
   ``sys.modules`` afterwards) loads each artifact directory and decodes
   the same files in eval's order through ``ExportedDecoder``, so the
   batches are eval's: every string identical to the eval phase's
   prediction for that file (phase 6's ``test_net(model=...)`` for the
   stacked model), the accuracy within the release's bar where the whole
   val set is served, and each bucket captured as a CUDA graph at its
   first call; then the same files once more under a ``torch.profiler``
   trace of the device, every call a replay (``serve.graph_replays``),
   the same strings, and in the trace's kernels ``bilstm_fwd`` launched
   exactly once a call (``lstm_fwd`` twice a call of the stacked model),
   the beam kernel once a call of a beam release; for one greedy and one
   beam release (``GRAPH_COMPARED``) each bucket's first chunk through
   its graph and through the loaded program called eagerly: ids equal,
   one replay a bucket counted by ``serve.graph_replays``. (c) Greedy
   ``lstm_ctc`` at W=96: the frozen program, replayed as a graph and
   called eagerly, against the live decode, in turns, images/s and p50 of
   a call, ids equal. (d)
   ``tools/calibrate_bn.py`` (8 batches of 64, native renderer) into a
   copy of the ``lstm_ctc`` release, params unchanged, then eval under
   ``BN_EVAL: moving``: at least 484/500. (e) ``tools/release_ckpt.py
   --verify-dir data/val`` on phase 5's fine-tuned snapshot, released into
   a scratch root: the released file's accuracy. Nothing touches the
   tracked ``checkpoints/``.
8. Dispatch phase: the device-resident dataset (``DATA_DEVICE``,
   ``data/device_store.py``) and 8 steps a dispatch
   (``TRAIN.STEPS_PER_DISPATCH``), one CUDA graph per bucket, at full width
   (``lstm/lstm.yml``, batch 64, bf16, Adam) on the records file: (a) from
   one saved state (parameters, moments, BN buffers, count), 8 graphed
   steps against 8 eager steps, run twice, for the gather chunk on the
   records store and the host-batch chunk on the records file's host feed:
   losses and state bit for bit, or, where two eager runs differ, within
   their difference, which is printed; (b) steps/s, images/s, device busy
   ms per step and the device's idle share (``torch.profiler``), and a
   graph replay's device time by CUDA events, for the store eager (K=1)
   and graphed, a 2,048-image pool feed (``POOL_REFRESH 2``) graphed, the
   synthetic stream (7 fork workers; a group breaks where the bucket
   changes) and the stacked-LSTM model on the store, beside the host-fed
   records rate of phase 5, each at its bucket; (c) ``train_net`` with
   ``DATA_DEVICE on`` and ``STEPS_PER_DISPATCH 8``, 60 steps: the loss
   falls, snapshots at 20, 40 and 60, the four kernels once a step (graph
   replays counted by their captures' launches), ``bilstm_fwd`` also once
   per validation decode.
9. Profiles: ``torch.profiler`` over a few warm decode calls and over a few
   warm train steps: device time by kernel and the device's busy share of
   the wall.
10. Data-parallel phase (``parallel/mesh.py``; the card has one GPU, so a
    group of one NCCL rank, and two gloo ranks sharing the card): (a)
    ``train_net`` in a process of ``torch.distributed.run --nproc_per_node
    1`` (``PARALLEL auto``, ``DATA_DEVICE on``, 8-step graphs, 60 steps of
    ``lstm/lstm.yml`` at full width, batch 64, bf16, Adam, the records
    file) against the same run with ``PARALLEL off`` in a fresh process of
    its own, started as that one is: losses and final state bit for bit (or
    within two such ``off`` runs' difference, printed), the four kernels
    once a step and ``bilstm_fwd`` once per validation decode; the same
    ``off`` run in this process, after the earlier phases, is printed
    beside them (it shares this process's history, the compared runs do
    not); in the process of (a), a mesh of that one
    rank runs the store's 8-step graph with its NCCL collectives captured:
    graph against eager, and steps/s, device busy ms a step and idle share
    beside the same graph without collectives (in turns) and phase 8's; (b)
    two processes over gloo on CUDA tensors, three f32 Momentum steps on
    their 32 rows of each of three fixed batches of 64 against one rank on
    the global batch: each step-1 gradient within 1e-5 of the largest or,
    where the one-rank run on the CPU (plain versions, CPU convs) already
    differs from the card's by more, within that difference (the conv2 to
    conv3_2 biases: batch norm downstream all but cancels their gradient);
    losses within 1e-5; the final state within the CPU tests' bar (rtol
    2e-5, atol 2e-6) or the CPU run's distance from the card's; ranks
    bit-identical; each rank's kernels counted; (c) the same two ranks run
    ``test_net`` on
    ``data/val`` (``lstm_ctc``, ``BN_EVAL batch``, batch 64 as 2 x 32):
    the strings against the eval phase's, file by file (a file moved by
    batch composition is printed; the release's bar holds).
11. Tools phase: the measurement tools of ``lstm_ctc_ocr_torch/tools``,
    each run in this process through ``main(argv)`` with its output
    captured and the kernel counters set to 0 just before it and read just
    after, at its default shapes with short windows (``profile_step`` and
    ``attrib_step`` at W=128 with the native renderer, ``attrib_step`` with
    20 warm steps): every line parses and carries the JAX tool's keys;
    ``bench_ctc`` launches kernels 3 and 4, ``bench_rnn`` kernels 1 and 2,
    ``bench_decode`` (and ``--frozen``, through the served program's custom
    op) kernel 1, ``profile_step`` and ``attrib_step`` kernels 1-4, each
    exactly as often as its calls say (the default ``attrib_step`` variant
    once a step); ``bench_fold_h``'s f32 gate (TF32 off) passes;
    ``bench_data --renderers native`` gives the synth, pool and records
    (phase 5's file) rates and no error line; ``train_net`` of
    ``lstm/lstm.yml`` with ``PROFILE_DIR`` (``PROFILE_START 3
    PROFILE_STEPS 3``) writes one trace naming ``bilstm_fwd_cluster_kernel``
    and ``ctc_fwd_warp_kernel``, with the same losses, bit for bit, as the
    run without it. Then ``attrib_step``'s default step beside phase 5's
    eager step, and ``bench_decode``'s greedy W=96 full step beside the
    eval phase's p50, and the phase's seconds.
12. DSL phase: the model DSL (``models/network.py``) and the offline
    surface, at full width. (a) The JAX package's ``crnn.LSTM_train``
    chain verbatim as a port ``Network`` subclass, the ``lstm_ctc`` release
    loaded through the weight bridge by ``test_net(model=)`` on
    ``data/val`` (bf16, batch 64): every string equal to the eval phase's
    fixed model's, at least 483/500, one ``bilstm_fwd`` launch a decode
    call. (b) ``train_net``, 20 steps on phase 5's records file: the DSL
    net and the fixed model from one seed, and a DSL ``.lstm(512, 2)``
    head and the ``make_head`` stacked model, losses and final state bit
    for bit (cuDNN deterministic for both runs), kernels 1-4 (5-6) 20
    launches a run (2 x 20). (c) A DSL net of ``fc``, ``avg_pool``,
    ``dropout``, ``conv_norm`` (BN and crelu), ``upconv``, ``lrn``,
    ``batch_normalization``, ``pva_negation_block_v2`` and
    ``pva_inception_res_block`` forward and backward in f32: card against
    CPU within 1e-4 of each tensor's scale at ``keep_prob`` 1; two seeded
    runs at 0.5 give bit-identical outputs (masks) and gradients within
    1e-5 (the backward's overlapping max pool and cuDNN's weight gradients
    sum with atomics). (d) ``convert_ckpt2npy`` of the release,
    then 5 steps from the ``.npy`` against 5 from the ``.ckpt.npz``, bit
    for bit. (e) ``gen_img.run(500)`` under ``digit4.yml`` + ``RENDERER
    native``: the names and decoded pixels of ``data/val_digit4_native``;
    ``build_records --synth 512`` trains 5 steps; ``vis_batch
    --from-store`` on a pool: tiles equal to the store's gathered rows.
    (f) Kernels 3-4 against the C++ oracle (``native/ctc_ref.py``) at
    batch 64, T=23/L=6 and T=111/L=24 (the kernel phase's cases, infeasible,
    empty-label and one-frame rows included): the loss within 1e-5
    relative, each example's gradient within max(1e-5, 1e-6 * its loss),
    the f32 rounding of the log-space sums (the plain version's distance
    printed beside it); these comparison launches count on no path.
    ``python3 chip_smoke.py --phase 12`` runs the build and this phase
    alone (its reference strings from the fixed model's eval, made there).
13. Shifted phase: ``CONV_IMPL shifted`` (``ops/conv.py``, conv2 to conv5
    as one GEMM over the taps) at full width, bf16, batch 64. (a) conv2 to
    conv5 at W=96 and W=160 against ``F.conv2d`` (cuDNN): f32 forward
    within rtol 2e-4 / atol 2e-5, both gradients within rtol 1e-4 / atol
    1e-4; each lowering's bf16 forward within rtol 2^-8 / atol 1e-2 of the
    f32 conv of the same bf16 values (the sum both round once), the share
    of outputs where the two differ; CUDA-event ms of both lowerings in
    both dtypes
    and the kernels a call launches. (b) ``test_net`` of ``lstm_ctc`` under
    ``shifted``: at least 483/500, the strings that differ from the eval
    phase's counted, one ``bilstm_fwd`` launch and six shifted convs a
    decode call. (c) 20 ``train_net`` steps on phase 5's records file,
    ``shifted`` against ``xla`` from one init: losses finite and falling,
    the f32 pair within 1e-4 relative (the bf16 distance printed), kernels
    1-4 20 launches a run; eager steps/s of both on the store. (d) The
    store as one 8-step CUDA graph under ``shifted``: against 8 eager steps
    bit for bit (or within two eager runs' difference, printed), steps/s
    and device ms a step beside the ``xla`` graph's (this phase's and phase
    8's). (e) ``attrib_step``'s ``conv=shifted`` line (phase 11's) against
    its default step. (f) A DSL net with dropout (keep_prob 0.5) on the
    store: its 8-step graph against 8 eager steps, a ``train_net`` resumed
    at step 4 drawing the uninterrupted run's masks, a mask on the card
    equal to the CPU's for its key. (g) The TF tools: without tensorflow
    each raises ``ImportError`` naming it; with it, export then import of
    ``data/val`` gives its records file byte for byte. ``python3
    chip_smoke.py --phase 13`` runs the build and this phase alone.
14. Width phase: every hidden width and label length the JAX package
    runs. (a) ``bilstm_fwd``/``bilstm_bwd``/``lstm_fwd``/``lstm_bwd``
    against their plain versions at H in 50 (zero-padded to the kernels'
    step), 300, 512 (the bf16 clusters' limit), 768 and 1024 (the wide
    recurrence) per direction, f32 and bf16, at batch 64 with T=23 and
    T=111, a ragged batch of 37 with empty rows and T=1 at batch 3: phase
    2's bars (f32 1e-4, the backwards relative to each output's largest
    entry; bf16 4 ulps of the reference's magnitude), two calls bit for
    bit, outputs zero past ``lens``; the kernels' ptxas reports and the
    BiLSTM's bf16 clusters at H=512; CUDA-event ms of each wrapper at
    H=512, 768 and 1024 (batch 64, T=23) beside cuDNN's ``nn.LSTM`` at the
    same H and the bound. (b) ``lstm/lstm.yml`` with ``TRAIN.NUM_HID
    1024`` (H=512 a direction): ``train_net`` 60 steps on phase 5's
    records file (finite, falling loss; kernels 1-4 once a step), one f32
    step's gradients against the plain versions (phase 5(c)'s bar),
    ``test_net`` on the snapshot (counts, no bar), its most populous
    bucket exported and served from a fresh process (strings equal to
    ``test_net``'s; served again under a device trace, every call a
    replay launching ``bilstm_fwd`` once), then 20 steps of the stacked
    head at ``.lstm(1024, 2)`` (kernels 5-6 once a layer a step). (c) The
    CTC kernels at L=512,
    600 and 1024, T=2L+9, batch 16 with an empty label, an infeasible and
    a one-frame example: logZ and alphas bit for bit, the gradient <=
    1e-5, two calls bit for bit. (d) ``conv3x3_bn_relu`` at C_in 1 and 24
    (zero channels up to 16) against its plain version at phase 2's bars.
    ``python3 chip_smoke.py --phase 14`` runs the build and this phase
    alone.

The line before the last is one JSON object ``{"kernels": [...]}`` with the
seven kernels and the beam kernel (and the rates, the synthetic stream's,
the serve, the dispatch, the data-parallel, the tools, the DSL and the
shifted phase's numbers); the last line is ``{"ok": true, "device":
{...}}``. Per-image eval lines, the training runs', the serve phase's, the
tools', the DSL and the shifted phase's output go to ``chiprun_out/``.
The width phase's numbers join the JSON line, and its training output goes
to ``chip_smoke_width.log`` beside the others.
"""

import contextlib
import io
import json
import os
import random
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, dense FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# the releases whose served graphs the serve phase compares with their
# programs called eagerly, bucket by bucket: one greedy, one beam
GRAPH_COMPARED = ('lstm_ctc/batch', 'lstm_records/beam')
# (label, config, val dir, BN_EVAL, decoder, images, least correct): the
# releases' recorded numbers (checkpoints/README.md), less 2 images
EVALS = [
    ('lstm_ctc/batch', 'lstm/lstm.yml', 'data/val', 'batch', 'greedy', 500,
     483),
    ('lstm_ctc/moving', 'lstm/lstm.yml', 'data/val', 'moving', 'greedy', 500,
     484),
    ('digit4/batch', 'lstm/digit4.yml', 'data/val_digit4', 'batch', 'greedy',
     500, 485),
    ('lstm_records/beam', 'lstm/records.yml', 'data/val', 'batch', 'beam',
     500, 490),
    ('longline/beam', 'lstm/longline.yml', 'data/val_longline', 'batch',
     'beam', 200, 191),
    ('scene/beam', 'lstm/scene.yml', 'data/val_scene', 'batch', 'beam', 200,
     193),
]


def check(cond, msg):
    if not cond:
        raise RuntimeError('chip_smoke: ' + msg)


def median_ms(fn, reps=50, warmup=5):
    """Median CUDA-event time of ``fn`` over ``reps`` calls after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps=100, warmup=5):
    """Host time of one call of ``fn``: the host clock over ``reps`` calls
    that end without waiting for the device (a wrapper's checks,
    allocations and launch). The device's queue absorbs the calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * dt / reps


def device_ms(fn, names, reps=20):
    """Device time of one call of ``fn`` spent in the kernels whose name
    contains one of ``names``, from ``torch.profiler`` over ``reps`` calls.
    A CUDA-event time of one short launch on an idle device is mostly the
    host's launch path; this is the kernel alone. The profiler's device
    tracing can come back empty on a machine that restricts it: the pass is
    then made once more, and if it is empty again the result is ``None``
    (printed as null, "not measured"). Nothing is checked against this
    number, and ``ms`` in the kernels line is the CUDA-event time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(2):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and any(n in e.key for n in names))
        if total > 0:
            return total / 1e3 / reps
    print('profiler: no device time seen in {}; device_ms not measured'
          .format(names), flush=True)
    return None


def bilstm_case(t_len, n, dtype, ragged, seed, h=256, d=512,
                lens_range=None):
    """Inputs at an eval shape: x [T, N, D], W [D, 8H], per-direction U [H,
    4H] and b [4H], and the projections xpf/xpb, all on the card; with
    ``lens_range`` (least, most) each row's frames are drawn from it."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).cuda().to(dtype)
    x = rnd(t_len, n, d, scale=0.5)
    w = rnd(d, 8 * h, scale=d ** -0.5)
    uf, ub = rnd(h, 4 * h, scale=h ** -0.5), rnd(h, 4 * h, scale=h ** -0.5)
    bf, bb = rnd(4 * h, scale=0.1), rnd(4 * h, scale=0.1)
    if lens_range:
        lens = torch.randint(lens_range[0], lens_range[1] + 1, (n,),
                             generator=g)
    elif ragged:
        lens = torch.randint(0, t_len + 1, (n,), generator=g)
        lens[:3] = 0
        lens[3] = t_len
    else:                      # eval widths: time steps near the bucket's T
        lens = torch.randint(max(1, t_len - 8), t_len + 1, (n,), generator=g)
    lens = lens.to(torch.int32).cuda()
    xp = (x.reshape(t_len * n, d) @ w).reshape(t_len, n, 8 * h)
    return dict(x=x, w=w, xpf=xp[:, :, :4 * h], xpb=xp[:, :, 4 * h:], uf=uf,
                ub=ub, bf=bf, bb=bb, lens=lens)


def kernel_args(c):
    return (c['xpf'], c['xpb'], c['uf'], c['ub'], c['bf'], c['bb'], c['lens'])


def max_err(got, want, dtype):
    """Max |difference| over the outputs, and whether each output is within
    its tolerance: 1e-4 in f32, 4 bf16 ulps of its own magnitude in bf16."""
    err, ok = 0.0, True
    for g, w in zip(got, want):
        w = w.float()
        e = float((g.float() - w).abs().max())
        scale = float(w.abs().max()) or 1.0
        ok = ok and e <= (1e-4 if dtype == torch.float32 else 4 * scale / 256)
        err = max(err, e)
    return err, ok


def rel_err(got, want, dtype, layers=1):
    """Over the outputs: max |difference|, max |difference| / max|reference|,
    and whether each output is within 1e-4 (f32) or 4 bf16 ulps (bf16) of
    its own largest entry, times the ``layers`` whose errors it holds."""
    worst_abs, worst_rel, ok = 0.0, 0.0, True
    for g, w in zip(got, want):
        w = w.float()
        e = float((g.float() - w).abs().max())
        rel = e / (float(w.abs().max()) or 1.0)
        ok = ok and rel <= layers * (1e-4 if dtype == torch.float32
                                     else 4 / 256)
        worst_abs, worst_rel = max(worst_abs, e), max(worst_rel, rel)
    return worst_abs, worst_rel, ok


def bilstm_bwd_args(c, rnn_cuda, seed, forget_bias=1.0):
    """The backward's inputs for a forward case: the residuals the forward
    kernel writes and random output cotangents."""
    _, gf, hf, cf, _, gb, hb, cb = rnn_cuda.bilstm_fwd(
        *kernel_args(c), forget_bias=forget_bias, save_residuals=True)
    g = torch.Generator().manual_seed(1000 + seed)
    dof, dob = ((torch.randn(hf.shape, generator=g) * 0.1).cuda().to(hf.dtype)
                for _ in range(2))
    return (dof, dob, gf, hf, cf, gb, hb, cb, c['uf'], c['ub'], c['lens'])


def bilstm_bwd_bound_ms(c, dtype):
    """Least time for the backward's work on an H100: dout, gates, h, c and
    U read once, dx, dU and db written once, over HBM bandwidth; or the live
    steps' two products (dg U^T and h_prev^T dg, 2*H*4H each per row, step
    and direction) over the dtype's peak; the larger of the two."""
    t_len, n, four_h = c['xpf'].shape
    h = four_h // 4
    es = torch.tensor([], dtype=dtype).element_size()
    tn = t_len * n
    read = (2 * tn * h + 2 * tn * four_h + 4 * tn * h + 2 * h * four_h) * es \
        + 4 * n
    written = 2 * tn * four_h * es + 4 * (2 * h * four_h + 2 * four_h)
    flops = 2 * int(c['lens'].sum()) * 4 * h * four_h
    t_bytes = (read + written) / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def cudnn_backward_yardstick(c):
    """cuDNN's LSTM backward alone (its input projection's backward
    included): gradients of a random cotangent with respect to the input and
    the weights, from one retained forward."""
    lstm, _ = cudnn_yardstick(c)
    x = c['x'].clone().requires_grad_()
    packed = torch.nn.utils.rnn.pack_padded_sequence(
        x, c['lens'].cpu(), enforce_sorted=False)
    out = lstm(packed)[0].data
    gout = torch.randn_like(out)
    inputs = [x] + list(lstm.parameters())
    return lambda: torch.autograd.grad(out, inputs, gout, retain_graph=True)


def ctc_case(ctc, t_len, l_max, seed, n=64, c=64, t_min=None):
    """A ragged CTC batch on the card with a full-length example (row 0,
    its label repeating a character where L > 1), an empty label (row 1),
    an infeasible example (row 2, where L > 1) and a one-frame example (row
    3), as far as N reaches, the other rows ``t_min`` (default ``T - 8``)
    to T frames long, and the kernels' inputs made from it."""
    rng = np.random.RandomState(seed)
    logits = (rng.randn(n, t_len, c) * 2).astype(np.float32)
    labels = rng.randint(1, c, (n, l_max)).astype(np.int32)
    label_lens = rng.randint(min(max(1, l_max - 2), l_max), l_max + 1,
                             n).astype(np.int32)
    logit_lens = rng.randint(t_min or max(1, t_len - 8), t_len + 1,
                             n).astype(np.int32)
    if l_max > 1:
        labels[0, 1] = labels[0, 0]
    label_lens[0], logit_lens[0] = l_max, t_len
    if n > 1:
        label_lens[1] = 0
    if n > 2 and l_max > 1:
        label_lens[2], logit_lens[2] = l_max, l_max - 1
    if n > 3:
        label_lens[3], logit_lens[3] = min(1, l_max), 1
    for i in range(n):
        labels[i, label_lens[i]:] = 0
    case = {k: torch.from_numpy(v).cuda() for k, v in (
        ('logits', logits), ('labels', labels), ('label_lens', label_lens),
        ('logit_lens', logit_lens))}
    ext = ctc.extended_labels(case['labels'])
    # a label matrix of width 0 (L=0) gets a two-wide skip mask from
    # _transition_masks (the JAX package's does the same); the one state's
    # is its first column
    skip, final, valid = (ctc._as_additive(m)[:, :ext.shape[1]].contiguous()
                          for m in ctc._transition_masks(
                              ext, case['label_lens']))
    logp = torch.log_softmax(case['logits'], dim=-1)
    case['g'] = ctc._gather_logp(logp, ext, case['logit_lens']).contiguous()
    case['masks'] = (skip, valid, final)
    return case


def ctc_bound_ms(case, backward):
    """Least time for a CTC recursion on an H100: g and the three masks read
    once (the backward also alphas, logz and lens) and alphas and logz (the
    backward: grad) written once, over HBM bandwidth; or ~14 f32 operations
    per (example, frame, state) — three exp, one log, adds and maxima — over
    the f32 peak; the larger of the two."""
    n, t_len, s_len = case['g'].shape
    cube = 4 * n * t_len * s_len
    nbytes = cube + 3 * 4 * n * s_len + cube + 4 * n
    if backward:
        nbytes += cube + 4 * n
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 14 * n * t_len * s_len / PEAK_FLOPS[torch.float32]
    return 1e3 * max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def ctc_library_yardstick(case):
    """``torch.nn.functional.ctc_loss`` on the case: forward + backward (the
    one library call that computes what ``ctc_fwd`` and ``ctc_bwd`` compute
    together) and the forward alone under ``torch.no_grad()`` (the alpha
    recursion and the loss, what ``ctc_fwd`` computes); returns the two
    callables and the per-example losses."""
    lp = torch.log_softmax(case['logits'], dim=-1).transpose(0, 1) \
        .contiguous().requires_grad_()
    args = (case['labels'].long(), case['logit_lens'].long(),
            case['label_lens'].long())

    def run():
        loss = torch.nn.functional.ctc_loss(lp, *args, blank=0,
                                            reduction='sum',
                                            zero_infinity=True)
        return torch.autograd.grad(loss, lp)

    def forward():
        with torch.no_grad():
            return torch.nn.functional.ctc_loss(lp, *args, blank=0,
                                                reduction='none',
                                                zero_infinity=True)
    return run, forward, forward()


def cudnn_lstm(x, lens, directions, forget_bias=1.0):
    """cuDNN's ``nn.LSTM`` carrying ``directions``, one ``(W, U, b)`` or two
    for a bidirectional layer (gate order i, f, g, o; forget_bias folded
    into the bias), and ``x`` as a packed sequence."""
    d = x.shape[2]
    h = directions[0][1].shape[0]
    lstm = torch.nn.LSTM(d, h, bidirectional=len(directions) == 2) \
        .cuda().to(x.dtype)

    def reorder(m):            # ..., [i, j, f, o] blocks -> [i, f, j, o]
        i, j, f, o = m.split(h, dim=-1)
        return torch.cat([i, f, j, o], dim=-1)
    with torch.no_grad():
        for sfx, (w, u, b) in zip(('', '_reverse'), directions):
            getattr(lstm, 'weight_ih_l0' + sfx).copy_(reorder(w).t())
            getattr(lstm, 'weight_hh_l0' + sfx).copy_(reorder(u).t())
            fb = torch.zeros(4 * h, device=b.device, dtype=b.dtype)
            fb[h:2 * h] = forget_bias
            getattr(lstm, 'bias_ih_l0' + sfx).copy_(reorder(b) + fb)
            getattr(lstm, 'bias_hh_l0' + sfx).zero_()
    lstm.flatten_parameters()          # cuDNN's packed weight buffer
    packed = torch.nn.utils.rnn.pack_padded_sequence(
        x, lens.cpu(), enforce_sorted=False)
    return lstm, packed


def cudnn_yardstick(c):
    """cuDNN's LSTM with a case's weights: bidirectional for a BiLSTM case,
    one direction for an ``lstm_case``."""
    if 'u' in c:
        return cudnn_lstm(c['x'], c['lens'], [(c['w'], c['u'], c['b'])])
    h4 = c['uf'].shape[1]
    return cudnn_lstm(c['x'], c['lens'],
                      [(c['w'][:, :h4], c['uf'], c['bf']),
                       (c['w'][:, h4:], c['ub'], c['bb'])])


def bound_ms(c, dtype, with_residuals=False):
    """Least time for the kernel's work on an H100: each input byte read
    once and each output written once over HBM bandwidth, or the recurrent
    products of the live steps (2*H*4H per row, step and direction) over the
    dtype's peak; the larger of the two."""
    t_len, n, four_h = c['xpf'].shape
    h = four_h // 4
    es = torch.tensor([], dtype=dtype).element_size()
    read = 2 * (t_len * n * four_h + h * four_h + four_h) * es + 4 * n
    written = 2 * t_len * n * h * es
    if with_residuals:
        written += 2 * t_len * n * (four_h + 2 * h) * es
    flops = 2 * int(c['lens'].sum()) * 2 * h * four_h
    t_bytes = (read + written) / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def lstm_case(t_len, n, dtype, ragged, seed, h=512, d=512):
    """Inputs of one stacked-head layer: x [T, N, D], W [D, 4H], U [H, 4H],
    b [4H] and the projection xp, all on the card."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).cuda().to(dtype)
    x = rnd(t_len, n, d, scale=0.5)
    w, u, b = rnd(d, 4 * h, scale=d ** -0.5), rnd(h, 4 * h, scale=h ** -0.5), \
        rnd(4 * h, scale=0.1)
    if ragged:
        lens = torch.randint(0, t_len + 1, (n,), generator=g)
        lens[:3] = 0
        lens[3], lens[4] = t_len, 1
    else:
        lens = torch.randint(max(1, t_len - 8), t_len + 1, (n,), generator=g)
    lens = lens.to(torch.int32).cuda()
    xp = (x.reshape(t_len * n, d) @ w).reshape(t_len, n, 4 * h)
    return dict(x=x, w=w, u=u, b=b, lens=lens, xp=xp)


def lstm_bound_ms(c, dtype, backward):
    """Least time for one direction's work on an H100. Forward: x_proj, U, b
    and lens read once, out written once, and the live steps' recurrent
    product (2*H*4H per row and step). Backward: dout, gates, h, c and U
    read once, dx, dU and db written once, and the live steps' two products.
    The larger of bytes over HBM bandwidth and operations over the dtype's
    peak."""
    t_len, n, four_h = c['xp'].shape
    h = four_h // 4
    es = torch.tensor([], dtype=dtype).element_size()
    tn = t_len * n
    live = int(c['lens'].sum())
    if backward:
        nbytes = (tn * h + tn * four_h + 2 * tn * h + h * four_h) * es \
            + 4 * n + tn * four_h * es + 4 * (h * four_h + four_h)
        flops = 2 * live * 2 * h * four_h
    else:
        nbytes = (tn * four_h + h * four_h + four_h) * es + 4 * n \
            + tn * h * es
        flops = live * 2 * h * four_h
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def ptxas_report(build, name, kernels):
    """Registers, static shared memory and spills of the kernels of
    ``csrc/<name>.cu`` whose mangled names contain one of ``kernels``, from
    the ptxas report (``-Xptxas -v``) of this run's build, one line each."""
    rows, current = {}, None
    for line in build.build_log(name).splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            current = next((k for k in kernels if k in entry.group(1)), None)
            if current:
                rows[current] = {}
            continue
        if current is None:
            continue
        spill = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                          line)
        if spill:
            rows[current]['spill_stores'] = int(spill.group(1))
            rows[current]['spill_loads'] = int(spill.group(2))
        regs = re.search(r'Used (\d+) registers', line)
        if regs:
            smem = re.search(r'(\d+) bytes smem', line)
            rows[current]['registers'] = int(regs.group(1))
            rows[current]['static_smem'] = int(smem.group(1)) if smem else 0
    for kernel, row in rows.items():
        print('ptxas {} {}: {}'.format(name, kernel, json.dumps(row)),
              flush=True)
    return rows


def achieved(label, flops, ms, bound):
    """The rate ``flops`` reach in ``ms`` beside the bound's: one line."""
    if not ms:
        print('{}: device time not measured, rate not measured'.format(label),
              flush=True)
        return None
    tflops = flops / ms / 1e9
    print('{}: {:.1f} TFLOP/s achieved on the device, the bound {:.4f} ms is '
          '{:.2%} of the device time ({} bound)'.format(
              label, tflops, bound[0], bound[0] / ms, bound[1]), flush=True)
    return tflops


def lstm_phase(rnn, rnn_cuda, build):
    """``lstm_fwd`` / ``lstm_bwd`` against their plain versions at H=512 on
    every case, timings at the stacked head's shapes, and the scan pair on
    these kernels against the fused BiLSTM kernels at H=256."""
    ub = rnn_cuda.units_per_block(512)
    ptxas = ptxas_report(build, 'lstm_bwd', ['lstm_bwd_cluster_kernel',
                                             'lstm_bwd_du_mma_kernel'])
    ptxas['cluster'] = rnn_cuda.cluster_report('lstm_bwd', 512, ub)
    print('lstm_bwd bf16 cluster at H=512: {}'.format(
        json.dumps(ptxas['cluster'])), flush=True)
    fwd_ptxas = ptxas_report(build, 'lstm_fwd', ['lstm_fwd_cluster_kernel'])
    fwd_ptxas['cluster'] = rnn_cuda.cluster_report('lstm_fwd', 512, ub)
    print('lstm_fwd bf16 cluster at H=512: {}'.format(
        json.dumps(fwd_ptxas['cluster'])), flush=True)
    # batch 64 is four row groups: one wave when four clusters fit
    check(fwd_ptxas['cluster']['max_active_clusters'] > 0,
          'no lstm_fwd cluster fits the card')
    errs = {}
    for i, (label, t_len, n, dtype, ragged) in enumerate(BILSTM_CASES):
        c = lstm_case(t_len, n, dtype, ragged, seed=40 + i)
        args = (c['xp'], c['u'], c['b'], c['lens'])
        out = rnn_cuda.lstm_fwd(*args)
        got = rnn_cuda.lstm_fwd(*args, save_residuals=True)
        again = rnn_cuda.lstm_fwd(*args, save_residuals=True)
        want = rnn_cuda.lstm_fwd_reference(*args, save_residuals=True)
        torch.cuda.synchronize()
        e_fwd, ok = max_err(got, want, dtype)
        ok = ok and torch.equal(out, got[0]) and all(
            torch.equal(a, b) for a, b in zip(got, again))
        g = torch.Generator().manual_seed(1040 + i)
        dout = (torch.randn(out.shape, generator=g) * 0.1).cuda().to(dtype)
        bwd_args = (dout,) + tuple(got[1:]) + (c['u'], c['lens'])
        e_bwd, rel, ok_b = rel_err(rnn_cuda.lstm_bwd(*bwd_args),
                                   rnn_cuda.lstm_bwd_reference(*bwd_args),
                                   dtype)
        torch.cuda.synchronize()
        print('lstm check H=512 {:24s} fwd max|diff| {:.3e}, bwd {:.3e} '
              '({:.2e} of the largest entry) within tolerance: {}'.format(
                  label, e_fwd, e_bwd, rel, ok and ok_b), flush=True)
        check(ok, 'lstm_fwd {}: max|diff| {}'.format(label, e_fwd))
        check(ok_b, 'lstm_bwd {}: {} of the largest entry'.format(label, rel))
        errs[label] = {'lstm_fwd': e_fwd, 'lstm_bwd': e_bwd}
    # the forward's bf16 cluster at its edges: a short ragged batch, T = 1
    # with a partial row group, and H = 136 and 8 (U zero-filled past H)
    for i, (label, t_len, n, ragged, h) in enumerate(LSTM_FWD_EDGES):
        c = lstm_case(t_len, n, torch.bfloat16, ragged, seed=60 + i, h=h)
        args = (c['xp'], c['u'], c['b'], c['lens'])
        got = rnn_cuda.lstm_fwd(*args, save_residuals=True)
        again = rnn_cuda.lstm_fwd(*args, save_residuals=True)
        want = rnn_cuda.lstm_fwd_reference(*args, save_residuals=True)
        torch.cuda.synchronize()
        e_fwd, ok = max_err(got, want, torch.bfloat16)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        print('lstm_fwd check {:28s} max|diff| {:.3e} within tolerance: {}, '
              'two calls bit-identical: {}'.format(label, e_fwd, ok, same),
              flush=True)
        check(ok and same, 'lstm_fwd {}: max|diff| {}, identical {}'.format(
            label, e_fwd, same))
        errs[label] = {'lstm_fwd': e_fwd}

    timings = {}
    for label, t_len, dtype in (('bf16 N=64 T=23', 23, torch.bfloat16),
                                ('bf16 N=64 T=111', 111, torch.bfloat16),
                                ('f32 N=64 T=23', 23, torch.float32),
                                ('f32 N=64 T=111', 111, torch.float32)):
        c = lstm_case(t_len, 64, dtype, False, seed=7)
        args = (c['xp'], c['u'], c['b'], c['lens'])
        res = rnn_cuda.lstm_fwd(*args, save_residuals=True)
        g = torch.Generator().manual_seed(1007)
        dout = (torch.randn(res[0].shape, generator=g) * 0.1).cuda().to(dtype)
        bwd_args = (dout,) + tuple(res[1:]) + (c['u'], c['lens'])
        row = {'fwd_ms': median_ms(lambda: rnn_cuda.lstm_fwd(*args)),
               'fwd_residuals_ms': median_ms(
                   lambda: rnn_cuda.lstm_fwd(*args, save_residuals=True)),
               'bwd_ms': median_ms(lambda: rnn_cuda.lstm_bwd(*bwd_args))}
        row['fwd_bound_ms'], row['fwd_bound_by'] = lstm_bound_ms(c, dtype,
                                                                 False)
        row['bwd_bound_ms'], row['bwd_bound_by'] = lstm_bound_ms(c, dtype,
                                                                 True)
        if dtype == torch.bfloat16:     # the stacked head's compute type
            lstm, packed = cudnn_yardstick(c)
            with torch.no_grad():
                lib_out = torch.nn.utils.rnn.pad_packed_sequence(
                    lstm(packed)[0], total_length=t_len)[0]
                row['cudnn_vs_kernel_max_abs_diff'] = float(
                    (lib_out.float() - res[0].float()).abs().max())
                row['fwd_library_ms'] = median_ms(lambda: lstm(packed))
            row.update({
                'fwd_device_ms': device_ms(lambda: rnn_cuda.lstm_fwd(*args),
                                           ['lstm_fwd_']),
                'fwd_host_ms': host_ms(lambda: rnn_cuda.lstm_fwd(*args)),
                'bwd_device_ms': device_ms(
                    lambda: rnn_cuda.lstm_bwd(*bwd_args), ['lstm_bwd_']),
                'fwd_plain_ms': median_ms(
                    lambda: rnn_cuda.lstm_fwd_reference(*args), reps=10,
                    warmup=2),
                'bwd_plain_ms': median_ms(
                    lambda: rnn_cuda.lstm_bwd_reference(*bwd_args), reps=10,
                    warmup=2),
                'bwd_library_ms': median_ms(cudnn_backward_yardstick(c))})
            live = int(c['lens'].sum())
            row['fwd_device_tflops'] = achieved(
                'lstm_fwd H=512 ' + label, live * 2 * 512 * 2048,
                row['fwd_device_ms'], (row['fwd_bound_ms'],
                                       row['fwd_bound_by']))
            row['bwd_device_tflops'] = achieved(
                'lstm_bwd H=512 ' + label, 2 * live * 2 * 512 * 2048,
                row['bwd_device_ms'], (row['bwd_bound_ms'],
                                       row['bwd_bound_by']))
        timings[label] = row
        print('lstm timing H=512 {:16s} {}'.format(label, json.dumps(row)),
              flush=True)

    # the two-scan pair on kernels 5/6 against the fused kernels 1/2, H=256
    for t_len in (23, 111):
        c = bilstm_case(t_len, 64, torch.bfloat16, False, seed=9)
        h4 = c['uf'].shape[1]
        cells = {'fw': {'w': c['w'][:, :h4], 'u': c['uf'], 'bias': c['bf']},
                 'bw': {'w': c['w'][:, h4:], 'u': c['ub'], 'bias': c['bb']}}
        x = c['x'].transpose(0, 1).contiguous()          # [N, T, D]
        lens = c['lens']

        def pair(cl, xx, ll):
            return rnn.bilstm_scan_pair(cl, xx, ll, scan=rnn.lstm)
        with torch.no_grad():
            diff = float((pair(cells, x, lens).float()
                          - rnn.bilstm(cells, x, lens).float()).abs().max())
            row = {'fused_fwd_ms': median_ms(
                       lambda: rnn.bilstm(cells, x, lens)),
                   'pair_fwd_ms': median_ms(lambda: pair(cells, x, lens))}
        # two [D, 4H] projections against one [D, 8H]: cuBLAS may sum them
        # in another order, so a bf16 projection entry can round the other
        # way; outputs are below 1 in magnitude, the bar is 8 bf16 ulps of 1
        check(diff <= 8 / 256, 'scan pair vs fused BiLSTM T={}: max|diff| {}'
              .format(t_len, diff))
        # forward + backward: gradients of x and of every weight
        cells_g = {k: {p: v.clone().requires_grad_() for p, v in cell.items()}
                   for k, cell in cells.items()}
        leaves = [x.clone().requires_grad_()] + [
            v for cell in cells_g.values() for v in cell.values()]

        def train_pass(fn):
            return lambda: torch.autograd.grad(
                fn(cells_g, leaves[0], lens).float().sum(), leaves)
        row['fused_fwd_bwd_ms'] = median_ms(train_pass(rnn.bilstm))
        row['pair_fwd_bwd_ms'] = median_ms(train_pass(pair))
        row['pair_vs_fused_max_abs_diff'] = diff
        timings['pair H=256 bf16 N=64 T={}'.format(t_len)] = row
        print('lstm scan pair (kernels 5/6) vs fused BiLSTM (kernels 1/2), '
              'projection included, H=256 bf16 N=64 T={}: {}'.format(
                  t_len, json.dumps(row)), flush=True)
    timings['ptxas'] = ptxas
    timings['fwd_ptxas'] = fwd_ptxas
    return errs, timings


def conv_bn_bound_ms(n, w, h, ci, co, dtype):
    """Least time for the fused conv+BN+ReLU on an H100: x, the kernel and
    the three channel vectors read once and the output written once over HBM
    bandwidth, or the nine taps' products (2*Ci*Co*9 per output position)
    over the dtype's dense peak; the larger of the two."""
    es = torch.tensor([], dtype=dtype).element_size()
    nbytes = (n * w * h * (ci + co) + 9 * ci * co) * es + 3 * 4 * co
    flops = 2 * n * w * h * co * ci * 9
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def conv_bn_phase(bench, conv_bn_cuda, build):
    """``conv3x3_bn_relu`` against its plain version and the unfused layer at
    the conv4_1 / conv4_2 geometry, batch 64, then timings; the A/B itself
    (``tools/bench_conv_bn.run``) with the launch count read around it."""
    errs, timings = {}, {}
    ptxas = ptxas_report(build, 'conv_bn', ['conv_bn_conv_mma_kernel'])
    ptxas.setdefault('conv_bn_conv_mma_kernel', {})['dynamic_smem'] = \
        build.library('conv_bn').conv_bn_mma_smem()
    for tag, w, h, ci, co in bench.SHAPES:
        for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            label = '{} {}'.format(tag, 'f32' if dtype == torch.float32
                                   else 'bf16')
            case = bench.make_case(64, w, h, ci, co, dtype, 'cuda')
            args = bench.fused_args(case)
            layer = bench.unfused_layer(case)
            ldt = None if dtype == torch.float32 else dtype
            with torch.no_grad():
                got = conv_bn_cuda.conv3x3_bn_relu(*args)
                again = conv_bn_cuda.conv3x3_bn_relu(*args)
                want = conv_bn_cuda.conv3x3_bn_relu_reference(*args)
                unfused = layer(case['x'], ldt)
            torch.cuda.synchronize()

            def close(ref):
                """max |difference| and its largest share of the bar
                ``tol + tol * |ref|``."""
                d = (got.float() - ref.float()).abs()
                return float(d.max()), float(
                    (d / (tol + tol * ref.float().abs())).max())
            err, share = close(want)
            # the unfused layer rounds the bias separately, takes the
            # two-pass variance and sums in cuDNN's order: the same bar
            vs_layer, share_layer = close(unfused)
            ok, ok_layer = share <= 1.0, share_layer <= 1.0
            same = torch.equal(got, again)
            print('conv_bn check {:14s} N=64 max|diff| vs plain {:.3e} ({:.0%} '
                  'of the bar {:g} absolute + relative), vs the unfused layer '
                  '{:.3e} ({:.0%}), two runs bit-identical: {}'.format(
                      label, err, share, tol, vs_layer, share_layer, same),
                  flush=True)
            check(ok and same and tuple(got.shape) == (64, co, w, h),
                  'conv_bn {}: max|diff| {}, identical {}'.format(label, err,
                                                                  same))
            check(ok_layer, 'conv_bn {} vs ConvSingle: {}'.format(label,
                                                                  vs_layer))
            errs[label] = err
            with torch.no_grad():
                row = {
                    'kernel_ms': median_ms(
                        lambda: conv_bn_cuda.conv3x3_bn_relu(*args)),
                    'device_ms': device_ms(
                        lambda: conv_bn_cuda.conv3x3_bn_relu(*args),
                        ['conv_bn_']),
                    'plain_ms': median_ms(
                        lambda: conv_bn_cuda.conv3x3_bn_relu_reference(*args),
                        reps=10, warmup=2),
                    'library_ms': median_ms(
                        lambda: layer(case['x'], ldt)),
                    # the conv kernel alone, without the layout, taps,
                    # statistics and normalisation launches
                    'conv_device_ms': device_ms(
                        lambda: conv_bn_cuda.conv3x3_bn_relu(*args),
                        ['conv_bn_conv']),
                    'vs_unfused_max_abs_diff': vs_layer}
            row['bound_ms'], row['bound_by'] = conv_bn_bound_ms(
                64, w, h, ci, co, dtype)
            row['device_tflops'] = achieved(
                'conv_bn ' + label, 2 * 64 * w * h * co * ci * 9,
                row['device_ms'], (row['bound_ms'], row['bound_by']))
            timings[label] = row
            print('conv_bn timing {:14s} {}'.format(label, json.dumps(row)),
                  flush=True)
    # the A/B as its user runs it; its launches are the path's count
    conv_bn_cuda.conv3x3_bn_relu.launches = 0
    for tag, w, h, ci, co in bench.SHAPES:
        for row in bench.run(tag, 64, w, h, ci, co, torch.bfloat16, 'cuda'):
            print('conv_bn a/b {}'.format(json.dumps(row)), flush=True)
    launches = conv_bn_cuda.conv3x3_bn_relu.launches
    check(launches > 0, 'the conv+BN A/B launched no kernel')
    timings['ptxas'] = ptxas
    return errs, timings, launches


# (label, T, N, ragged, H): lstm_fwd's bf16 cluster beyond BILSTM_CASES
LSTM_FWD_EDGES = [('bf16 ragged N=37 T=7 H=512', 7, 37, True, 512),
                  ('bf16 N=3 T=1 H=256', 1, 3, False, 256),
                  ('bf16 ragged N=20 T=6 H=136', 6, 20, True, 136),
                  ('bf16 N=5 T=11 H=8', 11, 5, True, 8)]

BILSTM_CASES = [('f32 N=64 T=23', 23, 64, torch.float32, False),
                ('f32 N=64 T=111', 111, 64, torch.float32, False),
                ('bf16 N=64 T=23', 23, 64, torch.bfloat16, False),
                ('bf16 N=64 T=111', 111, 64, torch.bfloat16, False),
                ('bf16 ragged N=37 T=23', 23, 37, torch.bfloat16, True),
                ('f32 ragged N=37 T=23', 23, 37, torch.float32, True)]


# (label, T, N, ragged): bilstm_bwd's bf16 cluster beyond BILSTM_CASES
BILSTM_BWD_EDGES = [('bf16 ragged N=37 T=7', 7, 37, True),
                    ('bf16 N=3 T=1', 1, 3, False)]


def bilstm_bwd_check(rnn_cuda, label, args, dtype, layers=1):
    """``bilstm_bwd`` on one case's inputs against ``bilstm_bwd_reference``
    (:func:`rel_err`'s bar times ``layers``), two calls bit-identical;
    returns the largest gap."""
    got = rnn_cuda.bilstm_bwd(*args)
    again = rnn_cuda.bilstm_bwd(*args)
    want = rnn_cuda.bilstm_bwd_reference(*args)
    torch.cuda.synchronize()
    err, rel, ok = rel_err(got, want, dtype, layers)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    print('bilstm_bwd check {:24s} max|diff| {:.3e} ({:.2e} of the '
          'largest entry) within tolerance: {}, two calls bit-identical: '
          '{}'.format(label, err, rel, ok, same), flush=True)
    check(ok and same, 'bilstm_bwd {}: {} of the largest entry, '
          'identical {}'.format(label, rel, same))
    return err


def bilstm_bwd_phase(rnn_cuda, build):
    """``bilstm_bwd`` against ``bilstm_bwd_reference`` on every case and at
    the edges of its bf16 cluster (two calls bit-identical in every case),
    then timings at the main path's shapes and the bf16 cluster's ptxas
    report."""
    ptxas = ptxas_report(build, 'bilstm_bwd', ['bilstm_bwd_cluster_kernel',
                                               'bilstm_bwd_du_mma_kernel'])
    ptxas['cluster'] = rnn_cuda.cluster_report(
        'bilstm_bwd', 256, rnn_cuda.units_per_block(256))
    print('bilstm_bwd bf16 cluster at H=256: {}'.format(
        json.dumps(ptxas['cluster'])), flush=True)
    # batch 64 is eight clusters (four row groups, two directions)
    check(ptxas['cluster']['max_active_clusters'] > 0,
          'no bilstm_bwd cluster fits the card')
    errs = {}
    cases = BILSTM_CASES + [(label, t_len, n, torch.bfloat16, ragged)
                            for label, t_len, n, ragged in BILSTM_BWD_EDGES]
    for i, (label, t_len, n, dtype, ragged) in enumerate(cases):
        c = bilstm_case(t_len, n, dtype, ragged, seed=20 + i)
        errs[label] = bilstm_bwd_check(rnn_cuda, label,
                                       bilstm_bwd_args(c, rnn_cuda, i), dtype)
    timings = {}
    for label, t_len in (('bf16 N=64 T=23', 23), ('bf16 N=64 T=111', 111)):
        c = bilstm_case(t_len, 64, torch.bfloat16, False, seed=7)
        args = bilstm_bwd_args(c, rnn_cuda, 7)
        row = {
            'kernel_ms': median_ms(lambda: rnn_cuda.bilstm_bwd(*args)),
            'device_ms': device_ms(lambda: rnn_cuda.bilstm_bwd(*args),
                                   ['bilstm_bwd_']),
            'recurrence_device_ms': device_ms(
                lambda: rnn_cuda.bilstm_bwd(*args),
                ['bilstm_bwd_cluster_kernel']),
            'host_ms': host_ms(lambda: rnn_cuda.bilstm_bwd(*args)),
            'plain_ms': median_ms(
                lambda: rnn_cuda.bilstm_bwd_reference(*args), reps=10,
                warmup=2),
            'library_ms': median_ms(cudnn_backward_yardstick(c)),
        }
        row['bound_ms'], row['bound_by'] = bilstm_bwd_bound_ms(
            c, torch.bfloat16)
        row['device_tflops'] = achieved(
            'bilstm_bwd H=256 ' + label,
            2 * int(c['lens'].sum()) * 4 * 256 * 1024, row['device_ms'],
            (row['bound_ms'], row['bound_by']))
        timings[label] = row
        print('bilstm_bwd timing {:16s} {}'.format(label, json.dumps(row)),
              flush=True)
    timings['ptxas'] = ptxas
    return errs, timings


# (label, T, L, N, timed): the main path (S=13, the warp kernels with K=1),
# longline (S=49, K=2), both sides of each of the kernels' path boundaries
# (S=31/33: K=1/2; S=63/65: K=2/the block kernels), the block kernels'
# widths up to their 1023 states, and the warp kernels' edges: one state
# (L=0 alone), T=1, T on both sides of one and two ring chunks (16 steps
# each), one example
CTC_CASES = [('N=64 T=23 L=6', 23, 6, 64, True),
             ('N=64 T=111 L=24', 111, 24, 64, True),
             ('N=64 T=50 L=15', 50, 15, 64, False),
             ('N=64 T=50 L=16', 50, 16, 64, False),
             ('N=64 T=100 L=31', 100, 31, 64, False),
             ('N=64 T=100 L=32', 100, 32, 64, False),
             ('N=64 T=160 L=64', 160, 64, 64, False),
             ('N=64 T=560 L=511', 560, 511, 64, False),
             ('N=64 T=23 L=0', 23, 0, 64, False),
             ('N=64 T=1 L=6', 1, 6, 64, False),
             ('N=64 T=15 L=6', 15, 6, 64, False),
             ('N=64 T=16 L=6', 16, 6, 64, False),
             ('N=64 T=17 L=6', 17, 6, 64, False),
             ('N=64 T=31 L=15', 31, 15, 64, False),
             ('N=64 T=32 L=24', 32, 24, 64, False),
             ('N=64 T=33 L=24', 33, 24, 64, False),
             ('N=1 T=23 L=6', 23, 6, 1, False),
             ('N=1 T=111 L=24', 111, 24, 1, False)]


def ctc_check(ctc, ctc_cuda, label, case, l_max):
    """``ctc_fwd`` / ``ctc_bwd`` on one case against their plain versions:
    ``ctc_fwd``'s logZ and alphas bit-identical, the gradient f32 <= 1e-5,
    the empty label's logZ finite, the infeasible example's at -inf with a
    zero gradient, two calls of each bit-identical. Returns the gaps and
    the kernels' and the plain versions' (logZ, alphas)."""
    g, masks, lens = case['g'], case['masks'], case['logit_lens']
    n = g.shape[0]
    logz, alphas = ctc_cuda.ctc_forward(g, *masks)
    logz2, alphas2 = ctc_cuda.ctc_forward(g, *masks)
    grad = ctc_cuda.ctc_backward(g, *masks, alphas, logz, lens)
    again = ctc_cuda.ctc_backward(g, *masks, alphas, logz, lens)
    logz_r, alphas_r = ctc.ctc_forward_reference(g, *masks)
    grad_r = ctc.ctc_backward_reference(g, *masks, alphas_r, logz_r, lens)
    torch.cuda.synchronize()

    def close(a, b):
        return float((a - b).abs().max()), bool(
            ((a - b).abs() <= 1e-5 + 1e-5 * b.abs()).all())
    e_z, _ = close(logz, logz_r)
    e_a, _ = close(alphas, alphas_r)
    e_g, ok_g = close(grad, grad_r)
    fwd_equal = torch.equal(logz, logz_r) and torch.equal(alphas, alphas_r)
    special = True
    if n > 1:                                  # the empty label
        special = bool(torch.isfinite(logz[1]))
    if n > 2 and l_max > 1:                    # the infeasible example
        special = special and float(logz[2]) <= ctc.NEG_INF / 2 \
            and not bool(grad[2].any())
    same = (torch.equal(grad, again) and torch.equal(logz, logz2)
            and torch.equal(alphas, alphas2))
    print('ctc check {:16s} S={:4d} max|diff| logz {:.2e} alphas {:.2e} '
          'grad {:.2e}; ctc_fwd bit-identical to its plain version: {}; '
          'infeasible row: zero gradient, empty label finite: {}; two '
          'calls of each bit-identical: {}'.format(
              label, g.shape[2], e_z, e_a, e_g, fwd_equal, special, same),
          flush=True)
    check(fwd_equal and ok_g and special and same,
          'ctc {}: out of tolerance, not bit-identical or calls differ'
          .format(label))
    return ({'ctc_fwd': max(e_z, e_a), 'ctc_bwd': e_g},
            (logz, alphas, logz_r, alphas_r))


def ctc_phase(ctc, ctc_cuda, build):
    """``ctc_fwd`` / ``ctc_bwd`` against their plain versions on every case
    (``ctc_fwd`` bit-identical; two calls of each bit-identical), then
    timings beside ``torch.nn.functional.ctc_loss``."""
    errs, timings = {}, {}
    timings['ptxas'] = ptxas_report(build, 'ctc', [
        'ctc_fwd_warp_kernelILi1', 'ctc_fwd_warp_kernelILi2',
        'ctc_bwd_warp_kernelILi1', 'ctc_bwd_warp_kernelILi2',
        'ctc_bwd_kernel', 'ctc_fwd_kernel'])
    for label, t_len, l_max, n, timed in CTC_CASES:
        case = ctc_case(ctc, t_len, l_max, seed=t_len, n=n)
        g, masks, lens = case['g'], case['masks'], case['logit_lens']
        errs[label], (logz, alphas, logz_r, alphas_r) = ctc_check(
            ctc, ctc_cuda, label, case, l_max)
        if not timed:
            continue

        lib, lib_fwd, lib_losses = ctc_library_yardstick(case)
        feasible = logz > ctc.NEG_INF / 2
        row = {
            'fwd_ms': median_ms(lambda: ctc_cuda.ctc_forward(g, *masks)),
            'fwd_device_ms': device_ms(
                lambda: ctc_cuda.ctc_forward(g, *masks), ['ctc_fwd_']),
            'fwd_host_ms': host_ms(lambda: ctc_cuda.ctc_forward(g, *masks)),
            'bwd_ms': median_ms(lambda: ctc_cuda.ctc_backward(
                g, *masks, alphas, logz, lens)),
            'bwd_device_ms': device_ms(lambda: ctc_cuda.ctc_backward(
                g, *masks, alphas, logz, lens), ['ctc_bwd_']),
            'bwd_host_ms': host_ms(lambda: ctc_cuda.ctc_backward(
                g, *masks, alphas, logz, lens)),
            'fwd_plain_ms': median_ms(
                lambda: ctc.ctc_forward_reference(g, *masks), reps=10,
                warmup=2),
            'bwd_plain_ms': median_ms(
                lambda: ctc.ctc_backward_reference(g, *masks, alphas_r,
                                                   logz_r, lens), reps=10,
                warmup=2),
            'library_fwd_ms': median_ms(lib_fwd),
            'library_fwd_bwd_ms': median_ms(lib),
            'library_vs_kernel_max_abs_diff': float(
                (lib_losses + logz)[feasible].abs().max()),
        }
        row['fwd_bound_ms'], row['fwd_bound_by'] = ctc_bound_ms(case, False)
        row['bwd_bound_ms'], row['bwd_bound_by'] = ctc_bound_ms(case, True)
        for d in ('fwd', 'bwd'):
            row[d + '_device_tflops'] = achieved(
                'ctc_{} {}'.format(d, label), 14 * g.numel(),
                row[d + '_device_ms'],
                (row[d + '_bound_ms'], row[d + '_bound_by']))
        timings[label] = row
        print('ctc timing {:16s} {}'.format(label, json.dumps(row)),
              flush=True)
    return errs, timings


def bilstm_fwd_check(rnn_cuda, label, c, dtype, forget_bias=1.0):
    """``bilstm_fwd`` on one case, residuals off and on, against
    ``bilstm_fwd_reference`` (:func:`max_err`'s bars), two calls
    bit-identical; returns ``{residuals: largest gap}``."""
    errs = {}
    for res in (False, True):
        def call(fn):
            return fn(*kernel_args(c), forget_bias=forget_bias,
                      save_residuals=res)
        got, again = call(rnn_cuda.bilstm_fwd), call(rnn_cuda.bilstm_fwd)
        want = call(rnn_cuda.bilstm_fwd_reference)
        torch.cuda.synchronize()
        err, ok = max_err(got, want, dtype)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        print('kernel check {:24s} residuals={!s:5s} max|diff| {:.3e} '
              'within tolerance: {}, two calls bit-identical: {}'.format(
                  label, res, err, ok, same), flush=True)
        check(ok and same, '{} residuals={}: max|diff| {} out of '
              'tolerance or calls differ'.format(label, res, err))
        errs[res] = err
    return errs


def bilstm_fwd_phase(rnn_cuda, build):
    """Correctness on every case (bf16 also two calls bit-identical), then
    timings at the eval shapes and the bf16 cluster's ptxas report."""
    cases = [('f32 N=64 T=23', 23, 64, torch.float32, False),
             ('bf16 N=64 T=23', 23, 64, torch.bfloat16, False),
             ('bf16 N=64 T=111', 111, 64, torch.bfloat16, False),
             ('bf16 ragged N=37 T=23', 23, 37, torch.bfloat16, True),
             ('bf16 ragged N=37 T=7', 7, 37, torch.bfloat16, True),
             ('bf16 N=3 T=1', 1, 3, torch.bfloat16, False)]
    ptxas = ptxas_report(build, 'bilstm_fwd', ['bilstm_fwd_cluster_kernel'])
    ptxas['cluster'] = rnn_cuda.cluster_report(
        'bilstm_fwd', 256, rnn_cuda.units_per_block(256))
    print('bilstm_fwd bf16 cluster at H=256: {}'.format(
        json.dumps(ptxas['cluster'])), flush=True)
    # batch 64 is eight clusters (four row groups, two directions)
    check(ptxas['cluster']['max_active_clusters'] > 0,
          'no bilstm_fwd cluster fits the card')
    errs = {}
    for i, (label, t_len, n, dtype, ragged) in enumerate(cases):
        c = bilstm_case(t_len, n, dtype, ragged, seed=i)
        for res, err in bilstm_fwd_check(rnn_cuda, label, c, dtype).items():
            errs[(label, res)] = err

    timings = {}
    for label, t_len in (('bf16 N=64 T=23', 23), ('bf16 N=64 T=111', 111)):
        c = bilstm_case(t_len, 64, torch.bfloat16, False, seed=7)
        args = kernel_args(c)
        x2d = c['x'].reshape(-1, c['x'].shape[2])

        def with_projection():
            xp = (x2d @ c['w']).reshape(t_len, 64, -1)
            h4 = c['uf'].shape[1]
            rnn_cuda.bilstm_fwd(xp[:, :, :h4], xp[:, :, h4:], *args[2:])
        lstm, packed = cudnn_yardstick(c)
        with torch.no_grad():
            lib_out = torch.nn.utils.rnn.pad_packed_sequence(
                lstm(packed)[0], total_length=t_len)[0]
        of, ob = rnn_cuda.bilstm_fwd(*args)
        lib_diff = float((lib_out.float()
                          - torch.cat([of, ob], -1).float()).abs().max())
        with torch.no_grad():
            row = {
                'kernel_ms': median_ms(lambda: rnn_cuda.bilstm_fwd(*args)),
                'device_ms': device_ms(lambda: rnn_cuda.bilstm_fwd(*args),
                                       ['bilstm_fwd_']),
                'host_ms': host_ms(lambda: rnn_cuda.bilstm_fwd(*args)),
                'kernel_residuals_ms': median_ms(
                    lambda: rnn_cuda.bilstm_fwd(*args, save_residuals=True)),
                'plain_ms': median_ms(
                    lambda: rnn_cuda.bilstm_fwd_reference(*args), reps=10,
                    warmup=2),
                'kernel_plus_proj_ms': median_ms(with_projection),
                'library_ms': median_ms(lambda: lstm(packed)),
            }
        row['bound_ms'], row['bound_by'] = bound_ms(c, torch.bfloat16)
        row['device_tflops'] = achieved(
            'bilstm_fwd H=256 ' + label,
            2 * int(c['lens'].sum()) * 2 * 256 * 1024, row['device_ms'],
            (row['bound_ms'], row['bound_by']))
        row['cudnn_vs_kernel_max_abs_diff'] = lib_diff
        timings[label] = row
        print('kernel timing {:16s} {}'.format(label, json.dumps(row)),
              flush=True)
    timings['ptxas'] = ptxas
    return errs, timings


# the htr_puigcerver.train_graphed cell's shapes: batch 16 at the store's
# width of 1,792 px (T=224), each line's own 137-222 frames, H=256 a
# direction, the first layer reading 1,280 features and each later one
# 512, forget bias 0; CTC over 80 classes with labels of 22-24 characters
HTR_T, HTR_N, HTR_LENS, HTR_FEATURES, HTR_FORGET_BIAS = 224, 16, (137, 222), \
    1280, 0.0


def htr_stack(fwd, bwd, c, top, dout):
    """Two BiLSTM layers chained as the handwriting model's head chains
    them, with ``fwd``/``bwd`` (the kernels or their plain versions): layer
    1 on ``c``'s projections, layer 2 on layer 1's output through ``top``'s
    W; layer 2's backward from the cotangents ``dout``, its input gradient
    ``dxp W^T`` split by direction into layer 1's backward. Returns layer
    2's outputs, layer 1's cotangents, layer 1's backward inputs after them
    and layer 1's gradients."""
    t_len, n, four_h = c['xpf'].shape
    h, lens, fb = four_h // 4, c['lens'], HTR_FORGET_BIAS
    r1 = fwd(*kernel_args(c), forget_bias=fb, save_residuals=True)
    x2 = torch.cat([r1[0], r1[4]], dim=-1).reshape(t_len * n, 2 * h)
    xp2 = (x2 @ top['w']).reshape(t_len, n, 2 * four_h)
    r2 = fwd(xp2[:, :, :four_h], xp2[:, :, four_h:], top['uf'], top['ub'],
             top['bf'], top['bb'], lens, forget_bias=fb, save_residuals=True)
    g2 = bwd(*dout, *r2[1:4], *r2[5:8], top['uf'], top['ub'], lens)
    dx2 = (g2[0].reshape(t_len * n, four_h) @ top['w'][:, :four_h].t()
           + g2[1].reshape(t_len * n, four_h) @ top['w'][:, four_h:].t()
           ).reshape(t_len, n, 2 * h)
    d1 = (dx2[:, :, :h].contiguous(), dx2[:, :, h:].contiguous())
    res1 = (*r1[1:4], *r1[5:8], c['uf'], c['ub'], lens)
    return (r2[0], r2[4]), d1, res1, bwd(*d1, *res1)


def htr_phase(rnn_cuda, ctc_cuda, ctc):
    """Kernels 1-4 at the htr_puigcerver.train_graphed cell's shapes
    (:data:`HTR_T` and beside it), each case's launches counted from 0:
    ``bilstm_fwd`` and ``bilstm_bwd`` on one layer, f32 and bf16, at
    :func:`bilstm_fwd_check`'s and :func:`bilstm_bwd_check`'s bars; two
    layers chained (:func:`htr_stack`), layer 1's backward fed layer 2's
    input gradient, at the one-layer bar against the plain backward on the
    same inputs, and the whole chain against the plain versions chained at
    twice the bar, two chains bit-identical; ``ctc_fwd``/``ctc_bwd`` at
    :func:`ctc_check`'s bars. Then the kernels' device time at these
    shapes in bf16 (CTC in f32). Returns ``{kernel: {case: row}}``."""
    out = {k: {} for k in ('bilstm_fwd', 'bilstm_bwd', 'ctc_fwd',
                           'ctc_bwd')}

    def counted(label, want):
        got = launch_counts(rnn_cuda, ctc_cuda)
        check(all(got[k] == want.get(k, 0) for k in got),
              'htr {}: launches {}, expected {}'.format(label, got, want))
        return got
    for i, dtype in enumerate((torch.float32, torch.bfloat16)):
        name = 'f32' if dtype == torch.float32 else 'bf16'
        label = '{} N={} T={} lens {}-{}'.format(name, HTR_N, HTR_T,
                                                 *HTR_LENS)
        launch_counts(rnn_cuda, ctc_cuda, reset=True)
        c = bilstm_case(HTR_T, HTR_N, dtype, False, seed=60 + 2 * i,
                        d=HTR_FEATURES, lens_range=HTR_LENS)
        fwd_errs = bilstm_fwd_check(rnn_cuda, 'htr ' + label, c, dtype,
                                    HTR_FORGET_BIAS)
        n = counted(label + ' fwd', {'bilstm_fwd': 4})
        out['bilstm_fwd'][label] = {'max_abs_err': max(fwd_errs.values()),
                                    'launches': n['bilstm_fwd']}
        launch_counts(rnn_cuda, ctc_cuda, reset=True)
        args = bilstm_bwd_args(c, rnn_cuda, 60 + 2 * i, HTR_FORGET_BIAS)
        err = bilstm_bwd_check(rnn_cuda, 'htr ' + label, args, dtype)
        n = counted(label + ' bwd', {'bilstm_fwd': 1, 'bilstm_bwd': 2})
        out['bilstm_bwd'][label] = {'max_abs_err': err,
                                    'launches': n['bilstm_bwd']}

        stacked = name + ' two layers chained'
        launch_counts(rnn_cuda, ctc_cuda, reset=True)
        top = bilstm_case(HTR_T, HTR_N, dtype, False, seed=61 + 2 * i)
        g = torch.Generator().manual_seed(62 + 2 * i)
        dout = tuple((torch.randn(HTR_T, HTR_N, 256, generator=g) * 0.1)
                     .cuda().to(dtype) for _ in range(2))
        got = htr_stack(rnn_cuda.bilstm_fwd, rnn_cuda.bilstm_bwd, c, top,
                        dout)
        again = htr_stack(rnn_cuda.bilstm_fwd, rnn_cuda.bilstm_bwd, c, top,
                          dout)
        block = bilstm_bwd_check(rnn_cuda, 'htr {} layer 1'.format(stacked),
                                 (*got[1], *got[2]), dtype)
        want = htr_stack(rnn_cuda.bilstm_fwd_reference,
                         rnn_cuda.bilstm_bwd_reference, c, top, dout)
        torch.cuda.synchronize()
        flat = [t for part in (got[0], got[3]) for t in part]
        chain, rel, ok = rel_err(
            flat, [t for part in (want[0], want[3]) for t in part], dtype,
            layers=2)
        same = all(torch.equal(a, b) for a, b in zip(
            flat, [t for part in (again[0], again[3]) for t in part]))
        print('bilstm check htr {:24s} layer 2 outputs and layer 1 '
              'gradients against the plain chain: max|diff| {:.3e} ({:.2e} '
              'of the largest entry) within twice the tolerance: {}, two '
              'chains bit-identical: {}'.format(stacked, chain, rel, ok,
                                                same), flush=True)
        check(ok and same, 'htr {}: {} of the largest entry, identical '
              '{}'.format(stacked, rel, same))
        n = counted(stacked, {'bilstm_fwd': 4, 'bilstm_bwd': 6})
        out['bilstm_bwd'][stacked] = {
            'max_abs_err': block, 'chain_max_abs_err': chain,
            'chain_rel_err': rel, 'launches': n['bilstm_bwd']}
        out['bilstm_fwd'][stacked] = {'launches': n['bilstm_fwd']}

    label = 'N={} T={} C=80 L=24 lens {}-{}'.format(HTR_N, HTR_T, *HTR_LENS)
    launch_counts(rnn_cuda, ctc_cuda, reset=True)
    case = ctc_case(ctc, HTR_T, 24, seed=HTR_T, n=HTR_N, c=80,
                    t_min=HTR_LENS[0])
    errs, (logz, alphas, _, _) = ctc_check(ctc, ctc_cuda, 'htr ' + label,
                                           case, 24)
    n = counted(label, {'ctc_fwd': 2, 'ctc_bwd': 2})
    g, masks, lens = case['g'], case['masks'], case['logit_lens']
    for k in ('ctc_fwd', 'ctc_bwd'):
        out[k][label] = {'max_abs_err': errs[k], 'launches': n[k]}
    out['ctc_fwd'][label]['device_ms'] = device_ms(
        lambda: ctc_cuda.ctc_forward(g, *masks), ['ctc_fwd_'])
    out['ctc_bwd'][label]['device_ms'] = device_ms(
        lambda: ctc_cuda.ctc_backward(g, *masks, alphas, logz, lens),
        ['ctc_bwd_'])

    label = 'bf16 N={} T={} lens {}-{}'.format(HTR_N, HTR_T, *HTR_LENS)
    c = bilstm_case(HTR_T, HTR_N, torch.bfloat16, False, seed=7,
                    d=HTR_FEATURES, lens_range=HTR_LENS)
    args = bilstm_bwd_args(c, rnn_cuda, 7, HTR_FORGET_BIAS)
    with torch.no_grad():
        out['bilstm_fwd'][label]['device_ms'] = device_ms(
            lambda: rnn_cuda.bilstm_fwd(*kernel_args(c),
                                        forget_bias=HTR_FORGET_BIAS,
                                        save_residuals=True),
            ['bilstm_fwd_'])
        out['bilstm_bwd'][label]['device_ms'] = device_ms(
            lambda: rnn_cuda.bilstm_bwd(*args), ['bilstm_bwd_'])
    print('htr kernels {}'.format(json.dumps(out)), flush=True)
    return out


def beam_case(n, t_len, c, dtype, seed):
    """[N, T, C] logits on the card, row r at scale 1 or 10 by its parity,
    and ragged [N] int32 lengths with T first and 0 second."""
    g = torch.Generator().manual_seed(seed)
    scale = torch.tensor([1.0, 10.0]).repeat(n)[:n]
    logits = torch.randn(n, t_len, c, generator=g) * scale[:, None, None]
    lens = torch.randint(0, t_len + 1, (n,), generator=g)
    lens[0], lens[1] = t_len, 0
    return logits.cuda().to(dtype), lens.to(torch.int32).cuda()


def beam_bound_ms(logits):
    """The beam kernel's least time: its logits read once and its [N, T]
    int32 ids and [N] lengths moved once, over HBM bandwidth (its arithmetic,
    about K (C + 1) scores a row and frame, is far below the peak)."""
    n, t_len, _ = logits.shape
    moved = logits.numel() * logits.element_size() + 4 * n * (t_len + 1)
    return 1e3 * moved / HBM_BYTES_PER_S


def beam_phase(beam, beam_cuda):
    """The beam kernel through the entry point ``ops/beam.py:beam_decode``
    against the plain search at the longline cell's shapes (ids equal, two
    calls bit-identical, one launch a call), then its timings; returns its
    launches and the timings by shape."""
    beam_cuda.beam_decode.launches = 0
    calls = 0
    cases = [(t_len, dtype, False) for t_len in (79, 95, 111)
             for dtype in (torch.float32, torch.bfloat16)]
    cases.append((111, torch.float32, True))
    for i, (t_len, dtype, merge) in enumerate(cases):
        logits, lens = beam_case(64, t_len, 64, dtype, seed=100 + i)
        got = beam.beam_decode(logits, lens, 16, 0, merge)
        again = beam.beam_decode(logits, lens, 16, 0, merge)
        calls += 2
        want = beam.beam_decode_reference(logits, lens, 16, 0, merge)
        torch.cuda.synchronize()
        bad = (got != want).any(dim=1).nonzero().flatten().tolist()
        same = torch.equal(got, again)
        label = '{} N=64 T={} K=16 C=64 merge={}'.format(
            str(dtype).split('.')[-1], t_len, merge)
        print('kernel check beam_decode {:36s} rows differing from the plain '
              'search {}, two calls bit-identical: {}'.format(
                  label, len(bad), same), flush=True)
        check(not bad and same, 'beam_decode {}: rows {} differ from the '
              'plain search, or calls differ'.format(label, bad[:8]))
    check(beam_cuda.beam_decode.launches == calls,
          'beam kernel launched {} times in {} calls'.format(
              beam_cuda.beam_decode.launches, calls))

    timings = {}
    for t_len in (23, 111, 1209):
        logits, lens = beam_case(64, t_len, 64, torch.float32, seed=7)

        def call():
            beam.beam_decode(logits, lens, 16)
        row = {'kernel_ms': median_ms(call),
               'device_ms': device_ms(call, ['beam_kernel']),
               'host_ms': host_ms(call),
               'bound_ms': beam_bound_ms(logits), 'bound_by': 'bytes'}
        if t_len == 111:
            row['plain_ms'] = median_ms(
                lambda: beam.beam_decode_reference(logits, lens, 16), reps=3,
                warmup=1)
        if row['device_ms'] is not None:
            row['device_us_per_frame'] = 1e3 * row['device_ms'] / t_len
        timings['f32 N=64 T={}'.format(t_len)] = row
        print('kernel timing beam_decode f32 N=64 T={:<5d} {}'.format(
            t_len, json.dumps(row)), flush=True)
    return beam_cuda.beam_decode.launches, timings


def eval_phase(rnn_cuda, beam_cuda, test_mod, load_cfg, log):
    """Evaluation of the tracked releases; returns the launch counts of
    ``bilstm_fwd`` and the beam kernel, each release's predictions (label ->
    file name -> string) and its p50 ms an image."""
    rnn_cuda.bilstm_fwd.launches = 0
    beam_launches = 0
    calls = 0
    predictions, p50_ms = {}, {}
    for label, yml, val_dir, bn_eval, decoder, total, least in EVALS:
        # the beam releases run their config's own decoder (beam, width 16)
        greedy = ['DECODER', "'greedy'"] if decoder == 'greedy' else []
        cfg = load_cfg(os.path.join(REPO, yml),
                       ['TEST.BATCH_SIZE', '64', 'BN_EVAL', repr(bn_eval),
                        'TRAIN.DTYPE', "'bfloat16'"] + greedy)
        check(str(cfg.DECODER) == decoder and int(cfg.BEAM_WIDTH) == 16,
              '{}: DECODER {} width {}'.format(label, cfg.DECODER,
                                               cfg.BEAM_WIDTH))
        before = (rnn_cuda.bilstm_fwd.launches,
                  beam_cuda.beam_decode.launches)
        log.write('== {}\n'.format(label))
        r = test_mod.test_net(
            cfg, os.path.join(REPO, val_dir),
            os.path.join(REPO, 'checkpoints', cfg.EXP_DIR), device='cuda',
            echo=lambda s: log.write(s + '\n'))
        launched = rnn_cuda.bilstm_fwd.launches - before[0]
        beamed = beam_cuda.beam_decode.launches - before[1]
        beam_launches += beamed
        calls += r.decode_calls
        predictions[label] = r.predictions
        p50_ms[label] = 1e3 * r.p50
        print('eval {:18s} {}/{} correct, {:.1f} images/s steady-state, '
              '{:.1f} images/s overall, p50 {:.4f} ms/image, {} decode calls,'
              ' {} kernel launches, {} beam kernel launches'.format(
                  label, r.correct, r.total, r.steady_images_per_sec,
                  r.images_per_sec, 1e3 * r.p50, r.decode_calls, launched,
                  beamed), flush=True)
        check(r.total == total, '{}: {} images, expected {}'.format(
            label, r.total, total))
        check(launched == r.decode_calls, '{}: {} launches for {} decode '
              'calls'.format(label, launched, r.decode_calls))
        check(beamed == (r.decode_calls if decoder == 'beam' else 0),
              '{}: {} beam kernel launches for {} {} decode calls'.format(
                  label, beamed, r.decode_calls, decoder))
        check(r.correct >= least, '{}: {}/{} correct, expected >= {}'.format(
            label, r.correct, total, least))
    launches = rnn_cuda.bilstm_fwd.launches
    check(launches == calls and launches > 0,
          'bilstm_fwd launched {} times in {} decode calls'.format(
              launches, calls))
    check(beam_launches > 0, 'the beam kernel was not launched in eval')
    return launches, beam_launches, predictions, p50_ms


def profile_phase(test_mod, load_cfg, reps=5):
    """Where a warm decode call's device time goes: ``torch.profiler`` over
    ``reps`` calls at batch 64 on W=96 val images, ``lstm_ctc`` release.
    Prints the device time by kernel and the device's busy share of the
    calls' wall time (host clock, each call ends in a copy to the host)."""
    from lstm_ctc_ocr_torch.data.image import load_image
    from lstm_ctc_ocr_torch.engine import checkpoint
    from lstm_ctc_ocr_torch.models.factory import get_network
    cfg = load_cfg(os.path.join(REPO, 'lstm', 'lstm.yml'),
                   ['TEST.BATCH_SIZE', '64', 'TRAIN.DTYPE', "'bfloat16'"])
    model = get_network('LSTM_test', cfg)
    checkpoint.load_into(model, checkpoint.latest_eval_checkpoint(
        os.path.join(REPO, 'checkpoints', cfg.EXP_DIR))[0], False)
    step = test_mod.make_decode_step(model.cuda().eval(), cfg, 'cuda')
    val = os.path.join(REPO, 'data', 'val')
    images, steps = [], []
    for f in sorted(os.listdir(val)):
        im, ts = test_mod.prepare_single(load_image(os.path.join(val, f)),
                                         cfg)
        if im.shape[1] == 96:
            images.append(im)
            steps.append(ts)
        if len(images) == 64:
            break
    check(len(images) == 64, 'fewer than 64 W=96 images in data/val')
    images, steps = np.concatenate(images), np.concatenate(steps)
    for _ in range(3):
        step(images, steps)
    profile_report('decode call (batch 64, W=96, bf16)',
                   lambda: step(images, steps), reps)


def train_overrides(records_path, exp):
    # the solver validates on the synthetic stream whatever the backend;
    # the GPU machine has no Pillow, so it renders with the native renderer
    return ['DATA_BACKEND', 'records', 'RECORDS_PATH', records_path,
            'RENDERER', 'native', 'DECODER', "'greedy'",
            'TRAIN.DTYPE', "'bfloat16'", 'EXP_DIR', exp, 'LOG_DIR', exp]


def wrappers(rnn_cuda, ctc_cuda):
    """name -> (module, attribute, plain version's module and attribute) of
    every kernel wrapper a train step or a decode call can reach."""
    return {'bilstm_fwd': (rnn_cuda, 'bilstm_fwd', 'bilstm_fwd_reference'),
            'bilstm_bwd': (rnn_cuda, 'bilstm_bwd', 'bilstm_bwd_reference'),
            'lstm_fwd': (rnn_cuda, 'lstm_fwd', 'lstm_fwd_reference'),
            'lstm_bwd': (rnn_cuda, 'lstm_bwd', 'lstm_bwd_reference'),
            'ctc_fwd': (ctc_cuda, 'ctc_forward', 'ctc_forward_reference'),
            'ctc_bwd': (ctc_cuda, 'ctc_backward', 'ctc_backward_reference')}


@contextlib.contextmanager
def plain_versions(rnn_cuda, ctc_cuda, ctc):
    """Put each kernel's plain version in its wrapper's place."""
    table = wrappers(rnn_cuda, ctc_cuda)
    saved = {k: getattr(mod, attr) for k, (mod, attr, _) in table.items()}
    for mod, attr, plain in table.values():
        setattr(mod, attr, getattr(ctc if mod is ctc_cuda else mod, plain))
    try:
        yield
    finally:
        for k, (mod, attr, _) in table.items():
            setattr(mod, attr, saved[k])


def launch_counts(rnn_cuda, ctc_cuda, reset=False):
    fns = {k: getattr(mod, attr)
           for k, (mod, attr, _) in wrappers(rnn_cuda, ctc_cuda).items()}
    if reset:
        for w in fns.values():
            w.launches = 0
    return {k: w.launches for k, w in fns.items()}


def compare_gradients(mods, net32, cfg32, rec_path, per_step, floor=1e-3):
    """One f32 step's parameter gradients with the kernels against the same
    step with the plain versions in their place; ``per_step`` is each
    wrapper's expected launches in that step. Each tensor must agree within
    1e-4 of its largest entry, or of ``floor`` times the largest gradient
    overall for a tensor whose own gradient is smaller than that (the biases
    that batch norm removes have a true gradient of zero and hold rounding
    noise on both sides). Returns the worst relative difference."""
    rnn_cuda, ctc_cuda, ctc = mods['rnn_cuda'], mods['ctc_cuda'], mods['ctc']
    ds = mods['records'].RecordsDataset(rec_path, cfg32)
    b = ds.batch(range(64))
    ds.close()
    batch = tuple(torch.from_numpy(a).cuda()
                  for a in (b.image, b.label, b.label_len, b.time_step))
    loss_fn = mods['train'].make_loss_fn(net32, cfg32, None)

    def gradients():
        net32.zero_grad(set_to_none=True)
        loss_fn(*batch)[0].backward()
        return {k: p.grad.clone() for k, p in net32.named_parameters()}
    before = launch_counts(rnn_cuda, ctc_cuda)
    with_kernels = gradients()
    after = launch_counts(rnn_cuda, ctc_cuda)
    check(all(after[k] == before[k] + per_step[k] for k in after),
          'one f32 step launched {} -> {}, expected +{}'.format(
              before, after, per_step))
    with plain_versions(rnn_cuda, ctc_cuda, ctc):
        with_plain = gradients()
    check(launch_counts(rnn_cuda, ctc_cuda) == after,
          'the plain versions launched a kernel')
    overall = max(float(g.abs().max()) for g in with_plain.values())
    worst = 0.0
    for name, ref in with_plain.items():
        scale = max(float(ref.abs().max()), floor * overall)
        rel = float((with_kernels[name] - ref).abs().max()) / scale
        worst = max(worst, rel)
        check(rel <= 1e-4, 'gradient of {}: {} of its largest entry'.format(
            name, rel))
    return worst, len(with_plain)


def measure_rate(mods, model, optimizer, cfg, card, what, log):
    """steps/s over 40 warm steps with the feed of ``cfg.DATA_BACKEND``,
    CUDA-synchronised, then a profile of five more."""
    train = mods['train']
    step = train.make_train_step(model, optimizer, cfg,
                                 train.compute_dtype(cfg))
    with contextlib.redirect_stdout(log):
        stream = train.make_train_stream(cfg, 64)

    def one_step():
        nb = next(stream)
        return step(*(torch.from_numpy(a).cuda(non_blocking=True) for a in
                      (nb.image, nb.label, nb.label_len, nb.time_step)))
    for _ in range(8):
        one_step()
    torch.cuda.synchronize()
    n_timed = 40
    t0 = time.perf_counter()
    for _ in range(n_timed):
        one_step()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rate = {'steps_per_s': n_timed / dt, 'images_per_s': 64 * n_timed / dt,
            'ms_per_step': 1e3 * dt / n_timed}
    rate['feed'] = str(cfg.DATA_BACKEND)
    print('{} rate (batch 64, bf16, Adam, {} feed, {} warm steps, '
          'CUDA-synchronised) on {}: {:.2f} steps/s, {:.1f} images/s, {:.3f} '
          'ms/step'.format(what, rate['feed'], n_timed, card,
                           rate['steps_per_s'], rate['images_per_s'],
                           rate['ms_per_step']),
          flush=True)
    rate['device_busy_ms_per_step'] = profile_report(
        '{} step (batch 64, bf16)'.format(what), one_step, reps=5)
    print('{} device busy ms per step: {}'.format(
        what, rate['device_busy_ms_per_step']), flush=True)
    stream.close()
    return rate


def stream_rate(get_batch, cfg, workers, n_batches):
    """Host images/s of ``get_batch`` at batch 64: the first batch (worker
    start-up) untimed, then ``n_batches`` timed."""
    stream = get_batch(cfg, num_workers=workers, seed=int(cfg.RNG_SEED),
                       batch_size=64, bucketed=True)
    try:
        next(stream)
        t0 = time.perf_counter()
        for _ in range(n_batches):
            next(stream)
        return 64 * n_batches / (time.perf_counter() - t0)
    finally:
        stream.close()


def synth_phase(mods, card, log):
    """The synthetic stream, the default feed of ``lstm/lstm.yml``: (a) the
    native renderer against the JAX package's tracked output, (b) the
    stream's host rate, (c) 60 steps of training from it through
    ``train_net`` and its rate, (d) the pool backend through the training
    CLI. Returns the launch counts of (c) and (d), the rates and counts."""
    load_cfg, train, gen = mods['load_cfg'], mods['train'], mods['gen']
    rnn_cuda, ctc_cuda = mods['rnn_cuda'], mods['ctc_cuda']
    image, get_network = mods['image'], mods['get_network']
    yml = os.path.join(REPO, 'lstm', 'lstm.yml')
    out = {}
    t_phase = time.perf_counter()

    # (a) data/val_digit4_native was written by the JAX package's offline
    # writer: image i from random.Random(i * 9176 + 11), its label from
    # gen_rand, its pixels from the native renderer
    cfg = load_cfg(os.path.join(REPO, 'lstm', 'digit4.yml'),
                   ['RENDERER', 'native'])
    val = os.path.join(REPO, 'data', 'val_digit4_native')
    files = sorted(os.listdir(val))
    t0 = time.perf_counter()
    same = 0
    for f in files:
        idx, label = f[:-4].split('_')
        rng = random.Random(int(idx) * 9176 + 11)
        chars = gen.gen_rand(cfg, rng)
        got = gen._renderer(cfg).generate_image(chars, rng=rng)
        want = image.load_image(os.path.join(val, f))
        same += chars == label and got.shape == want.shape \
            and bool(np.array_equal(got, want))
    out['val_digit4_native_identical'] = same
    print('synthetic stream (a): the native renderer regenerates {}/{} of '
          'data/val_digit4_native bit for bit, labels and pixels ({:.1f} s)'
          .format(same, len(files), time.perf_counter() - t0), flush=True)
    check(len(files) == 500 and same == 500,
          '{}/{} data/val_digit4_native images bit-identical'.format(
              same, len(files)))

    # (b) the stream's host rate; the kernel phases have started CUDA, so
    # the workers fork from a process that holds a CUDA context
    cfg = load_cfg(yml, ['RENDERER', 'native'])
    check(str(cfg.DATA_BACKEND) == 'synth' and str(cfg.MP_START) == 'fork',
          'lstm.yml does not default to the forked synthetic stream')
    workers = train.effective_workers(int(cfg.TRAIN.NUM_WORKERS))
    out['cpu_count'] = os.cpu_count()
    out['workers'] = workers
    out['images_per_s_inline'] = stream_rate(gen.get_batch, cfg, 0, 10)
    out['images_per_s_workers'] = stream_rate(gen.get_batch, cfg, workers, 60)
    print('synthetic stream (b): host images/s of get_batch at batch 64, '
          'lstm.yml, RENDERER native: {:.1f} inline, {:.1f} with {} fork '
          'workers (CUDA initialised in the parent: {}); os.cpu_count() {}; '
          'on {}'.format(out['images_per_s_inline'],
                         out['images_per_s_workers'], workers,
                         torch.cuda.is_initialized(), out['cpu_count'], card),
          flush=True)

    # (c) 60 steps of lstm.yml at full width from the synthetic stream
    exp = 'chip_smoke_synth'
    shutil.rmtree(os.path.join(REPO, 'output', exp), ignore_errors=True)
    steps, val_step = 60, 50
    cfg = load_cfg(yml, ['RENDERER', 'native', 'DECODER', "'greedy'",
                         'TRAIN.DTYPE', "'bfloat16'", 'EXP_DIR', exp,
                         'LOG_DIR', exp, 'VAL.VAL_STEP', str(val_step),
                         'TRAIN.DISPLAY', '10'])
    check(int(cfg.TRAIN.BATCH_SIZE) == 64 and int(cfg.TRAIN.NUM_HID) == 512
          and str(cfg.TRAIN.SOLVER) == 'Adam'
          and str(cfg.DATA_BACKEND) == 'synth',
          'lstm.yml is not the full-width default model on the synthetic '
          'stream')
    net = get_network('LSTM_train', cfg, generator=torch.Generator()
                      .manual_seed(int(cfg.RNG_SEED)))
    launch_counts(rnn_cuda, ctc_cuda, reset=True)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        model, optimizer, losses = train.train_net(
            net, {'name': 'chip_smoke'}, None,
            os.path.join(REPO, 'output', exp),
            os.path.join(REPO, 'logs', exp), cfg, max_iters=steps + 1,
            device='cuda')
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts(rnn_cuda, ctc_cuda)
    val_calls = sum(1 for it in range(1, steps + 1)
                    if (it + 1) % val_step == 0)
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    print('synthetic stream (c): {} steps of lstm.yml from the synthetic '
          'stream ({} fork workers) in {:.1f} s (start-up included), total '
          'loss first 10 {:.4f} -> last 10 {:.4f}, launches {}, {} validation'
          ' decode(s) on the synthetic validation batch'.format(
              len(losses), workers, wall, first, last, json.dumps(counts),
              val_calls), flush=True)
    check(len(losses) == steps and bool(np.isfinite(losses).all()),
          'expected {} finite losses, got {}'.format(steps, losses))
    check(last < first, 'the loss did not fall: {} -> {}'.format(first, last))
    want = {'bilstm_fwd': steps + val_calls, 'bilstm_bwd': steps,
            'lstm_fwd': 0, 'lstm_bwd': 0, 'ctc_fwd': steps, 'ctc_bwd': steps}
    check(counts == want, 'launches {} over {} steps, expected {}'.format(
        counts, steps, want))
    out['losses_first10_last10'] = [first, last]
    out['rate'] = measure_rate(mods, model, optimizer, cfg, card,
                               'synthetic-feed train', log)

    # (d) the pool backend through the training CLI, its cache in a scratch
    # working directory
    exp = 'chip_smoke_pool'
    shutil.rmtree(os.path.join(REPO, 'output', exp), ignore_errors=True)
    cwd = os.path.join(REPO, 'chiprun_out', exp)
    shutil.rmtree(cwd, ignore_errors=True)
    os.makedirs(cwd)
    pool_steps = 5
    text = io.StringIO()
    launch_counts(rnn_cuda, ctc_cuda, reset=True)
    here = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(text):
            rc = train.main(['--cfg', yml, '--iters', str(pool_steps + 1),
                             '--set', 'DATA_BACKEND', 'pool', 'POOL_SIZE',
                             '512', 'RENDERER', 'native', 'TRAIN.DTYPE',
                             "'bfloat16'", 'TRAIN.DISPLAY', '1',
                             'TRAIN.LOSS_MIN_SNAPSHOT', '0.0', 'EXP_DIR', exp,
                             'LOG_DIR', exp])
    finally:
        os.chdir(here)
    torch.cuda.synchronize()
    pool_counts = launch_counts(rnn_cuda, ctc_cuda)
    log.write(text.getvalue())
    pool_losses = [float(line.split('total loss: ')[1].split(',')[0])
                   for line in text.getvalue().splitlines()
                   if 'total loss: ' in line]
    print('synthetic stream (d): the training CLI with DATA_BACKEND pool, '
          'POOL_SIZE 512: {} steps, losses {}, launches {}'.format(
              len(pool_losses), [round(v, 4) for v in pool_losses],
              json.dumps(pool_counts)), flush=True)
    check(rc == 0 and len(pool_losses) == pool_steps
          and bool(np.isfinite(pool_losses).all()),
          'pool run: rc {}, losses {}'.format(rc, pool_losses))
    want = {'bilstm_fwd': pool_steps, 'bilstm_bwd': pool_steps,
            'lstm_fwd': 0, 'lstm_bwd': 0, 'ctc_fwd': pool_steps,
            'ctc_bwd': pool_steps}
    check(pool_counts == want, 'pool run launches {}, expected {}'.format(
        pool_counts, want))
    out['pool_losses'] = pool_losses
    out['seconds'] = time.perf_counter() - t_phase
    print('synthetic stream: phase took {:.1f} s'.format(out['seconds']),
          flush=True)
    return counts, pool_counts, out


def train_phase(mods, card, log):
    """The train step's path at full width; returns the kernels' launch
    counts over the fresh-init run and that run's model and solver."""
    load_cfg, train, test_mod = mods['load_cfg'], mods['train'], mods['test']
    rnn_cuda, ctc_cuda, ctc = mods['rnn_cuda'], mods['ctc_cuda'], mods['ctc']
    records, get_network = mods['records'], mods['get_network']
    yml = os.path.join(REPO, 'lstm', 'lstm.yml')
    out_root = os.path.join(REPO, 'output')
    for exp in ('chip_smoke_train', 'chip_smoke_finetune'):
        shutil.rmtree(os.path.join(out_root, exp), ignore_errors=True)

    t0 = time.perf_counter()
    rec_path = os.path.join(REPO, 'chiprun_out', 'chip_smoke_val.records')
    n_rec = records.write_image_annotation_pairs_to_records(
        os.path.join(REPO, 'data', 'val'), rec_path)
    print('records file: {} images from data/val in {:.1f} s'.format(
        n_rec, time.perf_counter() - t0), flush=True)
    check(n_rec == 500, 'records file holds {} images, expected 500'.format(
        n_rec))

    # (a) fresh init through train_net
    steps, val_step = 60, 50
    cfg = load_cfg(yml, train_overrides(rec_path, 'chip_smoke_train')
                   + ['VAL.VAL_STEP', str(val_step), 'TRAIN.DISPLAY', '10'])
    check(int(cfg.TRAIN.BATCH_SIZE) == 64 and int(cfg.TRAIN.NUM_HID) == 512
          and int(cfg.NCLASSES) == 64 and str(cfg.TRAIN.SOLVER) == 'Adam',
          'lstm.yml is not the full-width default model')
    net = get_network('LSTM_train', cfg, generator=torch.Generator()
                      .manual_seed(int(cfg.RNG_SEED)))
    launch_counts(rnn_cuda, ctc_cuda, reset=True)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        model, optimizer, losses = train.train_net(
            net, {'name': 'chip_smoke'}, None,
            os.path.join(out_root, 'chip_smoke_train'),
            os.path.join(REPO, 'logs', 'chip_smoke_train'), cfg,
            max_iters=steps + 1, device='cuda')
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts(rnn_cuda, ctc_cuda)
    val_calls = sum(1 for it in range(1, steps + 1)
                    if (it + 1) % val_step == 0)
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    print('train fresh init: {} steps in {:.1f} s (start-up included), total '
          'loss first 10 {:.4f} -> last 10 {:.4f}, launches {}, {} validation'
          ' decode(s)'.format(len(losses), wall, first, last,
                              json.dumps(counts), val_calls), flush=True)
    check(len(losses) == steps and bool(np.isfinite(losses).all()),
          'expected {} finite losses, got {}'.format(steps, losses))
    check(last < first, 'the loss did not fall: {} -> {}'.format(first, last))
    want = {'bilstm_fwd': steps + val_calls, 'bilstm_bwd': steps,
            'lstm_fwd': 0, 'lstm_bwd': 0, 'ctc_fwd': steps, 'ctc_bwd': steps}
    check(counts == want, 'launches {} over {} steps, expected {}'.format(
        counts, steps, want))

    # (b) fine-tune the release through the CLI, snapshot, evaluate
    release = os.path.join(REPO, 'checkpoints', 'lstm_ctc',
                           'lstm_ctc_iter_32207.ckpt.npz')
    with contextlib.redirect_stdout(log):
        rc = train.main(['--cfg', yml, '--iters', '21', '--pre_train',
                         release, '--set']
                        + train_overrides(rec_path, 'chip_smoke_finetune')
                        # no low-loss snapshots: the one snapshot is iter_21
                        + ['TRAIN.SNAPSHOT_ITERS', '21', 'TRAIN.DISPLAY', '5',
                           'TRAIN.LOSS_MIN_SNAPSHOT', '0.0'])
    check(rc == 0, 'training CLI returned {}'.format(rc))
    snap = os.path.join(out_root, 'chip_smoke_finetune',
                        'lstm_ctc_iter_21.ckpt.npz')
    check(os.path.isfile(snap), 'no snapshot at {}'.format(snap))
    eval_cfg = load_cfg(yml, ['TEST.BATCH_SIZE', '64', 'DECODER', "'greedy'",
                              'TRAIN.DTYPE', "'bfloat16'", 'EXP_DIR',
                              'chip_smoke_finetune'])
    echoed = []
    r = test_mod.test_net(eval_cfg, os.path.join(REPO, 'data', 'val'),
                          device='cuda', echo=echoed.append)
    log.write('\n'.join(echoed) + '\n')
    check(any(snap in line for line in echoed if line.startswith('Restored')),
          'the evaluation did not restore {}'.format(snap))
    print('train fine-tune: 20 steps from the lstm_ctc release, snapshot, '
          'eval {}/{} on data/val (the data trained on: shows that training '
          'does not wreck a good model, not that it generalises)'.format(
              r.correct, r.total), flush=True)
    check(r.total == 500 and r.correct >= 470,
          'fine-tuned snapshot: {}/{} correct, expected >= 470/500'.format(
              r.correct, r.total))

    # (c) one f32 step: gradients with the kernels vs with the plain versions
    cfg32 = load_cfg(yml, train_overrides(rec_path, 'chip_smoke_train')
                     + ['TRAIN.DTYPE', "'float32'"])
    net32 = get_network('LSTM_train', cfg32, generator=torch.Generator()
                        .manual_seed(int(cfg32.RNG_SEED))).cuda().train()
    worst, n_tensors = compare_gradients(
        mods, net32, cfg32, rec_path,
        {'bilstm_fwd': 1, 'bilstm_bwd': 1, 'lstm_fwd': 0, 'lstm_bwd': 0,
         'ctc_fwd': 1, 'ctc_bwd': 1})
    print('train gradients, one f32 step: kernels vs plain versions agree to '
          '{:.2e} of each tensor\'s largest entry ({} tensors)'.format(
              worst, n_tensors), flush=True)

    # rate over warm steps, the records feed included
    rate = measure_rate(mods, model, optimizer, cfg, card, 'train', log)
    return counts, rate, rec_path


STACKED_LAYERS = 2


def stacked_model(mods, cfg):
    """The CRNN with two stacked unidirectional LSTMs of 512 units as its
    head: what a user writes, a ``make_head`` override. Seeded."""
    crnn, layers = mods['crnn'], mods['layers']

    class StackedLSTM(crnn.LSTM_train):
        def make_head(self, num_hid, nclasses, generator):
            return layers.LSTM(512, num_hid, STACKED_LAYERS, nclasses,
                               generator)
    return StackedLSTM(
        nchannels=int(cfg.NCHANNELS), num_hid=int(cfg.TRAIN.NUM_HID),
        nclasses=int(cfg.NCLASSES),
        generator=torch.Generator().manual_seed(int(cfg.RNG_SEED)))


def stacked_phase(mods, card, rec_path, log):
    """The stacked unidirectional-LSTM model at full width through the same
    entry points; returns the kernels' launch counts over its 60 training
    steps and its evaluation, and its training rate."""
    load_cfg, train, test_mod = mods['load_cfg'], mods['train'], mods['test']
    rnn_cuda, ctc_cuda = mods['rnn_cuda'], mods['ctc_cuda']
    n_layers = STACKED_LAYERS
    yml = os.path.join(REPO, 'lstm', 'lstm.yml')
    exp = 'chip_smoke_stacked'
    out_dir = os.path.join(REPO, 'output', exp)
    shutil.rmtree(out_dir, ignore_errors=True)
    steps, val_step = 60, 50
    # one snapshot, after the last step but one; no low-loss snapshots
    cfg = load_cfg(yml, train_overrides(rec_path, exp) + [
        'VAL.VAL_STEP', str(val_step), 'TRAIN.DISPLAY', '10',
        'TRAIN.SNAPSHOT_ITERS', str(steps), 'TRAIN.LOSS_MIN_SNAPSHOT', '0.0'])
    check(int(cfg.TRAIN.NUM_HID) == 512 and int(cfg.TRAIN.BATCH_SIZE) == 64,
          'lstm.yml is not the full-width default model')

    def make(cfg_):
        return stacked_model(mods, cfg_)
    net = make(cfg)
    check(tuple(net.logits.cells[1].u.shape) == (512, 2048),
          'the stacked head is not 2 x LSTM 512')
    launch_counts(rnn_cuda, ctc_cuda, reset=True)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        model, optimizer, losses = train.train_net(
            net, {'name': 'chip_smoke'}, None, out_dir,
            os.path.join(REPO, 'logs', exp), cfg, max_iters=steps + 1,
            device='cuda')
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts(rnn_cuda, ctc_cuda)
    val_calls = sum(1 for it in range(1, steps + 1)
                    if (it + 1) % val_step == 0)
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    print('stacked LSTM fresh init: {} steps in {:.1f} s (start-up included), '
          'total loss first 10 {:.4f} -> last 10 {:.4f}, launches {}, {} '
          'validation decode(s)'.format(len(losses), wall, first, last,
                                        json.dumps(counts), val_calls),
          flush=True)
    check(len(losses) == steps and bool(np.isfinite(losses).all()),
          'expected {} finite losses, got {}'.format(steps, losses))
    check(last < first, 'the loss did not fall: {} -> {}'.format(first, last))
    want = {'bilstm_fwd': 0, 'bilstm_bwd': 0,
            'lstm_fwd': n_layers * (steps + val_calls),
            'lstm_bwd': n_layers * steps, 'ctc_fwd': steps, 'ctc_bwd': steps}
    check(counts == want, 'launches {} over {} steps, expected {}'.format(
        counts, steps, want))

    # the snapshot, evaluated through test_net with the subclass
    snap = os.path.join(out_dir, 'lstm_ctc_iter_{}.ckpt.npz'.format(steps))
    check(os.path.isfile(snap), 'no snapshot at {}'.format(snap))
    eval_cfg = load_cfg(yml, ['TEST.BATCH_SIZE', '64', 'DECODER', "'greedy'",
                              'TRAIN.DTYPE', "'bfloat16'", 'EXP_DIR', exp])
    echoed = []
    before = launch_counts(rnn_cuda, ctc_cuda)
    r = test_mod.test_net(eval_cfg, os.path.join(REPO, 'data', 'val'),
                          device='cuda', echo=echoed.append,
                          model=make(eval_cfg))
    log.write('\n'.join(echoed) + '\n')
    eval_launches = launch_counts(rnn_cuda, ctc_cuda)['lstm_fwd'] \
        - before['lstm_fwd']
    check(any(snap in line for line in echoed if line.startswith('Restored')),
          'the evaluation did not restore {}'.format(snap))
    print('stacked LSTM eval of the {}-step snapshot: {}/{} on data/val (no '
          'bar: it shows that the model decodes), {} decode calls, {} '
          'lstm_fwd launches'.format(steps - 1, r.correct, r.total,
                                     r.decode_calls, eval_launches),
          flush=True)
    check(r.total == 500 and len(r.predictions) == 500
          and eval_launches == n_layers * r.decode_calls,
          'stacked eval: {} images, {} launches for {} decode calls'.format(
              r.total, eval_launches, r.decode_calls))
    counts['lstm_fwd'] += eval_launches

    cfg32 = load_cfg(yml, train_overrides(rec_path, exp)
                     + ['TRAIN.DTYPE', "'float32'"])
    worst, n_tensors = compare_gradients(
        mods, make(cfg32).cuda().train(), cfg32, rec_path,
        {'bilstm_fwd': 0, 'bilstm_bwd': 0, 'lstm_fwd': n_layers,
         'lstm_bwd': n_layers, 'ctc_fwd': 1, 'ctc_bwd': 1},
        # this model's largest gradient is smaller beside the rounding noise
        # of the conv4 biases (true gradient zero) than the BiLSTM model's
        floor=1e-2)
    print('stacked LSTM gradients, one f32 step: kernels vs plain versions '
          'agree to {:.2e} of each tensor\'s largest entry ({} tensors)'
          .format(worst, n_tensors), flush=True)
    rate = measure_rate(mods, model, optimizer, cfg, card, 'stacked LSTM', log)
    return counts, rate, r.predictions


# runs in a fresh process that imports lstm_ctc_ocr_torch and nothing else
# of the repo: loads each artifact directory, decodes its files in the given
# (eval's) order and writes the strings, launch counts and modules seen
SERVE_WORKER = r'''
import json, os, re, sys, time
import numpy as np
import torch
from lstm_ctc_ocr_torch.data.image import load_image
from lstm_ctc_ocr_torch.engine.serve import ExportedDecoder
from lstm_ctc_ocr_torch.engine.test import full_f32
from lstm_ctc_ocr_torch.utils import profiler

# the served kernels' names in a device trace (bilstm_fwd_cluster_kernel
# holds lstm_fwd_cluster_kernel: a name starts where a word does)
KERNELS = {'bilstm_fwd': re.compile(r'(?<!\w)bilstm_fwd_\w*kernel'),
           'lstm_fwd': re.compile(r'(?<!\w)lstm_fwd_\w*kernel'),
           'beam': re.compile(r'(?<!\w)beam_kernel')}


def traced_decode(dec, images):
    # decode_images under a trace of the host and the device: the strings,
    # the program calls, the served kernels' launches counted from 0 in the
    # trace's device events, the device events seen, and the replays that
    # serve.graph_replays counted
    calls = dec.calls
    replays = profiler.counters().get('serve.graph_replays', 0)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        strings = dec.decode_images(images)
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return strings, {
        'calls': dec.calls - calls,
        'launches': {k: sum(e.count for e in device if pat.search(e.key))
                     for k, pat in KERNELS.items()},
        'device_events': sum(e.count for e in device),
        'graph_replays': profiler.counters().get('serve.graph_replays', 0)
        - replays}


def graphed_vs_eager(dec, images):
    # per bucket, the first chunk of the served images through its graph (a
    # replay, the bucket captured by the serving) and through the loaded
    # program called eagerly: the rows whose ids differ, and the replays a
    # trace counted
    by = {}
    for img in images:
        b, x, ts = dec._prepare(img)
        by.setdefault(b, []).append((x, ts))
    batch = int(dec.manifest['batch'])
    rows = {}
    before = profiler.counters().get('serve.graph_replays', 0)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for b, items in sorted(by.items()):
            chunk = items[:batch] + [items[:batch][-1]] * max(
                0, batch - len(items))
            x = np.stack([c[0] for c in chunk])
            ts = np.array([c[1] for c in chunk], np.int32)
            graphed = dec.run(x, ts)
            with full_f32():
                eager = dec._programs[b](torch.from_numpy(x).cuda(),
                                         torch.from_numpy(ts).cuda())
                eager = eager.cpu().numpy()
            rows[str(b)] = int((graphed != eager).any(axis=1).sum())
    return {'rows_differ': rows, 'replays_traced':
            profiler.counters().get('serve.graph_replays', 0) - before}


with open(sys.argv[1]) as f:
    spec = json.load(f)
out = {'releases': {}}
for entry in spec:
    t0 = time.perf_counter()
    dec = ExportedDecoder(entry['export_dir'], device='cuda')
    load_s = time.perf_counter() - t0
    images = [load_image(os.path.join(entry['val_dir'], f))
              for f in entry['files']]
    t0 = time.perf_counter()
    strings = dec.decode_images(images)      # each bucket captured
    got = out['releases'][entry['label']] = {
        'predictions': dict(zip(entry['files'], strings)),
        'calls': dec.calls, 'load_s': load_s,
        'decode_s': time.perf_counter() - t0,
        'graphs': len(dec._graphs)}
    again, got['traced'] = traced_decode(dec, images)    # all replays
    got['traced']['same_strings'] = again == strings
    if entry.get('compare'):
        got['graphed_vs_eager'] = graphed_vs_eager(dec, images)
out['foreign_modules'] = sorted(
    k for k in sys.modules
    if k.split('.')[0] in ('jax', 'jaxlib', 'lstm_ctc_ocr_tpu'))
with open(sys.argv[2], 'w') as f:
    json.dump(out, f)
'''


def files_by_bucket(mods, cfg, val_dir):
    """Eval's grouping: bucket -> the labelled files of ``val_dir`` that
    fall in it, in sorted order."""
    files = [f for f in sorted(os.listdir(val_dir))
             if mods['records'].parse_label_from_filename(f) is not None]
    return mods['test'].files_by_bucket(cfg, val_dir, files)


def serve_timing(mods, cfg, model, export_dir, card, n=30):
    """The frozen program, replayed as the decoder's CUDA graph
    (``graphed``) and called eagerly as the loaded module (``eager``),
    against the live decode, greedy ``lstm_ctc`` at batch 64 on the first
    64 W=96 images of ``data/val``, in turns (live, eager, graphed,
    graphed, eager, live), ``n`` calls a turn after 3 warm calls each; a
    call is host time from numpy in to ids back on the host."""
    test_mod, serve = mods['test'], mods['serve']
    val = os.path.join(REPO, 'data', 'val')
    names = files_by_bucket(mods, cfg, val)[96][:64]
    check(len(names) == 64, 'fewer than 64 W=96 images in data/val')
    loaded = [test_mod.prepare_single(
        mods['image'].load_image(os.path.join(val, f)), cfg) for f in names]
    images = np.concatenate([x[0] for x in loaded])
    steps = np.concatenate([x[1] for x in loaded])
    live_step = test_mod.make_decode_step(model, cfg, 'cuda')

    def live():
        with test_mod.full_f32():
            return live_step(images, steps)
    frozen_dec = serve.ExportedDecoder(export_dir, device='cuda')

    def graphed():
        return frozen_dec.run(images, steps)

    def eager():
        with test_mod.full_f32():
            x = torch.from_numpy(images).cuda()
            lens = torch.from_numpy(steps).cuda()
            return frozen_dec._programs[96](x, lens).cpu().numpy()
    fns = {'live': live, 'eager': eager, 'graphed': graphed}
    want = live()
    for what in ('graphed', 'eager', 'graphed'):   # a capture, then a replay
        check(np.array_equal(fns[what](), want),
              'the frozen program ({}) and the live decode differ at W=96'
              .format(what))
    times = {what: [] for what in fns}
    for _ in range(3):
        for fn in fns.values():
            fn()
    for what in ('live', 'eager', 'graphed', 'graphed', 'eager', 'live'):
        for _ in range(n):
            t0 = time.perf_counter()
            fns[what]()
            times[what].append(time.perf_counter() - t0)
    out = {}
    for what, ts in times.items():
        out[what] = {'images_per_s': 64 * len(ts) / sum(ts),
                     'p50_ms_per_call': 1e3 * statistics.median(ts),
                     'p50_ms_per_image': 1e3 * statistics.median(ts) / 64}
    print('serve timing on {} (lstm_ctc greedy, batch 64, W=96, {} calls '
          'each): live {:.1f} images/s, p50 {:.3f} ms a call; frozen eager '
          '{:.1f} images/s, p50 {:.3f} ms a call; frozen graphed {:.1f} '
          'images/s, p50 {:.3f} ms a call ({:+.1%} images/s over eager)'
          .format(card, 2 * n, out['live']['images_per_s'],
                  out['live']['p50_ms_per_call'],
                  out['eager']['images_per_s'],
                  out['eager']['p50_ms_per_call'],
                  out['graphed']['images_per_s'],
                  out['graphed']['p50_ms_per_call'],
                  out['graphed']['images_per_s']
                  / out['eager']['images_per_s'] - 1), flush=True)
    return out


def serve_phase(mods, card, eval_predictions, stacked_predictions, log):
    """The serving export and the release tools at full width (batch 64,
    bf16): returns the ``bilstm_fwd`` / ``lstm_fwd`` / beam kernel launches
    that a device trace counted in the served decode calls of the traced
    pass, and the phase's numbers."""
    load_cfg, test_mod, serve = mods['load_cfg'], mods['test'], mods['serve']
    checkpoint = mods['checkpoint']
    t_phase = time.perf_counter()
    root = os.path.join(REPO, 'output', 'chip_smoke_serve')
    shutil.rmtree(root, ignore_errors=True)
    spec, wanted, exports = [], {}, {}

    def export(label, model, cfg, val_dir, buckets):
        groups = files_by_bucket(mods, cfg, val_dir)
        files = sorted(f for b in buckets for f in groups[b])
        out_dir = os.path.join(root, label.replace('/', '_'))
        manifest = serve.export_decoder(model, cfg, out_dir, buckets=buckets,
                                        batch=64, device='cuda')
        mb = sum(os.path.getsize(os.path.join(out_dir, serve._artifact_name(
            b))) for b in buckets) / 1e6
        exports[label] = {'buckets': buckets, 'images': len(files),
                          'export_s': manifest['export_seconds'], 'mb': mb,
                          'calls': sum(-(-len(groups[b]) // 64)
                                       for b in buckets)}
        print('serve export {:18s} buckets {} ({} images): {} s a bucket, '
              '{:.1f} MB on {}'.format(
                  label, buckets, len(files), json.dumps(
                      {k: round(v, 2) for k, v in
                       manifest['export_seconds'].items()}), mb, card),
              flush=True)
        spec.append({'label': label, 'export_dir': out_dir,
                     'val_dir': val_dir, 'files': files,
                     'compare': label in GRAPH_COMPARED})
        return out_dir

    # 1. export the releases' buckets, and the stacked model's snapshot
    for label, yml, val_dir, bn_eval, decoder, total, least in EVALS:
        greedy = ['DECODER', "'greedy'"] if decoder == 'greedy' else []
        cfg = load_cfg(os.path.join(REPO, yml),
                       ['TEST.BATCH_SIZE', '64', 'BN_EVAL', repr(bn_eval),
                        'TRAIN.DTYPE', "'bfloat16'"] + greedy)
        model = mods['get_network']('LSTM_test', cfg)
        checkpoint.load_into(model, checkpoint.latest_eval_checkpoint(
            os.path.join(REPO, 'checkpoints', cfg.EXP_DIR))[0],
            bn_eval == 'moving')
        val = os.path.join(REPO, val_dir)
        out_dir = export(label, model, cfg, val,
                         sorted(files_by_bucket(mods, cfg, val)))
        wanted[label] = (eval_predictions[label], total, least, 'bilstm_fwd',
                         decoder == 'beam')
        if label == 'lstm_ctc/batch':
            timing_args = (cfg, model, out_dir)
    yml = os.path.join(REPO, 'lstm', 'lstm.yml')
    cfg = load_cfg(yml, ['TEST.BATCH_SIZE', '64', 'DECODER', "'greedy'",
                         'TRAIN.DTYPE', "'bfloat16'", 'EXP_DIR',
                         'chip_smoke_stacked'])
    stacked = stacked_model(mods, cfg)
    checkpoint.load_into(stacked, os.path.join(
        REPO, 'output', 'chip_smoke_stacked',
        'lstm_ctc_iter_60.ckpt.npz'), False)
    val = os.path.join(REPO, 'data', 'val')
    export('stacked_lstm', stacked, cfg, val,
           sorted(files_by_bucket(mods, cfg, val)))
    wanted['stacked_lstm'] = (stacked_predictions, 500, 0, 'lstm_fwd', False)
    export_s = time.perf_counter() - t_phase

    # 2. load and decode in a fresh process
    spec_path = os.path.join(root, 'spec.json')
    res_path = os.path.join(root, 'served.json')
    with open(spec_path, 'w') as f:
        json.dump(spec, f)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, '-c', SERVE_WORKER, spec_path,
                           res_path], cwd=REPO, capture_output=True,
                          text=True, timeout=900,
                          env=dict(os.environ, PYTHONPATH=REPO))
    worker_s = time.perf_counter() - t0
    log.write(proc.stdout + proc.stderr)
    check(proc.returncode == 0, 'serving process failed ({}):\n{}'.format(
        proc.returncode, proc.stderr[-4000:]))
    with open(res_path) as f:
        served = json.load(f)
    check(served['foreign_modules'] == [], 'the serving process imported '
          '{}'.format(served['foreign_modules']))

    # 3. the same strings as eval, file by file, one graph a bucket, and
    # the kernels once a call in a traced second pass
    launches = {'bilstm_fwd': 0, 'lstm_fwd': 0, 'beam': 0}
    for label, (want, total, least, kernel, beam) in wanted.items():
        got = served['releases'][label]
        traced = got['traced']
        counted = traced['launches']
        e = exports[label]
        preds = got['predictions']
        diff = [f for f in preds if preds[f] != want[f]]
        correct = sum(mods['records'].parse_label_from_filename(f) == s
                      for f, s in preds.items())
        eval_correct = sum(mods['records'].parse_label_from_filename(f)
                           == want[f] for f in preds)
        per_call = STACKED_LAYERS if kernel == 'lstm_fwd' else 1
        other = 'bilstm_fwd' if kernel == 'lstm_fwd' else 'lstm_fwd'
        print('serve {:18s} {}/{} correct (eval on the same files {}), {} of '
              '{} strings differ from eval, {} calls, {} graphs, load {:.1f} '
              's, decode {:.2f} s; traced again: {} calls, {} replays, '
              'launches in the device trace {} {} / {} {} / beam {} on {}'
              .format(label, correct, len(preds), eval_correct, len(diff),
                      len(preds), got['calls'], got['graphs'], got['load_s'],
                      got['decode_s'], traced['calls'],
                      traced['graph_replays'], kernel, counted[kernel], other,
                      counted[other], counted['beam'], card), flush=True)
        check(not diff, '{}: served strings differ from eval for {}'.format(
            label, diff[:10]))
        check(len(preds) == e['images'] and got['calls'] == e['calls'],
              '{}: {} images in {} calls, expected {} in {}'.format(
                  label, len(preds), got['calls'], e['images'], e['calls']))
        if len(preds) == total:
            check(correct >= least, '{}: {}/{} correct, expected >= {}'
                  .format(label, correct, total, least))
        # one CUDA graph a bucket, captured at its first call; the second
        # pass all replays, each launching the kernels once as a call does
        n_buckets = len(e['buckets'])
        check(got['graphs'] == n_buckets and traced['same_strings']
              and traced['calls'] == got['calls']
              and traced['graph_replays'] == traced['calls'],
              '{}: {} graphs for {} buckets; traced again {} calls, {} '
              'replays, strings {}'.format(
                  label, got['graphs'], n_buckets, traced['calls'],
                  traced['graph_replays'], 'the same' if
                  traced['same_strings'] else 'different'))
        check(traced['device_events'] > 0, '{}: the profiler saw no device '
              'events, so the served launches were not counted'.format(label))
        check(counted[kernel] == per_call * traced['calls']
              and counted[other] == 0
              and counted['beam'] == (traced['calls'] if beam else 0),
              '{}: launches in the device trace {} {} / {} {} / beam {} for '
              '{} calls'.format(label, kernel, counted[kernel], other,
                                counted[other], counted['beam'],
                                traced['calls']))
        compared = got.get('graphed_vs_eager')
        if compared is not None:
            print('serve {:18s} graphed vs eager program, rows whose ids '
                  'differ by bucket: {}, replays traced {} on {}'.format(
                      label, json.dumps(compared['rows_differ']),
                      compared['replays_traced'], card), flush=True)
            check(not any(compared['rows_differ'].values())
                  and compared['replays_traced'] == n_buckets,
                  '{}: graphed and eager ids differ ({}) or {} replays '
                  'traced for {} buckets'.format(
                      label, compared['rows_differ'],
                      compared['replays_traced'], n_buckets))
        launches[kernel] += counted[kernel]
        launches['beam'] += counted['beam']
        e.update(correct=correct, served=len(preds), load_s=got['load_s'],
                 decode_s=got['decode_s'],
                 graph_replays=traced['graph_replays'],
                 graphed_vs_eager=compared)

    # 4. frozen, graphed and eager, against live, greedy lstm_ctc at W=96
    timing = serve_timing(mods, *timing_args, card)

    # 5. calibrate a copy of the lstm_ctc release, evaluate it under moving
    calib_root = os.path.join(root, 'calibrate')
    rel = checkpoint.latest_eval_checkpoint(
        os.path.join(REPO, 'checkpoints', 'lstm_ctc'))[0]
    copy = os.path.join(calib_root, 'checkpoints', 'lstm_ctc',
                        os.path.basename(rel))
    os.makedirs(os.path.dirname(copy))
    shutil.copy(rel, copy)
    with contextlib.redirect_stdout(log):
        rc = mods['calibrate_bn'].main(
            ['--cfg', yml, '--ckpt', copy, '--device', 'cuda', '--batches',
             '8', '--set', 'RENDERER', 'native'])
    check(rc == 0, 'calibrate_bn returned {}'.format(rc))
    before, after = (checkpoint.read_flat(p) for p in (rel, copy))
    check(all(np.array_equal(before[k], after[k]) for k in before
              if k.startswith('params/'))
          and set(before) == set(after), 'calibration changed the params or '
          'the keys of {}'.format(copy))
    cfg = load_cfg(yml, ['TEST.BATCH_SIZE', '64', 'BN_EVAL', "'moving'",
                         'DECODER', "'greedy'", 'TRAIN.DTYPE', "'bfloat16'"])
    echoed = []
    r = test_mod.test_net(cfg, val, os.path.join(calib_root, 'output',
                                                 'lstm_ctc'),
                          device='cuda', echo=echoed.append)
    log.write('\n'.join(echoed) + '\n')
    print('serve calibrate_bn: 8 batches of 64 (native renderer) into a copy '
          'of the lstm_ctc release, BN_EVAL moving eval {}/{} (bar 484)'
          .format(r.correct, r.total), flush=True)
    check(any(copy in line for line in echoed if line.startswith('Restored')),
          'the evaluation did not restore {}'.format(copy))
    check(r.total == 500 and r.correct >= 484, 'calibrated release: {}/{} '
          'correct, expected >= 484'.format(r.correct, r.total))
    calibrated = r.correct

    # 6. release phase 5's fine-tuned snapshot into a scratch root
    rel_root = os.path.join(root, 'release')
    snap_dir = os.path.join(rel_root, 'output', 'chip_smoke_finetune')
    os.makedirs(snap_dir)
    shutil.copy(os.path.join(REPO, 'output', 'chip_smoke_finetune',
                             'lstm_ctc_iter_21.ckpt.npz'), snap_dir)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = mods['release_ckpt'].main(
            ['--cfg', yml, '--verify-dir', val, '--device', 'cuda', '--set',
             'ROOT_DIR', rel_root, 'EXP_DIR', 'chip_smoke_finetune',
             'DECODER', "'greedy'", 'TRAIN.DTYPE', "'bfloat16'"])
    log.write(out.getvalue())
    m = re.search(r'released-weights accuracy: ([0-9.]+) \((\d+)/(\d+)',
                  out.getvalue())
    released = os.path.join(rel_root, 'checkpoints', 'chip_smoke_finetune',
                            'lstm_ctc_iter_21.ckpt.npz')
    check(rc == 0 and m is not None and os.path.isfile(released),
          'release_ckpt: rc {}, no accuracy line or no {}'.format(
              rc, released))
    print('serve release_ckpt --verify-dir: phase 5\'s fine-tuned snapshot '
          'released as f16 ({:.1f} MB), released-weights accuracy {} ({}/{}) '
          'on data/val'.format(os.path.getsize(released) / 1e6, m.group(1),
                               m.group(2), m.group(3)), flush=True)
    for entry in spec:        # ~0.6 GB of programs; the JSON files stay
        shutil.rmtree(entry['export_dir'])
    seconds = time.perf_counter() - t_phase
    print('serve: phase took {:.1f} s (exports {:.1f} s, serving process '
          '{:.1f} s) on {}'.format(seconds, export_s, worker_s, card),
          flush=True)
    return launches, {'releases': exports, 'timing': timing,
                      'calibrated_moving_correct': calibrated,
                      'released_accuracy': float(m.group(1)),
                      'export_s': export_s, 'worker_s': worker_s,
                      'seconds': seconds, 'card': card}


def training_state(model, optimizer):
    """Every tensor a train step updates in place: parameters, BN buffers,
    the solver's moments and its device-side count."""
    return (list(model.parameters()) + list(model.buffers())
            + [t for slot in optimizer.moments.values()
               for t in slot.values()] + [optimizer.count_t])


def save_state(model, optimizer):
    return ([t.detach().clone() for t in training_state(model, optimizer)],
            optimizer.count)


def restore_state(model, optimizer, saved):
    """In place: a captured graph holds these tensors' storage."""
    with torch.no_grad():
        for t, s in zip(training_state(model, optimizer), saved[0]):
            t.copy_(s)
    optimizer.advance(saved[1] - optimizer.count)


def state_difference(a, b):
    """Largest |difference| over two saved states (losses first)."""
    return max(float((x.double() - y.double()).abs().max())
               for x, y in zip(a, b))


def graph_against_eager(model, optimizer, graph_group, eager_group):
    """(a) of the dispatch phase: from one saved state, one graphed group
    and two runs of the same steps eagerly; returns (graph vs eager, eager
    vs eager), each the largest |difference| over the losses, parameters,
    moments, BN buffers and count."""
    saved = save_state(model, optimizer)
    graph = [graph_group()] + save_state(model, optimizer)[0]
    runs = []
    for _ in range(2):
        restore_state(model, optimizer, saved)
        runs.append([eager_group()] + save_state(model, optimizer)[0])
    torch.cuda.synchronize()
    return state_difference(graph, runs[0]), state_difference(runs[0],
                                                              runs[1])


def group_rate(what, run_group, k, card, warm=2, n_timed=40, graph=True):
    """steps/s and images/s over about ``n_timed`` warm steps (dispatches of
    ``run_group``, which returns the steps it ran as an int, else ran
    ``k``), CUDA-synchronised; then ``torch.profiler`` over three more
    dispatches: the device's busy ms per step and its idle share of that
    window's wall; and for a graph, one replay's device time on an idle
    device by CUDA events."""
    def one():
        ran = run_group()
        return ran if isinstance(ran, int) else k
    for _ in range(warm):
        one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = 0
    while steps < n_timed:
        steps += one()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out = {'steps_per_s': steps / dt, 'images_per_s': 64 * steps / dt,
           'ms_per_step': 1e3 * dt / steps, 'steps_per_dispatch': k,
           'timed_steps': steps}
    ran = []
    busy, wall = profile_report(what, lambda: ran.append(one()), reps=3,
                                with_wall=True)
    out['device_busy_ms_per_step'] = None if busy is None \
        else 3 * busy / sum(ran)
    out['device_idle_share'] = None if busy is None else 1 - busy / wall
    if graph:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        one()
        end.record()
        torch.cuda.synchronize()
        out['replay_device_ms_per_step'] = start.elapsed_time(end) / k
    print('dispatch (b) {}: {:.2f} steps/s, {:.1f} images/s, {:.3f} ms/step, '
          'device busy {} ms/step and idle {} of the profiled wall{}, on {}'
          .format(what, out['steps_per_s'], out['images_per_s'],
                  out['ms_per_step'], out['device_busy_ms_per_step'],
                  out['device_idle_share'],
                  '' if not graph else ' (one replay on an idle device by CUDA'
                  ' events: {} ms/step)'.format(
                      out['replay_device_ms_per_step']), card), flush=True)
    return out


def dispatch_phase(mods, card, rec_path, host_rate, log,
                   dev=torch.device('cuda')):
    """The device-resident dataset (``DATA_DEVICE``) and K-step dispatch
    (``TRAIN.STEPS_PER_DISPATCH 8``, CUDA graphs) at full width: (a) bit
    identity of graphed and eager steps, (b) rates, (c) ``train_net``.
    Returns the launch counts of (c) and the phase's numbers."""
    load_cfg, train, ds_mod = mods['load_cfg'], mods['train'], \
        mods['device_store']
    rnn_cuda, ctc_cuda, get_network = mods['rnn_cuda'], mods['ctc_cuda'], \
        mods['get_network']
    yml = os.path.join(REPO, 'lstm', 'lstm.yml')
    k = 8
    out = {'steps_per_dispatch': k}
    t_phase = time.perf_counter()
    exp = 'chip_smoke_dispatch'
    base = train_overrides(rec_path, exp) + [
        'TRAIN.STEPS_PER_DISPATCH', str(k), 'DATA_DEVICE', "'on'"]
    cfg = load_cfg(yml, base)
    n = int(cfg.TRAIN.BATCH_SIZE)
    check(int(cfg.TRAIN.NUM_HID) == 512 and n == 64
          and str(cfg.TRAIN.SOLVER) == 'Adam',
          'lstm.yml is not the full-width default model')
    dtype = train.compute_dtype(cfg)

    def fresh(cfg_, make=None):
        net = (make or (lambda c: get_network(
            'LSTM_train', c, generator=torch.Generator().manual_seed(
                int(c.RNG_SEED)))))(cfg_)
        model = net.to(dev).train()
        return model, train.make_optimizer(model, cfg_)

    # (a) graph against eager, gather chunk on the records store
    model, optimizer = fresh(cfg)
    with contextlib.redirect_stdout(log):
        feed = ds_mod.make_device_feed(cfg, dev)
    store = feed.store
    out['store_bucket'] = store.w_bucket
    step1 = train.make_train_step_gather(model, optimizer, cfg, dtype)
    # (b)'s eager store rate first, before any graph is captured
    rates = {'records_host_eager': host_rate}
    rates['store_eager'] = group_rate(
        'records store, K=1 eager (bucket {})'.format(store.w_bucket),
        lambda: step1(*store.arrays, feed.step_indices(n)), 1, card,
        warm=8, graph=False)
    chunk = train.make_train_chunk(model, optimizer, cfg, dtype, k,
                                   gather=True)
    chunk(*store.arrays, feed.chunk_indices(n, k))  # eager first, captured
    idx = feed.chunk_indices(n, k)
    gather_diff = graph_against_eager(
        model, optimizer, lambda: chunk(*store.arrays, idx)[0],
        lambda: torch.stack([step1(*store.arrays, idx[j])[0]
                             for j in range(k)]))

    # the host-batch chunk on the records file's host feed (DATA_DEVICE
    # off): the first 16 batches of one bucket, in two groups of 8
    cfg_off = load_cfg(yml, base[:-2] + ['DATA_DEVICE', "'off'"])
    with contextlib.redirect_stdout(log):
        stream = train.make_train_stream(cfg_off, n)
    by_width = {}
    for _ in range(64):
        b = next(stream)
        by_width.setdefault(b.image.shape[1], []).append(b)
        if len(by_width[b.image.shape[1]]) == 2 * k:
            break
    stream.close()
    width, batches = max(by_width.items(), key=lambda kv: len(kv[1]))
    check(len(batches) == 2 * k, 'no {} host batches of one bucket in 64: {}'
          .format(2 * k, {w: len(v) for w, v in by_width.items()}))
    groups = [train.stack_batches(batches[:k]),
              train.stack_batches(batches[k:])]
    out['host_chunk_bucket'] = width
    hchunk = train.make_train_chunk(model, optimizer, cfg, dtype, k)
    hchunk(*groups[0])                            # eager first, captured
    hstep = train.make_train_step(model, optimizer, cfg, dtype)
    host_diff = graph_against_eager(
        model, optimizer, lambda: hchunk(*groups[1])[0],
        lambda: torch.stack([hstep(*(torch.from_numpy(a[j]).to(dev)
                                     for a in groups[1]))[0]
                             for j in range(k)]))
    for what, (graph, eager) in (('gather', gather_diff),
                                 ('host-batch', host_diff)):
        print('dispatch (a) {} chunk, {} graphed steps against {} eager from '
              'one saved state (losses, parameters, moments, BN buffers, '
              'count): largest |graph - eager| {}, largest |eager - eager| {}'
              '{}'.format(what, k, k, graph, eager,
                          '' if eager == 0 else ': two eager runs differ, '
                          'so the graph is held to their difference'),
              flush=True)
        check(graph <= eager, '{} chunk: graph differs from eager by {}, '
              'two eager runs by {}'.format(what, graph, eager))
    out['graph_vs_eager'] = {'gather': gather_diff[0], 'host': host_diff[0]}
    out['eager_vs_eager'] = {'gather': gather_diff[1], 'host': host_diff[1]}

    # (b) rates, one model state carried through (its numbers only)
    rates['store_graph'] = group_rate(
        'records store, K=8 graph (bucket {})'.format(store.w_bucket),
        lambda: chunk(*store.arrays, feed.chunk_indices(n, k)), k, card)

    cwd = os.path.join(REPO, 'chiprun_out', 'chip_smoke_pool')
    os.makedirs(cwd, exist_ok=True)
    here = os.getcwd()
    os.chdir(cwd)                              # the pool's cache goes here
    try:
        pool_cfg = load_cfg(yml, base + ['DATA_BACKEND', 'pool', 'POOL_SIZE',
                                         '2048', 'POOL_REFRESH', '2'])
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            pool_feed = ds_mod.make_device_feed(pool_cfg, dev)
        out['pool_build_s'] = time.perf_counter() - t0
    finally:
        os.chdir(here)
        shutil.rmtree(cwd, ignore_errors=True)
    pool_chunk = train.make_train_chunk(model, optimizer, cfg, dtype, k,
                                        gather=True)
    tick_s = []

    def pool_group():
        pool_chunk(*pool_feed.store.arrays, pool_feed.chunk_indices(n, k))
        t0 = time.perf_counter()
        pool_feed.tick(k)                # renders, stages, flushes every 32
        tick_s.append(time.perf_counter() - t0)
    rates['pool_graph'] = group_rate(
        'pool device feed (2,048 images, POOL_REFRESH 2, bucket {}), K=8 '
        'graph'.format(pool_feed.store.w_bucket), pool_group, k, card)
    rates['pool_graph']['host_refresh_ms_per_step'] = \
        1e3 * float(np.median(tick_s)) / k

    synth_cfg = load_cfg(yml, ['RENDERER', 'native', 'TRAIN.DTYPE',
                               "'bfloat16'", 'TRAIN.STEPS_PER_DISPATCH',
                               str(k)])
    workers = train.effective_workers(int(synth_cfg.TRAIN.NUM_WORKERS))
    stream = train.make_train_stream(synth_cfg, n)
    bucket_groups = train.BucketGroups(stream)
    in_graphs = [0, 0, 0]          # steps in graphs, steps, groups

    def synth_group():
        group = bucket_groups.take(k)
        if len(group) == k:
            schunk(*train.stack_batches(group))
            in_graphs[0] += k
        else:                                # a bucket change: eager steps
            for b in group:
                hstep(*(torch.from_numpy(a).to(dev) for a in
                        (b.image, b.label, b.label_len, b.time_step)))
        in_graphs[1] += len(group)
        in_graphs[2] += 1
        return len(group)
    schunk = train.make_train_chunk(model, optimizer, synth_cfg, dtype, k)
    try:
        # a long warm-up, so that the buckets' captures fall before the
        # timed window where the stream gives a full group of one bucket
        for _ in range(24):
            synth_group()
        in_graphs[:] = [0, 0, 0]
        rates['synth_graph'] = group_rate(
            'synthetic stream ({} fork workers), K=8 graph per bucket'
            .format(workers), synth_group, k, card, warm=0, n_timed=80,
            graph=False)
    finally:
        stream.close()
    rates['synth_graph']['share_of_steps_in_graphs'] = \
        in_graphs[0] / in_graphs[1]
    rates['synth_graph']['buckets_captured'] = len(schunk.graphs)
    rates['synth_graph']['mean_same_bucket_run'] = in_graphs[1] / in_graphs[2]

    stacked, stacked_opt = fresh(cfg, lambda c: stacked_model(mods, c))
    schunk_lstm = train.make_train_chunk(stacked, stacked_opt, cfg, dtype, k,
                                         gather=True)
    rates['stacked_store_graph'] = group_rate(
        'stacked-LSTM model, records store, K=8 graph (bucket {})'.format(
            store.w_bucket),
        lambda: schunk_lstm(*store.arrays, feed.chunk_indices(n, k)), k,
        card)
    out['rates'] = rates
    del model, optimizer, stacked, stacked_opt, chunk, hchunk, pool_chunk
    del schunk, schunk_lstm, pool_feed

    # (c) train_net: device store, K=8, 60 steps, snapshots every 20
    steps, val_step, snap = 60, 50, 20
    shutil.rmtree(os.path.join(REPO, 'output', exp), ignore_errors=True)
    cfg = load_cfg(yml, base + ['VAL.VAL_STEP', str(val_step),
                                'TRAIN.DISPLAY', '10', 'TRAIN.SNAPSHOT_ITERS',
                                str(snap)])
    net = get_network('LSTM_train', cfg, generator=torch.Generator()
                      .manual_seed(int(cfg.RNG_SEED)))
    launch_counts(rnn_cuda, ctc_cuda, reset=True)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        _, optimizer, losses = train.train_net(
            net, {'name': 'chip_smoke'}, None,
            os.path.join(REPO, 'output', exp),
            os.path.join(REPO, 'logs', exp), cfg, max_iters=steps + 1,
            device=str(dev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts(rnn_cuda, ctc_cuda)
    val_calls = sum(1 for it in range(1, steps + 1)
                    if (it + 1) % val_step == 0)
    snaps = sorted(f for f in os.listdir(os.path.join(REPO, 'output', exp))
                   if f.endswith('.ckpt.npz'))
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    print('dispatch (c): train_net with DATA_DEVICE on, STEPS_PER_DISPATCH '
          '{}: {} steps in {:.1f} s (start-up included), total loss first 10 '
          '{:.4f} -> last 10 {:.4f}, snapshots {}, launches {}, {} validation '
          'decode(s)'.format(k, len(losses), wall, first, last, snaps,
                             json.dumps(counts), val_calls), flush=True)
    check(len(losses) == steps and bool(np.isfinite(losses).all())
          and optimizer.count == steps == int(optimizer.count_t),
          'expected {} finite losses and count, got {} (count {})'.format(
              steps, losses, optimizer.count))
    check(last < first, 'the loss did not fall: {} -> {}'.format(first, last))
    want_snaps = ['lstm_ctc_iter_{}.ckpt.npz'.format(s)
                  for s in range(snap, steps + 1, snap)]
    check(snaps == sorted(want_snaps), 'snapshots {}, expected {}'.format(
        snaps, want_snaps))
    want = {'bilstm_fwd': steps + val_calls, 'bilstm_bwd': steps,
            'lstm_fwd': 0, 'lstm_bwd': 0, 'ctc_fwd': steps, 'ctc_bwd': steps}
    check(counts == want, 'launches {} over {} steps, expected {}'.format(
        counts, steps, want))
    out['train_net'] = {'losses_first10_last10': [first, last],
                        'snapshots': snaps, 'wall_s': wall}
    out['seconds'] = time.perf_counter() - t_phase
    print('dispatch: phase took {:.1f} s'.format(out['seconds']), flush=True)
    return counts, out


# ---- 10. data parallelism ---------------------------------------------------

DP_STEPS, DP_K = 60, 8


def dp_overrides(rec_path, exp, parallel):
    """Phase 10 (a)'s run: lstm.yml at full width on the records store,
    8-step graphs, 60 steps."""
    return train_overrides(rec_path, exp) + [
        'TRAIN.STEPS_PER_DISPATCH', str(DP_K), 'DATA_DEVICE', "'on'",
        'VAL.VAL_STEP', '50', 'TRAIN.DISPLAY', '10', 'TRAIN.SNAPSHOT_ITERS',
        '20', 'PARALLEL', repr(parallel)]


def dp_f32_overrides():
    """Phase 10 (b)'s steps: f32, Momentum at lr 1e-3 (linear in the
    gradient, the CPU tests' solver), full width."""
    return ['TRAIN.DTYPE', "'float32'", 'TRAIN.SOLVER', "'Momentum'",
            'TRAIN.LEARNING_RATE', '0.001', 'TRAIN.GAMMA', '1.0',
            'RENDERER', 'native']


def dp_batches(mods, cfg, rec_path):
    """Three fixed global batches of 64: the records file's rows 0-191."""
    ds = mods['records'].RecordsDataset(rec_path, cfg)
    out = [ds.batch(range(64 * j, 64 * (j + 1))) for j in range(3)]
    ds.close()
    return [(b.image, b.label, b.label_len, b.time_step) for b in out]


def dp_train_net(mods, cfg, exp):
    """``train_net`` of phase 10 (a) from the seed; returns its losses, its
    final state on the host, the solver's count, the launches and the wall
    seconds."""
    train, get_network = mods['train'], mods['get_network']
    shutil.rmtree(os.path.join(REPO, 'output', exp), ignore_errors=True)
    net = get_network('LSTM_train', cfg, generator=torch.Generator()
                      .manual_seed(int(cfg.RNG_SEED)))
    launch_counts(mods['rnn_cuda'], mods['ctc_cuda'], reset=True)
    t0 = time.perf_counter()
    model, optimizer, losses = train.train_net(
        net, {'name': 'chip_smoke'}, None, os.path.join(REPO, 'output', exp),
        os.path.join(REPO, 'logs', exp), cfg, max_iters=DP_STEPS + 1,
        device='cuda')
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {'losses': losses,
            'state': [t.cpu() for t in save_state(model, optimizer)[0]],
            'count': optimizer.count, 'wall_s': wall,
            'launches': launch_counts(mods['rnn_cuda'], mods['ctc_cuda'])}


def dp_worker_nccl(mods, args, card):
    """Phase 10 (a) in a process of ``torch.distributed.run
    --nproc_per_node 1``: ``train_net`` under the one-rank NCCL group, then
    a mesh of that rank driving the K-step graph with its collectives
    captured, against the same graph without them, in turns."""
    import torch.distributed as dist
    pmesh, train = mods['pmesh'], mods['train']
    world = pmesh.init_distributed(device='cuda')
    try:
        check(world == 1 and dist.get_backend() == 'nccl',
              'expected one NCCL rank, got {} ({})'.format(
                  world, dist.get_backend()))
        cfg = mods['load_cfg'](os.path.join(REPO, 'lstm', 'lstm.yml'),
                               dp_overrides(args.records, 'chip_smoke_dp',
                                            'auto'))
        out = dp_train_net(mods, cfg, 'chip_smoke_dp')
        out['world'], out['backend'] = world, dist.get_backend()

        dev = torch.device('cuda', torch.cuda.current_device())
        dtype = train.compute_dtype(cfg)
        mesh = pmesh.make_mesh(dev)
        feed = mods['device_store'].make_device_feed(cfg, dev, verbose=False)
        store, n, k = feed.store, 64, DP_K
        out['captured'], rates = {}, {'plain': [], 'mesh': []}
        runs = {}
        for tag, m in (('plain', None), ('mesh', mesh)):
            model = mods['get_network']('LSTM_train', cfg).to(dev).train()
            opt = train.make_optimizer(model, cfg)
            chunk = train.make_train_chunk(model, opt, cfg, dtype, k,
                                           gather=True, mesh=m)
            step1 = train.make_train_step_gather(model, opt, cfg, dtype, m)
            chunk(*store.arrays, feed.chunk_indices(n, k))   # captured
            idx = feed.chunk_indices(n, k)
            out['captured'][tag] = graph_against_eager(
                model, opt, lambda: chunk(*store.arrays, idx)[0],
                lambda: torch.stack([step1(*store.arrays, idx[j])[0]
                                     for j in range(k)]))
            runs[tag] = chunk
        for tag in ('plain', 'mesh', 'mesh', 'plain'):
            chunk = runs[tag]
            rates[tag].append(group_rate(
                'one NCCL rank, store K=8 graph, {}'.format(
                    'collectives of a one-rank mesh captured' if tag == 'mesh'
                    else 'no mesh'),
                lambda: chunk(*store.arrays, feed.chunk_indices(n, k)), k,
                card))
        out['rates'] = rates
        torch.save(out, args.out)
    finally:
        dist.destroy_process_group()
    return 0


def dp_worker_off(mods, args):
    """Phase 10 (a)'s reference in a fresh process of its own: the same
    ``train_net`` with ``PARALLEL off`` and no process group."""
    cfg = mods['load_cfg'](os.path.join(REPO, 'lstm', 'lstm.yml'),
                           dp_overrides(args.records, 'chip_smoke_dp_fresh{}'
                                        .format(args.rank), 'off'))
    torch.save(dp_train_net(mods, cfg, 'chip_smoke_dp_fresh{}'.format(
        args.rank)), args.out)
    return 0


def dp_worker_gloo(mods, args):
    """Phase 10 (b) and (c) at one of two gloo ranks on the one card: three
    f32 DP steps on this rank's rows of fixed batches, then the DP eval."""
    import torch.distributed as dist
    pmesh, train = mods['pmesh'], mods['train']
    dev = torch.device('cuda', 0)
    pmesh.init_distributed(args.init, 2, args.rank, device=dev,
                           backend='gloo')
    try:
        mesh = pmesh.make_mesh(dev)
        yml = os.path.join(REPO, 'lstm', 'lstm.yml')
        cfg = mods['load_cfg'](yml, dp_f32_overrides())
        model = mods['get_network']('LSTM_train', cfg, generator=torch
                                    .Generator().manual_seed(0)).to(dev)
        opt = train.make_optimizer(model.train(), cfg)
        step = pmesh.make_parallel_train_step(model, opt, cfg, None, mesh)
        launch_counts(mods['rnn_cuda'], mods['ctc_cuda'], reset=True)
        losses, first = [], None
        for b in dp_batches(mods, cfg, args.records):
            losses.append(float(step(*pmesh.shard_batch(mesh, *b))[0]))
            if first is None:
                first = [t.to('cpu', copy=True) for t in opt._slot('trace')]
        out = {'mesh': (mesh.size, mesh.rank, mesh.backend),
               'names': list(opt.names), 'losses': losses, 'first': first,
               'state': [t.cpu() for t in save_state(model, opt)[0]],
               'launches_b': launch_counts(mods['rnn_cuda'],
                                           mods['ctc_cuda'])}
        cfg = mods['load_cfg'](yml, ['TEST.BATCH_SIZE', '64', 'BN_EVAL',
                                     "'batch'", 'TRAIN.DTYPE', "'bfloat16'",
                                     'DECODER', "'greedy'"])
        launch_counts(mods['rnn_cuda'], mods['ctc_cuda'], reset=True)
        with open(args.out + '.eval.log', 'w') as log:
            r = mods['test'].test_net(
                cfg, os.path.join(REPO, 'data', 'val'),
                os.path.join(REPO, 'checkpoints', cfg.EXP_DIR), device=dev,
                echo=lambda line: log.write(line + '\n'))
        out.update(predictions=r.predictions, correct=r.correct,
                   decode_calls=r.decode_calls,
                   images_per_s=r.steady_images_per_sec,
                   launches_c=launch_counts(mods['rnn_cuda'],
                                            mods['ctc_cuda']))
        torch.save(out, args.out)
    finally:
        dist.destroy_process_group()
    return 0


def dp_worker(argv, mods, card):
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument('mode', choices=('nccl', 'gloo', 'off'))
    parser.add_argument('--records', required=True)
    parser.add_argument('--out', required=True)
    parser.add_argument('--rank', type=int, default=0)
    parser.add_argument('--init', default=None)
    args = parser.parse_args(argv)
    if args.mode == 'nccl':
        return dp_worker_nccl(mods, args, card)
    if args.mode == 'off':
        return dp_worker_off(mods, args)
    return dp_worker_gloo(mods, args)


def run_workers(cmds, log_paths, timeout):
    """Start every command at once (cwd the repo, output to its log), wait
    for all within ``timeout`` seconds, and kill any still running."""
    logs = [open(p, 'w') for p in log_paths]
    procs = [subprocess.Popen(cmd, cwd=REPO, stdout=log,
                              stderr=subprocess.STDOUT)
             for cmd, log in zip(cmds, logs)]
    deadline = time.perf_counter() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    return [p.returncode for p in procs]


def bar_ratio(got, want, rtol=2e-5, atol=2e-6):
    """The largest |got - want| / (atol + rtol |want|) over two states:
    at most 1 within the CPU tests' bar."""
    return max(float(((g.double() - w.double()).abs()
                      / (atol + rtol * w.double().abs())).max())
               for g, w in zip(got, want))


def dp_phase(mods, card, rec_path, dispatch, eval_predictions, log):
    """(a) ``train_net`` under a one-rank NCCL group against PARALLEL off in
    a fresh process, and the captured collectives; (b) two gloo ranks on
    the one card against one rank on the global batch; (c) the DP eval
    against the eval phase. Returns the launches by path and the phase's
    numbers."""
    train, load_cfg = mods['train'], mods['load_cfg']
    rnn_cuda, ctc_cuda = mods['rnn_cuda'], mods['ctc_cuda']
    t_phase = time.perf_counter()
    out_dir = os.path.join(REPO, 'chiprun_out')
    yml = os.path.join(REPO, 'lstm', 'lstm.yml')
    me = os.path.join(REPO, 'chip_smoke.py')
    a_out = os.path.join(out_dir, 'chip_smoke_dp_a.pt')
    gloo_out = [os.path.join(out_dir, 'chip_smoke_dp_rank{}.pt'.format(r))
                for r in range(2)]
    fresh_out = [os.path.join(out_dir, 'chip_smoke_dp_fresh{}.pt'.format(i))
                 for i in range(2)]
    rendezvous = os.path.join(out_dir, 'chip_smoke_dp_rendezvous')
    for path in [a_out, rendezvous] + gloo_out + fresh_out:
        if os.path.exists(path):
            os.remove(path)
    logs = [os.path.join(out_dir, 'chip_smoke_dp_{}.log'.format(w))
            for w in ('a', 'rank0', 'rank1', 'fresh0', 'fresh1')]

    def fresh_cmd(i):            # (a)'s reference, a process of its own
        return [sys.executable, me, '--dp-worker', 'off', '--records',
                rec_path, '--out', fresh_out[i], '--rank', str(i)]
    # (a) alone on the card, since it measures rates; then (b) and (c)'s
    # two ranks and (a)'s reference while this process computes the
    # references of (b) and the same reference again here
    procs_t0 = time.perf_counter()
    rcs = run_workers([[sys.executable, '-m', 'torch.distributed.run',
                        '--standalone', '--nproc_per_node', '1', me,
                        '--dp-worker', 'nccl', '--records', rec_path,
                        '--out', a_out]], logs[:1], timeout=300)
    waiter = threading.Thread(target=lambda: rcs.extend(run_workers(
        [[sys.executable, me, '--dp-worker', 'gloo', '--records', rec_path,
          '--out', gloo_out[r], '--rank', str(r), '--init',
          'file://' + rendezvous] for r in range(2)] + [fresh_cmd(0)],
        logs[1:4], timeout=300)))
    waiter.start()

    # (a)'s reference run once more in this process, after the earlier
    # phases: printed beside the comparison, which is between fresh
    # processes
    cfg_off = load_cfg(yml, dp_overrides(rec_path, 'chip_smoke_dp_off',
                                         'off'))
    with contextlib.redirect_stdout(log):
        ref = dp_train_net(mods, cfg_off, 'chip_smoke_dp_off')
    # (b)'s reference: one rank's steps on the global batch on the card,
    # and the same steps on the CPU (plain versions, CPU convs): a second
    # correct computation, whose distance from the first says how far
    # rounding alone moves each tensor
    cfg32 = load_cfg(yml, dp_f32_overrides())
    batches = dp_batches(mods, cfg32, rec_path)
    one = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)
    for dev in ('cuda', 'cpu'):
        model = mods['get_network']('LSTM_train', cfg32, generator=torch
                                    .Generator().manual_seed(0)).to(dev)
        opt = train.make_optimizer(model.train(), cfg32)
        step = train.make_train_step(model, opt, cfg32, None)
        losses, first = [], None
        for b in batches:
            losses.append(float(step(*(torch.from_numpy(a).to(dev)
                                       for a in b))[0]))
            if first is None:
                first = [t.to('cpu', copy=True) for t in opt._slot('trace')]
        one[dev] = (losses, first,
                    [t.cpu() for t in save_state(model, opt)[0]])
    torch.set_num_threads(threads)
    waiter.join()
    workers_s = time.perf_counter() - procs_t0
    for path, rc in zip(logs, rcs):
        if rc != 0:
            with open(path) as f:
                print(f.read()[-4000:], flush=True)
    check(rcs == [0, 0, 0, 0], 'DP workers exited {} (logs {})'.format(
        rcs, logs[:4]))
    a = torch.load(a_out, weights_only=False)
    ranks = [torch.load(p, weights_only=False) for p in gloo_out]
    fresh = torch.load(fresh_out[0], weights_only=False)
    for path in [a_out, fresh_out[0]] + gloo_out:   # states: too large
        os.remove(path)
    out = {'workers_s': workers_s}

    def run_state(r):
        return [torch.tensor(r['losses'])] + r['state']

    # (a) against PARALLEL off, each in a fresh process; a difference is
    # held to that of two fresh PARALLEL off runs
    diff = state_difference(run_state(a), run_state(fresh))
    history = state_difference(run_state(ref), run_state(fresh))
    eager = 0.0
    if diff:
        rc = run_workers([fresh_cmd(1)], logs[4:], timeout=300)
        check(rc == [0], 'DP reference worker exited {} (log {})'.format(
            rc, logs[4]))
        fresh2 = torch.load(fresh_out[1], weights_only=False)
        os.remove(fresh_out[1])
        eager = state_difference(run_state(fresh2), run_state(fresh))
    val_calls = sum(1 for it in range(1, DP_STEPS + 1) if (it + 1) % 50 == 0)
    want = {'bilstm_fwd': DP_STEPS + val_calls, 'bilstm_bwd': DP_STEPS,
            'lstm_fwd': 0, 'lstm_bwd': 0, 'ctc_fwd': DP_STEPS,
            'ctc_bwd': DP_STEPS}
    print('dp (a) train_net under torch.distributed.run --nproc_per_node 1 '
          '(world {}, {}), PARALLEL auto, DATA_DEVICE on, K={}, {} steps in '
          '{:.1f} s: losses {:.4f} -> {:.4f}; against PARALLEL off in a '
          'fresh process: largest |difference| over losses and final state '
          '{}{}; the PARALLEL off run in this process, after the earlier '
          'phases, against the fresh one: {}; launches {}'.format(
              a['world'], a['backend'], DP_K, len(a['losses']), a['wall_s'],
              a['losses'][0], a['losses'][-1], diff,
              ' (bit for bit)' if diff == 0 else
              ', two fresh PARALLEL off runs differ by {}'.format(eager),
              history, json.dumps(a['launches'])), flush=True)
    check(len(a['losses']) == DP_STEPS and a['count'] == DP_STEPS,
          'dp (a): {} losses, count {}'.format(len(a['losses']), a['count']))
    check(diff <= eager, 'dp (a) differs from PARALLEL off by {} (two off '
          'runs by {})'.format(diff, eager))
    check(all(r['launches'] == want for r in (a, fresh, ref)),
          'dp (a) launches {} (PARALLEL off {}, in this process {}), '
          'expected {}'.format(a['launches'], fresh['launches'],
                               ref['launches'], want))
    for tag, (graph, eager_k) in a['captured'].items():
        print('dp (a) one NCCL rank, store K=8 graph ({}): {} graphed steps '
              'against eager from one state, largest |graph - eager| {}, '
              '|eager - eager| {}'.format(
                  'collectives of a one-rank mesh captured' if tag == 'mesh'
                  else 'no mesh', DP_K, graph, eager_k), flush=True)
        check(graph <= eager_k, 'dp (a) {} graph differs from eager by {}'
              .format(tag, graph))
    rate = {tag: {key: statistics.mean(r[key] for r in runs)
                  for key in ('steps_per_s', 'device_busy_ms_per_step',
                              'device_idle_share')
                  if all(r[key] is not None for r in runs)}
            for tag, runs in a['rates'].items()}
    store_graph = dispatch['rates']['store_graph']
    print('dp (a) rates on {} (steps/s, device busy ms a step, idle share; '
          'mean of two turns each): one NCCL rank with the collectives {}, '
          'without {}; phase 8 store K=8 graph {:.2f} steps/s, {} ms, {}'
          .format(card, json.dumps(rate['mesh']), json.dumps(rate['plain']),
                  store_graph['steps_per_s'],
                  store_graph['device_busy_ms_per_step'],
                  store_graph['device_idle_share']), flush=True)
    out['a'] = {'max_abs_diff_vs_parallel_off': diff,
                'parallel_off_vs_off': eager,
                'parallel_off_this_process_vs_fresh': history,
                'losses_first_last':
                [a['losses'][0], a['losses'][-1]], 'wall_s': a['wall_s'],
                'graph_vs_eager': a['captured'], 'rates': rate,
                'rates_by_turn': a['rates']}

    # (b) two gloo ranks against one rank on the global batch. Each step-1
    # gradient within 1e-5 of the largest, or, for a tensor whose card and
    # CPU one-rank gradients differ by more (the conv2-conv3_2 biases, a
    # sum that batch norm downstream all but cancels), within that
    # difference; the 3-step state within the CPU tests' bar, or within the
    # card-to-CPU distance of the one-rank run where that is larger
    losses1, first1, state1 = one['cuda']
    names = ranks[0]['names']
    g_max = max(float(t.abs().max()) for t in first1)
    floor = [max(1e-5 * g_max, float((c - g).abs().max()))
             for c, g in zip(one['cpu'][1], first1)]
    control = bar_ratio(one['cpu'][2], state1)
    out['b'] = {'cpu_vs_card_bar_ratio': control, 'cpu_vs_card_gradients': {
        n: f / g_max for n, f in zip(names, floor) if f > 1e-5 * g_max}}
    for r, res in enumerate(ranks):
        check(res['mesh'] == (2, r, 'gloo'), 'dp (b) rank {} mesh {}'.format(
            r, res['mesh']))
        diffs = [float((g - w).abs().max())
                 for g, w in zip(res['first'], first1)]
        over = [(n, d / g_max, f / g_max)
                for n, d, f in zip(names, diffs, floor) if d > f]
        grad = max(diffs) / g_max
        loss = max(abs(x - y) / abs(y) for x, y in zip(res['losses'],
                                                         losses1))
        ratio = bar_ratio(res['state'], state1)
        same = all(torch.equal(x, y) for x, y in
                   zip(res['state'], ranks[0]['state'])) \
            and res['losses'] == ranks[0]['losses']
        print('dp (b) rank {} of 2 (gloo, CUDA tensors, one card), 3 f32 '
              'Momentum steps on its 32 rows of each batch of 64, against one '
              'rank on the global batch: step-1 gradients within {:.2e} of '
              'the largest ({} tensors past 1e-5, each within the card-to-CPU '
              'difference of the one-rank gradient: {}), losses within {:.2e} '
              'relative, final state at {:.3f} of the bar (rtol 2e-5, atol '
              '2e-6; the one-rank run on the CPU against the card: {:.3f}), '
              'bit-identical to rank 0: {}; launches {}'.format(
                  r, grad, sum(d > 1e-5 * g_max for d in diffs),
                  json.dumps({n: [round(d / g_max, 6), round(f / g_max, 6)]
                              for n, d, f in zip(names, diffs, floor)
                              if d > 1e-5 * g_max}),
                  loss, ratio, control, same,
                  json.dumps(res['launches_b'])), flush=True)
        check(not over and loss <= 1e-5 and same,
              'dp (b) rank {}: gradients past their bar {}, loss {}, same {}'
              .format(r, over, loss, same))
        check(ratio <= max(1.0, control),
              'dp (b) rank {}: state at {} of the bar, the CPU one-rank run '
              'at {}'.format(r, ratio, control))
        check(all(res['launches_b'][k] == 3 for k in
                  ('bilstm_fwd', 'bilstm_bwd', 'ctc_fwd', 'ctc_bwd')),
              'dp (b) rank {} launches {}'.format(r, res['launches_b']))
        out['b']['rank{}'.format(r)] = {'grad': grad, 'loss': loss,
                                        'bar_ratio': ratio}

    # (c) the DP eval against the eval phase's strings
    want = eval_predictions['lstm_ctc/batch']
    got = ranks[0]['predictions']
    moved = sorted(f for f in want if got.get(f) != want[f])
    for r, res in enumerate(ranks):
        check(res['predictions'] == got, 'dp (c) rank {} predictions differ '
              'from rank 0'.format(r))
        check(res['launches_c']['bilstm_fwd'] == res['decode_calls'],
              'dp (c) rank {}: {} launches for {} decode calls'.format(
                  r, res['launches_c']['bilstm_fwd'], res['decode_calls']))
    print('dp (c) eval at two gloo ranks (lstm_ctc, BN_EVAL batch, batch 64 '
          'as 2 x 32, bf16) on data/val: {}/{} correct, {} decode calls a '
          'rank, {:.1f} images/s steady; strings against the eval phase: {} '
          'of {} identical{}'.format(
              ranks[0]['correct'], len(got), ranks[0]['decode_calls'],
              ranks[0]['images_per_s'], len(want) - len(moved), len(want),
              '' if not moved else ', moved by batch composition: {}'.format(
                  [(f, want[f], got.get(f)) for f in moved])), flush=True)
    check(set(got) == set(want) and ranks[0]['correct'] >= EVALS[0][6],
          'dp (c): {} files, {} correct'.format(len(got),
                                                ranks[0]['correct']))
    out['c'] = {'correct': ranks[0]['correct'], 'moved': moved,
                'decode_calls': ranks[0]['decode_calls'],
                'images_per_s': ranks[0]['images_per_s']}
    out['seconds'] = time.perf_counter() - t_phase
    print('dp: phase took {:.1f} s (workers {:.1f} s)'.format(
        out['seconds'], workers_s), flush=True)
    launches = {'dp_train_nccl': a['launches'],
                'dp_reference': fresh['launches'],
                'dp_reference_this_process': ref['launches']}
    for r, res in enumerate(ranks):
        launches['dp_steps_rank{}'.format(r)] = res['launches_b']
        launches['dp_eval_rank{}'.format(r)] = res['launches_c']
    return launches, out


# ---- 11. the measurement tools ----------------------------------------------

# the JAX tools' JSON lines by their keys (tests/test_torch_tools.py cites
# each by file and line)
TOOL_KEYS = {
    'bench_ctc': [{'impl', 'fwd_ms', 'fwd_bwd_ms'}, {'piece', 'ms'},
                  {'device', 'shape'}],
    'bench_rnn': [{'impl', 'fwd_ms', 'fwd_bwd_ms', 'shape', 'hidden',
                   'dtype', 'device'}, {'speedup_fwd', 'speedup_fwd_bwd'}],
    'bench_decode': [{'shape', 'width', 'batch', 'decoder', 'beam_width',
                      'scope', 'p50_sec_per_batch', 'p50_ms_per_image',
                      'images_per_sec'}, {'beam_over_greedy_full_step'}],
    'bench_decode --frozen': [{'shape', 'width', 'batch', 'decoder',
                               'variant', 'p50_sec_per_batch',
                               'p50_ms_per_image', 'images_per_sec'}],
    'profile_step': [{'piece', 'ms', 'gflops', 'tflops_achieved', 'mfu'},
                     {'device', 'batch', 'width', 'lstm_impl', 'ctc_impl'}],
    'attrib_step': [{'variant', 'ms_per_step'},
                    {'delta_ctc_pallas_vs_scan_ms',
                     'delta_ctc_pallas_vs_none_ms',
                     'delta_lstm_pallas_vs_scan_ms', 'device'}],
    'bench_fold_h': [{'check', 'rel_err', 'shape'},
                     {'variant', 'batch', 'w', 'fwd_ms', 'fwd_bwd_ms'}],
    'bench_data': [{'renderer', 'img_per_sec'},
                   {'backend', 'batch', 'batches_per_sec', 'img_per_sec'}],
}
# windows x calls of the timed tools: short, the phase has ~120 s
TOOL_WINDOWS, TOOL_CALLS = 3, 10


def run_tool(mods, name, argv, log):
    """One tool's ``main(argv)`` in this process, its standard output
    captured into ``log``; the kernel counters set to 0 just before and read
    just after. Returns its JSON lines and the launches. Every line must
    parse and carry one of the JAX tool's key sets."""
    tool = mods['tools'][name.split()[0]]
    launch_counts(mods['rnn_cuda'], mods['ctc_cuda'], reset=True)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = tool.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = launch_counts(mods['rnn_cuda'], mods['ctc_cuda'])
    text = buf.getvalue()
    log.write('== {} {}\n{}'.format(name, ' '.join(argv), text))
    check(rc == 0, '{} returned {}'.format(name, rc))
    lines = [json.loads(t) for t in text.splitlines() if t.strip()]
    for line in lines:
        check(set(line) in TOOL_KEYS[name], '{}: a line with keys {} is not '
              "one of the JAX tool's {}".format(name, sorted(line),
                                                TOOL_KEYS[name]))
        print('tool {}: {}'.format(name, json.dumps(line)), flush=True)
    print('tool {}: {:.1f} s, launches {}'.format(name, secs,
                                                  json.dumps(launches)),
          flush=True)
    return lines, launches


def expect_launches(name, got, want):
    check(all(got[k] == want.get(k, 0) for k in got),
          '{}: launches {}, expected {}'.format(name, got, want))


def profiled_train(mods, rec_path, trace_dir, log):
    """Phase 11's solver run: 8 iterations (7 steps) of ``lstm/lstm.yml``
    at full width on the records file, traced where ``trace_dir`` is given
    (``PROFILE_START 3``, ``PROFILE_STEPS 3``); returns the losses and the
    launches."""
    exp = 'chip_smoke_profile' if trace_dir else 'chip_smoke_noprofile'
    prof = ['PROFILE_DIR', trace_dir, 'PROFILE_START', '3', 'PROFILE_STEPS',
            '3'] if trace_dir else []
    cfg = mods['load_cfg'](os.path.join(REPO, 'lstm', 'lstm.yml'),
                           train_overrides(rec_path, exp) + prof)
    shutil.rmtree(os.path.join(REPO, 'output', exp), ignore_errors=True)
    net = mods['get_network']('LSTM_train', cfg, generator=torch.Generator()
                              .manual_seed(int(cfg.RNG_SEED)))
    launch_counts(mods['rnn_cuda'], mods['ctc_cuda'], reset=True)
    with contextlib.redirect_stdout(log):
        losses = mods['train'].train_net(
            net, {'name': 'chip_smoke'}, None,
            os.path.join(REPO, 'output', exp),
            os.path.join(REPO, 'logs', exp), cfg, max_iters=8,
            device='cuda')[2]
    torch.cuda.synchronize()
    return losses, launch_counts(mods['rnn_cuda'], mods['ctc_cuda'])


def tools_phase(mods, card, rec_path, train_rate, eval_p50_ms, log):
    """Phase 11: each measurement tool in this process at the shapes its
    flags give, its lines against the JAX tool's keys and its kernel
    launches counted; ``bench_fold_h``'s f32 gate; ``bench_data``'s three
    backends on the native renderer; ``PROFILE_DIR`` in the solver. Returns
    the launches by tool and the phase's numbers."""
    t_phase = time.perf_counter()
    wc = ['--windows', str(TOOL_WINDOWS), '--calls', str(TOOL_CALLS)]
    r = 1 + TOOL_WINDOWS * TOOL_CALLS           # calls of a timed function
    native = ['--set', 'RENDERER', 'native']
    launches, out = {}, {}

    # bench_ctc: the kernels' loss forward and forward+backward, and the
    # forward kernel alone: 3 r ctc_fwd, r ctc_bwd
    lines, launches['bench_ctc'] = run_tool(mods, 'bench_ctc', wc, log)
    expect_launches('bench_ctc', launches['bench_ctc'],
                    {'ctc_fwd': 3 * r, 'ctc_bwd': r})
    out['bench_ctc'] = lines

    # bench_rnn at its default longline shape (T=191: its plain pair takes
    # ~1,000 launches a call, so fewer calls): the fused forward (the
    # inference op) and forward+backward: 2 rr bilstm_fwd, rr bilstm_bwd
    rr = 1 + 3 * 3
    lines, launches['bench_rnn'] = run_tool(
        mods, 'bench_rnn', ['--windows', '3', '--calls', '3'], log)
    expect_launches('bench_rnn', launches['bench_rnn'],
                    {'bilstm_fwd': 2 * rr, 'bilstm_bwd': rr})
    out['bench_rnn'] = lines

    # bench_decode: the full step of two decoders at two shapes, and each
    # shape's logits: 4 rd + 2 bilstm_fwd; --frozen: the live step and the
    # served program's op, 2 rd
    dwc = ['--windows', '5', '--calls', '3']
    rd = 1 + 5 * 3
    lines, launches['bench_decode'] = run_tool(mods, 'bench_decode', dwc, log)
    expect_launches('bench_decode', launches['bench_decode'],
                    {'bilstm_fwd': 4 * rd + 2})
    out['bench_decode'] = lines
    frozen, launches['bench_decode --frozen'] = run_tool(
        mods, 'bench_decode --frozen', dwc + ['--frozen'], log)
    expect_launches('bench_decode --frozen',
                    launches['bench_decode --frozen'], {'bilstm_fwd': 2 * rd})
    out['bench_decode_frozen'] = frozen
    greedy96 = next(x for x in lines if x.get('shape') == 'default_W96'
                    and x.get('decoder') == 'greedy'
                    and x.get('scope') == 'full_step')

    # profile_step at W=128 (the native renderer's 6-character lines are
    # ~108 pixels wide; --width 96 would double to a W=192 bucket): each of
    # five pieces counted once and timed r times
    pw = ['--width', '128']
    rp = r + 1
    lines, launches['profile_step'] = run_tool(mods, 'profile_step',
                                               wc + pw + native, log)
    expect_launches('profile_step', launches['profile_step'],
                    {'bilstm_fwd': 3 * rp, 'bilstm_bwd': rp,
                     'ctc_fwd': 4 * rp, 'ctc_bwd': 2 * rp})
    out['profile_step'] = lines

    # attrib_step: S steps a variant; the default and conv=shifted variants
    # launch each of kernels 1-4 once a step, ctc=plain and ctc=none the
    # BiLSTM kernels, lstm=plain the CTC kernels
    warm, aw, ac = 20, 3, 20
    steps = warm + 1 + aw * ac
    lines, launches['attrib_step'] = run_tool(
        mods, 'attrib_step', ['--windows', str(aw), '--calls', str(ac),
                              '--warm', str(warm)] + pw + native, log)
    expect_launches('attrib_step', launches['attrib_step'],
                    {'bilstm_fwd': 4 * steps, 'bilstm_bwd': 4 * steps,
                     'ctc_fwd': 3 * steps, 'ctc_bwd': 3 * steps})
    out['attrib_step'] = lines
    default_ms = next(x['ms_per_step'] for x in lines
                      if x.get('variant') == 'ctc=kernel lstm=kernel')

    # bench_fold_h: the f32 gate (the tool raises past it), then bf16
    lines, _ = run_tool(mods, 'bench_fold_h', ['--windows', '3', '--calls',
                                               '4'], log)
    check(lines[0]['rel_err'] < 1e-4, 'fold_h f32 gate: rel_err {}'.format(
        lines[0]['rel_err']))
    out['bench_fold_h'] = lines

    # bench_data: the native renderer and the three backends, the records
    # file phase 5 wrote
    lines, _ = run_tool(mods, 'bench_data', [
        '--renderers', 'native', '--backends', 'synth,pool,records', '--set',
        'RECORDS_PATH', rec_path], log)
    rates = [x for x in lines if 'backend' in x]
    check([x['backend'] for x in rates] == ['synth', 'pool', 'records']
          and all(x.get('img_per_sec') for x in rates)
          and not any('error' in x for x in lines),
          'bench_data: {}'.format(lines))
    out['bench_data'] = lines

    # PROFILE_DIR in the solver: the trace names the kernels, the losses
    # are the untraced run's, bit for bit
    trace_dir = os.path.join(REPO, 'output', 'chip_smoke_profile_trace')
    shutil.rmtree(trace_dir, ignore_errors=True)
    plain, _ = profiled_train(mods, rec_path, None, log)
    traced, launches['profiler_train'] = profiled_train(mods, rec_path,
                                                        trace_dir, log)
    traces = sorted(f for f in os.listdir(trace_dir)
                    if f.endswith('.pt.trace.json'))
    check(len(traces) == 1, 'PROFILE_DIR: trace files {}'.format(traces))
    with open(os.path.join(trace_dir, traces[0])) as f:
        trace = f.read()
    names = {k: k in trace for k in ('bilstm_fwd_cluster_kernel',
                                     'ctc_fwd_warp_kernel')}
    print('tool profiler: train_net with PROFILE_DIR (steps [3, 6)): {} '
          '({:.1f} MB), kernels named {}; losses {} against the untraced '
          'run {}: bit for bit {}; launches {}'.format(
              traces[0], len(trace) / 1e6, json.dumps(names), traced, plain,
              traced == plain, json.dumps(launches['profiler_train'])),
          flush=True)
    check(all(names.values()), 'the trace names {}'.format(names))
    check(len(plain) == 7 and traced == plain,
          'PROFILE_DIR changed the losses: {} vs {}'.format(traced, plain))
    expect_launches('profiler_train', launches['profiler_train'],
                    {'bilstm_fwd': 7, 'bilstm_bwd': 7, 'ctc_fwd': 7,
                     'ctc_bwd': 7})

    eager_ms = 1e3 / train_rate['steps_per_s']
    print('tools cross-check on {}: attrib_step default variant {:.3f} ms a '
          'step (W=128, one batch) beside phase 5\'s eager records-feed step '
          '{:.3f} ms; bench_decode greedy W=96 full step {:.4f} ms an image '
          '(random images, seeded weights) beside the eval phase\'s '
          'lstm_ctc/batch p50 {:.4f} ms an image'.format(
              card, default_ms, eager_ms, greedy96['p50_ms_per_image'],
              eval_p50_ms), flush=True)
    out['cross_check'] = {
        'attrib_default_ms_per_step': default_ms,
        'phase5_eager_ms_per_step': eager_ms,
        'decode_greedy_w96_full_step_ms_per_image':
            greedy96['p50_ms_per_image'],
        'eval_lstm_ctc_p50_ms_per_image': eval_p50_ms}
    out['seconds'] = time.perf_counter() - t_phase
    print('tools: phase took {:.1f} s'.format(out['seconds']), flush=True)
    return launches, out


# --- phase 12: the model DSL and the offline surface -------------------------

def dsl_classes(Network):
    """The JAX package's ``crnn.LSTM_train`` chain verbatim as a port
    ``Network`` subclass (``cfg`` read from ``self.cfg``), the same chain
    with a stacked ``.lstm(512, 2)`` head, and phase 12 (c)'s net of the
    DSL-only and legacy layers."""

    class LSTMTrainDSL(Network):
        def setup(self):
            cfg = self.cfg
            (self.feed('data')
             .conv_single(3, 3, 64, 1, 1, name='conv1', c_i=cfg.NCHANNELS)
             .max_pool(2, 2, 2, 2, padding='VALID', name='pool1')
             .conv_single(3, 3, 128, 1, 1, name='conv2')
             .max_pool(2, 2, 2, 2, padding='VALID', name='pool2')
             .conv_single(3, 3, 256, 1, 1, name='conv3_1')
             .conv_single(3, 3, 256, 1, 1, name='conv3_2')
             .max_pool(1, 2, 1, 2, padding='VALID', name='pool2')
             .conv_single(3, 3, 512, 1, 1, name='conv4_1', bn=True)
             .conv_single(3, 3, 512, 1, 1, name='conv4_2', bn=True)
             .max_pool(1, 2, 1, 2, padding='VALID', name='pool3')
             .conv_single(2, 2, 512, 1, 1, padding='VALID', name='conv5',
                          relu=False)
             .reshape_squeeze_layer(d=512, name='reshaped_layer'))
            (self.feed('reshaped_layer', 'time_step_len')
             .bi_lstm(cfg.TRAIN.NUM_HID, cfg.TRAIN.NUM_LAYERS, name='logits'))

    class StackedDSL(LSTMTrainDSL):
        def setup(self):
            super().setup()
            self.specs.pop()
            self.layer_order.pop()
            (self.feed('reshaped_layer', 'time_step_len')
             .lstm(512, STACKED_LAYERS, name='logits'))

    class LegacyNet(Network):
        input_names = ('data',)

        def __init__(self, keep_prob, cfg, generator):
            self.keep_prob = keep_prob
            super().__init__(cfg, generator=generator,
                             input_shapes={'data': LEGACY_SHAPE})

        def setup(self):
            (self.feed('data')
             .conv_norm(3, 3, 32, 1, 1, name='cn')
             .conv_norm(3, 3, 32, 2, 2, biased=False, name='crelu')
             .lrn(2, 1e-4, 0.75, name='lrn')
             .batch_normalization(name='bn')
             .pva_negation_block_v2(3, 3, 128, 1, 1, 64, name='neg')
             .pva_inception_res_block(name='incep')
             .upconv(None, 64, name='up')
             .avg_pool(2, 2, 2, 2, name='avg')
             .dropout(self.keep_prob, name='drop')
             .fc(10, relu=False, name='fc'))
    return LSTMTrainDSL, StackedDSL, LegacyNet


# phase 12 (c)'s input, JAX layout [N, A1, A2, C]
LEGACY_SHAPE = (8, 32, 32, 3)


def dsl_train_overrides(rec_path, exp, steps):
    """``train_overrides`` for a run of ``steps`` steps with no validation
    decode and no snapshot."""
    return train_overrides(rec_path, exp) + [
        'VAL.VAL_STEP', '1000', 'TRAIN.SNAPSHOT_ITERS', '1000',
        'TRAIN.LOSS_MIN_SNAPSHOT', '0.0', 'TRAIN.DISPLAY', str(steps)]


def train_pair(mods, make, cfg, exp, steps, log, pre_train=(None, None)):
    """``train_net`` of ``steps`` steps for each of the two models
    ``make(i)`` gives (``pre_train[i]`` each), the kernel counters set to 0
    before each run and read after it. Returns the two (losses, state,
    launches)."""
    out = []
    for i in range(2):
        net = make(i)
        launch_counts(mods['rnn_cuda'], mods['ctc_cuda'], reset=True)
        with contextlib.redirect_stdout(log):
            model, _, losses = mods['train'].train_net(
                net, {'name': 'chip_smoke'}, pre_train[i],
                os.path.join(REPO, 'output', exp),
                os.path.join(REPO, 'logs', exp), cfg, max_iters=steps + 1,
                device='cuda')
        torch.cuda.synchronize()
        out.append((losses, {k: v.detach().clone()
                             for k, v in model.state_dict().items()},
                    launch_counts(mods['rnn_cuda'], mods['ctc_cuda'])))
    return out


def bit_for_bit(pair, steps, what):
    """Check two ``train_pair`` runs: ``steps`` finite losses each, equal,
    and every tensor of the final state equal. Returns the largest
    difference of a state tensor (0.0)."""
    (la, sa, _), (lb, sb, _) = pair
    check(len(la) == steps and bool(np.isfinite(la).all()),
          '{}: expected {} finite losses, got {}'.format(what, steps, la))
    diff = max(float((sa[k].float() - sb[k].float()).abs().max())
               for k in sa)
    check(list(sa) == list(sb), '{}: state keys differ'.format(what))
    check(la == lb and diff == 0.0,
          '{}: losses {} vs {}, largest state difference {}'.format(
              what, la, lb, diff))
    return diff


def legacy_phase(LegacyNet, cfg):
    """(c): the DSL-only and legacy layers forward and backward in f32 on
    the card against the same net on the CPU (dropout at keep_prob 1), and
    two dropout runs at keep_prob 0.5 from one seed. Returns the worst
    output and gradient differences over each tensor's scale."""
    gen = torch.Generator().manual_seed(0)
    cpu = LegacyNet(1.0, cfg, gen).train()
    card = LegacyNet(1.0, cfg, torch.Generator().manual_seed(1))
    card.load_state_dict(cpu.state_dict())
    card = card.cuda().train()
    rng = np.random.RandomState(0)
    n, a1, a2, c = LEGACY_SHAPE
    x = torch.from_numpy(rng.randn(n, c, a1, a2).astype(np.float32))
    y_cpu = cpu(x)
    w = torch.from_numpy(rng.randn(*y_cpu.shape).astype(np.float32))
    (y_cpu * w).sum().backward()
    y_card = card(x.cuda())
    (y_card * w.cuda()).sum().backward()
    torch.cuda.synchronize()

    def rel(got, want):
        return float((got.cpu() - want).abs().max()) / max(
            1.0, float(want.abs().max()))
    out_err = rel(y_card.detach(), y_cpu.detach())
    grads = {k: p.grad for k, p in cpu.named_parameters()}
    big = max(float(g.abs().max()) for g in grads.values())
    grad_err, noise = 0.0, 0.0
    for k, p in card.named_parameters():
        want = grads[k]
        if float(want.abs().max()) <= 1e-6 * big:
            # zero in exact arithmetic (a bias batch norm removes): noise
            noise = max(noise, float(p.grad.abs().max()) / big)
        else:
            grad_err = max(grad_err, rel(p.grad, want))
    check(y_card.shape == (n, 10, a1 // 4, a2 // 4),
          'legacy net output {}'.format(tuple(y_card.shape)))
    check(out_err <= 1e-4 and grad_err <= 1e-4 and noise <= 1e-5,
          'legacy net card vs CPU: output {:.2e}, gradients {:.2e}, '
          'zero-gradient noise {:.2e} (bars 1e-4, 1e-4, 1e-5)'.format(
              out_err, grad_err, noise))
    drop = LegacyNet(0.5, cfg, torch.Generator().manual_seed(0)).cuda()
    drop.load_state_dict(cpu.state_dict())
    drop.train()
    runs = []
    for _ in range(2):
        drop.seed_dropout(11)
        drop.zero_grad()
        outs = drop.outputs(x.cuda())
        y = outs['fc']
        (y * w.cuda()).sum().backward()
        runs.append((y.detach().clone(),
                     [p.grad.clone() for p in drop.parameters()]))
    # the forward (masks and all) is deterministic; the backward's overlapping
    # 3x3/2 max pool and cuDNN's weight gradients sum with atomics, so two
    # backwards agree to rounding, not bit for bit
    same = torch.equal(runs[0][0], runs[1][0])
    grad_runs = max(rel(a, b.cpu()) for a, b in zip(runs[0][1], runs[1][1]))
    kept = float((outs['drop'] != 0).sum()) / max(
        1, int((outs['avg'] != 0).sum()))
    moved = not torch.equal(runs[0][0], y_card.detach())
    check(same and moved and grad_runs <= 1e-5,
          'dropout at keep_prob 0.5: two seeded runs bit-identical {}, '
          'masks drawn {}, gradients {:.2e} apart'.format(same, moved,
                                                          grad_runs))
    return {'output_rel_err': out_err, 'grad_rel_err': grad_err,
            'zero_grad_noise': noise, 'dropout_runs_bit_identical': same,
            'dropout_runs_grad_rel_diff': grad_runs,
            'dropout_kept_share': kept,
            'parameters': sum(p.numel() for p in cpu.parameters())}


def caption_rows(shape, tiles, cols, pad=6, caption_h=14):
    """True on the caption band of each row of a vis_batch sheet."""
    mask = np.zeros(shape, bool)
    cell_h = max(im.shape[0] for im, _ in tiles) + caption_h + pad
    for k, (im, _) in enumerate(tiles):
        y = pad + (k // max(1, min(cols, len(tiles)))) * cell_h + im.shape[0]
        mask[y:y + caption_h] = True
    return mask


def oracle_phase(mods, ctc_ref):
    """(f): kernels 3 and 4 (``ctc_cuda.ctc_loss`` and its backward) against
    the C++ oracle at the kernel phase's cases. The loss within 1e-5
    relative; each example's gradient within max(1e-5, 1e-6 * its loss)
    absolute: the f32 log-space sums the kernels (and the plain version)
    carry round to ~1e-7 of the loss (tests/test_torch_ctc_ref.py). The
    plain version's distance from the oracle is printed beside it."""
    ctc, ctc_cuda = mods['ctc'], mods['ctc_cuda']
    out = {}
    for t_len, l_max in ((23, 6), (111, 24)):
        case = ctc_case(ctc, t_len, l_max, seed=5)
        args = [case[k].cpu().numpy() for k in ('logits', 'labels',
                                                'label_lens', 'logit_lens')]
        ref_loss, ref_grad = ctc_ref.ctc_loss_grad(*args)
        feasible = np.isfinite(ref_loss)
        errs = {}
        for name, fn in (('kernels', ctc_cuda.ctc_loss),
                         ('plain', ctc.ctc_loss)):
            x = case['logits'].clone().requires_grad_()
            loss = fn(x, case['labels'], case['label_lens'],
                      case['logit_lens'])
            torch.where(loss < 1e29, loss, torch.zeros_like(loss)).sum() \
                .backward()
            got = loss.detach().cpu().numpy()
            grad = x.grad.cpu().numpy()
            check(np.array_equal(got >= 1e29, ~feasible),
                  '{} T={}: infeasible rows {} vs the oracle\'s {}'.format(
                      name, t_len, np.where(got >= 1e29)[0],
                      np.where(~feasible)[0]))
            g_err = np.abs(grad - ref_grad).max(axis=(1, 2))
            errs[name] = {
                'loss_rel_err': float(np.max(
                    np.abs(got[feasible] - ref_loss[feasible])
                    / np.abs(ref_loss[feasible]))),
                'grad_abs_err': float(g_err.max()),
                'grad_over_bar': float(np.max(g_err / np.maximum(
                    1e-5, 1e-6 * np.where(feasible, ref_loss, 0.0)))),
                'infeasible_grad_zero': not grad[~feasible].any()}
        k = errs['kernels']
        key = 'T={} L={}'.format(t_len, l_max)
        print('dsl (f) CTC kernels vs the C++ oracle, N=64 {}: loss {:.2e} '
              'relative, gradient {:.2e} absolute ({:.2f} of the bar); the '
              'plain version {:.2e} / {:.2e}; infeasible rows {}'.format(
                  key, k['loss_rel_err'], k['grad_abs_err'],
                  k['grad_over_bar'], errs['plain']['loss_rel_err'],
                  errs['plain']['grad_abs_err'],
                  np.where(~feasible)[0].tolist()), flush=True)
        check(k['loss_rel_err'] <= 1e-5 and k['grad_over_bar'] <= 1.0
              and k['infeasible_grad_zero'],
              'CTC kernels vs the oracle at {}: {}'.format(key, k))
        out[key] = errs
    return out


def dsl_phase(mods, card, rec_path, eval_predictions, log):
    """Phase 12: the model DSL and the offline surface at full width on the
    card. Returns the launches by path and the phase's numbers."""
    from lstm_ctc_ocr_torch.data import gen_img
    from lstm_ctc_ocr_torch.data.image import decode_png
    from lstm_ctc_ocr_torch.models.network import Network
    from lstm_ctc_ocr_torch.native import ctc_ref
    from lstm_ctc_ocr_torch.tools import (build_records, convert_ckpt2npy,
                                         vis_batch)
    load_cfg, train, test_mod = mods['load_cfg'], mods['train'], mods['test']
    rnn_cuda, ctc_cuda = mods['rnn_cuda'], mods['ctc_cuda']
    LSTMTrainDSL, StackedDSL, LegacyNet = dsl_classes(Network)
    t_phase = time.perf_counter()
    yml = os.path.join(REPO, 'lstm', 'lstm.yml')
    work = os.path.join(REPO, 'output', 'chip_smoke_dsl')
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    launches, out = {}, {'card': card}

    def seeded(i=0):
        return torch.Generator().manual_seed(int(cfg.RNG_SEED) + i)

    # (a) the DSL LSTM_train on the lstm_ctc release through test_net
    cfg = load_cfg(yml, ['TEST.BATCH_SIZE', '64', 'BN_EVAL', "'batch'",
                         'TRAIN.DTYPE', "'bfloat16'", 'DECODER', "'greedy'"])
    launch_counts(rnn_cuda, ctc_cuda, reset=True)
    echoed = []
    t0 = time.perf_counter()
    r = test_mod.test_net(cfg, os.path.join(REPO, 'data', 'val'),
                          os.path.join(REPO, 'checkpoints', cfg.EXP_DIR),
                          device='cuda', echo=echoed.append,
                          model=LSTMTrainDSL(cfg, generator=seeded()))
    eval_s = time.perf_counter() - t0
    log.write('== (a) DSL LSTM_train eval\n' + '\n'.join(echoed) + '\n')
    launches['dsl_eval'] = launch_counts(rnn_cuda, ctc_cuda)
    want = eval_predictions['lstm_ctc/batch']
    same = sum(r.predictions.get(f) == s for f, s in want.items())
    print('dsl (a) the JAX LSTM_train chain as a port Network, lstm_ctc '
          'release through the bridge, test_net on data/val (bf16, batch '
          '64): {}/{} correct, {}/{} strings equal to the fixed model\'s '
          '(eval phase), {} decode calls, bilstm_fwd {} launches, {:.1f} s'
          .format(r.correct, r.total, same, len(want), r.decode_calls,
                  launches['dsl_eval']['bilstm_fwd'], eval_s), flush=True)
    check(r.total == 500 and r.correct >= 483 and same == len(want) == 500,
          'DSL eval: {}/{} correct, {} strings equal'.format(
              r.correct, r.total, same))
    check(launches['dsl_eval']['bilstm_fwd'] == r.decode_calls > 0,
          'DSL eval: {} launches for {} decode calls'.format(
              launches['dsl_eval']['bilstm_fwd'], r.decode_calls))
    out['a'] = {'correct': r.correct, 'total': r.total,
                'strings_equal': same, 'decode_calls': r.decode_calls,
                'seconds': eval_s}

    # (b) 20 steps of train_net: the DSL nets against the fixed models,
    # from one seed, on the records file, bf16, batch 64 (deterministic
    # cuDNN for both runs of a pair)
    steps = 20
    torch.backends.cudnn.deterministic = True
    try:
        for what, dsl_cls, fixed in (
                ('dsl_train', LSTMTrainDSL, None),
                ('dsl_stacked_train', StackedDSL, stacked_model)):
            exp = 'chip_smoke_' + what
            cfg = load_cfg(yml, dsl_train_overrides(rec_path, exp, steps))
            check(int(cfg.TRAIN.BATCH_SIZE) == 64
                  and int(cfg.TRAIN.NUM_HID) == 512,
                  'lstm.yml is not the full-width default model')

            def make(i, dsl_cls=dsl_cls, fixed=fixed, cfg=cfg):
                if i == 0:
                    return dsl_cls(cfg, generator=seeded())
                if fixed is None:
                    return mods['get_network']('LSTM_train', cfg,
                                               generator=seeded())
                return fixed(mods, cfg)
            t0 = time.perf_counter()
            pair = train_pair(mods, make, cfg, exp, steps, log)
            secs = time.perf_counter() - t0
            bit_for_bit(pair, steps, what)
            (losses, _, dsl_counts), (_, _, fixed_counts) = pair
            if fixed is None:
                want = {'bilstm_fwd': steps, 'bilstm_bwd': steps,
                        'lstm_fwd': 0, 'lstm_bwd': 0}
            else:
                want = {'bilstm_fwd': 0, 'bilstm_bwd': 0,
                        'lstm_fwd': STACKED_LAYERS * steps,
                        'lstm_bwd': STACKED_LAYERS * steps}
            want.update(ctc_fwd=steps, ctc_bwd=steps)
            check(dsl_counts == want == fixed_counts,
                  '{}: launches {} (DSL) and {} (fixed), expected {}'.format(
                      what, dsl_counts, fixed_counts, want))
            launches[what] = {k: dsl_counts[k] + fixed_counts[k]
                              for k in dsl_counts}
            print('dsl (b) {}: the DSL net and the fixed model from one '
                  'seed, {} steps each of train_net (records, bf16, batch '
                  '64): losses and final state bit for bit, loss {:.4f} -> '
                  '{:.4f}, launches {} each, {:.1f} s for both'.format(
                      what, steps, losses[0], losses[-1],
                      json.dumps(dsl_counts), secs), flush=True)
            out[what] = {'steps': steps, 'first_loss': losses[0],
                         'last_loss': losses[-1], 'bit_for_bit': True,
                         'seconds': secs}

        # (d) .npy pre-train against .ckpt.npz pre-train, 5 steps each
        release = os.path.join(REPO, 'checkpoints', 'lstm_ctc',
                               'lstm_ctc_iter_32207.ckpt.npz')
        npy = os.path.join(work, 'lstm_ctc.npy')
        with contextlib.redirect_stdout(log):
            check(convert_ckpt2npy.main([release, '--out', npy]) == 0,
                  'convert_ckpt2npy failed')
        exp = 'chip_smoke_npy'
        cfg = load_cfg(yml, dsl_train_overrides(rec_path, exp, 5))
        pair = train_pair(
            mods, lambda i: mods['get_network']('LSTM_train', cfg,
                                                generator=seeded(i)),
            cfg, exp, 5, log, pre_train=(npy, release))
        bit_for_bit(pair, 5, 'npy pre-train')
        launches['npy_pre_train'] = {k: pair[0][2][k] + pair[1][2][k]
                                     for k in pair[0][2]}
        print('dsl (d) convert_ckpt2npy of the lstm_ctc release, then 5 '
              'steps of train_net(pre_train=.npy) against '
              'pre_train=.ckpt.npz: losses and final state bit for bit '
              '({:.4f} -> {:.4f})'.format(pair[0][0][0], pair[0][0][-1]),
              flush=True)
        out['npy_pre_train'] = {'steps': 5, 'losses': pair[0][0],
                                'bit_for_bit': True}
    finally:
        torch.backends.cudnn.deterministic = False

    # (c) the DSL-only and legacy layers on the card
    out['legacy'] = legacy_phase(LegacyNet, load_cfg(yml))
    print('dsl (c) fc, avg_pool, dropout, conv_norm (BN and crelu), upconv, '
          'lrn, batch_normalization, pva_negation_block_v2 and '
          'pva_inception_res_block, {parameters} parameters, f32 at {shape}: '
          'card vs CPU output {output_rel_err:.2e}, gradients '
          '{grad_rel_err:.2e} of each tensor\'s scale (zero-gradient noise '
          '{zero_grad_noise:.2e}); dropout 0.5, two seeded runs\' outputs '
          'bit-identical: {dropout_runs_bit_identical} (kept '
          '{dropout_kept_share:.3f}; gradients {dropout_runs_grad_rel_diff:.2e} '
          'apart)'.format(shape=LEGACY_SHAPE, **out['legacy']), flush=True)

    # (e) the offline writers: gen_img against the tracked native set,
    # build_records --synth into a 5-step run, vis_batch --from-store
    ref_dir = os.path.join(REPO, 'data', 'val_digit4_native')
    gen_dir = os.path.join(work, 'gen_img')
    cfg = load_cfg(os.path.join(REPO, 'lstm', 'digit4.yml'),
                   ['RENDERER', 'native'])
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        gen_img.run(500, gen_dir, cfg=cfg)
    gen_s = time.perf_counter() - t0
    names = sorted(os.listdir(gen_dir))
    want_names = sorted(os.listdir(ref_dir))
    same = 0
    for f in names:
        if f in want_names:
            with open(os.path.join(gen_dir, f), 'rb') as a, \
                    open(os.path.join(ref_dir, f), 'rb') as b:
                same += bool(np.array_equal(decode_png(a.read()),
                                            decode_png(b.read())))
    print('dsl (e) gen_img.run(500) under digit4.yml + RENDERER native: {} '
          'files, names equal to data/val_digit4_native\'s: {}, decoded '
          'pixels bit-identical {}/500, {:.1f} s ({} workers)'.format(
              len(names), names == want_names, same, gen_s,
              max(os.cpu_count() - 1, 0)), flush=True)
    check(names == want_names and same == 500,
          'gen_img: names equal {}, pixels equal {}/500'.format(
              names == want_names, same))
    synth_rec = os.path.join(work, 'synth512.records')
    with contextlib.redirect_stdout(log):
        check(build_records.main(['--synth', '512', '--out', synth_rec,
                                  '--set', 'RENDERER', 'native']) == 0,
              'build_records --synth failed')
    exp = 'chip_smoke_synth_records'
    cfg = load_cfg(yml, dsl_train_overrides(synth_rec, exp, 5))
    launch_counts(rnn_cuda, ctc_cuda, reset=True)
    with contextlib.redirect_stdout(log):
        losses = train.train_net(
            mods['get_network']('LSTM_train', cfg, generator=seeded()),
            {'name': 'chip_smoke'}, None, os.path.join(REPO, 'output', exp),
            os.path.join(REPO, 'logs', exp), cfg, max_iters=6,
            device='cuda')[2]
    torch.cuda.synchronize()
    launches['synth_records_train'] = launch_counts(rnn_cuda, ctc_cuda)
    check(len(losses) == 5 and bool(np.isfinite(losses).all()),
          'build_records --synth 512: losses {}'.format(losses))
    check(launches['synth_records_train']['bilstm_fwd'] == 5,
          'synth records: launches {}'.format(
              launches['synth_records_train']))
    print('dsl (e) build_records --synth 512 (native), 5 steps of train_net '
          'on it: losses {}, launches {}'.format(
              [round(x, 4) for x in losses],
              json.dumps(launches['synth_records_train'])), flush=True)
    sheet_png = os.path.join(work, 'vis_batch.png')
    pool_set = ['DATA_BACKEND', 'pool', 'POOL_SIZE', '64', 'RENDERER',
                'native']
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        check(vis_batch.main(['--n', '16', '--cols', '4', '--from-store',
                              '--out', sheet_png, '--set'] + pool_set) == 0,
              'vis_batch --from-store failed')
    log.write(buf.getvalue())
    shown = re.search(r'rows \[([0-9, ]*)\]', buf.getvalue())
    check(shown is not None, 'vis_batch named no rows')
    idx = torch.tensor([int(i) for i in shown.group(1).split(',')],
                       device='cuda')
    # the same pool again (from its cache): the rows the sheet names
    cfg = load_cfg(None, pool_set)
    with contextlib.redirect_stdout(log):
        feed = mods['device_store'].make_device_feed(cfg, torch.device('cuda'))
    rows = [a.index_select(0, idx).cpu().numpy() for a in feed.store.arrays]
    from lstm_ctc_ocr_torch.config import get_encode_decode_dict
    tiles = vis_batch.batch_to_images(rows[0], rows[1], rows[2],
                                      get_encode_decode_dict(cfg)[1])
    with open(sheet_png, 'rb') as f:
        sheet = decode_png(f.read())[..., 0]
    want = vis_batch.contact_sheet(tiles, 4)
    mask = caption_rows(sheet.shape, tiles, 4)
    tiles_equal = sheet.shape == want.shape and bool(
        np.array_equal(sheet[~mask], want[~mask]))
    print('dsl (e) vis_batch --from-store on a 64-image pool: a {}x{} sheet, '
          'tiles equal to the store\'s gathered rows: {}'.format(
              sheet.shape[1], sheet.shape[0], tiles_equal), flush=True)
    check(tiles_equal, 'vis_batch --from-store: tiles differ from the rows')
    out['offline'] = {'gen_img_identical': same, 'gen_img_seconds': gen_s,
                      'synth_records_losses': losses,
                      'vis_batch_tiles_equal': tiles_equal}

    # (f) kernels 3-4 against the C++ oracle (comparison launches: not
    # counted on any path)
    out['oracle'] = oracle_phase(mods, ctc_ref)
    out['seconds'] = time.perf_counter() - t_phase
    print('dsl: phase took {:.1f} s on {}'.format(out['seconds'], card),
          flush=True)
    return launches, out


# ---- 13. the shifted-matmul conv lowering, dropout graphs, TF tools --------

# the convs of the CRNN that take the shifted lowering, at a W bucket: (name,
# C_in, C_out, kernel, padding, the bucket's divisor for the input's width,
# the input's height)
SHIFTED_CONVS = [('conv2', 64, 128, 3, 'SAME', 2, 16),
                 ('conv3_1', 128, 256, 3, 'SAME', 4, 8),
                 ('conv3_2', 256, 256, 3, 'SAME', 4, 8),
                 ('conv4_1', 256, 512, 3, 'SAME', 4, 4),
                 ('conv4_2', 512, 512, 3, 'SAME', 4, 4),
                 ('conv5', 512, 512, 2, 'VALID', 4, 2)]


def bar_worst(got, want, rtol, atol):
    """Largest ``|got - want| / (atol + rtol * |want|)``: at most 1 where
    ``assert_allclose(got, want, rtol, atol)`` holds."""
    got, want = got.double(), want.double()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def kernels_per_call(fn):
    """Device kernels launched by one call of ``fn`` and their device ms,
    from ``torch.profiler`` over 3 calls; (None, None) where the profiler
    sees no device events."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    if not rows:
        return None, None
    return (sum(e.count for e in rows) / 3,
            sum(e.self_device_time_total for e in rows) / 3e3)


def shifted_geometries(layers, conv_mod, card):
    """(a): conv2 to conv5 at batch 64, W=96 and W=160, the shifted lowering
    against ``F.conv2d`` (``layers.conv2d_tf``, cuDNN): the layer's own
    glorot weights, post-ReLU-like inputs U(0, 1), a normal cotangent of
    standard deviation 1e-3. f32: the forward within rtol 2e-4 / atol 2e-5,
    both gradients within rtol 1e-4 / atol 1e-4 (TF32 off). bf16: each
    lowering's forward
    within rtol 2^-8 / atol 1e-2 of the f32 conv of the same bf16 values,
    the sum both round once (a tie between two f32 sums of another order
    rounds one bf16 ulp apart, more than 2^-8 at the bottom of a binade);
    the share of bf16 outputs where the two lowerings differ, and their
    largest difference as a share of that bar. CUDA-event ms of
    forward and forward+backward for both lowerings and both dtypes, and
    the device kernels a bf16 forward+backward call launches."""
    rows = {}
    for w in (96, 160):
        for name, ci, co, k, pad, div, h in SHIFTED_CONVS:
            g = torch.Generator().manual_seed(13)
            kernel = layers.ConvSingle(ci, co, k, padding=pad,
                                       generator=g).kernel.detach().cuda()
            x = torch.rand(64, ci, w // div, h, generator=g).cuda()
            row = {'shape': [64, ci, w // div, h], 'c_out': co}
            for dtype, tag in ((torch.float32, 'f32'),
                               (torch.bfloat16, 'bf16')):
                xd, kd = x.to(dtype), kernel.to(dtype)
                def lib(a, b, pad=pad):
                    return layers.conv2d_tf(a, b, (1, 1), pad)

                def ours(a, b, pad=pad):
                    return conv_mod.conv2d_shifted(a, b, (1, 1), pad)
                outs, grads = {}, {}
                ct = None
                for which, fn in (('cudnn', lib), ('shifted', ours)):
                    a = xd.clone().requires_grad_()
                    b = kd.clone().requires_grad_()
                    y = fn(a, b)
                    if ct is None:
                        ct = (1e-3 * torch.randn(y.shape, generator=g)).to(
                            y.device, dtype)
                    (y.float() * ct.float()).sum().backward()
                    outs[which], grads[which] = y.detach(), (a.grad, b.grad)
                if dtype == torch.float32:
                    row['f32_fwd_worst'] = bar_worst(
                        outs['shifted'], outs['cudnn'], 2e-4, 2e-5)
                    row['f32_grad_worst'] = max(
                        bar_worst(s, c, 1e-4, 1e-4) for s, c in
                        zip(grads['shifted'], grads['cudnn']))
                    check(row['f32_fwd_worst'] <= 1 and
                          row['f32_grad_worst'] <= 1,
                          'shifted {} W={} f32: forward {:.3g}, gradients '
                          '{:.3g} of their bars'.format(
                              name, w, row['f32_fwd_worst'],
                              row['f32_grad_worst']))
                else:
                    exact = layers.conv2d_tf(xd.float(), kd.float(), (1, 1),
                                             pad)
                    row['bf16_fwd_worst'] = bar_worst(
                        outs['shifted'], exact, 2 ** -8, 1e-2)
                    row['bf16_cudnn_worst'] = bar_worst(
                        outs['cudnn'], exact, 2 ** -8, 1e-2)
                    row['bf16_share_differing_from_cudnn'] = float(
                        (outs['shifted'] != outs['cudnn']).float().mean())
                    row['bf16_worst_against_cudnn'] = bar_worst(
                        outs['shifted'], outs['cudnn'], 2 ** -8, 1e-2)
                    check(row['bf16_fwd_worst'] <= 1,
                          'shifted {} W={} bf16: {:.3g} of the bar'.format(
                              name, w, row['bf16_fwd_worst']))
                for which, fn in (('cudnn', lib), ('shifted', ours)):
                    a = xd.clone().requires_grad_()
                    b = kd.clone().requires_grad_()

                    def fwd_bwd(fn=fn, a=a, b=b):
                        y = fn(a, b)
                        torch.autograd.grad(y, (a, b), ct)
                    with torch.no_grad():
                        row['{}_{}_fwd_ms'.format(tag, which)] = median_ms(
                            lambda fn=fn: fn(xd, kd), reps=20, warmup=3)
                    row['{}_{}_fwd_bwd_ms'.format(tag, which)] = median_ms(
                        fwd_bwd, reps=20, warmup=3)
                    if dtype == torch.bfloat16 and w == 160:
                        n, ms = kernels_per_call(fwd_bwd)
                        row['bf16_{}_kernels_per_fwd_bwd'.format(which)] = n
                        row['bf16_{}_device_ms_fwd_bwd'.format(which)] = ms
            rows['{} W={}'.format(name, w)] = row
            print('shifted (a) {} W={} {}: f32 forward {:.3g} / gradients '
                  '{:.3g} of the bars; bf16 {:.3g} of the bar (cuDNN {:.3g}), '
                  '{:.2%} of outputs differ from cuDNN\'s (by {:.3g} of the '
                  'bar at most); '
                  'ms fwd / fwd+bwd f32 cuDNN {:.3f} / {:.3f}, shifted {:.3f} '
                  '/ {:.3f}; bf16 cuDNN {:.3f} / {:.3f}, shifted {:.3f} / '
                  '{:.3f}{}'.format(
                      name, w, row['shape'], row['f32_fwd_worst'],
                      row['f32_grad_worst'], row['bf16_fwd_worst'],
                      row['bf16_cudnn_worst'],
                      row['bf16_share_differing_from_cudnn'],
                      row['bf16_worst_against_cudnn'],
                      row['f32_cudnn_fwd_ms'], row['f32_cudnn_fwd_bwd_ms'],
                      row['f32_shifted_fwd_ms'],
                      row['f32_shifted_fwd_bwd_ms'],
                      row['bf16_cudnn_fwd_ms'], row['bf16_cudnn_fwd_bwd_ms'],
                      row['bf16_shifted_fwd_ms'],
                      row['bf16_shifted_fwd_bwd_ms'],
                      '' if w != 160 else '; bf16 fwd+bwd kernels a call '
                      'cuDNN {} ({} ms), shifted {} ({} ms)'.format(
                          row['bf16_cudnn_kernels_per_fwd_bwd'],
                          row['bf16_cudnn_device_ms_fwd_bwd'],
                          row['bf16_shifted_kernels_per_fwd_bwd'],
                          row['bf16_shifted_device_ms_fwd_bwd'])),
                  flush=True)
    print('shifted (a) on {}'.format(card), flush=True)
    return rows


@contextlib.contextmanager
def counting_shifted(layers):
    """Count the shifted lowering's calls from ``ConvSingle`` (eager
    calls; a CUDA graph's replay runs no Python)."""
    real = layers.conv2d_shifted
    calls = [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)
    layers.conv2d_shifted = counted
    try:
        yield calls
    finally:
        layers.conv2d_shifted = real


@contextlib.contextmanager
def recording_masks(layers):
    """Record every dropout mask drawn (a copy), in order."""
    real = layers.dropout_mask
    masks = []

    def recorded(*args, **kwargs):
        m = real(*args, **kwargs)
        masks.append(m.clone())
        return m
    layers.dropout_mask = recorded
    try:
        yield masks
    finally:
        layers.dropout_mask = real


def tf_tools_phase(mods, rec_dir):
    """(g): the three TF tools. Without tensorflow each raises ImportError
    naming it and the tool; with it, export -> import of ``rec_dir`` gives
    the records file ``data/records.py`` writes from it, byte for byte."""
    from lstm_ctc_ocr_torch.tools import (export_tfrecords,
                                         import_tf_checkpoint,
                                         import_tfrecords)
    work = os.path.join(REPO, 'output', 'chip_smoke_tf')
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        import tensorflow  # noqa: F401
        have_tf = True
    except ImportError:
        have_tf = False
    out = {'tensorflow': have_tf}
    if not have_tf:
        calls = {
            'import_tf_checkpoint': lambda: import_tf_checkpoint.main(
                [os.path.join(work, 'x.ckpt')]),
            'import_tfrecords': lambda: import_tfrecords.main(
                [os.path.join(work, 'x.tfrecords'), '--out',
                 os.path.join(work, 'x.records')]),
            'export_tfrecords': lambda: export_tfrecords.main(
                [rec_dir, '--out', os.path.join(work, 'x.tfrecords')])}
        for tool, call in calls.items():
            try:
                call()
                raised = None
            except ImportError as e:
                raised = str(e)
            check(raised is not None and 'tensorflow' in raised
                  and tool in raised,
                  '{} without tensorflow: {}'.format(tool, raised))
            out[tool] = raised
            print('shifted (g) {} without tensorflow: ImportError: {}'.format(
                tool, raised), flush=True)
    else:
        tfr = os.path.join(work, 'val.tfrecords')
        back = os.path.join(work, 'back.records')
        direct = os.path.join(work, 'direct.records')
        n = export_tfrecords.export_tfrecords(rec_dir, tfr)
        m = import_tfrecords.import_tfrecords(tfr, back)
        mods['records'].write_image_annotation_pairs_to_records(rec_dir,
                                                                direct)
        with open(back, 'rb') as f, open(direct, 'rb') as g:
            same = f.read() == g.read()
        print('shifted (g) tensorflow imports: export -> import of {} '
              'images, {} back, byte-identical to the direct records file: '
              '{}'.format(n, m, same), flush=True)
        check(n == m == 500 and same, 'TF round trip: {} / {}, identical '
              '{}'.format(n, m, same))
        out['round_trip'] = {'exported': n, 'imported': m, 'identical': same}
    shutil.rmtree(work, ignore_errors=True)
    return out


def shifted_phase(mods, card, rec_path, eval_predictions, log,
                  attrib_lines=None, phase8=None, dev=torch.device('cuda')):
    """Phase 13: ``CONV_IMPL shifted`` (``ops/conv.py``) through the entry
    points, a DSL net's dropout as a K-step graph and across a resume, and
    the TF tools. Returns the launches by path and the phase's numbers."""
    from lstm_ctc_ocr_torch.models import layers
    from lstm_ctc_ocr_torch.models.network import Network
    from lstm_ctc_ocr_torch.ops import conv as conv_mod
    load_cfg, train, test_mod = mods['load_cfg'], mods['train'], mods['test']
    rnn_cuda, ctc_cuda = mods['rnn_cuda'], mods['ctc_cuda']
    get_network = mods['get_network']
    t_phase = time.perf_counter()
    yml = os.path.join(REPO, 'lstm', 'lstm.yml')
    shifted = ['CONV_IMPL', "'shifted'"]
    launches, out = {}, {'card': card}

    # (a) each geometry against F.conv2d
    out['geometries'] = shifted_geometries(layers, conv_mod, card)

    # (b) eval of the lstm_ctc release under shifted
    cfg = load_cfg(yml, ['TEST.BATCH_SIZE', '64', 'BN_EVAL', "'batch'",
                         'TRAIN.DTYPE', "'bfloat16'", 'DECODER', "'greedy'"]
                   + shifted)
    launch_counts(rnn_cuda, ctc_cuda, reset=True)
    echoed = []
    t0 = time.perf_counter()
    with counting_shifted(layers) as calls:
        r = test_mod.test_net(cfg, os.path.join(REPO, 'data', 'val'),
                              os.path.join(REPO, 'checkpoints', cfg.EXP_DIR),
                              device='cuda', echo=echoed.append)
    eval_s = time.perf_counter() - t0
    log.write('== (b) lstm_ctc under CONV_IMPL shifted\n'
              + '\n'.join(echoed) + '\n')
    launches['shifted_eval'] = launch_counts(rnn_cuda, ctc_cuda)
    want = eval_predictions['lstm_ctc/batch']
    differ = sorted(f for f, s in want.items() if r.predictions.get(f) != s)
    print('shifted (b) lstm_ctc release under CONV_IMPL shifted, test_net on '
          'data/val (bf16, batch 64): {}/{} correct, {} of {} strings differ '
          'from the cuDNN eval\'s {}, {} decode calls, bilstm_fwd {} '
          'launches, shifted convs {} calls, {:.1f} s'.format(
              r.correct, r.total, len(differ), len(want), differ[:8],
              r.decode_calls, launches['shifted_eval']['bilstm_fwd'],
              calls[0], eval_s), flush=True)
    check(r.total == 500 and r.correct >= 483,
          'shifted eval: {}/{} correct'.format(r.correct, r.total))
    check(launches['shifted_eval']['bilstm_fwd'] == r.decode_calls > 0
          and calls[0] == 6 * r.decode_calls,
          'shifted eval: {} launches and {} shifted convs for {} decode '
          'calls'.format(launches['shifted_eval']['bilstm_fwd'], calls[0],
                         r.decode_calls))
    out['eval'] = {'correct': r.correct, 'total': r.total,
                   'strings_differing_from_cudnn': len(differ),
                   'decode_calls': r.decode_calls, 'seconds': eval_s}

    # (c) 20 train_net steps from one init, shifted against xla, f32 and
    # bf16, on phase 5's records file
    steps = 20
    runs = {}
    for tag, dt in (('f32', "'float32'"), ('bf16', "'bfloat16'")):
        exp = 'chip_smoke_shifted_' + tag
        base = dsl_train_overrides(rec_path, exp, steps) + ['TRAIN.DTYPE', dt]
        cfgs = [load_cfg(yml, base), load_cfg(yml, base + shifted)]

        def make(i, cfgs=cfgs):
            return get_network('LSTM_train', cfgs[i],
                               generator=torch.Generator().manual_seed(
                                   int(cfgs[i].RNG_SEED)))
        t0 = time.perf_counter()
        with counting_shifted(layers) as calls:
            pair = train_pair(mods, make, cfgs[0], exp, steps, log)
        secs = time.perf_counter() - t0
        (lx, _, cx), (ls, _, cs) = pair
        rel = max(abs(a - b) / abs(b) for a, b in zip(ls, lx))
        want_counts = {'bilstm_fwd': steps, 'bilstm_bwd': steps,
                       'lstm_fwd': 0, 'lstm_bwd': 0, 'ctc_fwd': steps,
                       'ctc_bwd': steps}
        for what, losses, counts in (('xla', lx, cx), ('shifted', ls, cs)):
            check(len(losses) == steps and bool(np.isfinite(losses).all())
                  and np.mean(losses[-5:]) < np.mean(losses[:5]),
                  'shifted (c) {} {}: losses {}'.format(tag, what, losses))
            check(counts == want_counts, 'shifted (c) {} {}: launches {}, '
                  'expected {}'.format(tag, what, counts, want_counts))
        check(calls[0] == 6 * steps, 'shifted (c) {}: {} shifted conv calls '
              'in {} steps'.format(tag, calls[0], steps))
        if tag == 'f32':
            check(rel <= 1e-4, 'shifted (c) f32: losses {} against {}, '
                  '{:.3g} relative'.format(ls, lx, rel))
        launches['shifted_train_' + tag] = {k: cx[k] + cs[k] for k in cx}
        runs[tag] = {'xla_losses': lx, 'shifted_losses': ls,
                     'max_rel_distance': rel, 'seconds_both': secs}
        print('shifted (c) {}: train_net {} steps from one init, cuDNN {:.4f}'
              ' -> {:.4f}, shifted {:.4f} -> {:.4f}, largest relative '
              'distance {:.3g}{}, launches {} a run, {:.1f} s for both'.format(
                  tag, steps, lx[0], lx[-1], ls[0], ls[-1], rel,
                  ' (bar 1e-4)' if tag == 'f32' else '', json.dumps(cs),
                  secs), flush=True)
    out['train'] = runs

    # (c) rates and (d) the 8-step graph on the records store, bf16
    k = 8
    cfg = load_cfg(yml, train_overrides(rec_path, 'chip_smoke_shifted') + [
        'TRAIN.STEPS_PER_DISPATCH', str(k), 'DATA_DEVICE', "'on'"])
    cfg_s = load_cfg(yml, train_overrides(rec_path, 'chip_smoke_shifted') + [
        'TRAIN.STEPS_PER_DISPATCH', str(k), 'DATA_DEVICE', "'on'"] + shifted)
    dtype = train.compute_dtype(cfg)
    n = int(cfg.TRAIN.BATCH_SIZE)
    with contextlib.redirect_stdout(log):
        feed = mods['device_store'].make_device_feed(cfg, dev)
    store = feed.store
    rates, graphs = {}, {}
    for what, c in (('xla', cfg), ('shifted', cfg_s)):
        model = get_network('LSTM_train', c, generator=torch.Generator()
                            .manual_seed(int(c.RNG_SEED))).to(dev).train()
        optimizer = train.make_optimizer(model, c)
        step1 = train.make_train_step_gather(model, optimizer, c, dtype)
        rates[what + '_eager'] = group_rate(
            '{} convs, records store, K=1 eager (bucket {})'.format(
                what, store.w_bucket),
            lambda: step1(*store.arrays, feed.step_indices(n)), 1, card,
            warm=8, graph=False)
        chunk = train.make_train_chunk(model, optimizer, c, dtype, k,
                                       gather=True)
        chunk(*store.arrays, feed.chunk_indices(n, k))   # eager, captured
        idx = feed.chunk_indices(n, k)
        graphs[what] = graph_against_eager(
            model, optimizer, lambda: chunk(*store.arrays, idx)[0],
            lambda: torch.stack([step1(*store.arrays, idx[j])[0]
                                 for j in range(k)]))
        rates[what + '_graph'] = group_rate(
            '{} convs, records store, K=8 graph (bucket {})'.format(
                what, store.w_bucket),
            lambda: chunk(*store.arrays, feed.chunk_indices(n, k)), k, card)
        del model, optimizer, chunk
    g, e = graphs['shifted']
    print('shifted (d) the store\'s 8-step graph under shifted against 8 '
          'eager steps from one state: largest |graph - eager| {}, |eager - '
          'eager| {}; steps/s and device ms a step: shifted {:.2f} / {}, '
          'cuDNN {:.2f} / {} (this phase), phase 8\'s cuDNN graph {}; eager '
          'K=1 steps/s shifted {:.2f}, cuDNN {:.2f}, on {}'.format(
              g, e, rates['shifted_graph']['steps_per_s'],
              rates['shifted_graph']['replay_device_ms_per_step'],
              rates['xla_graph']['steps_per_s'],
              rates['xla_graph']['replay_device_ms_per_step'],
              None if phase8 is None else [
                  round(phase8['steps_per_s'], 2),
                  phase8['replay_device_ms_per_step']],
              rates['shifted_eager']['steps_per_s'],
              rates['xla_eager']['steps_per_s'], card), flush=True)
    check(g <= e, 'shifted graph differs from eager by {}, two eager runs '
          'by {}'.format(g, e))
    out['store'] = {'bucket': store.w_bucket, 'rates': rates,
                    'graph_vs_eager': {w: v[0] for w, v in graphs.items()},
                    'eager_vs_eager': {w: v[1] for w, v in graphs.items()}}

    # (e) attrib_step's conv=shifted variant against its default step
    if attrib_lines is None:
        attrib_lines, launches['shifted_attrib'] = run_tool(
            mods, 'attrib_step', ['--windows', '3', '--calls', '20',
                                  '--warm', '20', '--width', '128', '--set',
                                  'RENDERER', 'native'], log)
    ms = {x['variant']: x['ms_per_step'] for x in attrib_lines
          if 'variant' in x}
    check('conv=shifted' in ms, 'attrib_step has no conv=shifted line')
    out['attrib'] = {'default_ms': ms['ctc=kernel lstm=kernel'],
                     'shifted_ms': ms['conv=shifted'],
                     'delta_conv_shifted_vs_default_ms':
                         ms['conv=shifted'] - ms['ctc=kernel lstm=kernel']}
    print('shifted (e) attrib_step (W=128): conv=shifted {:.3f} ms a step, '
          'default {:.3f}, delta {:+.3f} ms'.format(
              ms['conv=shifted'], ms['ctc=kernel lstm=kernel'],
              out['attrib']['delta_conv_shifted_vs_default_ms']), flush=True)

    # (f) a DSL net with dropout (keep_prob 0.5): the store's 8-step graph
    # against 8 eager steps, and a run resumed at step 4 against the whole
    LSTMTrainDSL = dsl_classes(Network)[0]

    class DropDSL(LSTMTrainDSL):
        def setup(self):
            super().setup()
            spec = self.specs.pop()
            self.layer_order.pop()
            self.feed('reshaped_layer').dropout(0.5, name='drop')
            self.feed('drop', 'time_step_len').bi_lstm(
                spec.kwargs['num_hids'], 2, name='logits')
    key = layers.dropout_key(int(cfg.RNG_SEED), 0,
                             torch.tensor(5, device=dev))
    same_device = torch.equal(
        layers.dropout_mask((64, 39, 512), 0.5, key, dev).cpu(),
        layers.dropout_mask((64, 39, 512), 0.5, key.cpu(), 'cpu'))
    model = DropDSL(cfg, generator=torch.Generator().manual_seed(
        int(cfg.RNG_SEED))).to(dev).train()
    optimizer = train.make_optimizer(model, cfg)
    step1 = train.make_train_step_gather(model, optimizer, cfg, dtype)
    chunk = train.make_train_chunk(model, optimizer, cfg, dtype, k,
                                   gather=True)
    chunk(*store.arrays, feed.chunk_indices(n, k))
    idx = feed.chunk_indices(n, k)
    drop_g, drop_e = graph_against_eager(
        model, optimizer, lambda: chunk(*store.arrays, idx)[0],
        lambda: torch.stack([step1(*store.arrays, idx[j])[0]
                             for j in range(k)]))
    del model, optimizer, chunk
    snap, total = 4, 12
    runs = {}
    for what, max_iters, restore in (('whole', total + 1, False),
                                     ('cut', snap + 1, False),
                                     ('resumed', total + 1, True)):
        exp = 'chip_smoke_dropout_' + ('whole' if what == 'whole' else 'cut')
        if not restore:
            shutil.rmtree(os.path.join(REPO, 'output', exp),
                          ignore_errors=True)
        c = load_cfg(yml, dsl_train_overrides(rec_path, exp, total) + [
            'DATA_DEVICE', "'on'", 'TRAIN.SNAPSHOT_ITERS', str(snap)])
        net = DropDSL(c, generator=torch.Generator().manual_seed(
            int(c.RNG_SEED)))
        launch_counts(rnn_cuda, ctc_cuda, reset=True)
        with recording_masks(layers) as masks, \
                contextlib.redirect_stdout(log):
            _, _, losses = train.train_net(
                net, {'name': 'chip_smoke'}, None,
                os.path.join(REPO, 'output', exp),
                os.path.join(REPO, 'logs', exp), c, max_iters=max_iters,
                restore=restore, device=str(dev))
        torch.cuda.synchronize()
        launches['dropout_' + what] = launch_counts(rnn_cuda, ctc_cuda)
        runs[what] = (losses, masks)
    whole, resumed = runs['whole'][1], runs['resumed'][1]
    same_masks = len(resumed) == total - snap + 1 and all(
        torch.equal(a, b) for a, b in zip(resumed, whole[snap - 1:]))
    kept = float(whole[0].float().mean())
    moved = not torch.equal(whole[0], whole[1])
    for what, steps_run in (('whole', total), ('cut', snap),
                            ('resumed', total - snap + 1)):
        counts = launches['dropout_' + what]
        check(counts['bilstm_fwd'] == counts['ctc_bwd'] == steps_run
              == len(runs[what][0]), 'dropout {} run: {} losses, launches '
              '{}'.format(what, len(runs[what][0]), counts))
    print('shifted (f) DSL net with dropout 0.5 on the store (bf16): 8-step '
          'graph against 8 eager steps, largest |graph - eager| {}, |eager - '
          'eager| {}; train_net resumed at step {}: {} masks, equal to the '
          'uninterrupted run\'s from step {}: {} (kept share {:.4f}, masks '
          'move step to step {}); a mask on the card equals the CPU\'s for '
          'the same key: {}; losses whole {:.4f} -> {:.4f}'.format(
              drop_g, drop_e, snap, len(resumed), snap, same_masks, kept,
              moved, same_device, runs['whole'][0][0],
              runs['whole'][0][-1]), flush=True)
    check(drop_g <= drop_e, 'dropout graph differs from eager by {}, two '
          'eager runs by {}'.format(drop_g, drop_e))
    check(same_masks and moved and same_device and 0.45 < kept < 0.55,
          'dropout masks: resumed equal {}, moved {}, card = CPU {}, kept '
          '{}'.format(same_masks, moved, same_device, kept))
    check(all(np.isfinite(l).all() for l, _ in runs.values()),
          'dropout runs: non-finite losses')
    out['dropout'] = {'graph_vs_eager': drop_g, 'eager_vs_eager': drop_e,
                      'resumed_masks_equal': same_masks, 'kept_share': kept,
                      'card_mask_equals_cpu': same_device}

    # (g) the TF tools
    out['tf_tools'] = tf_tools_phase(mods, os.path.join(REPO, 'data', 'val'))
    out['seconds'] = time.perf_counter() - t_phase
    print('shifted: phase took {:.1f} s on {}'.format(out['seconds'], card),
          flush=True)
    return launches, out


# --- phase 14: every hidden width and label length the JAX package runs ----

# hidden sizes of phase 14 (a), per direction: no multiple of 8 (padded), the
# f32 wide path and the bf16 cluster's limit, past one cluster
WIDTHS = (50, 300, 512, 768, 1024)
# (label, T, N, ragged) of phase 14 (a), each at every width and type
WIDTH_CASES = [('N=64 T=23', 23, 64, False), ('N=64 T=111', 111, 64, False),
               ('ragged N=37 T=23', 23, 37, True), ('N=3 T=1', 1, 3, False)]
WIDE_HID = 1024          # TRAIN.NUM_HID of phase 14 (b): H = 512 a direction


def width_kernels(rnn_cuda, label, c, uni, dtype):
    """Phase 14 (a) at one case: the four LSTM wrappers against their plain
    versions, each kernel called twice (bit for bit), the forwards with
    residuals. Returns the worst shares of the bars by kernel."""
    args = kernel_args(c)
    h = c['uf'].shape[0]
    fwd = rnn_cuda.bilstm_fwd(*args, save_residuals=True)
    fwd2 = rnn_cuda.bilstm_fwd(*args, save_residuals=True)
    want = rnn_cuda.bilstm_fwd_reference(*args, save_residuals=True)
    g = torch.Generator().manual_seed(h)
    dof, dob = ((torch.randn(fwd[2].shape, generator=g) * 0.1).cuda()
                .to(dtype) for _ in range(2))
    res = fwd[1:4] + fwd[5:8]
    bwd_args = (dof, dob) + res + (c['uf'], c['ub'], c['lens'])
    bwd = rnn_cuda.bilstm_bwd(*bwd_args)
    bwd2 = rnn_cuda.bilstm_bwd(*bwd_args)
    want_b = rnn_cuda.bilstm_bwd_reference(*bwd_args)
    uargs = (uni['xp'], uni['u'], uni['b'], uni['lens'])
    ufwd = rnn_cuda.lstm_fwd(*uargs, save_residuals=True)
    ufwd2 = rnn_cuda.lstm_fwd(*uargs, save_residuals=True)
    want_u = rnn_cuda.lstm_fwd_reference(*uargs, save_residuals=True)
    ubargs = (dof,) + tuple(ufwd[1:]) + (uni['u'], uni['lens'])
    ubwd = rnn_cuda.lstm_bwd(*ubargs)
    ubwd2 = rnn_cuda.lstm_bwd(*ubargs)
    want_ub = rnn_cuda.lstm_bwd_reference(*ubargs)
    torch.cuda.synchronize()
    out = {}
    for name, got, again, ref, backward, lens in (
            ('bilstm_fwd', fwd, fwd2, want, False, c['lens']),
            ('bilstm_bwd', bwd, bwd2, want_b, True, c['lens']),
            ('lstm_fwd', ufwd, ufwd2, want_u, False, uni['lens']),
            ('lstm_bwd', ubwd, ubwd2, want_ub, True, uni['lens'])):
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        if backward:      # phase 2's backward bar: of each output's largest
            err, share, ok = rel_err(got, ref, dtype)
            share /= 1e-4 if dtype == torch.float32 else 4 / 256
        else:
            err, ok = max_err(got, ref, dtype)
            share = max(
                float((a.float() - r.float()).abs().max())
                / (1e-4 if dtype == torch.float32
                   else 4 * (float(r.float().abs().max()) or 1.0) / 256)
                for a, r in zip(got, ref))
        dead = torch.arange(got[0].shape[0], device='cuda')[:, None] \
            >= lens[None, :]
        zero = backward or not got[0][dead].any()
        check(ok and same and zero and all(
            a.shape == r.shape for a, r in zip(got, ref)),
            'phase 14 {} H={} {} {}: max|diff| {}, bit for bit {}, zero past '
            'lens {}'.format(name, h, label, dtype, err, same, zero))
        out[name] = share
    return out


def width_timing(rnn_cuda, h, dtype):
    """Phase 14 (a)'s times at one width (batch 64, T=23): each wrapper
    beside cuDNN's ``nn.LSTM`` at the same H (forward, and backward alone)
    and its bound; median CUDA-event ms."""
    c = bilstm_case(23, 64, dtype, False, seed=h, h=h, d=512)
    uni = lstm_case(23, 64, dtype, False, seed=h + 1, h=h, d=512)
    reps = 10 if h > 512 else 30
    bargs = bilstm_bwd_args(c, rnn_cuda, h)
    ures = rnn_cuda.lstm_fwd(uni['xp'], uni['u'], uni['b'], uni['lens'],
                             save_residuals=True)
    g = torch.Generator().manual_seed(7)
    dout = (torch.randn(ures[0].shape, generator=g) * 0.1).cuda().to(dtype)
    uargs = (dout,) + tuple(ures[1:]) + (uni['u'], uni['lens'])
    row = {}
    bi_lstm, bi_packed = cudnn_yardstick(c)
    uni_lstm, uni_packed = cudnn_yardstick(uni)
    with torch.no_grad():
        row['bilstm_fwd'] = {
            'ms': median_ms(lambda: rnn_cuda.bilstm_fwd(*kernel_args(c)),
                            reps=reps),
            'library_ms': median_ms(lambda: bi_lstm(bi_packed), reps=reps)}
        row['lstm_fwd'] = {
            'ms': median_ms(lambda: rnn_cuda.lstm_fwd(
                uni['xp'], uni['u'], uni['b'], uni['lens']), reps=reps),
            'library_ms': median_ms(lambda: uni_lstm(uni_packed), reps=reps)}
        row['bilstm_bwd'] = {
            'ms': median_ms(lambda: rnn_cuda.bilstm_bwd(*bargs), reps=reps)}
        row['lstm_bwd'] = {
            'ms': median_ms(lambda: rnn_cuda.lstm_bwd(*uargs), reps=reps)}
    row['bilstm_bwd']['library_ms'] = median_ms(cudnn_backward_yardstick(c),
                                                reps=reps)
    uni_c = dict(uni, xpf=uni['xp'])
    row['lstm_bwd']['library_ms'] = median_ms(
        cudnn_backward_yardstick(uni_c), reps=reps)
    row['bilstm_fwd']['bound_ms'], row['bilstm_fwd']['bound_by'] = \
        bound_ms(c, dtype)
    row['bilstm_bwd']['bound_ms'], row['bilstm_bwd']['bound_by'] = \
        bilstm_bwd_bound_ms(c, dtype)
    row['lstm_fwd']['bound_ms'], row['lstm_fwd']['bound_by'] = \
        lstm_bound_ms(uni, dtype, False)
    row['lstm_bwd']['bound_ms'], row['lstm_bwd']['bound_by'] = \
        lstm_bound_ms(uni, dtype, True)
    row['path'] = rnn_cuda.kernel_path(dtype, h)
    return row


def ctc_long_phase(ctc, ctc_cuda):
    """Phase 14 (c): the CTC kernels past 511 characters, one block per
    example walking several states a thread, against their plain versions:
    logZ and alphas bit for bit, the gradient f32 <= 1e-5, two calls of each
    bit for bit; ragged, with an empty label, an infeasible and a one-frame
    example. Also each kernel's time at L=600."""
    out = {}
    for l_max in (512, 600, 1024):
        t_len = 2 * l_max + 9
        case = ctc_case(ctc, t_len, l_max, seed=l_max, n=16)
        g, (skip, valid, final) = case['g'], case['masks']
        check(g.shape[2] == 2 * l_max + 1, 'CTC case S {}'.format(g.shape))
        logz, alphas = ctc_cuda.ctc_forward(g, skip, valid, final)
        again = ctc_cuda.ctc_forward(g, skip, valid, final)
        want_z, want_a = ctc.ctc_forward_reference(g, skip, valid, final)
        grad = ctc_cuda.ctc_backward(g, skip, valid, final, want_a, want_z,
                                     case['logit_lens'])
        grad2 = ctc_cuda.ctc_backward(g, skip, valid, final, want_a, want_z,
                                      case['logit_lens'])
        want_g = ctc.ctc_backward_reference(g, skip, valid, final, want_a,
                                            want_z, case['logit_lens'])
        torch.cuda.synchronize()
        bits = torch.equal(logz, want_z) and torch.equal(alphas, want_a)
        same = torch.equal(logz, again[0]) and torch.equal(alphas, again[1]) \
            and torch.equal(grad, grad2)
        err = float((grad - want_g).abs().max())
        infeasible = float(logz[2]) <= ctc.NEG_INF / 2 and not grad[2].any()
        print('phase 14 ctc L={} T={} S={} N=16: logZ and alphas bit for bit '
              '{}, grad max|diff| {:.3e} (bar 1e-5), two calls bit for bit {}, '
              'infeasible example zero {}'.format(
                  l_max, t_len, g.shape[2], bits, err, same, infeasible),
              flush=True)
        check(bits and same and err <= 1e-5 and infeasible,
              'phase 14 ctc L={}: bit for bit {}, grad {}, same {}'.format(
                  l_max, bits, err, same))
        row = {'t': t_len, 's': int(g.shape[2]), 'grad_max_abs_err': err}
        if l_max == 600:
            row['fwd_ms'] = median_ms(
                lambda: ctc_cuda.ctc_forward(g, skip, valid, final), reps=10)
            row['bwd_ms'] = median_ms(
                lambda: ctc_cuda.ctc_backward(g, skip, valid, final, want_a,
                                              want_z, case['logit_lens']),
                reps=10)
            row['fwd_plain_ms'] = median_ms(
                lambda: ctc.ctc_forward_reference(g, skip, valid, final),
                reps=3, warmup=1)
            row['fwd_bound_ms'], row['fwd_bound_by'] = ctc_bound_ms(case,
                                                                    False)
            row['bwd_bound_ms'], row['bwd_bound_by'] = ctc_bound_ms(case, True)
        out['L={}'.format(l_max)] = row
    return out


def conv_bn_any_phase(conv_bn_cuda):
    """Phase 14 (d): ``conv3x3_bn_relu`` at C_in 1 (a first conv layer, W=96
    by 32) and 24 (W=24 by 4), batch 64, against its plain version at phase
    2's bars (f32 2e-5, bf16 2e-2, absolute + relative), two runs bit for
    bit."""
    out = {}
    g = torch.Generator().manual_seed(14)
    for ci, co, w, h in ((1, 64, 96, 32), (24, 128, 24, 4)):
        for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            def rnd(*shape, scale=1.0, shift=0.0):
                return (torch.randn(*shape, generator=g) * scale + shift
                        ).cuda()
            x = rnd(64, ci, w, h).to(dtype)
            args = (rnd(co, ci, 3, 3, scale=(9 * ci) ** -0.5),
                    rnd(co, scale=0.1), rnd(co, scale=0.1, shift=1.0),
                    rnd(co, scale=0.1))
            with torch.no_grad():
                got = conv_bn_cuda.conv3x3_bn_relu(x, *args)
                again = conv_bn_cuda.conv3x3_bn_relu(x, *args)
                want = conv_bn_cuda.conv3x3_bn_relu_reference(x, *args)
            torch.cuda.synchronize()
            d = (got.float() - want.float()).abs()
            share = float((d / (tol + tol * want.float().abs())).max())
            same = torch.equal(got, again)
            label = 'C_in={} {}'.format(ci, 'f32' if dtype == torch.float32
                                        else 'bf16')
            print('phase 14 conv_bn {} [64, {}, {}, {}] -> {}: max|diff| '
                  '{:.3e} ({:.0%} of the bar), two runs bit for bit {}'.format(
                      label, ci, w, h, co, float(d.max()), share, same),
                  flush=True)
            check(share <= 1.0 and same
                  and tuple(got.shape) == (64, co, w, h),
                  'phase 14 conv_bn {}: {} of the bar, same {}'.format(
                      label, share, same))
            out[label] = float(d.max())
    return out


def wide_stacked_model(mods, cfg):
    """The CRNN with the stacked head at ``.lstm(1024, 2)``: two layers of
    1024 units, past one cluster's shared memory (the wide recurrence)."""
    crnn, layers = mods['crnn'], mods['layers']

    class WideStacked(crnn.LSTM_train):
        def make_head(self, num_hid, nclasses, generator):
            return layers.LSTM(512, WIDE_HID, STACKED_LAYERS, nclasses,
                               generator)
    return WideStacked(
        nchannels=int(cfg.NCHANNELS), num_hid=int(cfg.TRAIN.NUM_HID),
        nclasses=int(cfg.NCLASSES),
        generator=torch.Generator().manual_seed(int(cfg.RNG_SEED)))


def wide_path_phase(mods, card, rec_path, log):
    """Phase 14 (b): ``lstm/lstm.yml`` with ``TRAIN.NUM_HID 1024`` through
    the entry points -- ``train_net`` 60 steps, one f32 step's gradients
    against the plain versions, ``test_net`` on the snapshot, one exported
    bucket served from a fresh process -- then 20 steps of the stacked head
    at ``.lstm(1024, 2)``. Returns launches by path and the numbers."""
    load_cfg, train, test_mod = mods['load_cfg'], mods['train'], mods['test']
    rnn_cuda, ctc_cuda, serve = mods['rnn_cuda'], mods['ctc_cuda'], \
        mods['serve']
    yml = os.path.join(REPO, 'lstm', 'lstm.yml')
    exp = 'chip_smoke_wide'
    out_dir = os.path.join(REPO, 'output', exp)
    shutil.rmtree(out_dir, ignore_errors=True)
    steps, val_step = 60, 50
    wide = ['TRAIN.NUM_HID', str(WIDE_HID)]
    cfg = load_cfg(yml, train_overrides(rec_path, exp) + wide + [
        'VAL.VAL_STEP', str(val_step), 'TRAIN.DISPLAY', '10',
        'TRAIN.SNAPSHOT_ITERS', str(steps), 'TRAIN.LOSS_MIN_SNAPSHOT', '0.0'])
    net = mods['get_network']('LSTM_train', cfg, generator=torch.Generator()
                              .manual_seed(int(cfg.RNG_SEED)))
    check(tuple(net.logits.cells['fw'].u.shape) == (512, 2048),
          'the BiLSTM is not 512 units a direction')
    launch_counts(rnn_cuda, ctc_cuda, reset=True)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        model, optimizer, losses = train.train_net(
            net, {'name': 'chip_smoke'}, None, out_dir,
            os.path.join(REPO, 'logs', exp), cfg, max_iters=steps + 1,
            device='cuda')
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts(rnn_cuda, ctc_cuda)
    val_calls = sum(1 for it in range(1, steps + 1)
                    if (it + 1) % val_step == 0)
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    print('phase 14 NUM_HID {} train: {} steps in {:.1f} s (start-up '
          'included), total loss first 10 {:.4f} -> last 10 {:.4f}, launches '
          '{}, {} validation decode(s) on {}'.format(
              WIDE_HID, len(losses), wall, first, last, json.dumps(counts),
              val_calls, card), flush=True)
    check(len(losses) == steps and bool(np.isfinite(losses).all()),
          'expected {} finite losses, got {}'.format(steps, losses))
    check(last < first, 'the loss did not fall: {} -> {}'.format(first, last))
    want = {'bilstm_fwd': steps + val_calls, 'bilstm_bwd': steps,
            'lstm_fwd': 0, 'lstm_bwd': 0, 'ctc_fwd': steps, 'ctc_bwd': steps}
    check(counts == want, 'launches {} over {} steps, expected {}'.format(
        counts, steps, want))
    paths = {'wide_train': counts}

    # one f32 step: gradients with the kernels vs with the plain versions
    cfg32 = load_cfg(yml, train_overrides(rec_path, exp) + wide
                     + ['TRAIN.DTYPE', "'float32'"])
    net32 = mods['get_network']('LSTM_train', cfg32, generator=torch
                                .Generator().manual_seed(
                                    int(cfg32.RNG_SEED))).cuda().train()
    worst, n_tensors = compare_gradients(
        mods, net32, cfg32, rec_path,
        {'bilstm_fwd': 1, 'bilstm_bwd': 1, 'lstm_fwd': 0, 'lstm_bwd': 0,
         'ctc_fwd': 1, 'ctc_bwd': 1})
    print('phase 14 NUM_HID {} gradients, one f32 step: kernels vs plain '
          'versions agree to {:.2e} of each tensor\'s largest entry ({} '
          'tensors)'.format(WIDE_HID, worst, n_tensors), flush=True)
    del net32

    # test_net on the snapshot: it runs and counts (no release at this width)
    snap = os.path.join(out_dir, 'lstm_ctc_iter_{}.ckpt.npz'.format(steps))
    check(os.path.isfile(snap), 'no snapshot at {}'.format(snap))
    eval_cfg = load_cfg(yml, wide + [
        'TEST.BATCH_SIZE', '64', 'DECODER', "'greedy'", 'TRAIN.DTYPE',
        "'bfloat16'", 'EXP_DIR', exp])
    echoed = []
    before = launch_counts(rnn_cuda, ctc_cuda)
    val = os.path.join(REPO, 'data', 'val')
    r = test_mod.test_net(eval_cfg, val, device='cuda', echo=echoed.append)
    log.write('\n'.join(echoed) + '\n')
    eval_launches = launch_counts(rnn_cuda, ctc_cuda)['bilstm_fwd'] \
        - before['bilstm_fwd']
    check(any(snap in line for line in echoed if line.startswith('Restored')),
          'the evaluation did not restore {}'.format(snap))
    check(r.total == 500 and len(r.predictions) == 500
          and eval_launches == r.decode_calls,
          'NUM_HID {} eval: {} images, {} launches for {} decode calls'
          .format(WIDE_HID, r.total, eval_launches, r.decode_calls))
    print('phase 14 NUM_HID {} test_net on the {}-step snapshot: {}/{} on '
          'data/val (no bar), {} decode calls, {} bilstm_fwd launches'.format(
              WIDE_HID, steps - 1, r.correct, r.total, r.decode_calls,
              eval_launches), flush=True)
    paths['wide_eval'] = dict({k: 0 for k in before},
                              bilstm_fwd=eval_launches)

    # one exported bucket (the most populous), served from a fresh process
    groups = files_by_bucket(mods, eval_cfg, val)
    bucket = max(groups, key=lambda b: len(groups[b]))
    model = mods['get_network']('LSTM_test', eval_cfg)
    mods['checkpoint'].load_into(model, snap, False)
    export_dir = os.path.join(out_dir, 'export')
    t0 = time.perf_counter()
    serve.export_decoder(model, eval_cfg, export_dir, buckets=[bucket],
                         batch=64, device='cuda')
    export_s = time.perf_counter() - t0
    files = sorted(groups[bucket])
    spec_path = os.path.join(out_dir, 'spec.json')
    res_path = os.path.join(out_dir, 'served.json')
    with open(spec_path, 'w') as f:
        json.dump([{'label': 'wide', 'export_dir': export_dir,
                    'val_dir': val, 'files': files}], f)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, '-c', SERVE_WORKER, spec_path,
                           res_path], cwd=REPO, capture_output=True,
                          text=True, timeout=600,
                          env=dict(os.environ, PYTHONPATH=REPO))
    worker_s = time.perf_counter() - t0
    log.write(proc.stdout + proc.stderr)
    check(proc.returncode == 0, 'phase 14 serving process failed ({}):\n{}'
          .format(proc.returncode, proc.stderr[-4000:]))
    with open(res_path) as f:
        served = json.load(f)
    got = served['releases']['wide']
    traced = got['traced']              # the second pass, all replays
    launched = traced['launches']['bilstm_fwd']
    diff = [f for f in files if got['predictions'][f] != r.predictions[f]]
    print('phase 14 NUM_HID {} served bucket W={} ({} images) from a fresh '
          'process: {} strings differ from test_net, {} calls; traced again '
          '{} calls, {} replays, {} bilstm_fwd launches in the device trace; '
          'export {:.1f} s, serving process {:.1f} s'.format(
              WIDE_HID, bucket, len(files), len(diff), got['calls'],
              traced['calls'], traced['graph_replays'], launched, export_s,
              worker_s), flush=True)
    check(not diff and served['foreign_modules'] == []
          and traced['same_strings'] and got['graphs'] == 1
          and traced['graph_replays'] == traced['calls'] == got['calls']
          and launched == traced['calls'] > 0,
          'phase 14 served: {} differ, modules {}, {} graphs, traced again '
          '{} calls, {} replays, {} launches'.format(
              diff[:10], served['foreign_modules'], got['graphs'],
              traced['calls'], traced['graph_replays'], launched))
    paths['wide_serve'] = dict({k: 0 for k in before}, bilstm_fwd=launched)
    shutil.rmtree(export_dir)

    # the stacked head at .lstm(1024, 2): 20 steps
    stacked_steps = 20
    cfg_s = load_cfg(yml, train_overrides(rec_path, exp + '_stacked') + wide
                     + ['VAL.VAL_STEP', '1000', 'TRAIN.DISPLAY', '5'])
    snet = wide_stacked_model(mods, cfg_s)
    check(tuple(snet.logits.cells[1].u.shape) == (WIDE_HID, 4 * WIDE_HID),
          'the stacked head is not 2 x LSTM {}'.format(WIDE_HID))
    launch_counts(rnn_cuda, ctc_cuda, reset=True)
    shutil.rmtree(os.path.join(REPO, 'output', exp + '_stacked'),
                  ignore_errors=True)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        _, _, s_losses = train.train_net(
            snet, {'name': 'chip_smoke'}, None,
            os.path.join(REPO, 'output', exp + '_stacked'),
            os.path.join(REPO, 'logs', exp + '_stacked'), cfg_s,
            max_iters=stacked_steps + 1, device='cuda')
    torch.cuda.synchronize()
    s_wall = time.perf_counter() - t0
    s_counts = launch_counts(rnn_cuda, ctc_cuda)
    s_first = float(np.mean(s_losses[:5]))
    s_last = float(np.mean(s_losses[-5:]))
    print('phase 14 .lstm({}, {}) train: {} steps in {:.1f} s, total loss '
          'first 5 {:.4f} -> last 5 {:.4f}, launches {} on {}'.format(
              WIDE_HID, STACKED_LAYERS, len(s_losses), s_wall, s_first,
              s_last, json.dumps(s_counts), card), flush=True)
    want = {'bilstm_fwd': 0, 'bilstm_bwd': 0,
            'lstm_fwd': STACKED_LAYERS * stacked_steps,
            'lstm_bwd': STACKED_LAYERS * stacked_steps,
            'ctc_fwd': stacked_steps, 'ctc_bwd': stacked_steps}
    check(len(s_losses) == stacked_steps
          and bool(np.isfinite(s_losses).all()) and s_counts == want,
          '.lstm({}, 2): losses {}, launches {}, expected {}'.format(
              WIDE_HID, s_losses, s_counts, want))
    paths['wide_stacked_train'] = s_counts
    return paths, {'train_loss_first10': first, 'train_loss_last10': last,
                   'train_s': wall, 'gradient_worst': worst,
                   'eval_correct': r.correct, 'eval_total': r.total,
                   'served_bucket': bucket, 'served_images': len(files),
                   'served_differ': len(diff), 'export_s': export_s,
                   'worker_s': worker_s,
                   'stacked_loss_first5': s_first,
                   'stacked_loss_last5': s_last, 'stacked_s': s_wall}


def width_phase(mods, card, rec_path, log):
    """Phase 14: (a) the four LSTM kernels at every width of ``WIDTHS``
    against their plain versions, with times beside cuDNN; (b) the
    NUM_HID 1024 path; (c) CTC past 511 characters; (d) conv_bn at any
    C_in. Returns the launches by path of (b) and the phase's numbers."""
    rnn_cuda, ctc_cuda, ctc = mods['rnn_cuda'], mods['ctc_cuda'], mods['ctc']
    build = mods['build']
    t_phase = time.perf_counter()
    ptxas = {}
    for name in ('bilstm_fwd', 'bilstm_bwd', 'lstm_fwd', 'lstm_bwd'):
        ptxas[name] = ptxas_report(build, name, [name + '_wide_kernel'])
    for name in ('bilstm_fwd', 'bilstm_bwd'):
        ptxas[name]['cluster_h512'] = rnn_cuda.cluster_report(
            name, 512, rnn_cuda.units_per_block(512))
        print('phase 14 {} bf16 cluster at H=512: {}'.format(
            name, json.dumps(ptxas[name]['cluster_h512'])), flush=True)
    shares = {}
    for h in WIDTHS:
        for dtype in (torch.float32, torch.bfloat16):
            tag = '{} H={}'.format('f32' if dtype == torch.float32 else 'bf16',
                                   h)
            worst = {}
            for label, t_len, n, ragged in WIDTH_CASES:
                seed = h + t_len + n
                c = bilstm_case(t_len, n, dtype, ragged, seed, h=h, d=64)
                uni = lstm_case(t_len, n, dtype, ragged, seed + 1, h=h, d=64)
                for k, v in width_kernels(rnn_cuda, label, c, uni,
                                          dtype).items():
                    worst[k] = max(worst.get(k, 0.0), v)
            print('phase 14 {}: worst share of the bar over {} cases {}, '
                  'the {} kernels, two calls bit for bit'.format(
                      tag, len(WIDTH_CASES), json.dumps(
                          {k: round(v, 4) for k, v in worst.items()}),
                      rnn_cuda.kernel_path(dtype, h)), flush=True)
            shares[tag] = worst
    timings = {}
    for h in (512, 768, 1024):
        for dtype in (torch.bfloat16, torch.float32):
            tag = '{} H={}'.format('f32' if dtype == torch.float32 else 'bf16',
                                   h)
            timings[tag] = width_timing(rnn_cuda, h, dtype)
            print('phase 14 timing {} (N=64 T=23) on {}: {}'.format(
                tag, card, json.dumps(timings[tag])), flush=True)
    t_a = time.perf_counter() - t_phase
    launches, wide = wide_path_phase(mods, card, rec_path, log)
    ctc_long = ctc_long_phase(ctc, ctc_cuda)
    conv_any = conv_bn_any_phase(mods['conv_bn_cuda'])
    seconds = time.perf_counter() - t_phase
    print('phase 14: took {:.1f} s ((a) {:.1f} s) on {}'.format(
        seconds, t_a, card), flush=True)
    return launches, {'shares': shares, 'timings': timings, 'ptxas': ptxas,
                      'wide_path': wide, 'ctc_long': ctc_long,
                      'conv_bn_any_c_in': conv_any, 'seconds': seconds}


def phase_alone(mods, card, kind, phase):
    """``python3 chip_smoke.py --phase 12``, ``13`` or ``14``: the kernels'
    build, then that phase alone, its reference strings from the fixed
    model's eval of ``lstm_ctc`` and its records file from ``data/val`` made
    here. For working on a phase; the smoke run takes no arguments."""
    cfg = mods['load_cfg'](os.path.join(REPO, 'lstm', 'lstm.yml'),
                           ['TEST.BATCH_SIZE', '64', 'BN_EVAL', "'batch'",
                            'TRAIN.DTYPE', "'bfloat16'", 'DECODER',
                            "'greedy'"])
    r = mods['test'].test_net(cfg, os.path.join(REPO, 'data', 'val'),
                              os.path.join(REPO, 'checkpoints', cfg.EXP_DIR),
                              device='cuda', echo=lambda s: None)
    rec_path = os.path.join(REPO, 'chiprun_out', 'chip_smoke_val.records')
    os.makedirs(os.path.dirname(rec_path), exist_ok=True)
    mods['records'].write_image_annotation_pairs_to_records(
        os.path.join(REPO, 'data', 'val'), rec_path)
    name, run = {'12': ('dsl', dsl_phase),
                 '13': ('shifted', shifted_phase),
                 '14': ('width', width_phase)}[phase]
    with open(os.path.join(REPO, 'chiprun_out',
                           'chip_smoke_{}.log'.format(name)), 'w') as log:
        if phase == '14':
            _, result = run(mods, card, rec_path, log)
        else:
            _, result = run(mods, card, rec_path,
                            {'lstm_ctc/batch': r.predictions}, log)
    print(json.dumps({name: result}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


def profile_report(what, fn, reps, with_wall=False):
    """``torch.profiler`` over ``reps`` warm calls of ``fn``, the last
    followed to its end on the device: device time by kernel and the
    device's busy share of the wall time. Returns the device busy ms per
    call (None when the profiler saw no device events), and with
    ``with_wall`` also the wall ms per call."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    # device-side kernel events only: the CPU ops that launched them
    # report the same time again
    rows = [(e.self_device_time_total / 1e3 / reps, e.count / reps, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    if not rows:
        print('profile {}: wall {:.3f} ms; the profiler saw no device '
              'events, device time by kernel not measured'.format(
                  what, wall_ms), flush=True)
        return (None, wall_ms) if with_wall else None
    busy_ms = sum(ms for ms, _, _ in rows)
    launches = sum(n for _, n, _ in rows)
    print('profile {}: wall {:.3f} ms, device busy {:.3f} ms ({:.0%}), {} '
          'kernels with device time, {:.0f} launches a call'.format(
              what, wall_ms, busy_ms, busy_ms / wall_ms, len(rows),
              launches), flush=True)
    rows.sort(reverse=True)
    own = [r for r in rows[15:] if 'lstm_' in r[2] or 'ctc_' in r[2]]
    for ms, n, name in rows[:15] + own:         # top 15, and the port's own
        print('profile {:8.4f} ms {:5.1%} x{:<5.0f} {}'.format(
            ms, ms / busy_ms if busy_ms else 0.0, n, name[:84]),
            flush=True)
    return (busy_ms, wall_ms) if with_wall else busy_ms


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available; this smoke run needs an '
              'NVIDIA GPU', file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from lstm_ctc_ocr_torch.config import load_cfg
    from lstm_ctc_ocr_torch.parallel import mesh as pmesh
    from lstm_ctc_ocr_torch.data import device_store, gen, image, records
    from lstm_ctc_ocr_torch.engine import checkpoint, serve
    from lstm_ctc_ocr_torch.engine import test as test_mod
    from lstm_ctc_ocr_torch.engine import train
    from lstm_ctc_ocr_torch.models import crnn, layers
    from lstm_ctc_ocr_torch.models.factory import get_network
    from lstm_ctc_ocr_torch.ops import (_build, beam, beam_cuda,
                                        conv_bn_cuda, ctc, ctc_cuda, rnn,
                                        rnn_cuda)
    from lstm_ctc_ocr_torch.tools import (attrib_step, bench_conv_bn,
                                         bench_ctc, bench_data, bench_decode,
                                         bench_fold_h, bench_rnn,
                                         calibrate_bn, profile_step,
                                         release_ckpt)

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    mods = {'load_cfg': load_cfg, 'train': train, 'test': test_mod,
            'rnn_cuda': rnn_cuda, 'ctc_cuda': ctc_cuda, 'ctc': ctc,
            'records': records, 'get_network': get_network, 'crnn': crnn,
            'layers': layers, 'gen': gen, 'image': image,
            'device_store': device_store, 'serve': serve,
            'checkpoint': checkpoint, 'calibrate_bn': calibrate_bn,
            'release_ckpt': release_ckpt, 'pmesh': pmesh, 'build': _build,
            'conv_bn_cuda': conv_bn_cuda,
            'tools': {'bench_ctc': bench_ctc, 'bench_rnn': bench_rnn,
                      'bench_decode': bench_decode,
                      'profile_step': profile_step,
                      'attrib_step': attrib_step, 'bench_data': bench_data,
                      'bench_fold_h': bench_fold_h}}
    if sys.argv[1:2] == ['--dp-worker']:        # a rank of phase 10
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        return dp_worker(sys.argv[2:], mods, card)
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    print('torch {} CUDA {} device {} (count {})'.format(
        torch.__version__, torch.version.cuda, kind,
        torch.cuda.device_count()), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t_start = time.perf_counter()
    _build.build_all()
    print('kernel build {:.1f} s'.format(time.perf_counter() - t_start),
          flush=True)
    for name in _build.kernel_sources():
        for line in _build.build_log(name).splitlines():
            if 'registers' in line or 'spill' in line:
                print('ptxas {}: {}'.format(name, line.strip()), flush=True)

    if sys.argv[1:2] == ['--phase']:            # phase 12, 13 or 14 alone
        check(sys.argv[2:] in (['12'], ['13'], ['14']),
              '--phase takes 12, 13 or 14, got {}'.format(sys.argv[2:]))
        return phase_alone(mods, card, kind, sys.argv[2])

    errs, timings = bilstm_fwd_phase(rnn_cuda, _build)
    bwd_errs, bwd_timings = bilstm_bwd_phase(rnn_cuda, _build)
    lstm_errs, lstm_timings = lstm_phase(rnn, rnn_cuda, _build)
    ctc_errs, ctc_timings = ctc_phase(ctc, ctc_cuda, _build)
    conv_errs, conv_timings, conv_launches = conv_bn_phase(
        bench_conv_bn, conv_bn_cuda, _build)
    beam_kernel_launches, beam_timings = beam_phase(beam, beam_cuda)
    htr = htr_phase(rnn_cuda, ctc_cuda, ctc)

    out_dir = os.path.join(REPO, 'chiprun_out')
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, 'chip_smoke_eval.log'), 'w') as log:
        (eval_launches, eval_beam_launches, eval_predictions,
         eval_p50) = eval_phase(rnn_cuda, beam_cuda, test_mod, load_cfg, log)
    profile_phase(test_mod, load_cfg)
    with open(os.path.join(out_dir, 'chip_smoke_train.log'), 'w') as log:
        synth_launches, pool_launches, synth = synth_phase(mods, card, log)
        train_launches, rate, rec_path = train_phase(mods, card, log)
        stacked_launches, stacked_rate, stacked_predictions = stacked_phase(
            mods, card, rec_path, log)
        with open(os.path.join(out_dir, 'chip_smoke_serve.log'),
                  'w') as serve_log:
            serve_launches, served = serve_phase(
                mods, card, eval_predictions, stacked_predictions, serve_log)
        dispatch_launches, dispatch = dispatch_phase(mods, card, rec_path,
                                                     rate, log)
        dp_launches, dp = dp_phase(mods, card, rec_path, dispatch,
                                   eval_predictions, log)
    with open(os.path.join(out_dir, 'chip_smoke_tools.log'), 'w') as log:
        tool_launches, tools = tools_phase(mods, card, rec_path, rate,
                                           eval_p50['lstm_ctc/batch'], log)
    with open(os.path.join(out_dir, 'chip_smoke_dsl.log'), 'w') as log:
        dsl_launches, dsl = dsl_phase(mods, card, rec_path, eval_predictions,
                                      log)
    with open(os.path.join(out_dir, 'chip_smoke_shifted.log'), 'w') as log:
        shifted_launches, shifted = shifted_phase(
            mods, card, rec_path, eval_predictions, log,
            attrib_lines=tools['attrib_step'],
            phase8=dispatch['rates']['store_graph'])
    with open(os.path.join(out_dir, 'chip_smoke_width.log'), 'w') as log:
        width_launches, width = width_phase(mods, card, rec_path, log)
    print('train rate on {}: synthetic feed {:.2f} steps/s ({} fork workers, '
          'os.cpu_count() {}), records feed {:.2f} steps/s; device busy ms '
          'per step {} and {}'.format(
              card, synth['rate']['steps_per_s'], synth['workers'],
              synth['cpu_count'], rate['steps_per_s'],
              synth['rate']['device_busy_ms_per_step'],
              rate['device_busy_ms_per_step']), flush=True)
    print('dispatch rates on {} (steps/s; device busy ms per step): {}'
          .format(card, json.dumps({
              k: [round(v['steps_per_s'], 2), v['device_busy_ms_per_step']]
              for k, v in dispatch['rates'].items()})), flush=True)
    for name in ('bilstm_fwd', 'bilstm_bwd', 'ctc_fwd', 'ctc_bwd'):
        check(train_launches[name] > 0 and synth_launches[name] > 0
              and pool_launches[name] > 0 and dispatch_launches[name] > 0
              and all(dp_launches[p][name] > 0 for p in dp_launches
                      if not p.startswith('dp_eval')),
              '{} was not launched on every train path'.format(name))
    check(all(dp_launches[p]['bilstm_fwd'] > 0 for p in dp_launches),
          'bilstm_fwd was not launched on every DP path')

    # the paths of the later phases: data parallelism, the tools, the model
    # DSL and the offline surface, and the shifted conv lowering
    later = dict(dp_launches, **{'tool ' + k: v
                                 for k, v in tool_launches.items()})
    later.update({'dsl ' + k: v for k, v in dsl_launches.items()})
    later.update({'shifted ' + k: v for k, v in shifted_launches.items()})
    later.update({'width ' + k: v for k, v in width_launches.items()})

    def later_total(name):
        return sum(v[name] for v in later.values())

    def later_paths(name):
        return {p: v[name] for p, v in later.items()}
    for name in ('bilstm_fwd', 'bilstm_bwd', 'ctc_fwd', 'ctc_bwd'):
        check(dsl_launches['dsl_train'][name] > 0,
              '{} was not launched on the DSL train path'.format(name))
    for name in ('bilstm_fwd', 'bilstm_bwd', 'ctc_fwd', 'ctc_bwd'):
        check(shifted_launches['shifted_train_bf16'][name] > 0,
              '{} was not launched on the shifted train path'.format(name))
    check(shifted_launches['shifted_eval']['bilstm_fwd'] > 0,
          'bilstm_fwd was not launched on the shifted eval path')
    for name in ('bilstm_fwd', 'bilstm_bwd', 'ctc_fwd', 'ctc_bwd'):
        check(width_launches['wide_train'][name] > 0,
              '{} was not launched on the NUM_HID 1024 train path'.format(
                  name))
    for name in ('lstm_fwd', 'lstm_bwd'):
        check(width_launches['wide_stacked_train'][name] > 0,
              '{} was not launched on the .lstm(1024, 2) path'.format(name))
    for name in ('lstm_fwd', 'lstm_bwd'):
        check(dsl_launches['dsl_stacked_train'][name] > 0,
              '{} was not launched on the DSL stacked path'.format(name))
    for name in ('lstm_fwd', 'lstm_bwd', 'ctc_fwd', 'ctc_bwd'):
        check(stacked_launches[name] > 0,
              '{} was not launched on the stacked-LSTM path'.format(name))
    for name in ('bilstm_fwd', 'lstm_fwd', 'beam'):
        check(serve_launches[name] > 0,
              '{} was not launched on the serving path'.format(name))

    fwd, bwd = timings['bf16 N=64 T=23'], bwd_timings['bf16 N=64 T=23']
    fwd111, bwd111 = timings['bf16 N=64 T=111'], bwd_timings['bf16 N=64 T=111']
    uni, uni111 = (lstm_timings['bf16 N=64 T=23'],
                   lstm_timings['bf16 N=64 T=111'])
    ctc_row, ctc111 = (ctc_timings['N=64 T=23 L=6'],
                       ctc_timings['N=64 T=111 L=24'])
    conv_row = conv_timings['conv4_1 bf16']
    beam_row = beam_timings['f32 N=64 T=111']
    common = {'route': 'cuda', 'card': card, 'train_steps': 60}

    def ctc_launches(name):
        return {'launches': synth_launches[name] + pool_launches[name]
                + train_launches[name] + stacked_launches[name]
                + dispatch_launches[name] + later_total(name),
                'launches_by_path': dict({
                    'synth_train': synth_launches[name],
                    'pool_train': pool_launches[name],
                    'train': train_launches[name],
                    'stacked_lstm': stacked_launches[name],
                    'dispatch_train': dispatch_launches[name]},
                    **later_paths(name))}
    print(json.dumps({'kernels': [dict(common, **{
        'name': 'bilstm_fwd',
        'htr_cell': htr['bilstm_fwd'],
        'source': 'lstm_ctc_ocr_torch/csrc/bilstm_fwd.cu',
        'replaces': 'lstm_ctc_ocr_tpu/ops/rnn_pallas.py:398',
        'tpu_kernel': 'ops/rnn_pallas.py:_bi_fwd_kernel',
        'launches': eval_launches + synth_launches['bilstm_fwd']
        + pool_launches['bilstm_fwd'] + train_launches['bilstm_fwd']
        + dispatch_launches['bilstm_fwd'] + serve_launches['bilstm_fwd']
        + later_total('bilstm_fwd'),
        'launches_by_path': dict({
            'eval': eval_launches, 'serve': serve_launches['bilstm_fwd'],
            'synth_train': synth_launches['bilstm_fwd'],
            'pool_train': pool_launches['bilstm_fwd'],
            'train': train_launches['bilstm_fwd'],
            'dispatch_train': dispatch_launches['bilstm_fwd']},
            **later_paths('bilstm_fwd')),
        'max_abs_err': errs[('bf16 N=64 T=23', False)],
        'ms': fwd['kernel_ms'],
        'device_ms': fwd['device_ms'],
        'kernel_ms': fwd['kernel_ms'],
        'kernel_with_residuals_ms': fwd['kernel_residuals_ms'],
        'plain_ms': fwd['plain_ms'],
        'bound_ms': fwd['bound_ms'],
        'bound_by': fwd['bound_by'],
        'library_ms': fwd['library_ms'],
        'kernel_plus_proj_ms': fwd['kernel_plus_proj_ms'],
        'library': 'cuDNN nn.LSTM forward, bidirectional, packed, input '
                   'projection included',
        'shape': 'bf16 T=23 N=64 H=256',
        'device_tflops': fwd['device_tflops'],
        'host_ms': fwd['host_ms'],
        'max_active_clusters':
            timings['ptxas']['cluster']['max_active_clusters'],
        'ptxas': timings['ptxas'],
        't111': {('ms' if k == 'kernel_ms' else k): fwd111[k] for k in (
            'kernel_ms', 'device_ms', 'plain_ms', 'library_ms', 'bound_ms',
            'device_tflops')},
    }), dict(common, **{
        'name': 'bilstm_bwd',
        'htr_cell': htr['bilstm_bwd'],
        'source': 'lstm_ctc_ocr_torch/csrc/bilstm_bwd.cu',
        'replaces': 'lstm_ctc_ocr_tpu/ops/rnn_pallas.py:522',
        'tpu_kernel': 'ops/rnn_pallas.py:_bi_bwd_kernel',
        'launches': synth_launches['bilstm_bwd']
        + pool_launches['bilstm_bwd'] + train_launches['bilstm_bwd']
        + dispatch_launches['bilstm_bwd'] + later_total('bilstm_bwd'),
        'launches_by_path': dict({
            'synth_train': synth_launches['bilstm_bwd'],
            'pool_train': pool_launches['bilstm_bwd'],
            'train': train_launches['bilstm_bwd'],
            'dispatch_train': dispatch_launches['bilstm_bwd']},
            **later_paths('bilstm_bwd')),
        'max_abs_err': bwd_errs['bf16 N=64 T=23'],
        'ms': bwd['kernel_ms'],
        'device_ms': bwd['device_ms'],
        'plain_ms': bwd['plain_ms'],
        'bound_ms': bwd['bound_ms'],
        'bound_by': bwd['bound_by'],
        'library_ms': bwd['library_ms'],
        'library': 'cuDNN nn.LSTM backward, input projection included',
        'shape': 'bf16 T=23 N=64 H=256',
        'recurrence_device_ms': bwd['recurrence_device_ms'],
        'device_tflops': bwd['device_tflops'],
        'host_ms': bwd['host_ms'],
        'max_active_clusters':
            bwd_timings['ptxas']['cluster']['max_active_clusters'],
        'ptxas': bwd_timings['ptxas'],
        't111': {('ms' if k == 'kernel_ms' else k): bwd111[k] for k in (
            'kernel_ms', 'device_ms', 'recurrence_device_ms', 'plain_ms',
            'library_ms', 'bound_ms', 'device_tflops')},
    }), dict(common, **ctc_launches('ctc_fwd'), **{
        'name': 'ctc_fwd',
        'htr_cell': htr['ctc_fwd'],
        'source': 'lstm_ctc_ocr_torch/csrc/ctc.cu',
        'replaces': 'lstm_ctc_ocr_tpu/ops/ctc_pallas.py:54',
        'tpu_kernel': 'ops/ctc_pallas.py:_fwd_kernel',
        'max_abs_err': ctc_errs['N=64 T=23 L=6']['ctc_fwd'],
        'ms': ctc_row['fwd_ms'],
        'device_ms': ctc_row['fwd_device_ms'],
        'plain_ms': ctc_row['fwd_plain_ms'],
        'bound_ms': ctc_row['fwd_bound_ms'],
        'bound_by': ctc_row['fwd_bound_by'],
        'library_ms': ctc_row['library_fwd_ms'],
        'library': 'torch.nn.functional.ctc_loss forward alone under '
                   'torch.no_grad(): the alpha recursion and the loss',
        'shape': 'f32 T=23 N=64 S=13',
        'device_tflops': ctc_row['fwd_device_tflops'],
        'host_ms': ctc_row['fwd_host_ms'],
        'ptxas': ctc_timings['ptxas'],
        't111': dict({k[4:]: ctc111[k] for k in (
            'fwd_ms', 'fwd_device_ms', 'fwd_host_ms', 'fwd_plain_ms',
            'fwd_bound_ms', 'fwd_device_tflops')},
            library_ms=ctc111['library_fwd_ms']),
    }), dict(common, **ctc_launches('ctc_bwd'), **{
        'name': 'ctc_bwd',
        'htr_cell': htr['ctc_bwd'],
        'source': 'lstm_ctc_ocr_torch/csrc/ctc.cu',
        'replaces': 'lstm_ctc_ocr_tpu/ops/ctc_pallas.py:89',
        'tpu_kernel': 'ops/ctc_pallas.py:_bwd_kernel',
        'max_abs_err': ctc_errs['N=64 T=23 L=6']['ctc_bwd'],
        'ms': ctc_row['bwd_ms'],
        'device_ms': ctc_row['bwd_device_ms'],
        'plain_ms': ctc_row['bwd_plain_ms'],
        'bound_ms': ctc_row['bwd_bound_ms'],
        'bound_by': ctc_row['bwd_bound_by'],
        'library_ms': ctc_row['library_fwd_bwd_ms'],
        'library': 'torch.nn.functional.ctc_loss forward+backward, which '
                   'covers ctc_fwd and ctc_bwd together',
        'shape': 'f32 T=23 N=64 S=13',
        'device_tflops': ctc_row['bwd_device_tflops'],
        'host_ms': ctc_row['bwd_host_ms'],
        'ptxas': ctc_timings['ptxas'],
        't111': dict({k[4:]: ctc111[k] for k in (
            'bwd_ms', 'bwd_device_ms', 'bwd_plain_ms', 'bwd_bound_ms',
            'bwd_device_tflops')}, library_ms=ctc111['library_fwd_bwd_ms']),
    }), dict(common, **{
        'name': 'lstm_fwd',
        'source': 'lstm_ctc_ocr_torch/csrc/lstm_fwd.cu',
        'replaces': 'lstm_ctc_ocr_tpu/ops/rnn_pallas.py:90',
        'tpu_kernel': 'ops/rnn_pallas.py:_fwd_kernel',
        'launches': stacked_launches['lstm_fwd'] + serve_launches['lstm_fwd']
        + later_total('lstm_fwd'),
        'launches_by_path': dict({
            'stacked_lstm': stacked_launches['lstm_fwd'],
            'serve': serve_launches['lstm_fwd']},
            **later_paths('lstm_fwd')),
        'max_abs_err': lstm_errs['bf16 N=64 T=23']['lstm_fwd'],
        'ms': uni['fwd_ms'],
        'device_ms': uni['fwd_device_ms'],
        'kernel_with_residuals_ms': uni['fwd_residuals_ms'],
        'plain_ms': uni['fwd_plain_ms'],
        'bound_ms': uni['fwd_bound_ms'],
        'bound_by': uni['fwd_bound_by'],
        'library_ms': uni['fwd_library_ms'],
        'library': 'cuDNN nn.LSTM forward, one direction, packed, input '
                   'projection included',
        'shape': 'bf16 T=23 N=64 H=512',
        'device_tflops': uni['fwd_device_tflops'],
        'host_ms': uni['fwd_host_ms'],
        'max_active_clusters':
            lstm_timings['fwd_ptxas']['cluster']['max_active_clusters'],
        'ptxas': lstm_timings['fwd_ptxas'],
        't111': {k[4:]: uni111[k] for k in (
            'fwd_ms', 'fwd_device_ms', 'fwd_plain_ms', 'fwd_library_ms',
            'fwd_bound_ms', 'fwd_device_tflops')},
    }), dict(common, **{
        'name': 'lstm_bwd',
        'source': 'lstm_ctc_ocr_torch/csrc/lstm_bwd.cu',
        'replaces': 'lstm_ctc_ocr_tpu/ops/rnn_pallas.py:177',
        'tpu_kernel': 'ops/rnn_pallas.py:_bwd_kernel',
        'launches': stacked_launches['lstm_bwd'] + later_total('lstm_bwd'),
        'launches_by_path': dict(
            {'stacked_lstm': stacked_launches['lstm_bwd']},
            **later_paths('lstm_bwd')),
        'max_abs_err': lstm_errs['bf16 N=64 T=23']['lstm_bwd'],
        'ms': uni['bwd_ms'],
        'device_ms': uni['bwd_device_ms'],
        'plain_ms': uni['bwd_plain_ms'],
        'bound_ms': uni['bwd_bound_ms'],
        'bound_by': uni['bwd_bound_by'],
        'library_ms': uni['bwd_library_ms'],
        'library': 'cuDNN nn.LSTM backward, one direction, input projection '
                   'included',
        'shape': 'bf16 T=23 N=64 H=512',
        'device_tflops': uni['bwd_device_tflops'],
        'ptxas': lstm_timings['ptxas'],
    }), dict(common, **{
        'name': 'conv_bn',
        'source': 'lstm_ctc_ocr_torch/csrc/conv_bn.cu',
        'replaces': 'lstm_ctc_ocr_tpu/ops/conv_bn_pallas.py:55',
        'tpu_kernel': 'ops/conv_bn_pallas.py:_kernel',
        'launches': conv_launches,
        'launches_by_path': {'bench_conv_bn': conv_launches},
        'max_abs_err': conv_errs['conv4_1 bf16'],
        'ms': conv_row['kernel_ms'],
        'device_ms': conv_row['device_ms'],
        'plain_ms': conv_row['plain_ms'],
        'bound_ms': conv_row['bound_ms'],
        'bound_by': conv_row['bound_by'],
        'library_ms': conv_row['library_ms'],
        'library': 'the unfused layer: cuDNN conv, then bias, batch norm and '
                   'ReLU as torch ops',
        'shape': 'bf16 N=64 conv4_1 [24, 4, 256] -> 512',
        'device_tflops': conv_row['device_tflops'],
        'by_shape': conv_timings,
    }), dict(common, **{
        'name': 'beam_decode',
        'source': 'lstm_ctc_ocr_torch/csrc/beam.cu',
        'replaces': None,
        'tpu_kernel': None,
        'launches': beam_cuda.beam_decode.launches + serve_launches['beam'],
        'launches_by_path': {
            'kernel_check': beam_kernel_launches, 'eval': eval_beam_launches,
            'serve': serve_launches['beam'],
            'later_phases_in_process': beam_cuda.beam_decode.launches
            - beam_kernel_launches - eval_beam_launches},
        'ms': beam_row['kernel_ms'],
        'device_ms': beam_row['device_ms'],
        'plain_ms': beam_row['plain_ms'],
        'bound_ms': beam_row['bound_ms'],
        'bound_by': beam_row['bound_by'],
        'host_ms': beam_row['host_ms'],
        'library_ms': None,
        'library': 'none: no library runs a CTC prefix beam search',
        'shape': 'f32 N=64 T=111 K=16 C=64',
        'by_shape': beam_timings,
    })], 'train': rate, 'stacked_lstm_train': stacked_rate,
        'synthetic_stream': synth, 'dispatch': dispatch, 'serve': served,
        'data_parallel': dp, 'tools': tools, 'dsl': dsl, 'shifted': shifted,
        'width': width, 'seconds': time.perf_counter() - t_start}),
        flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
