#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``lstm_ctc_ocr_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which stops the run with a non-zero exit when it fails:

1. The card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   and the build of every CUDA kernel from ``lstm_ctc_ocr_torch/csrc`` with
   nvcc, one process per source (its time and ptxas report).
2. Kernel phase: each of the seven kernels against its plain PyTorch version
   on the card.
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
   L=511, the longest label one block of threads holds, L=0 alone, T=1,
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
3. Eval phase, the serving path: the evaluation entry point
   (``engine/test.py``, bf16, batch 64) on the tracked releases —
   ``lstm_ctc`` on ``data/val`` under ``BN_EVAL`` batch and moving and
   ``digit4`` on ``data/val_digit4`` with greedy decode; ``lstm_records`` on
   ``data/val``, ``longline`` on ``data/val_longline`` and ``scene`` on
   ``data/val_scene`` with their default beam decode (width 16). Each
   accuracy must be within 2 images of the release's recorded accuracy
   (checkpoints/README.md), and ``bilstm_fwd``'s launch count must grow by
   exactly the number of decode calls.
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
7. Dispatch phase: the device-resident dataset (``DATA_DEVICE``,
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
8. Profiles: ``torch.profiler`` over a few warm decode calls and over a few
   warm train steps: device time by kernel and the device's busy share of
   the wall.

The line before the last is one JSON object ``{"kernels": [...]}`` with the
seven kernels (and the rates, the synthetic stream's and the dispatch
phase's numbers); the last
line is ``{"ok": true, "device": {...}}``. Per-image eval lines and the
training runs' output go to ``chiprun_out/``.
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
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, dense FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

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


def bilstm_case(t_len, n, dtype, ragged, seed, h=256, d=512):
    """Inputs at an eval shape: x [T, N, D], W [D, 8H], per-direction U [H,
    4H] and b [4H], and the projections xpf/xpb, all on the card."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).cuda().to(dtype)
    x = rnd(t_len, n, d, scale=0.5)
    w = rnd(d, 8 * h, scale=d ** -0.5)
    uf, ub = rnd(h, 4 * h, scale=h ** -0.5), rnd(h, 4 * h, scale=h ** -0.5)
    bf, bb = rnd(4 * h, scale=0.1), rnd(4 * h, scale=0.1)
    if ragged:
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


def rel_err(got, want, dtype):
    """Over the outputs: max |difference|, max |difference| / max|reference|,
    and whether each output is within 1e-4 (f32) or 4 bf16 ulps (bf16) of
    its own largest entry."""
    worst_abs, worst_rel, ok = 0.0, 0.0, True
    for g, w in zip(got, want):
        w = w.float()
        e = float((g.float() - w).abs().max())
        rel = e / (float(w.abs().max()) or 1.0)
        ok = ok and rel <= (1e-4 if dtype == torch.float32 else 4 / 256)
        worst_abs, worst_rel = max(worst_abs, e), max(worst_rel, rel)
    return worst_abs, worst_rel, ok


def bilstm_bwd_args(c, rnn_cuda, seed):
    """The backward's inputs for a forward case: the residuals the forward
    kernel writes and random output cotangents."""
    _, gf, hf, cf, _, gb, hb, cb = rnn_cuda.bilstm_fwd(*kernel_args(c),
                                                       save_residuals=True)
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


def ctc_case(ctc, t_len, l_max, seed, n=64, c=64):
    """A ragged CTC batch on the card with a full-length example (row 0,
    its label repeating a character where L > 1), an empty label (row 1),
    an infeasible example (row 2, where L > 1) and a one-frame example (row
    3), as far as N reaches, and the kernels' inputs made from it."""
    rng = np.random.RandomState(seed)
    logits = (rng.randn(n, t_len, c) * 2).astype(np.float32)
    labels = rng.randint(1, c, (n, l_max)).astype(np.int32)
    label_lens = rng.randint(min(max(1, l_max - 2), l_max), l_max + 1,
                             n).astype(np.int32)
    logit_lens = rng.randint(max(1, t_len - 8), t_len + 1, n).astype(np.int32)
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
        args = bilstm_bwd_args(c, rnn_cuda, i)
        got = rnn_cuda.bilstm_bwd(*args)
        again = rnn_cuda.bilstm_bwd(*args)
        want = rnn_cuda.bilstm_bwd_reference(*args)
        torch.cuda.synchronize()
        err, rel, ok = rel_err(got, want, dtype)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        print('bilstm_bwd check {:24s} max|diff| {:.3e} ({:.2e} of the '
              'largest entry) within tolerance: {}, two calls bit-identical: '
              '{}'.format(label, err, rel, ok, same), flush=True)
        check(ok and same, 'bilstm_bwd {}: {} of the largest entry, '
              'identical {}'.format(label, rel, same))
        errs[label] = err
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
        errs[label] = {'ctc_fwd': max(e_z, e_a), 'ctc_bwd': e_g}
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
        for res in (False, True):
            got = rnn_cuda.bilstm_fwd(*kernel_args(c), save_residuals=res)
            again = rnn_cuda.bilstm_fwd(*kernel_args(c), save_residuals=res)
            want = rnn_cuda.bilstm_fwd_reference(*kernel_args(c),
                                                 save_residuals=res)
            torch.cuda.synchronize()
            err, ok = max_err(got, want, dtype)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            print('kernel check {:24s} residuals={!s:5s} max|diff| {:.3e} '
                  'within tolerance: {}, two calls bit-identical: {}'.format(
                      label, res, err, ok, same), flush=True)
            check(ok and same, '{} residuals={}: max|diff| {} out of '
                  'tolerance or calls differ'.format(label, res, err))
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


def eval_phase(rnn_cuda, test_mod, load_cfg, log):
    """Evaluation of the tracked releases; returns the launch count."""
    rnn_cuda.bilstm_fwd.launches = 0
    calls = 0
    for label, yml, val_dir, bn_eval, decoder, total, least in EVALS:
        # the beam releases run their config's own decoder (beam, width 16)
        greedy = ['DECODER', "'greedy'"] if decoder == 'greedy' else []
        cfg = load_cfg(os.path.join(REPO, yml),
                       ['TEST.BATCH_SIZE', '64', 'BN_EVAL', repr(bn_eval),
                        'TRAIN.DTYPE', "'bfloat16'"] + greedy)
        check(str(cfg.DECODER) == decoder and int(cfg.BEAM_WIDTH) == 16,
              '{}: DECODER {} width {}'.format(label, cfg.DECODER,
                                               cfg.BEAM_WIDTH))
        before = rnn_cuda.bilstm_fwd.launches
        log.write('== {}\n'.format(label))
        r = test_mod.test_net(
            cfg, os.path.join(REPO, val_dir),
            os.path.join(REPO, 'checkpoints', cfg.EXP_DIR), device='cuda',
            echo=lambda s: log.write(s + '\n'))
        launched = rnn_cuda.bilstm_fwd.launches - before
        calls += r.decode_calls
        print('eval {:18s} {}/{} correct, {:.1f} images/s steady-state, '
              '{:.1f} images/s overall, p50 {:.4f} ms/image, {} decode calls,'
              ' {} kernel launches'.format(
                  label, r.correct, r.total, r.steady_images_per_sec,
                  r.images_per_sec, 1e3 * r.p50, r.decode_calls, launched),
              flush=True)
        check(r.total == total, '{}: {} images, expected {}'.format(
            label, r.total, total))
        check(launched == r.decode_calls, '{}: {} launches for {} decode '
              'calls'.format(label, launched, r.decode_calls))
        check(r.correct >= least, '{}: {}/{} correct, expected >= {}'.format(
            label, r.correct, total, least))
    launches = rnn_cuda.bilstm_fwd.launches
    check(launches == calls and launches > 0,
          'bilstm_fwd launched {} times in {} decode calls'.format(
              launches, calls))
    return launches


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
    return counts, rate


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
    from lstm_ctc_ocr_torch.data import device_store, gen, image, records
    from lstm_ctc_ocr_torch.engine import test as test_mod
    from lstm_ctc_ocr_torch.engine import train
    from lstm_ctc_ocr_torch.models import crnn, layers
    from lstm_ctc_ocr_torch.models.factory import get_network
    from lstm_ctc_ocr_torch.ops import (_build, conv_bn_cuda, ctc, ctc_cuda,
                                        rnn, rnn_cuda)
    from lstm_ctc_ocr_torch.tools import bench_conv_bn

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
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

    errs, timings = bilstm_fwd_phase(rnn_cuda, _build)
    bwd_errs, bwd_timings = bilstm_bwd_phase(rnn_cuda, _build)
    lstm_errs, lstm_timings = lstm_phase(rnn, rnn_cuda, _build)
    ctc_errs, ctc_timings = ctc_phase(ctc, ctc_cuda, _build)
    conv_errs, conv_timings, conv_launches = conv_bn_phase(
        bench_conv_bn, conv_bn_cuda, _build)

    out_dir = os.path.join(REPO, 'chiprun_out')
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, 'chip_smoke_eval.log'), 'w') as log:
        eval_launches = eval_phase(rnn_cuda, test_mod, load_cfg, log)
    profile_phase(test_mod, load_cfg)
    mods = {'load_cfg': load_cfg, 'train': train, 'test': test_mod,
            'rnn_cuda': rnn_cuda, 'ctc_cuda': ctc_cuda, 'ctc': ctc,
            'records': records, 'get_network': get_network, 'crnn': crnn,
            'layers': layers, 'gen': gen, 'image': image,
            'device_store': device_store}
    with open(os.path.join(out_dir, 'chip_smoke_train.log'), 'w') as log:
        synth_launches, pool_launches, synth = synth_phase(mods, card, log)
        train_launches, rate, rec_path = train_phase(mods, card, log)
        stacked_launches, stacked_rate = stacked_phase(mods, card, rec_path,
                                                       log)
        dispatch_launches, dispatch = dispatch_phase(mods, card, rec_path,
                                                     rate, log)
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
              and pool_launches[name] > 0 and dispatch_launches[name] > 0,
              '{} was not launched on every train path'.format(name))
    for name in ('lstm_fwd', 'lstm_bwd', 'ctc_fwd', 'ctc_bwd'):
        check(stacked_launches[name] > 0,
              '{} was not launched on the stacked-LSTM path'.format(name))

    fwd, bwd = timings['bf16 N=64 T=23'], bwd_timings['bf16 N=64 T=23']
    fwd111, bwd111 = timings['bf16 N=64 T=111'], bwd_timings['bf16 N=64 T=111']
    uni, uni111 = (lstm_timings['bf16 N=64 T=23'],
                   lstm_timings['bf16 N=64 T=111'])
    ctc_row, ctc111 = (ctc_timings['N=64 T=23 L=6'],
                       ctc_timings['N=64 T=111 L=24'])
    conv_row = conv_timings['conv4_1 bf16']
    common = {'route': 'cuda', 'card': card, 'train_steps': 60}

    def ctc_launches(name):
        return {'launches': synth_launches[name] + pool_launches[name]
                + train_launches[name] + stacked_launches[name]
                + dispatch_launches[name],
                'launches_by_path': {'synth_train': synth_launches[name],
                                     'pool_train': pool_launches[name],
                                     'train': train_launches[name],
                                     'stacked_lstm': stacked_launches[name],
                                     'dispatch_train':
                                         dispatch_launches[name]}}
    print(json.dumps({'kernels': [dict(common, **{
        'name': 'bilstm_fwd',
        'source': 'lstm_ctc_ocr_torch/csrc/bilstm_fwd.cu',
        'replaces': 'lstm_ctc_ocr_tpu/ops/rnn_pallas.py:398',
        'tpu_kernel': 'ops/rnn_pallas.py:_bi_fwd_kernel',
        'launches': eval_launches + synth_launches['bilstm_fwd']
        + pool_launches['bilstm_fwd'] + train_launches['bilstm_fwd']
        + dispatch_launches['bilstm_fwd'],
        'launches_by_path': {'eval': eval_launches,
                             'synth_train': synth_launches['bilstm_fwd'],
                             'pool_train': pool_launches['bilstm_fwd'],
                             'train': train_launches['bilstm_fwd'],
                             'dispatch_train':
                                 dispatch_launches['bilstm_fwd']},
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
        'source': 'lstm_ctc_ocr_torch/csrc/bilstm_bwd.cu',
        'replaces': 'lstm_ctc_ocr_tpu/ops/rnn_pallas.py:522',
        'tpu_kernel': 'ops/rnn_pallas.py:_bi_bwd_kernel',
        'launches': synth_launches['bilstm_bwd']
        + pool_launches['bilstm_bwd'] + train_launches['bilstm_bwd']
        + dispatch_launches['bilstm_bwd'],
        'launches_by_path': {'synth_train': synth_launches['bilstm_bwd'],
                             'pool_train': pool_launches['bilstm_bwd'],
                             'train': train_launches['bilstm_bwd'],
                             'dispatch_train':
                                 dispatch_launches['bilstm_bwd']},
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
        'launches': stacked_launches['lstm_fwd'],
        'launches_by_path': {'stacked_lstm': stacked_launches['lstm_fwd']},
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
        'launches': stacked_launches['lstm_bwd'],
        'launches_by_path': {'stacked_lstm': stacked_launches['lstm_bwd']},
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
    })], 'train': rate, 'stacked_lstm_train': stacked_rate,
        'synthetic_stream': synth, 'dispatch': dispatch,
        'seconds': time.perf_counter() - t_start}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
