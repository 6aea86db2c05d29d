#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``lstm_ctc_ocr_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which stops the run with a non-zero exit when it fails:

1. The card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   and the build of every CUDA kernel from ``lstm_ctc_ocr_torch/csrc`` with
   nvcc (its time and ptxas report).
2. Kernel phase: ``bilstm_fwd`` against its plain PyTorch version
   ``bilstm_fwd_reference`` on the card, with residuals on and off, in f32
   and bf16 at the eval shapes (batch 64; T=23 at the W=96 bucket, T=111 at
   W=448) and a ragged batch of 37 with some empty rows. Tolerance: f32 max
   |difference| <= 1e-4; bf16 <= 4 bf16 ulps of the reference's magnitude
   (4 * max|ref| / 256, as tests/test_rnn_pallas.py defines it). Then CUDA-
   event timings (median of 50 after warm-up) of the kernel, the plain
   version, the kernel plus the input projection, and a library yardstick:
   cuDNN's bidirectional ``torch.nn.LSTM`` on a packed sequence with the
   same weights (timed here only; the port never calls it).
3. Eval phase, the port's main path: the evaluation entry point (``engine/test.py``,
   bf16, greedy, batch 64) on the tracked releases — ``lstm_ctc`` on
   ``data/val`` under ``BN_EVAL`` batch and moving, ``digit4`` on
   ``data/val_digit4``. Each accuracy must be within 2 images of the
   release's recorded accuracy (checkpoints/README.md), and the kernel's
   launch count must grow by exactly the number of decode calls.
4. Profile: ``torch.profiler`` over a few warm decode calls at batch 64,
   W=96: device time by kernel and the device's busy share of the wall.

The line before the last is one JSON object ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``. Per-image eval lines go to
``chiprun_out/chip_smoke_eval.log``.
"""

import json
import os
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

# (label, config, val dir, BN_EVAL, least correct of 500): the releases'
# recorded 485 (batch) / 486 (moving) for lstm_ctc and 487 for digit4, less 2
EVALS = [
    ('lstm_ctc/batch', 'lstm/lstm.yml', 'data/val', 'batch', 483),
    ('lstm_ctc/moving', 'lstm/lstm.yml', 'data/val', 'moving', 484),
    ('digit4/batch', 'lstm/digit4.yml', 'data/val_digit4', 'batch', 485),
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


def cudnn_yardstick(c, forget_bias=1.0):
    """cuDNN's bidirectional LSTM with the case's weights (gate order i, f,
    g, o; forget_bias folded into the bias), on a packed sequence."""
    d = c['x'].shape[2]
    h = c['uf'].shape[0]
    lstm = torch.nn.LSTM(d, h, bidirectional=True).cuda().to(c['x'].dtype)

    def reorder(m):            # ..., [i, j, f, o] blocks -> [i, f, j, o]
        i, j, f, o = m.split(h, dim=-1)
        return torch.cat([i, f, j, o], dim=-1)
    with torch.no_grad():
        for sfx, w, u, b in (('', c['w'][:, :4 * h], c['uf'], c['bf']),
                             ('_reverse', c['w'][:, 4 * h:], c['ub'],
                              c['bb'])):
            getattr(lstm, 'weight_ih_l0' + sfx).copy_(reorder(w).t())
            getattr(lstm, 'weight_hh_l0' + sfx).copy_(reorder(u).t())
            fb = torch.zeros(4 * h, device=b.device, dtype=b.dtype)
            fb[h:2 * h] = forget_bias
            getattr(lstm, 'bias_ih_l0' + sfx).copy_(reorder(b) + fb)
            getattr(lstm, 'bias_hh_l0' + sfx).zero_()
    lstm.flatten_parameters()          # cuDNN's packed weight buffer
    packed = torch.nn.utils.rnn.pack_padded_sequence(
        c['x'], c['lens'].cpu(), enforce_sorted=False)
    return lstm, packed


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


def kernel_phase(rnn_cuda):
    """Correctness on every case, then timings at the eval shapes."""
    cases = [('f32 N=64 T=23', 23, 64, torch.float32, False),
             ('bf16 N=64 T=23', 23, 64, torch.bfloat16, False),
             ('bf16 N=64 T=111', 111, 64, torch.bfloat16, False),
             ('bf16 ragged N=37 T=23', 23, 37, torch.bfloat16, True)]
    errs = {}
    for i, (label, t_len, n, dtype, ragged) in enumerate(cases):
        c = bilstm_case(t_len, n, dtype, ragged, seed=i)
        for res in (False, True):
            got = rnn_cuda.bilstm_fwd(*kernel_args(c), save_residuals=res)
            want = rnn_cuda.bilstm_fwd_reference(*kernel_args(c),
                                                 save_residuals=res)
            torch.cuda.synchronize()
            err, ok = max_err(got, want, dtype)
            print('kernel check {:24s} residuals={!s:5s} max|diff| {:.3e} '
                  'within tolerance: {}'.format(label, res, err, ok),
                  flush=True)
            check(ok, '{} residuals={}: max|diff| {} out of tolerance'.format(
                label, res, err))
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
                'plain_ms': median_ms(
                    lambda: rnn_cuda.bilstm_fwd_reference(*args)),
                'kernel_plus_proj_ms': median_ms(with_projection),
                'library_ms': median_ms(lambda: lstm(packed)),
            }
        row['bound_ms'], row['bound_by'] = bound_ms(c, torch.bfloat16)
        row['cudnn_vs_kernel_max_abs_diff'] = lib_diff
        timings[label] = row
        print('kernel timing {:16s} {}'.format(label, json.dumps(row)),
              flush=True)
    return errs, timings


def eval_phase(rnn_cuda, test_mod, load_cfg, log):
    """Evaluation of the tracked releases; returns the launch count."""
    rnn_cuda.bilstm_fwd.launches = 0
    calls = 0
    for label, yml, val_dir, bn_eval, least in EVALS:
        cfg = load_cfg(os.path.join(REPO, yml),
                       ['TEST.BATCH_SIZE', '64', 'BN_EVAL', repr(bn_eval),
                        'DECODER', "'greedy'", 'TRAIN.DTYPE', "'bfloat16'"])
        before = rnn_cuda.bilstm_fwd.launches
        log.write('== {}\n'.format(label))
        r = test_mod.test_net(
            cfg, os.path.join(REPO, val_dir),
            os.path.join(REPO, 'checkpoints', cfg.EXP_DIR), device='cuda',
            echo=lambda s: log.write(s + '\n'))
        launched = rnn_cuda.bilstm_fwd.launches - before
        calls += r.decode_calls
        print('eval {:16s} {}/{} correct, {:.1f} images/s steady-state, '
              '{:.1f} images/s overall, p50 {:.4f} ms/image, {} decode calls,'
              ' {} kernel launches'.format(
                  label, r.correct, r.total, r.steady_images_per_sec,
                  r.images_per_sec, 1e3 * r.p50, r.decode_calls, launched),
              flush=True)
        check(r.total == 500, '{}: {} images, expected 500'.format(
            label, r.total))
        check(launched == r.decode_calls, '{}: {} launches for {} decode '
              'calls'.format(label, launched, r.decode_calls))
        check(r.correct >= least, '{}: {}/500 correct, expected >= {}'.format(
            label, r.correct, least))
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
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            step(images, steps)
        wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    # device-side kernel events only: the CPU ops that launched them
    # report the same time again
    rows = [(e.self_device_time_total / 1e3 / reps, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    device_ms = sum(ms for ms, _ in rows)
    print('profile decode call (batch 64, W=96, bf16): wall {:.3f} ms, '
          'device busy {:.3f} ms ({:.0%}), {} kernels with device time'
          .format(wall_ms, device_ms, device_ms / wall_ms, len(rows)),
          flush=True)
    for ms, name in sorted(rows, reverse=True)[:15]:
        print('profile {:8.4f} ms {:5.1%}  {}'.format(
            ms, ms / device_ms if device_ms else 0.0, name[:90]), flush=True)


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available; this smoke run needs an '
              'NVIDIA GPU', file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from lstm_ctc_ocr_torch.config import load_cfg
    from lstm_ctc_ocr_torch.engine import test as test_mod
    from lstm_ctc_ocr_torch.ops import _build, rnn_cuda

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

    t0 = time.perf_counter()
    _build.build_all()
    print('kernel build {:.1f} s'.format(time.perf_counter() - t0),
          flush=True)
    for name in _build.kernel_sources():
        for line in _build.build_log(name).splitlines():
            if 'registers' in line or 'spill' in line:
                print('ptxas {}: {}'.format(name, line.strip()), flush=True)

    errs, timings = kernel_phase(rnn_cuda)

    os.makedirs(os.path.join(REPO, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(REPO, 'chiprun_out', 'chip_smoke_eval.log'),
              'w') as log:
        launches = eval_phase(rnn_cuda, test_mod, load_cfg, log)
    profile_phase(test_mod, load_cfg)

    main_row = timings['bf16 N=64 T=23']
    print(json.dumps({'kernels': [{
        'name': 'bilstm_fwd',
        'route': 'cuda',
        'source': 'lstm_ctc_ocr_torch/csrc/bilstm_fwd.cu',
        'replaces': 'lstm_ctc_ocr_tpu/ops/rnn_pallas.py:398',
        'tpu_kernel': 'ops/rnn_pallas.py:_bi_fwd_kernel',
        'launches': launches,
        'max_abs_err': errs[('bf16 N=64 T=23', False)],
        'ms': main_row['kernel_ms'],
        'kernel_ms': main_row['kernel_ms'],
        'plain_ms': main_row['plain_ms'],
        'bound_ms': main_row['bound_ms'],
        'bound_by': main_row['bound_by'],
        'library_ms': main_row['library_ms'],
        'kernel_plus_proj_ms': main_row['kernel_plus_proj_ms'],
        'shape': 'bf16 T=23 N=64 H=256',
        'card': card,
    }]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
