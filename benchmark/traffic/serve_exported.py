"""Driver ``serve_exported``: the serving export as a closed loop with one
caller. ``engine/serve.py:export_decoder`` writes one program per bucket
the traffic uses, as a server's deployment step does once, into the
checkout's cache (``.bench_cache/export/``, keyed by the release, the
configuration, the buckets and the program's sources), so that only a
checkout's first run exports, as only its first builds the kernels; at
set-up ``ExportedDecoder`` loads them. A request is ``request_images``
raw grayscale images of mixed widths sent to
``ExportedDecoder.decode_images``, which resizes them, groups them by
bucket and pads each group to the programs' batch; it is timed from its
issue to its strings.

Parameters: ``data_dir``, ``release``, ``buckets`` (exported),
``request_images`` (images a request; the programs' batch is the
configuration's ``TEST.BATCH_SIZE``), ``drawn_requests``,
``check_requests``, ``trace_units``. Each request's images are drawn from
the seed without replacement from the data set.

The comparison: the reference re-does a sample of the window's requests
from the raw images (``reference/png.py``'s resize and bucket padding, the
decoder's grouping and padding with copies of a group's last image, the
f32 forward with each padded group's batch statistics, then the
configured decoder) and each answer is judged by ``judge.py`` on the ids
of its string; the number compared is the widest gap.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time

import numpy as np
import torch

from benchmark import common, judge
from benchmark.harness import closed_loop
from benchmark.reference import ckpt as ref_ckpt
from benchmark.reference import png as ref_png


# the program's sources, whose change makes an exported program stale
SOURCE_SUFFIXES = ('.py', '.cu', '.cuh', '.cpp', '.h')


def export_dir(ctx, cfg, dev):
    """The directory of the cell's exported programs, exported there if it
    is not yet: ``.bench_cache/export/<cell>-<key>``, at a fixed path for
    a given release, configuration, buckets, device type and program."""
    from lstm_ctc_ocr_torch.engine import checkpoint
    from lstm_ctc_ocr_torch.engine.serve import MANIFEST, export_decoder
    from lstm_ctc_ocr_torch.models.factory import get_network

    release = common.repo_path(ctx.work['release'])
    key = hashlib.sha1(json.dumps(
        [ctx.config['cfg'], sorted(ctx.work['buckets']), dev.type,
         torch.__version__], sort_keys=True).encode())
    with open(release, 'rb') as f:
        key.update(f.read())
    pkg = common.repo_path('lstm_ctc_ocr_torch')
    for root, dirs, files in os.walk(pkg):
        dirs[:] = sorted(d for d in dirs if d not in ('build',
                                                      '__pycache__'))
        for f in sorted(files):
            if f.endswith(SOURCE_SUFFIXES):
                key.update(os.path.relpath(os.path.join(root, f),
                                           pkg).encode())
                with open(os.path.join(root, f), 'rb') as fh:
                    key.update(fh.read())
    out_dir = os.path.join(common.CACHE_DIR, 'export', '{}-{}'.format(
        ctx.name, key.hexdigest()[:16]))
    if os.path.isfile(os.path.join(out_dir, MANIFEST)):
        return out_dir
    # written aside and renamed whole, so that the cache's directory only
    # ever holds a finished export, also where two processes race
    part = '{}.part{}'.format(out_dir, os.getpid())
    model = get_network('LSTM_test', cfg)
    checkpoint.load_into(model, release, str(cfg.BN_EVAL) == 'moving')
    export_decoder(model, cfg, part, buckets=ctx.work['buckets'],
                   batch=int(cfg.TEST.BATCH_SIZE), device=dev)
    try:
        os.replace(part, out_dir)
    except OSError:                     # another process finished first
        shutil.rmtree(part, ignore_errors=True)
    return out_dir


def setup(ctx):
    from lstm_ctc_ocr_torch.engine.serve import ExportedDecoder

    cfg = common.port_cfg(ctx.config)
    dev = torch.device(ctx.device)
    labels, raw, res = common.load_images(ctx.work['data_dir'],
                                          int(cfg.IMG_HEIGHT))
    widths = [im.shape[1] for im in res]
    rng = np.random.default_rng(ctx.seed)
    n, batch = (int(ctx.work['drawn_requests']),
                int(ctx.work['request_images']))
    reqs = np.argsort(rng.random((n, len(raw))), axis=1)[:, :batch]
    t0 = time.time()
    decoder = ExportedDecoder(export_dir(ctx, cfg, dev), device=dev)
    t1 = time.time()
    run = decoder.run
    spans = ctx.spans

    def traced_run(images, steps):
        with spans('serve.program_run'):
            return run(images, steps)
    decoder.run = traced_run
    state = {'program': {'decoder': decoder}, 'raw': raw, 'widths': widths,
             'reqs': reqs}
    # warm up every exported bucket
    for b in ctx.work['buckets']:
        one = next(i for i, w in enumerate(widths)
                   if common.pick_bucket(w, cfg.BUCKETS) == b)
        decoder.decode_images([raw[one]])
    ctx.records['setup_phases'] = {'programs_s': t1 - t0,
                                   'warm_s': time.time() - t1}
    return state


def window(ctx, state):
    decoder = state['program']['decoder']
    reqs, raw = state['reqs'], state['raw']
    spans = ctx.spans
    latencies, answers = [], []
    trace_units = int(ctx.work['trace_units']) if ctx.trace else 0
    buckets = ctx.config['cfg']['BUCKETS']
    prog_batch = int(ctx.config['cfg']['TEST']['BATCH_SIZE'])
    calls = []
    for rows in reqs[:trace_units]:
        by = {}
        for r in rows:
            w = state['widths'][r]
            by.setdefault(common.pick_bucket(w, buckets), []).append(w)
        for _, ws in sorted(by.items()):
            calls.extend(ws[i:i + prog_batch]
                         for i in range(0, len(ws), prog_batch))
    ctx.records['trace_counts'] = {
        'calls': calls, 'images': int(reqs[:trace_units].size),
        'rows': prog_batch * len(calls),
        'num_hid': common.model_dims(ctx.config)['num_hid'],
        'nclasses': common.model_dims(ctx.config)['nclasses'],
        'dtype': ctx.config['cfg']['TRAIN']['DTYPE']}
    calls0 = decoder.calls

    def step(i):
        imgs = [raw[r] for r in reqs[i % len(reqs)]]
        t0 = time.perf_counter()
        with spans('serve.decode_images'):
            strings = decoder.decode_images(imgs)
        latencies.append(time.perf_counter() - t0)
        answers.append(strings)

    units, secs, summary = closed_loop(ctx, step, lambda: None, trace_units)
    ctx.records['attempted'] = units
    ctx.records['failed'] = sum(1 for s in answers if len(s) != reqs.shape[1])
    ctx.records['answers'] = answers
    ctx.records['program_calls'] = decoder.calls - calls0
    return {'decode_images_per_s': units * reqs.shape[1] / secs,
            'decode_p95_ms': 1e3 * float(np.percentile(latencies, 95))}, \
        summary


def sample(ctx, n_done):
    rng = np.random.default_rng([ctx.seed, 1])
    k = min(int(ctx.work['check_requests']), n_done)
    return sorted(int(i) for i in rng.choice(n_done, size=k, replace=False))


def reference_batches(ctx, imgs):
    """The decoder's batches as the reference builds them from the raw
    images: ``[(positions, images [B, W, 32] f32, steps [B])]`` by bucket
    in ascending order, each chunk padded with copies of its last image."""
    cfg_d = ctx.config['cfg']
    height, batch = int(cfg_d['IMG_HEIGHT']), int(cfg_d['TEST'][
        'BATCH_SIZE'])
    prep = []
    for im in imgs:
        h, w = im.shape
        if h != height:
            w = int(height / h * w)
            im = ref_png.resize_linear(im, w, height)
        b = common.pick_bucket(w, cfg_d['BUCKETS'])
        a = np.zeros((b, height), np.float32)
        a[:w] = im.T.astype(np.float32) / 255.0
        prep.append((b, a, w // 4 - 1))
    by = {}
    for i, (b, _, _) in enumerate(prep):
        by.setdefault(b, []).append(i)
    out = []
    for _, idxs in sorted(by.items()):
        for s in range(0, len(idxs), batch):
            chunk = idxs[s:s + batch]
            rows = chunk + [chunk[-1]] * (batch - len(chunk))
            out.append((chunk, np.stack([prep[i][1] for i in rows]),
                        np.array([prep[i][2] for i in rows], np.int32)))
    return out


def check(ctx, state):
    from lstm_ctc_ocr_torch.engine.test import full_f32
    dev = torch.device(ctx.device)
    cfg_d = ctx.config['cfg']
    charset = cfg_d['CHARSET']
    params = ref_ckpt.load_release(common.repo_path(ctx.work['release']), dev)
    answers = ctx.records['answers']
    mode = 'beam' if cfg_d['DECODER'] == 'beam' else 'greedy'

    def to_ids(s):
        return common.encode(s, charset)

    def to_str(ids):
        return ''.join(charset[i - 1] for i in ids if 1 <= i <= len(charset))

    widest = 0.0
    with full_f32():
        for i in sample(ctx, len(answers)):
            imgs = [state['raw'][r] for r in state['reqs'][i % len(
                state['reqs'])]]
            for chunk, images, steps in reference_batches(ctx, imgs):
                x = torch.from_numpy(images).to(dev)
                lens = torch.from_numpy(steps).to(dev)
                logits, own = judge.reference_decode(params, x, lens,
                                                     cfg_d)
                own = [to_ids(to_str(o)) for o in own[:len(chunk)]]
                n = len(chunk)
                if ctx.produce == 'fp8':
                    low = judge.reference_logits(params, x, lens, cfg_d,
                                                 'fp8')
                    g = judge.frame_gaps(logits[:, :n], low[:, :n],
                                         lens[:n])
                else:
                    if ctx.produce is None:
                        ans = [to_ids(answers[i][j]) for j in chunk]
                    else:                           # a character altered
                        ans = judge.altered(own)
                    g = judge.gaps(logits[:, :n], lens[:n], ans, own, mode)
                widest = max(widest, max(g))
    return [('decode_gap', widest, ctx.work['limits']['decode_gap'])]

