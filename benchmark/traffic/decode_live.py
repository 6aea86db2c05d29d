"""Driver ``decode_live``: the eval driver's batched decode as a closed
loop with one caller. A request is ``batch`` images of one width bucket,
the batch ``engine/test.py:_test_batched`` forms; it goes through
``engine/test.py:make_decode_step`` (the live forward in the configured
compute type and ``BN_EVAL`` statistics, then the configured decoder) and
``decode_ids`` (ids to strings). It is timed from its issue to its
strings on the host.

Parameters: ``data_dir`` (the labelled PNGs), ``release`` (the weights),
``drawn_requests``, ``check_requests`` (the sample the comparison
re-decodes), ``trace_units`` (requests traced). The batch is the
configuration's ``TEST.BATCH_SIZE``, as the eval driver reads it. Each
request's bucket is drawn from the seed with the data set's own bucket
frequencies, its images with replacement from that bucket's files; the
images are resized to the model height and zero-padded to the bucket by
the benchmark (``reference/png.py``) before the clock starts.

The comparison: the reference (``reference/model.py`` in f32, batch
statistics over the same padded batch, then ``reference/decode.py``'s
decoder) re-decodes a sample of the window's requests drawn from the seed,
the first request of the widest bucket among them, and each answer is
judged by ``judge.py``; the number compared is the widest gap.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import common, judge
from benchmark.harness import closed_loop
from benchmark.reference import ckpt as ref_ckpt


def prepared(ctx):
    """Each image resized to the model height, width-major, /255 and
    zero-padded to its bucket: ``(arrays [W_b, 32] f32, own widths,
    buckets)``."""
    cfg_d = ctx.config['cfg']
    _, _, res = common.load_images(ctx.work['data_dir'],
                                   int(cfg_d['IMG_HEIGHT']))
    arrays, widths, buckets = [], [], []
    for im in res:
        w = im.shape[1]
        b = common.pick_bucket(w, cfg_d['BUCKETS'])
        a = np.zeros((b, im.shape[0]), np.float32)
        a[:w] = im.T.astype(np.float32) / 255.0
        arrays.append(a)
        widths.append(w)
        buckets.append(b)
    return arrays, widths, buckets


def _batch(ctx):
    return int(ctx.config['cfg']['TEST']['BATCH_SIZE'])


def requests(ctx, buckets):
    """``[drawn, batch]`` file indices, each row from one bucket drawn
    with the data set's bucket frequencies."""
    rng = np.random.default_rng(ctx.seed)
    by = {}
    for i, b in enumerate(buckets):
        by.setdefault(b, []).append(i)
    keys = sorted(by)
    freq = np.array([len(by[k]) for k in keys], np.float64)
    n, batch = int(ctx.work['drawn_requests']), _batch(ctx)
    pick = rng.choice(len(keys), size=n, p=freq / freq.sum())
    return np.stack([rng.choice(by[keys[p]], size=batch) for p in pick])


def setup(ctx):
    from lstm_ctc_ocr_torch.config import get_encode_decode_dict
    from lstm_ctc_ocr_torch.engine import checkpoint
    from lstm_ctc_ocr_torch.engine.test import full_f32, make_decode_step
    from lstm_ctc_ocr_torch.models.factory import get_network

    cfg = common.port_cfg(ctx.config)
    dev = torch.device(ctx.device)
    t0 = time.time()
    arrays, widths, buckets = prepared(ctx)
    reqs = requests(ctx, buckets)
    model = get_network('LSTM_test', cfg)
    checkpoint.load_into(model, common.repo_path(ctx.work['release']),
                         str(cfg.BN_EVAL) == 'moving')
    model = model.to(dev).eval()
    decode_step = make_decode_step(model, cfg, dev)
    t1 = time.time()
    _, decode_maps = get_encode_decode_dict(cfg)
    state = {'program': {'decode_step': decode_step, 'model': model},
             'decode_maps': decode_maps, 'arrays': arrays, 'widths': widths,
             'buckets': buckets, 'reqs': reqs}
    # warm up every bucket the traffic sends
    seen = set()
    with full_f32():
        for rows in reqs:
            b = buckets[rows[0]]
            if b not in seen:
                seen.add(b)
                decode_step(*batch_of(state, rows))
    ctx.records['setup_phases'] = {'inputs_and_model_s': t1 - t0,
                                   'warm_s': time.time() - t1}
    return state


def batch_of(state, rows):
    images = np.stack([state['arrays'][r] for r in rows])
    steps = np.array([state['widths'][r] // 4 - 1 for r in rows], np.int32)
    return images, steps


def window(ctx, state):
    from lstm_ctc_ocr_torch.engine.test import decode_ids, full_f32
    decode_step = state['program']['decode_step']
    reqs, maps = state['reqs'], state['decode_maps']
    spans = ctx.spans
    latencies, answers = [], []
    trace_units = int(ctx.work['trace_units']) if ctx.trace else 0
    traced = reqs[:trace_units]
    ctx.records['trace_counts'] = {
        'calls': [[state['widths'][r] for r in rows] for rows in traced],
        'images': int(traced.size),
        'num_hid': common.model_dims(ctx.config)['num_hid'],
        'nclasses': common.model_dims(ctx.config)['nclasses'],
        'dtype': ctx.config['cfg']['TRAIN']['DTYPE']}

    def step(i):
        images, steps = batch_of(state, reqs[i % len(reqs)])
        t0 = time.perf_counter()
        with spans('eval.request'):
            with spans('eval.decode_step'):
                ids = decode_step(images, steps)
            strings = [decode_ids(x, maps) for x in ids]
        latencies.append(time.perf_counter() - t0)
        answers.append((ids, strings))

    with full_f32():
        units, secs, summary = closed_loop(ctx, step, lambda: None,
                                           trace_units)
    batch = _batch(ctx)
    ctx.records['attempted'] = units
    ctx.records['failed'] = sum(1 for _, s in answers if len(s) != batch)
    ctx.records['answers'] = answers
    return {'decode_images_per_s': units * batch / secs,
            'decode_p95_ms': 1e3 * float(np.percentile(latencies, 95))}, \
        summary


def sample(ctx, state, n_done):
    """The requests the comparison re-decodes: ``check_requests`` of the
    window's, drawn from the seed, with the first of the widest bucket."""
    rng = np.random.default_rng([ctx.seed, 1])
    k = min(int(ctx.work['check_requests']), n_done)
    picked = list(rng.choice(n_done, size=k, replace=False))
    reqs, buckets = state['reqs'], state['buckets']
    widest = max(buckets[reqs[i % len(reqs)][0]] for i in range(n_done))
    first = next(i for i in range(n_done)
                 if buckets[reqs[i % len(reqs)][0]] == widest)
    if first not in picked:
        picked[0] = first
    return sorted(int(i) for i in picked)


def check(ctx, state):
    from lstm_ctc_ocr_torch.engine.test import full_f32
    dev = torch.device(ctx.device)
    cfg_d = ctx.config['cfg']
    params = ref_ckpt.load_release(common.repo_path(ctx.work['release']), dev)
    beam = cfg_d['DECODER'] == 'beam'
    answers = ctx.records['answers']
    widest = 0.0
    with full_f32():
        for i in sample(ctx, state, len(answers)):
            images, steps = batch_of(state, state['reqs'][i % len(
                state['reqs'])])
            x = torch.from_numpy(images).to(dev)
            lens = torch.from_numpy(steps).to(dev)
            own = judge.reference_decode(params, x, lens, cfg_d)
            logits = own[0]
            if ctx.produce == 'fp8':
                low = judge.reference_logits(params, x, lens, cfg_d, 'fp8')
                g = judge.frame_gaps(logits, low, lens)
            else:
                if ctx.produce is None:
                    ans = [judge.strip(r) for r in answers[i][0]]
                else:                               # a token altered
                    ans = judge.altered(own[1])
                g = judge.gaps(logits, lens, ans, own[1],
                               'beam' if beam else 'greedy')
            widest = max(widest, max(g))
    return [('decode_gap', widest, ctx.work['limits']['decode_gap'])]

