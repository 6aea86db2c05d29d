"""Driver ``train_store``: training as a closed loop of K-step dispatches on
the device-resident store, as the solver wires it for a pool or records
backend (``engine/train.py:SolverWrapper.train_model``): the labelled
images of ``data_dir`` held on the device by ``data/device_store.py``'s
``DeviceStore`` (padded to its widest row's bucket), ``[K, batch]`` row
indices a dispatch, ``engine/train.py:make_train_chunk(..., gather=True)``
(one CUDA graph per store, its first dispatch eager), and one readback of
the K losses a dispatch, finished after the next dispatch is submitted.

Parameters (the workload file): ``data_dir`` and ``trace_units``
(dispatches traced). The batch and the steps a dispatch are the
configuration's ``TRAIN.BATCH_SIZE`` and ``TRAIN.STEPS_PER_DISPATCH``, as
the solver reads them.

The weights are drawn from the seed (``reference/model.py:make_params``)
and handed to both sides. Every batch holds ``batch`` distinct rows, drawn
from the seed; every seed runs the same store, so the same work a step.

The comparison: the reference (``reference/train.py``) follows the probe
dispatches' steps on the same rows, padded to the store's width as the
store pads them: the first dispatch (eager) from the seed's weights, the
second (a replay of its CUDA graph) from the state, moments and update
count the first left in the program (:func:`check`). In each, the numbers
compared are the worst relative loss gap of its first ``LOSS_STEPS``
steps, the worst leaf's gap of the first Adam moment's norm (the gradients
as the optimizer got them), and of the change of each parameter and moving
statistic, the worst leaf's and the median leaf's
(:func:`benchmark.common.leaf_gaps`); the larger of the two dispatches'
is compared.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import common
from benchmark.harness import closed_loop
from benchmark.reference import model as ref_model
from benchmark.reference import train as ref_train

# the first dispatches, which the comparison follows
PROBE_DISPATCHES = 2
# dispatches after the probe that finish the warm-up (a graph replay)
WARM_DISPATCHES = 2
# index arrays drawn from the seed; the window cycles through them
DRAWN_DISPATCHES = 1024
# the steps of each probe dispatch whose loss is compared
LOSS_STEPS = 3


def _rows(ctx):
    cfg_d = ctx.config['cfg']
    labels, _, res = common.load_images(ctx.work['data_dir'],
                                        int(cfg_d['IMG_HEIGHT']))
    return labels, res


def _sizes(ctx):
    """``(steps a dispatch, batch)`` as the configuration states them."""
    t = ctx.config['cfg']['TRAIN']
    return int(t['STEPS_PER_DISPATCH']), int(t['BATCH_SIZE'])


def _indices(ctx, n_rows):
    """``[drawn, K, batch]`` int32 row indices from the seed, each batch
    of distinct rows."""
    (k, b), d = _sizes(ctx), DRAWN_DISPATCHES
    rng = np.random.default_rng(ctx.seed)
    keys = rng.random((d * k, n_rows))
    return np.argsort(keys, axis=1)[:, :b].astype(np.int32).reshape(d, k, b)


def setup(ctx):
    from lstm_ctc_ocr_torch.data.device_store import DeviceStore
    from lstm_ctc_ocr_torch.engine.test import full_f32
    from lstm_ctc_ocr_torch.engine.train import (compute_dtype,
                                                 make_optimizer,
                                                 make_train_chunk)
    from lstm_ctc_ocr_torch.models.factory import get_network

    cfg = common.port_cfg(ctx.config)
    dev = torch.device(ctx.device)
    t0 = time.time()
    labels, res = _rows(ctx)
    idx = _indices(ctx, len(res))
    store = DeviceStore(res, labels, 'uniform', np.random.RandomState(0),
                        cfg, dev, verbose=False)
    model = get_network('LSTM_train', cfg).to(dev)
    params = ref_model.make_params(ctx.seed, dev,
                                   **common.model_dims(ctx.config))
    model.load_state_dict(params, strict=True)
    del params
    optimizer = make_optimizer(model, cfg)
    k, _ = _sizes(ctx)
    t1 = time.time()
    with full_f32():
        chunk = make_train_chunk(model, optimizer, cfg, compute_dtype(cfg),
                                 k, gather=True)
        stages = []
        for d in range(PROBE_DISPATCHES):
            losses = chunk(*store.arrays, idx[d])[0].tolist()
            stages.append({
                'losses': losses,
                'state': {key: v.detach().clone()
                          for key, v in model.state_dict().items()},
                'moments': tuple({key: v.detach().clone() for key, v in
                                  optimizer.moments[m].items()}
                                 for m in ('mu', 'nu'))})
        first = PROBE_DISPATCHES
        for d in range(first, first + WARM_DISPATCHES):
            chunk(*store.arrays, idx[d])
    ctx.records['program'] = stages
    ctx.records['setup_phases'] = {'store_and_model_s': t1 - t0,
                                   'probe_and_warm_s': time.time() - t1}
    return {'program': {'chunk': chunk, 'store': store, 'model': model,
                        'optimizer': optimizer},
            'idx': idx, 'labels': labels, 'res': res,
            'store_width': store.w_bucket,
            'next': first + WARM_DISPATCHES}


def window(ctx, state):
    from lstm_ctc_ocr_torch.engine.test import full_f32
    from lstm_ctc_ocr_torch.engine.train import (_finish_readback,
                                                 _start_readback)
    prog = state['program']
    chunk, store = prog['chunk'], prog['store']
    idx, first = state['idx'], state['next']
    k, b = _sizes(ctx)
    pending = []
    losses = []
    spans = ctx.spans
    trace_units = int(ctx.work['trace_units']) if ctx.trace else 0
    widths = [im.shape[1] for im in state['res']]
    label_lens = [len(s) for s in state['labels']]
    traced_rows = idx[first:first + trace_units].reshape(-1)
    ctx.records['trace_counts'] = {
        'steps': trace_units * k, 'batch': b,
        'widths': [widths[r] for r in traced_rows],
        'label_lens': [label_lens[r] for r in traced_rows],
        'store_width': state['store_width'],
        'num_hid': common.model_dims(ctx.config)['num_hid'],
        'nclasses': common.model_dims(ctx.config)['nclasses'],
        'dtype': ctx.config['cfg']['TRAIN']['DTYPE']}

    def drain():
        while pending:
            losses.extend(_finish_readback(pending.pop(0)))

    def step(i):
        rows = idx[(first + i) % len(idx)]
        with spans('solver.dispatch'):
            totals = chunk(*store.arrays, rows)[0]
        readback = _start_readback(totals)
        if pending:
            with spans('solver.readback'):
                losses.extend(_finish_readback(pending.pop(0)))
        pending.append(readback)

    with full_f32():
        units, secs, summary = closed_loop(ctx, step, drain, trace_units)
    ctx.records['attempted'] = units
    ctx.records['failed'] = int(sum(1 for v in losses if not np.isfinite(v)))
    return {'train_images_per_s': units * k * b / secs}, summary


def _batches(ctx, state, n_steps):
    """The probe steps' batches as the reference builds them: each row's
    image padded with zeros to the store's width, width-major, the labels
    dense and 0-padded, ``time_step = W // 4 - 1`` of its own width."""
    dev = torch.device(ctx.device)
    cfg_d = ctx.config['cfg']
    charset, l_max = cfg_d['CHARSET'], int(cfg_d['MAX_CHAR_LEN'])
    width = state['store_width']
    out = []
    for rows in state['idx'].reshape(-1, _sizes(ctx)[1])[:n_steps]:
        img = np.zeros((len(rows), width, 32), np.uint8)
        lab = np.zeros((len(rows), l_max), np.int64)
        lab_len = np.zeros(len(rows), np.int32)
        t_step = np.zeros(len(rows), np.int32)
        for j, r in enumerate(rows):
            im = state['res'][r]
            img[j, :im.shape[1]] = im.T
            code = common.encode(state['labels'][r], charset)
            lab[j, :len(code)] = code
            lab_len[j] = len(code)
            t_step[j] = im.shape[1] // 4 - 1
        out.append(tuple(torch.from_numpy(a).to(dev)
                         for a in (img, lab, lab_len, t_step)))
    return out


def hyper(config):
    t = config['cfg']['TRAIN']
    return {'lr': float(t['LEARNING_RATE']), 'gamma': float(t['GAMMA']),
            'stepsize': int(t['STEPSIZE']),
            'weight_decay': float(t['WEIGHT_DECAY']),
            'clip': float(t['GRAD_CLIP']),
            'bn_momentum': float(config['cfg']['BN_MOMENTUM'])}


def check(ctx, state):
    """The probe's dispatches, a stage each. The first stage starts from
    the seed's weights; each later one from the state in which the one
    before left the side judged (the program's, or what stands in its
    place), so that each stage compares ``STEPS_PER_DISPATCH`` steps and
    not the growing divergence of two trajectories."""
    from lstm_ctc_ocr_torch.engine.test import full_f32
    dev = torch.device(ctx.device)
    k, _ = _sizes(ctx)
    n_stages = PROBE_DISPATCHES
    batches = _batches(ctx, state, n_stages * k)
    hp = hyper(ctx.config)
    start = ref_model.make_params(ctx.seed, dev,
                                  **common.model_dims(ctx.config))
    moments = None
    gaps = {'loss_gap': 0.0, 'grad_gap': 0.0, 'update_gap': 0.0,
            'median_update_gap': 0.0}
    look = []
    for s in range(n_stages):
        stage = batches[s * k:(s + 1) * k]
        with full_f32():
            ref = ref_train.train_steps(start, stage, hp, moments=moments,
                                        count0=s * k)
            if ctx.produce is None:
                prog = ctx.records['program'][s]
                side = (prog['losses'], prog['moments'], prog['state'])
            else:
                prec = 'fp8' if ctx.produce == 'fp8' else None
                fault = None if ctx.produce == 'fp8' else ctx.produce
                side = ref_train.train_steps(start, stage, hp, prec=prec,
                                             fault=fault, moments=moments,
                                             count0=s * k)
        stage_gaps, stage_look = compare(side, ref, start)
        for n, v in stage_gaps.items():
            gaps[n] = max(gaps[n], v)
        look.append(stage_look)
        start = {key: v.float() for key, v in side[2].items()}
        moments = side[1]
    ctx.records['look'] = look
    lim = ctx.work['limits']
    return [(n, v, lim[n]) for n, v in gaps.items()]


def compare(side, ref, start):
    """One stage's numbers: the worst relative loss gap of its first
    ``LOSS_STEPS`` steps, the worst leaf's gap of Adam's first moment, and
    the worst and the median leaf's gap of each leaf's change."""
    losses, (mu, _), after = side
    ref_losses, (ref_mu, _), ref_after = ref
    n = LOSS_STEPS
    if len(losses) != len(ref_losses):
        losses = [float('inf')] * len(ref_losses)
    step_gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    quiet = common.quiet_leaves(ref_mu)
    grad_gap, grad_leaf = common.leaf_gap(mu, ref_mu, skip=quiet)
    delta = {key: after[key].float() - start[key] for key in start}
    ref_delta = {key: ref_after[key] - start[key] for key in start}
    changes = common.leaf_gaps(delta, ref_delta, skip=quiet)
    update_leaf = max(changes, key=changes.get)
    gaps = {'loss_gap': max(step_gaps[:n]), 'grad_gap': grad_gap,
            'update_gap': changes[update_leaf],
            'median_update_gap': float(np.median(list(changes.values())))}
    return gaps, {'step_loss_gaps': step_gaps, 'grad_leaf': grad_leaf,
                  'update_leaf': update_leaf}
