"""Driver ``train_store_htr``: ``train_store``'s closed loop of K-step
dispatches on the device-resident store, for Puigcerver's handwriting model
(``NET_NAME htr``, ``reference/htr.py``): lines at the configuration's
``IMG_HEIGHT``, ``W // 8`` frames, dropout on.

Parameters (the workload file): ``data_dir``, ``trace_units`` and
``limits``, as ``train_store``'s. The weights are drawn from the seed
(``reference/htr.py:make_params``) and handed to both sides, and the seed
is the program's ``RNG_SEED`` too, which keys the dropout masks that both
sides draw at each step's update count. The rows a step, the window, the
readbacks and the comparison (the probe's two dispatches, a stage each,
:func:`train_store.compare`) are ``train_store``'s.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import common
from benchmark.reference import htr as ref_htr
from benchmark.traffic import train_store
from benchmark.traffic.train_store import (PROBE_DISPATCHES, WARM_DISPATCHES,
                                           _indices, _rows, _sizes)


def dims(config):
    """The reference's sizes, from the configuration."""
    c = config['cfg']
    return dict(nchannels=int(c['NCHANNELS']),
                num_hid=int(c['TRAIN']['NUM_HID']),
                num_layers=int(c['TRAIN']['NUM_LAYERS']),
                nclasses=int(c['NCLASSES']), height=int(c['IMG_HEIGHT']))


def setup(ctx):
    from lstm_ctc_ocr_torch.data.device_store import DeviceStore
    from lstm_ctc_ocr_torch.engine.test import full_f32
    from lstm_ctc_ocr_torch.engine.train import (compute_dtype,
                                                 make_optimizer,
                                                 make_train_chunk)
    from lstm_ctc_ocr_torch.models.factory import get_network

    cfg = common.port_cfg(ctx.config)
    cfg.RNG_SEED = ctx.seed
    dev = torch.device(ctx.device)
    t0 = time.time()
    labels, res = _rows(ctx)
    idx = _indices(ctx, len(res))
    store = DeviceStore(res, labels, 'uniform', np.random.RandomState(0),
                        cfg, dev, verbose=False)
    model = get_network('LSTM_train', cfg).to(dev)
    model.load_state_dict(ref_htr.make_params(ctx.seed, dev,
                                              **dims(ctx.config)),
                          strict=True)
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
    """``train_store.window``; the traced counts also give the stack's
    depth and the lines' height, which the ``htr.*`` readers take."""
    values, summary = train_store.window(ctx, state)
    if summary is not None:
        d = dims(ctx.config)
        summary['counts'].update(num_layers=d['num_layers'],
                                 height=d['height'])
    return values, summary


def _batches(ctx, state, n_steps):
    """The probe steps' batches as the reference builds them: each row's
    image padded with zeros to the store's width, width-major at the
    configuration's height, the labels dense and 0-padded, ``time_step =
    W // 8`` of its own width."""
    dev = torch.device(ctx.device)
    cfg_d = ctx.config['cfg']
    charset, l_max = cfg_d['CHARSET'], int(cfg_d['MAX_CHAR_LEN'])
    width, height = state['store_width'], int(cfg_d['IMG_HEIGHT'])
    out = []
    for rows in state['idx'].reshape(-1, _sizes(ctx)[1])[:n_steps]:
        img = np.zeros((len(rows), width, height), np.uint8)
        lab = np.zeros((len(rows), l_max), np.int64)
        lab_len = np.zeros(len(rows), np.int32)
        t_step = np.zeros(len(rows), np.int32)
        for j, r in enumerate(rows):
            im = state['res'][r]
            img[j, :im.shape[1]] = im.T
            code = common.encode(state['labels'][r], charset)
            lab[j, :len(code)] = code
            lab_len[j] = len(code)
            t_step[j] = im.shape[1] // 8
        out.append(tuple(torch.from_numpy(a).to(dev)
                         for a in (img, lab, lab_len, t_step)))
    return out


def check(ctx, state):
    """``train_store.check`` with this model's reference: the probe's
    dispatches, a stage each, every later stage from the state in which the
    one before left the side judged."""
    from lstm_ctc_ocr_torch.engine.test import full_f32
    dev = torch.device(ctx.device)
    k, _ = _sizes(ctx)
    batches = _batches(ctx, state, PROBE_DISPATCHES * k)
    hp = train_store.hyper(ctx.config)
    start = ref_htr.make_params(ctx.seed, dev, **dims(ctx.config))
    moments = None
    gaps = {'loss_gap': 0.0, 'grad_gap': 0.0, 'update_gap': 0.0,
            'median_update_gap': 0.0}
    look = []
    for s in range(PROBE_DISPATCHES):
        stage = batches[s * k:(s + 1) * k]
        with full_f32():
            ref = ref_htr.train_steps(start, stage, hp, ctx.seed,
                                      moments=moments, count0=s * k)
            if ctx.produce is None:
                prog = ctx.records['program'][s]
                side = (prog['losses'], prog['moments'], prog['state'])
            else:
                prec = 'fp8' if ctx.produce == 'fp8' else None
                fault = None if ctx.produce == 'fp8' else ctx.produce
                side = ref_htr.train_steps(start, stage, hp, ctx.seed,
                                           prec=prec, fault=fault,
                                           moments=moments, count0=s * k)
        stage_gaps, stage_look = train_store.compare(side, ref, start)
        for n, v in stage_gaps.items():
            gaps[n] = max(gaps[n], v)
        look.append(stage_look)
        start = {key: v.float() for key, v in side[2].items()}
        moments = side[1]
    ctx.records['look'] = look
    lim = ctx.work['limits']
    return [(n, v, lim[n]) for n, v in gaps.items()]
