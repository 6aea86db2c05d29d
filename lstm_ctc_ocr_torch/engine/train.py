"""Training: the train step, its solver, snapshot/restore and in-loop
validation.

Counterpart of the JAX package's ``engine/train.py`` for one device:

* loss = mean CTC over the feasible examples + the L2 collection
  (:func:`make_loss_fn`); bf16 compute casts the f32 master parameters per
  use (``models/layers.py``) and autograd carries the gradients back to
  them; the CTC runs in f32;
* the solver is written out by hand (:class:`Optimizer`) because optax and
  ``torch.optim`` differ in places: the global-norm clip has no epsilon and
  scales only at ``norm >= GRAD_CLIP``; RMS puts its epsilon inside the
  square root; the learning rate of an update is
  ``lr_schedule(count)`` with ``count`` starting at 0;
* the moving BN statistics are updated after the parameter update from the
  step's batch statistics, ``BN_MOMENTUM * old + (1 - BN_MOMENTUM) * new``,
  on buffers outside the optimizer;
* :class:`SolverWrapper` keeps the cadence: display, periodic snapshot,
  low-loss snapshot, validation on a cached batch (the first batch of an
  inline synthetic stream seeded ``RNG_SEED + 7``, whatever the training
  backend, as in the JAX solver), and the loss readback one step late so
  that the host does not wait for the device every step.

The step runs four hand-written CUDA kernels on a CUDA device — the BiLSTM
forward and backward, or with the stacked ``lstm`` head the unidirectional
LSTM forward and backward once per layer (``ops/rnn_cuda.py``), and the CTC
forward and backward (``ops/ctc_cuda.py``) — and their plain versions on the
CPU. The validation decode is greedy or beam, by ``DECODER``.

The training data comes from ``DATA_BACKEND``: ``synth`` (the default,
freshly rendered captchas from worker processes, ``data/gen.py``), ``pool``
(a pre-rendered pool, ``data/pool.py``) or ``records`` (a serialized
dataset, ``data/records.py``). Run::

    python -m lstm_ctc_ocr_torch.engine.train --cfg lstm/lstm.yml --iters N \\
        [--set RENDERER native ...] [--device cpu]

The device is CUDA unless ``--device cpu`` is given; without CUDA it raises
rather than fall back. Not ported yet, and raising ``NotImplementedError``
by name: ``TRAIN.STEPS_PER_DISPATCH`` > 1, ``DATA_DEVICE: on``,
``PARALLEL`` over several devices, ``.npy`` pre-train dicts and
``PROFILE_DIR``.
"""

from __future__ import annotations

import argparse
import os
import pprint
import sys
import time
from typing import Dict

import numpy as np
import torch

from ..config import get_log_dir, get_output_dir, load_cfg
from ..data.gen import get_batch
from ..data.records import RecordsDataset
from ..models.factory import get_network
from ..ops import ctc_cuda
from ..utils.metrics import accuracy_calculation
from . import checkpoint
from .summary import SummaryWriter
from .test import full_f32, make_decode_step, resolve_device

_DTYPES = {'bfloat16': torch.bfloat16, 'float32': None}


def lr_schedule(cfg, step: int) -> float:
    """lr = LEARNING_RATE * GAMMA^(step // STEPSIZE), in f32."""
    e = int(step) // int(cfg.TRAIN.STEPSIZE)
    return float(np.float32(cfg.TRAIN.LEARNING_RATE)
                 * np.power(np.float32(cfg.TRAIN.GAMMA), np.float32(e)))


class Optimizer:
    """Global-norm clip, then Adam, RMS or Momentum with the step-decay
    learning rate; the optax chain of the JAX package written out.

    ``moments`` maps each slot of the solver (``mu`` and ``nu`` for Adam,
    ``nu`` for RMS, ``trace`` for Momentum) to a dict of per-parameter f32
    tensors; ``count`` is the number of updates made. Parameters are
    updated in place. Nothing here reads a value back to the host.
    """

    _SLOTS = {'Adam': ('mu', 'nu'), 'RMS': ('nu',)}

    def __init__(self, named_params: Dict[str, torch.Tensor], cfg):
        self.cfg = cfg
        self.solver = str(cfg.TRAIN.SOLVER)
        self.names = list(named_params)
        self.params = [named_params[k] for k in self.names]
        self.count = 0
        self.moments = {
            slot: {k: torch.zeros_like(p) for k, p in named_params.items()}
            for slot in self._SLOTS.get(self.solver, ('trace',))}

    def _slot(self, slot):
        return [self.moments[slot][k] for k in self.names]

    @torch.no_grad()
    def step(self):
        """One update from the parameters' ``.grad``."""
        grads = [p.grad for p in self.params]
        # clip_by_global_norm: t -> (t / norm) * max_norm when norm >= max
        max_norm = float(self.cfg.TRAIN.GRAD_CLIP)
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        keep = norm < max_norm
        grads = torch._foreach_div(grads, torch.where(keep, 1.0, norm))
        torch._foreach_mul_(grads, torch.where(keep, 1.0, max_norm))

        lr = lr_schedule(self.cfg, self.count)
        count = self.count + 1
        if self.solver == 'Adam':
            b1, b2, eps = 0.9, 0.999, 1e-8
            mu, nu = self._slot('mu'), self._slot('nu')
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1.0 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
            denom = torch._foreach_div(nu, 1.0 - b2 ** count)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, eps)
            updates = torch._foreach_div(mu, 1.0 - b1 ** count)
            torch._foreach_div_(updates, denom)
        elif self.solver == 'RMS':
            decay, eps = 0.9, 1e-10
            nu = self._slot('nu')
            torch._foreach_mul_(nu, decay)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - decay)
            denom = torch._foreach_add(nu, eps)          # eps inside the root
            torch._foreach_sqrt_(denom)
            updates = torch._foreach_div(grads, denom)
        else:                                            # Momentum
            trace = self._slot('trace')
            torch._foreach_mul_(trace, float(self.cfg.TRAIN.MOMENTUM))
            torch._foreach_add_(trace, grads)
            updates = trace
        torch._foreach_add_(self.params, updates, alpha=-lr)
        self.count = count


def make_optimizer(model, cfg) -> Optimizer:
    return Optimizer(dict(model.named_parameters()), cfg)


def compute_dtype(cfg):
    return _DTYPES.get(str(cfg.TRAIN.DTYPE))


def make_loss_fn(model, cfg, dtype):
    """``loss_fn(image, label, label_len, time_step) -> (total, ctc,
    bn_batch)``: the mean CTC loss over the feasible examples plus the L2
    collection, and the BN layers' batch statistics."""
    weight_decay = float(cfg.TRAIN.WEIGHT_DECAY)

    def loss_fn(image, label, label_len, time_step):
        bn_batch = []      # bn=True convs deposit their batch mean/var here
        logits = model(image, time_step, dtype=dtype, bn_collect=bn_batch)
        losses = ctc_cuda.ctc_loss(logits.transpose(0, 1), label, label_len,
                                   time_step)
        # an infeasible alignment (input too short for the label) carries
        # the 1e30 sentinel and a zero gradient; average over the feasible
        # examples only so one degenerate sample cannot blow up the scalar
        feasible = losses < 1e29
        n_ok = torch.clamp(feasible.sum(), min=1)
        ctc = torch.where(feasible, losses, torch.zeros_like(losses)).sum() \
            / n_ok
        total = ctc + model.regularization_loss(weight_decay)
        return total, ctc, bn_batch
    return loss_fn


def make_train_step(model, optimizer, cfg, dtype):
    """``train_step(image, label, label_len, time_step) -> (total, ctc)``
    (device scalars): forward, backward, the solver's update, then the BN
    moving-statistics update. Updates ``model`` and ``optimizer`` in place."""
    loss_fn = make_loss_fn(model, cfg, dtype)
    momentum = float(cfg.BN_MOMENTUM)

    def train_step(image, label, label_len, time_step):
        model.zero_grad(set_to_none=True)
        total, ctc, bn_batch = loss_fn(image, label, label_len, time_step)
        total.backward()
        optimizer.step()
        with torch.no_grad():
            for layer, mean, var in bn_batch:
                layer.bn_mean.mul_(momentum).add_(mean, alpha=1.0 - momentum)
                layer.bn_var.mul_(momentum).add_(var, alpha=1.0 - momentum)
        return total.detach(), ctc.detach()
    return train_step


def effective_workers(requested: int) -> int:
    """Scale the worker count to the host: a 1-core host runs inline."""
    cores = os.cpu_count() or 1
    if cores <= 1:
        return 0
    return min(requested, max(cores - 1, 1))


def make_train_stream(cfg, batch_size):
    """The training batch stream of ``cfg.DATA_BACKEND``: 'synth' (fresh
    captchas from ``effective_workers(TRAIN.NUM_WORKERS)`` worker processes),
    'pool' (a pre-rendered pool with refresh) or 'records' (a serialized
    dataset). Seeded by ``RNG_SEED``."""
    backend = str(cfg.DATA_BACKEND)
    seed = int(cfg.RNG_SEED)
    if backend == 'records':
        ds = RecordsDataset(str(cfg.RECORDS_PATH), cfg,
                            cache_resized=bool(cfg.RECORDS_CACHE_RESIZED))
        print('records backend: {} examples from {}'.format(
            len(ds), cfg.RECORDS_PATH))
        return ds.batch_iterator(batch_size, shuffle=True, seed=seed)
    if backend == 'pool':
        from ..data.pool import PoolSampler
        return PoolSampler(cfg, int(cfg.POOL_SIZE), seed=seed) \
            .batch_iterator(batch_size)
    if backend != 'synth':
        raise ValueError('DATA_BACKEND={!r}: expected synth, pool or records'
                         .format(backend))
    workers = effective_workers(int(cfg.TRAIN.NUM_WORKERS))
    return get_batch(cfg, num_workers=workers, seed=seed,
                     batch_size=batch_size, bucketed=True)


def _check_ported(cfg, pre_train, device):
    """Raise by name for what is not ported yet."""
    if max(1, int(cfg.TRAIN.STEPS_PER_DISPATCH)) > 1:
        raise NotImplementedError('TRAIN.STEPS_PER_DISPATCH > 1 is not ported')
    if str(cfg.DATA_DEVICE) == 'on':
        raise NotImplementedError('DATA_DEVICE=on (the device-resident '
                                  'dataset) is not ported')
    if str(cfg.PARALLEL) != 'off' and device.type == 'cuda' \
            and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            'PARALLEL={!r} with {} devices: data parallelism is not ported; '
            'set PARALLEL off to train on one device'.format(
                cfg.PARALLEL, torch.cuda.device_count()))
    if pre_train and str(pre_train).endswith('.npy'):
        raise NotImplementedError('.npy pre-train dicts are not ported; pass '
                                  'a .ckpt.npz checkpoint')
    if str(cfg.PROFILE_DIR):
        raise NotImplementedError('PROFILE_DIR (utils/profiler.py) is not '
                                  'ported')


class SolverWrapper:
    """Training orchestrator. ``losses`` collects every step's total loss as
    it is read back."""

    def __init__(self, network, imgdb, pre_train, output_dir, logdir, cfg,
                 device='cuda'):
        self.net = network
        self.imgdb = imgdb
        self.pre_train = pre_train
        self.output_dir = output_dir
        self.cfg = cfg
        self.device = resolve_device(device)
        self.writer = SummaryWriter(logdir, flush_secs=5)
        self.optimizer = None
        self.losses = []

    def snapshot(self, step):
        # keep_every exempts the SNAPSHOT_ITERS cadence from pruning
        fname = checkpoint.save(self.net, self.optimizer, self.output_dir,
                                step, self.cfg, max_to_keep=100,
                                keep_every=int(self.cfg.TRAIN.SNAPSHOT_ITERS))
        print('Wrote snapshot to: {:s}'.format(fname))

    @full_f32()
    def train_model(self, max_iters, restore=False):
        cfg, dev = self.cfg, self.device
        _check_ported(cfg, self.pre_train, dev)
        dtype = compute_dtype(cfg)
        n = int(cfg.TRAIN.BATCH_SIZE)
        model = self.net.to(dev).train()
        self.optimizer = optimizer = make_optimizer(model, cfg)

        restore_iter = 1
        if restore:
            step = checkpoint.restore_latest(model, optimizer,
                                             self.output_dir)
            if not step:
                raise RuntimeError('restore requested but no checkpoint in {}'
                                   .format(self.output_dir))
            restore_iter = step
            print('Restored step {} from {}'.format(step, self.output_dir))
        elif self.pre_train:
            checkpoint.load_into(model, self.pre_train, need_bn_state=False,
                                 params_only=True)
            print('Loaded pre-trained weights from {}'.format(self.pre_train))

        train_step = make_train_step(model, optimizer, cfg, dtype)
        decode_step = make_decode_step(model, cfg, dev)
        train_gen = make_train_stream(cfg, n)

        def put(*arrays):
            return tuple(torch.from_numpy(a).to(dev, non_blocking=True)
                         for a in arrays)

        loss_min = float(cfg.TRAIN.LOSS_MIN_SNAPSHOT)
        val_batch = None

        def run_val(it):
            nonlocal val_batch
            if val_batch is None:
                # the same batch is validated every time
                val_gen = get_batch(cfg, num_workers=0,
                                    seed=int(cfg.RNG_SEED) + 7,
                                    batch_size=int(cfg.VAL.BATCH_SIZE),
                                    bucketed=True)
                val_batch = next(val_gen)
                val_gen.close()
            vb = val_batch
            dec = decode_step(vb.image, vb.time_step)
            org = [vb.label[i, :vb.label_len[i]].tolist()
                   for i in range(vb.label.shape[0])]
            acc = accuracy_calculation(org, dec.tolist(), ignore_value=0,
                                       print_num=int(cfg.VAL.PRINT_NUM))
            self.writer.add_scalar('val_accuracy', acc, it)
            print('accuracy: {:.5f}'.format(acc), flush=True)

        # The loss of step N is read back after step N+1 is submitted: by
        # then step N has finished on the device, so the readback does not
        # stall it and the host prepares the next batch while the device
        # runs. Snapshots and validation stay synchronous at their own
        # cadence, so a checkpoint named iter_K holds exactly the
        # post-step-K state; only the low-loss snapshot is decided one step
        # late, and is named for the step whose parameters it contains.
        pending = None                  # (it, total)

        def process_step(it, total, secs_per_iter, cur_end):
            nonlocal loss_min
            loss_val = float(total)
            self.losses.append(loss_val)
            self.writer.add_scalar('loss', loss_val, it)
            if it % cfg.TRAIN.DISPLAY == 0:
                # the schedule count before step `it` is it - 1
                print('iter: %d / %d, total loss: %.7f, lr: %.7f' %
                      (it, max_iters, loss_val, lr_schedule(cfg, it - 1)),
                      end=' ')
                print('speed: {:.3f}s / iter'.format(secs_per_iter),
                      flush=True)
            if loss_val < loss_min:
                print('loss: ', loss_val, end=' ')
                loss_min = loss_val
                self.snapshot(cur_end + 1)
                run_val(it)

        try:
            step_t0 = None
            it = restore_iter
            while it < max_iters:
                # wall time between successive submissions is the s/iter: the
                # step returns before the device finishes
                now = time.perf_counter()
                secs_per_iter = now - step_t0 if step_t0 is not None else 0.0
                step_t0 = now
                b = next(train_gen)
                total, _ = train_step(
                    *put(b.image, b.label, b.label_len, b.time_step))
                if pending is not None:
                    process_step(pending[0], pending[1], secs_per_iter,
                                 cur_end=it)
                pending = (it, total)
                if (it + 1) % cfg.TRAIN.SNAPSHOT_ITERS == 0:
                    self.snapshot(it + 1)
                if (it + 1) % cfg.VAL.VAL_STEP == 0:
                    run_val(it)
                it += 1
            if pending is not None:
                final_secs = time.perf_counter() - step_t0 \
                    if step_t0 is not None else 0.0
                process_step(pending[0], pending[1], final_secs,
                             cur_end=pending[0])
        finally:
            train_gen.close()
            self.writer.close()
        return model, optimizer


def train_net(network, imgdb, pre_train, output_dir, log_dir, cfg,
              max_iters=40000, restore=False, device='cuda'):
    """Train ``network`` in place; returns ``(model, optimizer, losses)``
    with ``losses`` the total loss of every step taken."""
    sw = SolverWrapper(network, imgdb, pre_train, output_dir, log_dir, cfg,
                       device=device)
    print('Solving...')
    model, optimizer = sw.train_model(max_iters, restore=restore)
    print('done solving')
    return model, optimizer, sw.losses


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Train the CRNN+CTC OCR model with the PyTorch port')
    parser.add_argument('--gpu', dest='gpu_id', default=0, type=int,
                        help='CUDA device index')
    parser.add_argument('--iters', dest='max_iters', default=1000000,
                        type=int, help='training iteration budget')
    parser.add_argument('--cfg', dest='cfg_file', default=None,
                        help='YAML experiment config merged over the defaults')
    parser.add_argument('--pre_train', default=None,
                        help='checkpoint (.ckpt.npz) to initialise from')
    parser.add_argument('--rand', dest='randomize', action='store_true',
                        help='skip the fixed RNG seed (non-reproducible run)')
    parser.add_argument('--network', dest='network_name',
                        default='LSTM_train', help='model name to build')
    parser.add_argument('--set', dest='set_cfgs', default=[], nargs='+',
                        help='dotted-path config overrides: KEY VALUE ...')
    parser.add_argument('--restore', default=0, type=int,
                        help='1: resume from the latest checkpoint in the '
                             'output dir')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    cfg = load_cfg(args.cfg_file, args.set_cfgs)
    print('Effective config:')
    pprint.pprint(cfg)
    device = args.device
    if device == 'cuda':
        device = 'cuda:{}'.format(args.gpu_id)
    gen = torch.Generator()
    if args.randomize:
        gen.seed()
    else:
        gen.manual_seed(int(cfg.RNG_SEED))
        np.random.seed(int(cfg.RNG_SEED))
    name = 'lstm_' + args.network_name.split('_')[-1]
    imgdb = {'path': str(cfg.RECORDS_PATH), 'name': name}
    output_dir = get_output_dir(cfg)
    log_dir = get_log_dir(cfg, name)
    print('checkpoints -> {:s}'.format(output_dir))
    print('tensorboard events -> {:s}'.format(log_dir))
    network = get_network(args.network_name, cfg, generator=gen)
    print('training model: {:s}'.format(args.network_name))
    train_net(network, imgdb, pre_train=args.pre_train,
              output_dir=output_dir, log_dir=log_dir, cfg=cfg,
              max_iters=args.max_iters, restore=bool(args.restore),
              device=device)
    return 0


if __name__ == '__main__':
    sys.exit(main())
