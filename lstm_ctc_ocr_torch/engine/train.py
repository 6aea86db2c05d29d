"""Training: the train step, its solver, snapshot/restore and in-loop
validation.

Counterpart of the JAX package's ``engine/train.py``:

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
  backend, as in the JAX solver), and the loss readback one dispatch late
  so that the host does not wait for the device every step;
* ``TRAIN.STEPS_PER_DISPATCH`` = K > 1 runs K steps per dispatch
  (:func:`make_train_chunk`), on a CUDA device as one CUDA graph per
  bucket, the counterpart of the JAX package's ``lax.scan`` programs;
  groups are clipped to the snapshot and validation boundaries and a
  bucket change in the host stream, and short groups take the eager step;
* ``DATA_DEVICE`` (``data/device_store.py``) keeps a pool or records
  dataset on the device, where each step gathers its batch by row index
  (:func:`make_train_step_gather`); ``auto`` takes it for those backends
  and says why when it does not;
* data parallelism (``parallel/mesh.py``): one process per GPU, started by
  torchrun or the JAX package's environment variables
  (``parallel/mesh.py:init_distributed``). A rank plays one JAX process with
  one device: ``TRAIN.BATCH_SIZE`` and ``VAL.BATCH_SIZE`` are global
  batches, each rank feeds ``B / world`` rows from streams seeded ``100003 *
  rank`` apart, ``DATA_DEVICE`` takes the sharded store (each rank its own
  partition), and the step all-reduces the BN statistics, the CTC mean and
  the gradients (:func:`make_loss_fn`, :func:`all_reduce_grads`); snapshots,
  summaries and display lines come from rank 0.

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

or, data parallel, one process per GPU::

    torchrun --nproc_per_node N -m lstm_ctc_ocr_torch.engine.train ...

The device is CUDA unless ``--device cpu`` is given (gloo between CPU
ranks); without CUDA it raises rather than fall back. ``PROFILE_DIR``
traces the steps ``[PROFILE_START, PROFILE_START + PROFILE_STEPS)`` with
``torch.profiler`` into a ``*.pt.trace.json`` under it
(``utils/profiler.py``). ``pre_train`` takes a checkpoint (``.ckpt.npz``)
or a ``.npy`` dict (``tools/convert_ckpt2npy.py``'s), the latter loaded
with ``ignore_missing`` as the JAX solver loads it
(``checkpoint.load_npy_pretrained``).

``network`` is any model with the CRNN's call contract: ``models/crnn.py``'s
fixed modules or a ``models/network.py`` DSL subclass. A DSL net's dropout
masks are keyed by ``RNG_SEED``, the layer and the step's index, read from
the solver's update count on the device (the JAX solver's ``fold_in(base,
it)``): K steps a dispatch, eager or as a CUDA graph, draw the masks of K
single steps, and a resumed run those of an uninterrupted one.
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
import torch.distributed as dist

from ..config import get_log_dir, get_output_dir, load_cfg
from ..data.device_store import make_device_feed, make_sharded_device_feed
from ..data.gen import get_batch
from ..data.records import RecordsDataset
from ..models.factory import get_network
from ..ops import ctc_cuda
from ..parallel import mesh as pmesh
from ..utils.metrics import accuracy_calculation
from ..utils.profiler import StepProfiler, count, span
from . import checkpoint
from . import graphs as cuda_graphs
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
    tensors. The number of updates made lives on the parameters' device
    (``count_t``, int32), and the learning rate and Adam's bias corrections
    are computed from it there, in f32 as optax computes them, so that a
    captured CUDA graph of the step advances them as eager steps do;
    ``count`` is its host mirror, for snapshots and the display. Parameters
    are updated in place. Nothing here reads a value back to the host.
    """

    _SLOTS = {'Adam': ('mu', 'nu'), 'RMS': ('nu',)}

    def __init__(self, named_params: Dict[str, torch.Tensor], cfg):
        self.cfg = cfg
        self.solver = str(cfg.TRAIN.SOLVER)
        self.names = list(named_params)
        self.params = [named_params[k] for k in self.names]
        dev = self.params[0].device if self.params else torch.device('cpu')
        self.moments = {
            slot: {k: torch.zeros_like(p) for k, p in named_params.items()}
            for slot in self._SLOTS.get(self.solver, ('trace',))}
        self._count = 0
        self.count_t = torch.zeros((), dtype=torch.int32, device=dev)

        def f32(v):
            return torch.tensor(float(v), dtype=torch.float32, device=dev)
        self._lr0 = f32(cfg.TRAIN.LEARNING_RATE)
        self._gamma = f32(cfg.TRAIN.GAMMA)
        self._betas = (f32(0.9), f32(0.999))

    @property
    def count(self) -> int:
        """Updates made (host mirror of ``count_t``)."""
        return self._count

    @count.setter
    def count(self, value):
        self._count = int(value)
        self.count_t.fill_(self._count)

    def advance(self, steps: int) -> None:
        """Move the host mirror on by ``steps`` updates that ran on the
        device without this object's Python (a CUDA graph's replay)."""
        self._count += int(steps)

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

        # lr_schedule(count) on the device
        epoch = torch.div(self.count_t, int(self.cfg.TRAIN.STEPSIZE),
                          rounding_mode='floor')
        lr = self._lr0 * torch.pow(self._gamma, epoch.float())
        if self.solver == 'Adam':
            b1, b2, eps = 0.9, 0.999, 1e-8
            count = (self.count_t + 1).float()
            mu, nu = self._slot('mu'), self._slot('nu')
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1.0 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
            # bias corrections 1 - b^count in f32 on the device
            denom = torch._foreach_div(
                nu, 1.0 - torch.pow(self._betas[1], count))
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, eps)
            updates = torch._foreach_div(
                mu, 1.0 - torch.pow(self._betas[0], count))
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
        # optax: params + (-lr * updates)
        torch._foreach_sub_(self.params, torch._foreach_mul(updates, lr))
        self.count_t.add_(1)
        self._count += 1


def make_optimizer(model, cfg) -> Optimizer:
    return Optimizer(dict(model.named_parameters()), cfg)


def compute_dtype(cfg):
    return _DTYPES.get(str(cfg.TRAIN.DTYPE))


def make_loss_fn(model, cfg, dtype, mesh=None, ctc_loss=None, count=None):
    """``loss_fn(image, label, label_len, time_step) -> (total, ctc,
    bn_batch)``: the mean CTC loss over the feasible examples plus the L2
    collection, and the BN layers' batch statistics. ``ctc_loss`` gives the
    per-example losses (``ops/ctc.py:ctc_loss``'s contract); None is the
    kernels' ``ctc_cuda.ctc_loss``, a comparison passes the plain version
    (``tools/attrib_step.py``). ``count``: the solver's update count on the
    device (``Optimizer.count_t``), read at each call; a model with dropout
    keys its masks by ``count + 1``, the step's index in the JAX solver.

    With a ``mesh`` (``parallel/mesh.py``) the batch is this rank's rows of
    the global batch: the BN statistics are the global batch's, and the CTC
    mean is over every rank's feasible examples, its value the same bits on
    every rank, its gradient into this rank's losses ``1 / n_global``, so
    that summing the ranks' gradients (:func:`all_reduce_grads`) gives the
    global loss's. The L2 term takes its gradient on rank 0 only, since
    every rank would add the same one; its value counts on every rank."""
    weight_decay = float(cfg.TRAIN.WEIGHT_DECAY)
    group = mesh.group if mesh is not None else None
    keyed = count is not None and getattr(model, 'has_dropout',
                                          lambda: False)()

    def loss_fn(image, label, label_len, time_step):
        bn_batch = []      # bn=True convs deposit their batch mean/var here
        extra = {'dropout_step': count + 1} if keyed else {}
        logits = model(image, time_step, dtype=dtype, bn_collect=bn_batch,
                       bn_group=group, **extra)
        losses = (ctc_loss or ctc_cuda.ctc_loss)(
            logits.transpose(0, 1), label, label_len, time_step)
        # an infeasible alignment (input too short for the label) carries
        # the 1e30 sentinel and a zero gradient; average over the feasible
        # examples only so one degenerate sample cannot blow up the scalar
        feasible = losses < 1e29
        total_loss = torch.where(feasible, losses,
                                 torch.zeros_like(losses)).sum()
        n_ok = feasible.sum()
        reg = model.regularization_loss(weight_decay)
        if group is not None:
            # one all-reduce of (sum, count); the global sum keeps its bits
            # and takes the gradient of this rank's sum (x - x is 0 exactly)
            both = torch.stack([total_loss.detach(), n_ok.float()])
            dist.all_reduce(both, group=group)
            total_loss = both[0] + (total_loss - total_loss.detach())
            n_ok = both[1]
            if mesh.rank != 0:
                reg = reg.detach()
        ctc = total_loss / torch.clamp(n_ok, min=1)
        total = ctc + reg
        return total, ctc, bn_batch
    return loss_fn


@torch.no_grad()
def all_reduce_grads(params, mesh):
    """Sum the parameters' ``.grad`` over the ranks in one flat buffer (one
    all-reduce, not one a tensor); each ``.grad`` becomes its view of the
    summed buffer."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    for p, g in zip(params, flat.split([g.numel() for g in grads])):
        p.grad = g.view_as(p)


def make_train_step(model, optimizer, cfg, dtype, mesh=None, loss_fn=None):
    """``train_step(image, label, label_len, time_step) -> (total, ctc)``
    (device scalars): forward, backward, the solver's update, then the BN
    moving-statistics update. Updates ``model`` and ``optimizer`` in place.
    With a ``mesh``: this rank's rows, the gradients summed over the ranks
    before the solver's clip (:func:`make_loss_fn`). ``loss_fn`` replaces
    :func:`make_loss_fn`'s (same contract), for a comparison."""
    if loss_fn is None:
        loss_fn = make_loss_fn(model, cfg, dtype, mesh,
                               count=optimizer.count_t)
    momentum = float(cfg.BN_MOMENTUM)

    def train_step(image, label, label_len, time_step):
        model.zero_grad(set_to_none=True)
        total, ctc, bn_batch = loss_fn(image, label, label_len, time_step)
        total.backward()
        if mesh is not None:
            all_reduce_grads(optimizer.params, mesh)
        optimizer.step()
        with torch.no_grad():
            for layer, mean, var in bn_batch:
                layer.bn_mean.mul_(momentum).add_(mean, alpha=1.0 - momentum)
                layer.bn_var.mul_(momentum).add_(var, alpha=1.0 - momentum)
        return total.detach(), ctc.detach()
    return train_step


def _gather(store_arrays, idx):
    """The batch of rows ``idx`` [N] from the device-resident store's
    ``(img, lab, lab_len, t_step)`` (the JAX ``jnp.take``)."""
    return tuple(a.index_select(0, idx) for a in store_arrays)


def make_train_step_gather(model, optimizer, cfg, dtype, mesh=None):
    """``step(img, lab, lab_len, t_step, idx) -> (total, ctc)``: the train
    step on the rows ``idx`` [N] int32 of the device-resident store
    (``data/device_store.py``), gathered on the device. The same step as
    :func:`make_train_step` by construction; with a ``mesh``, ``idx`` is
    this rank's rows of its store (the replicated store's global rows, or
    the sharded store's local ids)."""
    train_step = make_train_step(model, optimizer, cfg, dtype, mesh)

    def step(img, lab, lab_len, t_step, idx):
        return train_step(*_gather((img, lab, lab_len, t_step), idx))
    return step


def check_graph_collectives(mesh, device):
    """Raise where a CUDA graph cannot hold the step's collectives: NCCL
    ones can be captured, gloo's run on the host and cannot."""
    if mesh is not None and mesh.group is not None \
            and torch.device(device).type == 'cuda' and mesh.backend != 'nccl':
        raise ValueError(
            'TRAIN.STEPS_PER_DISPATCH > 1 on CUDA under a {} group: a CUDA '
            'graph cannot capture {} collectives; use NCCL, or '
            'TRAIN.STEPS_PER_DISPATCH 1'.format(mesh.backend, mesh.backend))


def make_train_chunk(model, optimizer, cfg, dtype, k, gather=False,
                     mesh=None):
    """K optimizer steps per dispatch (``TRAIN.STEPS_PER_DISPATCH``): the
    counterpart of the JAX package's ``lax.scan`` chunk programs
    (``make_train_chunk_step``, ``make_train_chunk_step_gather``), the same
    step as :func:`make_train_step` repeated ``k`` times.

    ``gather=False``: ``chunk(images, labels, label_lens, time_steps)``,
    host arrays stacked on a leading axis of ``k`` same-bucket batches
    (``[k, N, W, F]`` uint8 or f32, ``[k, N, L]``, ``[k, N]``, ``[k, N]``).
    ``gather=True``: ``chunk(img, lab, lab_len, t_step, idxs)``, the
    device-resident store's tensors and ``[k, N]`` int32 row indices on its
    device. Either returns ``(totals, ctcs)``, ``[k]`` device tensors.

    On a CUDA device the ``k`` steps run as one CUDA graph per input shape
    and store (one per bucket) from static input buffers: each dispatch
    copies its inputs in and replays. The first dispatch of a shape runs its
    ``k`` steps eagerly on the capture's side stream (the warm-up that sets
    up cuBLAS, cuDNN and the kernels' one-time attributes; they are real
    steps and count as such), then captures them without running them. A
    capture that fails raises; nothing falls back to eager steps. Replays
    add the launches their capture recorded to the wrappers' counters, the
    counts it made (such as ``rnn.layer_frames``) to the profiler's while
    a trace records, and ``k`` to ``optimizer.count``. On the CPU the ``k``
    steps run eagerly.
    Under a ``torch.profiler`` trace the input copy is the span
    ``solver.upload`` and a replay with its outputs' clone
    ``solver.replay``; every dispatch but a capture adds 1 to the counter
    ``solver.dispatches``.
    A DSL net's dropout keys its masks by the update count on the device,
    so a replay draws the masks of ``k`` single steps.

    With a ``mesh`` the steps are :func:`make_train_step`'s with it, on
    this rank's rows. A graph holds their NCCL collectives; the eager
    warm-up runs them first, so the communicator exists before the
    capture. A gloo group on CUDA raises (:func:`check_graph_collectives`).
    """
    check_graph_collectives(mesh, next(model.parameters()).device)
    train_step = make_train_step(model, optimizer, cfg, dtype, mesh)
    k = int(k)

    def body(inputs):
        totals, ctcs = [], []
        for j in range(k):
            if gather:
                batch = _gather(inputs[:4], inputs[4][j])
            else:
                batch = tuple(a[j] for a in inputs)
            total, ctc = train_step(*batch)
            totals.append(total)
            ctcs.append(ctc)
        return torch.stack(totals), torch.stack(ctcs)

    graphs = {}
    shared = {}                    # the side stream and the memory pool

    def capture(dev, static, key):
        side = shared.setdefault('stream', torch.cuda.Stream(dev))
        pool = shared.setdefault('pool', torch.cuda.graph_pool_handle())

        def steps():
            # the warm-up's are the real first k steps; a capture runs the
            # steps' Python but not the steps, so the host's step count is
            # put back there, as graphs.capture takes the launches aside
            before = optimizer.count
            try:
                return body(static)
            finally:
                if torch.cuda.is_current_stream_capturing():
                    optimizer.advance(before - optimizer.count)
        out, graphs[key] = cuda_graphs.capture(
            steps, static, side, pool,
            'the {}-step train program for inputs {}'.format(k, key))
        return out

    def chunk(*args):
        dev = next(model.parameters()).device
        if dev.type != 'cuda':
            count('solver.dispatches')
            with span('solver.upload'):
                inputs = tuple(torch.as_tensor(a).to(dev) for a in args)
            return body(inputs)
        if gather:
            store, idxs = args[:4], torch.as_tensor(args[4])
            key = ('gather', tuple(idxs.shape)) + tuple(
                (a.data_ptr(), tuple(a.shape), a.dtype) for a in store)
        else:
            arrays = [torch.as_tensor(a) for a in args]
            key = ('batch',) + tuple((tuple(a.shape), a.dtype)
                                     for a in arrays)
        g = graphs.get(key)
        if g is None:
            if gather:
                static = store + (torch.empty(idxs.shape, dtype=torch.int32,
                                              device=dev),)
            else:
                static = tuple(torch.empty(a.shape, dtype=a.dtype,
                                           device=dev) for a in arrays)
        else:
            static = g.inputs
        with span('solver.upload'):
            if gather:
                static[4].copy_(idxs, non_blocking=True)
            else:
                for dst, src in zip(static, arrays):
                    if src.device.type == 'cpu':
                        src = src.pin_memory()
                    dst.copy_(src, non_blocking=True)
        if g is None:
            return capture(dev, static, key)
        count('solver.dispatches')
        with span('solver.replay'):
            g.replay()
            optimizer.advance(k)
            return tuple(t.clone() for t in g.outputs)
    chunk.graphs = graphs
    return chunk


def effective_workers(requested: int) -> int:
    """Scale the worker count to the host: a 1-core host runs inline."""
    cores = os.cpu_count() or 1
    if cores <= 1:
        return 0
    return min(requested, max(cores - 1, 1))


def make_train_stream(cfg, batch_size, rank=0):
    """The training batch stream of ``cfg.DATA_BACKEND``: 'synth' (fresh
    captchas from ``effective_workers(TRAIN.NUM_WORKERS)`` worker processes),
    'pool' (a pre-rendered pool with refresh) or 'records' (a serialized
    dataset). Seeded ``RNG_SEED + 100003 * rank``: under data parallelism
    each rank feeds its own rows, as each JAX host does."""
    backend = str(cfg.DATA_BACKEND)
    seed = int(cfg.RNG_SEED) + 100003 * int(rank)
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


class BucketGroups:
    """Groups of consecutive same-bucket batches from a host stream, for the
    K-step program: ``take(target)`` returns up to ``target`` batches in
    stream order; a change of bucket ends a group early and the odd batch
    carries over into the next group."""

    def __init__(self, stream):
        self.stream = stream
        self._holdover = []          # batches taken back, in stream order

    def take(self, target):
        group = []
        while len(group) < target:
            b = self._holdover.pop(0) if self._holdover else next(self.stream)
            if group and b.image.shape[1] != group[0].image.shape[1]:
                self._holdover.insert(0, b)
                break
            group.append(b)
        return group

    def give_back(self, batches):
        """Return the tail of a group taken: the next ``take`` starts with
        it."""
        self._holdover[:0] = list(batches)


def stack_batches(group):
    """``(images, labels, label_lens, time_steps)`` of a same-bucket group,
    stacked on a leading axis: the host-batch chunk's inputs."""
    return tuple(np.stack([getattr(b, f) for b in group])
                 for f in ('image', 'label', 'label_len', 'time_step'))


def select_mesh(cfg, device):
    """The data-parallel mesh of a solver run, or None for the one-device
    step (the JAX solver's ``_select_mesh``, a rank for a device).

    Under a process group of several ranks: its mesh, or with ``PARALLEL
    off`` a ``ValueError``. One process: None (the one-device step, as the
    JAX solver takes at one device), but a ``ValueError`` where ``PARALLEL``
    is not ``off`` and the host has several GPUs, since one process drives
    one GPU: launch one process per GPU."""
    world = pmesh.world_size()
    if str(cfg.PARALLEL) == 'off':
        if world > 1:
            raise ValueError(
                "PARALLEL 'off' under a process group of {} ranks: every rank "
                'would train alone; launch one process, or set PARALLEL auto'
                .format(world))
        return None
    if world > 1:
        return pmesh.make_mesh(device)
    if device.type == 'cuda' and torch.cuda.device_count() > 1:
        raise ValueError(
            'PARALLEL={!r} with {} GPUs in one process: the port drives one '
            'GPU a process; launch one process per GPU (torchrun '
            '--nproc_per_node {} -m lstm_ctc_ocr_torch.engine.train ...), or '
            'set PARALLEL off to train on one'.format(
                cfg.PARALLEL, torch.cuda.device_count(),
                torch.cuda.device_count()))
    return None


def global_accuracy(local_acc: float, local_n: int, mesh=None) -> float:
    """The exact-match accuracy over every rank's rows from each rank's
    local score and row count (an all-gather of ``(acc * n, n)``); the
    identity without a mesh or at one rank."""
    if mesh is None or mesh.size == 1:
        return local_acc
    local = torch.tensor([local_acc * local_n, local_n], dtype=torch.float64)
    counts = mesh.all_gather(local)
    return float(counts[:, 0].sum() / counts[:, 1].sum())


class _NoWriter:
    """The summary writer of a rank other than 0: writes nothing."""

    def add_scalar(self, *args, **kwargs):
        pass

    def close(self):
        pass


def _start_readback(t):
    """Start copying ``t`` to the host behind the work queued before it;
    :func:`_finish_readback` waits for that copy alone (a plain ``.cpu()``
    would also wait for every step submitted since)."""
    if t.device.type != 'cuda':
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))
    return host, done


def _finish_readback(pending):
    host, done = pending
    if done is not None:
        with span('solver.readback_wait'):
            done.synchronize()
    return host.reshape(-1).tolist()


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
        # under data parallelism rank 0 writes the summaries and snapshots
        self.rank = dist.get_rank() if pmesh.world_size() > 1 else 0
        self.writer = (SummaryWriter(logdir, flush_secs=5) if self.rank == 0
                       else _NoWriter())
        self.optimizer = None
        self.losses = []

    def snapshot(self, step):
        if self.rank != 0:
            return
        # keep_every exempts the SNAPSHOT_ITERS cadence from pruning
        fname = checkpoint.save(self.net, self.optimizer, self.output_dir,
                                step, self.cfg, max_to_keep=100,
                                keep_every=int(self.cfg.TRAIN.SNAPSHOT_ITERS))
        print('Wrote snapshot to: {:s}'.format(fname))

    @full_f32()
    def train_model(self, max_iters, restore=False):
        cfg, dev = self.cfg, self.device
        mesh = select_mesh(cfg, dev)
        world, rank = (mesh.size, mesh.rank) if mesh is not None else (1, 0)
        lead = rank == 0                # prints the display lines
        dtype = compute_dtype(cfg)
        n, n_val = int(cfg.TRAIN.BATCH_SIZE), int(cfg.VAL.BATCH_SIZE)
        # each rank feeds its share of the global batches
        if n % world or n_val % world:
            raise ValueError(
                'TRAIN.BATCH_SIZE ({}) and VAL.BATCH_SIZE ({}) must both '
                'divide over the {} ranks, so that every rank feeds an equal '
                'share'.format(n, n_val, world))
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
        elif self.pre_train and str(self.pre_train).endswith('.npy'):
            checkpoint.load_npy_pretrained(model, self.pre_train,
                                           ignore_missing=True)
            print('Loaded pre-trained weights from {}'.format(self.pre_train))
        elif self.pre_train:
            checkpoint.load_into(model, self.pre_train, need_bn_state=False,
                                 params_only=True)
            print('Loaded pre-trained weights from {}'.format(self.pre_train))
        if mesh is not None:
            # every rank starts from rank 0's weights, BN buffers, moments,
            # update count and first step
            first = torch.tensor([restore_iter], dtype=torch.int64,
                                 device=dev)
            pmesh.replicated(mesh, list(model.parameters())
                             + list(model.buffers())
                             + [t for slot in optimizer.moments.values()
                                for t in slot.values()]
                             + [optimizer.count_t, first])
            optimizer.count = int(optimizer.count_t)
            restore_iter = int(first)
            if lead:
                print('data parallel over {} ranks ({}): {} rows a rank a '
                      'step'.format(world, mesh.backend, n // world))

        # the device-resident dataset (DATA_DEVICE): the pool or records
        # rows live on the device and each step gathers its batch by row
        # index. One process: the replicated store (DATA_DEVICE_LAYOUT
        # 'sharded' needs a mesh, so it is read as the JAX package reads it
        # on one device); several ranks: each holds its own partition, as
        # each JAX host does
        K = max(1, int(cfg.TRAIN.STEPS_PER_DISPATCH))
        if mesh is None:
            feed = make_device_feed(cfg, dev)
        else:
            feed = make_sharded_device_feed(cfg, n, mesh, dev)
        if feed is not None:
            step1 = make_train_step_gather(model, optimizer, cfg, dtype, mesh)
        else:
            step1 = make_train_step(model, optimizer, cfg, dtype, mesh)
        chunk = make_train_chunk(model, optimizer, cfg, dtype, K,
                                 gather=feed is not None,
                                 mesh=mesh) if K > 1 else None
        decode_step = make_decode_step(model, cfg, dev, mesh=mesh)
        # with a device feed the host stream is redundant (the feed owns the
        # backend's sampler and RNG streams)
        train_gen = None if feed is not None else \
            make_train_stream(cfg, n // world, rank)
        groups = BucketGroups(train_gen)

        def put(*arrays):
            return tuple(torch.from_numpy(a).to(dev, non_blocking=True)
                         for a in arrays)

        prof = StepProfiler(cfg=cfg, device=dev)
        loss_min = float(cfg.TRAIN.LOSS_MIN_SNAPSHOT)
        val_batch = None

        def run_val(it):
            nonlocal val_batch
            if val_batch is None:
                # the same batch is validated every time; each rank
                # validates its own rows, seeded apart like its stream
                val_gen = get_batch(cfg, num_workers=0,
                                    seed=int(cfg.RNG_SEED) + 7
                                    + 100003 * rank,
                                    batch_size=n_val // world, bucketed=True)
                val_batch = next(val_gen)
                val_gen.close()
            vb = val_batch
            dec = decode_step(vb.image, vb.time_step)
            org = [vb.label[i, :vb.label_len[i]].tolist()
                   for i in range(vb.label.shape[0])]
            acc = accuracy_calculation(
                org, dec.tolist(), ignore_value=0,
                print_num=int(cfg.VAL.PRINT_NUM) if lead else 0)
            acc = global_accuracy(acc, len(org), mesh)
            self.writer.add_scalar('val_accuracy', acc, it)
            if lead:
                print('accuracy: {:.5f}'.format(acc), flush=True)

        # A group is one dispatch: one step (K = 1, or a short group), or K
        # consecutive same-bucket steps as one CUDA graph. The losses of
        # group G are read back after group G+1 is submitted: by then G has
        # finished on the device, so the readback does not stall it and the
        # host prepares the next group while the device runs. Groups are
        # clipped so that snapshot and validation boundaries fall on a
        # group's end, where those stay synchronous: a checkpoint named
        # iter_K holds exactly the post-step-K state. Only the low-loss
        # snapshot is decided one group late, and is named for the step
        # whose parameters it contains.
        pending = None                  # (first_it, readback, group length)

        def process_group(first_it, readback, secs_per_iter, cur_end):
            nonlocal loss_min
            vals = _finish_readback(readback)        # one readback a group
            for j, loss_val in enumerate(vals):
                it = first_it + j
                self.losses.append(loss_val)
                self.writer.add_scalar('loss', loss_val, it)
                if lead and it % cfg.TRAIN.DISPLAY == 0:
                    # the schedule count before step `it` is it - 1
                    print('iter: %d / %d, total loss: %.7f, lr: %.7f' %
                          (it, max_iters, loss_val, lr_schedule(cfg, it - 1)),
                          end=' ')
                    print('speed: {:.3f}s / iter'.format(secs_per_iter),
                          flush=True)
            lo = min(vals)
            if lo < loss_min:
                if lead:
                    print('loss: ', lo, end=' ')
                loss_min = lo
                # the parameters are post-step cur_end: within a group the
                # trigger collapses to one snapshot
                self.snapshot(cur_end + 1)
                run_val(first_it + int(np.argmin(vals)))

        try:
            group_t0 = None
            it = restore_iter
            while it < max_iters:
                prof.step(it)
                # wall time between successive submissions is the s/iter:
                # a dispatch returns before the device finishes
                now = time.perf_counter()
                secs_per_iter = ((now - group_t0) / pending[2]
                                 if group_t0 is not None else 0.0)
                group_t0 = now
                target = min(
                    K, max_iters - it,
                    cfg.TRAIN.SNAPSHOT_ITERS - it % cfg.TRAIN.SNAPSHOT_ITERS,
                    cfg.VAL.VAL_STEP - it % cfg.VAL.VAL_STEP)
                if feed is not None:
                    # ship row indices, gather on the device
                    m = target if chunk is not None and target == K else 1
                    if m > 1:
                        totals = chunk(*feed.store.arrays,
                                       feed.chunk_indices(n, m))[0]
                    else:
                        totals = step1(*feed.store.arrays,
                                       feed.step_indices(n))[0].reshape(1)
                    feed.tick(m)
                else:
                    group = groups.take(K if target == K else 1)
                    m = len(group)
                    if mesh is not None and K > 1:
                        # a bucket change ends one rank's group early: every
                        # rank runs the shortest, the rest waits its turn
                        m = mesh.all_min(m)
                        groups.give_back(group[m:])
                        group = group[:m]
                    if chunk is not None and m == K:
                        totals = chunk(*stack_batches(group))[0]
                    else:
                        totals = torch.stack([
                            step1(*put(b.image, b.label, b.label_len,
                                       b.time_step))[0] for b in group])
                readback = _start_readback(totals)
                if pending is not None:
                    process_group(pending[0], pending[1], secs_per_iter,
                                  cur_end=it + m - 1)
                pending = (it, readback, m)
                it_end = it + m - 1
                if (it_end + 1) % cfg.TRAIN.SNAPSHOT_ITERS == 0:
                    self.snapshot(it_end + 1)
                if (it_end + 1) % cfg.VAL.VAL_STEP == 0:
                    run_val(it_end)
                it += m
            if pending is not None:
                final_secs = ((time.perf_counter() - group_t0) / pending[2]
                              if group_t0 is not None else 0.0)
                process_group(pending[0], pending[1], final_secs,
                              cur_end=pending[0] + pending[2] - 1)
        finally:
            prof.close()
            if train_gen is not None:
                train_gen.close()
            if feed is not None:
                feed.store.flush_refresh()
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
                        help='checkpoint (.ckpt.npz) or .npy dict to '
                             'initialise from')
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
                        help="'cuda' (default) or 'cpu' (gloo between ranks)")
    args = parser.parse_args(argv)
    cfg = load_cfg(args.cfg_file, args.set_cfgs)
    # a rank of torchrun (or of the JAX package's variables) joins its
    # group here; one process alone goes on as before
    owned = not dist.is_initialized()
    pmesh.init_distributed(device=args.device)
    try:
        return _main(args, cfg)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


def _main(args, cfg):
    if not dist.is_initialized() or dist.get_rank() == 0:
        print('Effective config:')
        pprint.pprint(cfg)
    device = args.device
    if device == 'cuda':
        device = 'cuda:{}'.format(torch.cuda.current_device()
                                  if dist.is_initialized() else args.gpu_id)
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
