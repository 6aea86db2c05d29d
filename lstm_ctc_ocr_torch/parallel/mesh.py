"""Data parallelism over ``torch.distributed``: the port's counterpart of the
JAX package's ``parallel/mesh.py``.

JAX runs one SPMD program over a mesh of devices: the batch is sharded on
the ``data`` axis, parameters and solver state are replicated, and XLA
inserts the gradient ``psum`` and the all-reduce of the batch-norm batch
statistics from the sharding annotations. Torch runs one process per GPU,
so a rank of the port plays the part of one JAX *process* (host) with one
device, and the cross-rank work the sharding annotations implied is written
out where it happens:

* the BN batch statistics are all-reduced inside the layer
  (``models/layers.py:batch_moments``), autograd flowing through them;
* the CTC mean runs over the global batch: the feasible-loss sum and the
  feasible count are all-reduced (``engine/train.py:make_loss_fn``);
* the gradients are summed over the ranks in one flat buffer before the
  solver's global-norm clip (``engine/train.py:all_reduce_grads``), so every
  rank clips the same norm and keeps the same parameters, moments, BN
  buffers and count; the L2 term's gradient is taken on rank 0 only.

The JAX names map as follows. A JAX sharding says which part of a global
array a device holds; here the same name gives the index that picks a
rank's part (``batch_sharded``: the rank's rows of a global batch,
``chunk_sharded``: the same rows of a ``[K, B, ...]`` chunk,
``block_sharded``: the rank's block of ``[D, R, ...]`` block arrays), and
``replicated`` makes every rank's copy of some tensors equal to rank 0's
(the ``device_put(x, replicated(mesh))`` of a JAX solver).
``make_mesh`` returns a :class:`Mesh`: the process group, its world size,
this rank and its device. Each ``make_parallel_*`` factory delegates to the
port's one-device factory in ``engine/train.py`` or ``engine/test.py`` with
the mesh, as the JAX ones delegate with sharding annotations, so the
one-device and the data-parallel step are one program.

Every factory takes the rank's part of its inputs: ``shard_batch`` /
``shard_chunk`` cut it from a global batch that every rank holds (the
JAX single-process mesh: one stream, cut on the batch axis), and
``shard_host_batch`` / ``shard_host_chunk`` take a local batch as it is
(the JAX multi-host path, each host feeding its own rows).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """The ranks of a data-parallel run: ``group`` (a ``torch.distributed``
    process group, or None for one process on its own), ``size``, ``rank``,
    ``backend`` ('nccl', 'gloo' or None) and ``device``, where this rank's
    model and batches live: this process's CUDA device unless another is
    given, and without CUDA a ``RuntimeError`` (:func:`cuda_device`)."""

    def __init__(self, group=None, device=None):
        self.group = group
        self.device = torch.device(device) if device is not None \
            else cuda_device()
        if group is None:
            self.size, self.rank, self.backend = 1, 0, None
        else:
            self.size = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
            self.backend = str(dist.get_backend(group))

    def __repr__(self):
        return 'Mesh(rank {} of {}, {}, {})'.format(
            self.rank, self.size, self.backend, self.device)

    @property
    def comm_device(self) -> torch.device:
        """Where a host value is put for a collective: NCCL takes CUDA
        tensors only, gloo takes CPU tensors everywhere."""
        if self.backend == 'nccl':
            return self.device
        return torch.device('cpu')

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``[size, *t.shape]``: every rank's ``t`` (same shape and dtype on
        every rank), in rank order, on ``t``'s device."""
        if self.group is None:
            return t.unsqueeze(0)
        src = t.to(self.comm_device).contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return torch.stack(parts).to(t.device)

    def all_max(self, value: int) -> int:
        """The largest of every rank's ``value``."""
        return self._all_reduce_int(value, dist.ReduceOp.MAX)

    def all_min(self, value: int) -> int:
        """The smallest of every rank's ``value``."""
        return self._all_reduce_int(value, dist.ReduceOp.MIN)

    def _all_reduce_int(self, value, op) -> int:
        if self.group is None:
            return int(value)
        t = torch.tensor([int(value)], dtype=torch.int64,
                         device=self.comm_device)
        dist.all_reduce(t, op=op, group=self.group)
        return int(t.item())


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device='cuda', backend: Optional[str] = None) -> int:
    """Start this process's rank of a multi-process run; returns the world
    size.

    The arguments default to the JAX package's environment variables
    (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``),
    then to torchrun's (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``). A coordinator ``host:port`` becomes ``tcp://host:port``; an
    address with a scheme (``tcp://``, ``file://``) is used as it is; with
    no address, torchrun's ``env://``. The backend is NCCL on CUDA and gloo
    on the CPU unless ``backend`` says otherwise (gloo also takes CUDA
    tensors, for several ranks on one card). On CUDA the rank binds
    ``cuda:LOCAL_RANK`` (0 where ``LOCAL_RANK`` is unset) unless ``device``
    names an index. Nothing configured: a no-op that returns 1, so entry
    points call it unconditionally; an initialised group: its world size.
    """
    if dist.is_initialized():
        return dist.get_world_size()
    env = os.environ
    coord = coordinator_address or env.get('JAX_COORDINATOR_ADDRESS')
    if num_processes is None:
        num_processes = env.get('JAX_NUM_PROCESSES', env.get('WORLD_SIZE'))
    if process_id is None:
        process_id = env.get('JAX_PROCESS_ID', env.get('RANK'))
    if coord is None and 'MASTER_ADDR' not in env:
        if num_processes is not None and int(num_processes) > 1:
            raise ValueError('{} processes but no coordinator address (pass '
                             'one, or set JAX_COORDINATOR_ADDRESS or '
                             'MASTER_ADDR)'.format(num_processes))
        return 1
    if num_processes is None or process_id is None:
        raise ValueError('a coordinator but no process count or id (set '
                         'JAX_NUM_PROCESSES and JAX_PROCESS_ID, or run under '
                         'torchrun)')
    if coord is None:
        init_method = 'env://'
    elif '://' in coord:
        init_method = coord
    else:
        init_method = 'tcp://' + coord
    dev = torch.device(device)
    kwargs = {}
    if dev.type == 'cuda':
        if dev.index is None:
            dev = torch.device('cuda', int(env.get('LOCAL_RANK', 0)))
        torch.cuda.set_device(dev)
    backend = backend or ('nccl' if dev.type == 'cuda' else 'gloo')
    if backend == 'nccl':
        kwargs['device_id'] = dev
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(num_processes),
                            rank=int(process_id), **kwargs)
    return dist.get_world_size()


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose backward sums the gradient over the ranks:
    rank r's input feeds every rank's output."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over the ranks of ``group``, differentiable."""
    return _AllReduceSum.apply(t, group)


def cuda_device() -> torch.device:
    """This process's CUDA device; raises where there is none, as the entry
    points do (``engine/test.py:resolve_device``)."""
    if not torch.cuda.is_available():
        raise RuntimeError('CUDA is not available; pass device="cpu" to run '
                           'the mesh on the CPU')
    return torch.device('cuda', torch.cuda.current_device())


def make_mesh(device=None) -> Mesh:
    """The mesh of every rank of the default group (none initialised: one
    process on its own). ``device`` defaults to this process's CUDA device,
    and raises without one; the CPU comes only when asked for
    (``device='cpu'``) or from a gloo group on a host without CUDA, which
    can only have been made on the CPU. On a host with CUDA, a gloo group
    made for CPU tensors passes ``'cpu'``."""
    group = None
    if dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if device is None and group is not None \
            and str(dist.get_backend(group)) == 'gloo' \
            and not torch.cuda.is_available():
        device = 'cpu'
    return Mesh(group, device)


def world_size() -> int:
    """Ranks in the default group; 1 where none is initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def batch_sharded(mesh: Mesh, n: int):
    """The index of this rank's rows ``[r*n/D, (r+1)*n/D)`` of a global
    batch of ``n`` on axis 0; ``n`` must divide over the ranks."""
    if n % mesh.size:
        raise ValueError('a global batch of {} does not divide over {} ranks'
                         .format(n, mesh.size))
    b = n // mesh.size
    return (slice(mesh.rank * b, (mesh.rank + 1) * b),)


def chunk_sharded(mesh: Mesh, n: int):
    """``batch_sharded`` on axis 1 of a ``[K, n, ...]`` chunk."""
    return (slice(None),) + batch_sharded(mesh, n)


def block_sharded(mesh: Mesh):
    """The index of this rank's block of ``[D, R, ...]`` block arrays."""
    return (mesh.rank,)


def _put(mesh: Mesh, a) -> torch.Tensor:
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(mesh.device)


def shard_batch(mesh: Mesh, *arrays):
    """This rank's rows of global batches (numpy or tensors, axis 0), as
    tensors on the mesh's device."""
    return tuple(_put(mesh, a[batch_sharded(mesh, a.shape[0])])
                 for a in arrays)


def shard_chunk(mesh: Mesh, *arrays):
    """This rank's rows of global ``[K, B, ...]`` chunks (axis 1)."""
    return tuple(_put(mesh, a[chunk_sharded(mesh, a.shape[1])])
                 for a in arrays)


def shard_host_batch(mesh: Mesh, *arrays):
    """A rank's local batches as they are (each rank feeds its own rows),
    as tensors on the mesh's device."""
    return tuple(_put(mesh, a) for a in arrays)


def shard_host_chunk(mesh: Mesh, *arrays):
    """A rank's local ``[K, B/D, ...]`` chunks as they are."""
    return shard_host_batch(mesh, *arrays)


@torch.no_grad()
def replicated(mesh: Mesh, tensors: Sequence[torch.Tensor]):
    """Make every rank's ``tensors`` equal to rank 0's, in place (a
    broadcast each); returns them."""
    if mesh.group is not None:
        for t in tensors:
            dist.broadcast(t, src=dist.get_global_rank(mesh.group, 0),
                           group=mesh.group)
    return tensors


def gather_rows(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``t`` (the rank's part of a batch, the same
    shape on every rank) concatenated in rank order: the global batch's
    rows back in their order."""
    parts = mesh.all_gather(t)
    return parts.reshape((-1,) + tuple(t.shape[1:]))


def make_parallel_train_step(model, optimizer, cfg, dtype, mesh: Mesh):
    """The DP train step: ``step(image, label, label_len, time_step)`` on
    this rank's rows (``shard_batch`` / ``shard_host_batch``); global BN
    statistics and CTC mean, gradients summed over the ranks."""
    from ..engine.train import make_train_step
    return make_train_step(model, optimizer, cfg, dtype, mesh=mesh)


def make_parallel_train_chunk_step(model, optimizer, cfg, dtype, mesh: Mesh,
                                   n_steps: int):
    """K DP steps a dispatch on ``[K, B/D, ...]`` chunks of this rank's rows
    (``shard_chunk`` / ``shard_host_chunk``)."""
    from ..engine.train import make_train_chunk
    return make_train_chunk(model, optimizer, cfg, dtype, n_steps, mesh=mesh)


def make_parallel_train_step_gather(model, optimizer, cfg, dtype, mesh: Mesh):
    """The DP step on the replicated store: every rank holds the whole store
    and gathers its rows of the global ``[N]`` index array (``shard_batch``
    of it, or a replicated feed's ``step_indices`` under a mesh)."""
    from ..engine.train import make_train_step_gather
    return make_train_step_gather(model, optimizer, cfg, dtype, mesh=mesh)


def make_parallel_train_chunk_step_gather(model, optimizer, cfg, dtype,
                                          mesh: Mesh, n_steps: int):
    """K DP steps a dispatch on the replicated store: ``[K, N/D]`` index
    rows, this rank's part of the global ``[K, N]``."""
    from ..engine.train import make_train_chunk
    return make_train_chunk(model, optimizer, cfg, dtype, n_steps,
                            gather=True, mesh=mesh)


def make_parallel_train_step_gather_sharded(model, optimizer, cfg, dtype,
                                            mesh: Mesh):
    """The DP step on the sharded store (``data/device_store.py:
    ShardedDeviceStore``): this rank's ``R``-row block and ``[B/D]`` local
    row ids; no rank reads another's rows."""
    from ..engine.train import make_train_step_gather
    return make_train_step_gather(model, optimizer, cfg, dtype, mesh=mesh)


def make_parallel_train_chunk_step_gather_sharded(model, optimizer, cfg,
                                                  dtype, mesh: Mesh,
                                                  n_steps: int):
    """K DP steps a dispatch on the sharded store: ``[K, B/D]`` local ids."""
    from ..engine.train import make_train_chunk
    return make_train_chunk(model, optimizer, cfg, dtype, n_steps,
                            gather=True, mesh=mesh)


def make_parallel_decode_step(model, cfg, mesh: Mesh):
    """The DP decode step: this rank's rows in, its decoded ids out (numpy),
    under ``BN_EVAL: batch`` with the statistics of every rank's rows;
    ``gather_rows`` puts the global batch's ids back together."""
    from ..engine.test import make_decode_step
    return make_decode_step(model, cfg, mesh.device, mesh=mesh)
