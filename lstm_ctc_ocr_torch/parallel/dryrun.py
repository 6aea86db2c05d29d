"""The multi-process dry run of data parallelism: the port's counterpart of
the JAX package's ``__graft_entry__.py:dryrun_multichip``.

``dryrun_multichip(n)`` starts ``n`` CPU processes joined by gloo and runs
three f32 Momentum train steps of the CRNN on tiny shapes through each of
the three data paths of ``parallel/mesh.py``: host batches cut per rank
(``make_parallel_train_step``), the replicated device store's gather of
each rank's rows of a global index array
(``make_parallel_train_step_gather``), and the sharded store's gather of
local ids from each rank's own block
(``make_parallel_train_step_gather_sharded``). Each path must give what one
process gives on the global batch: the same losses within 1e-5 relative,
and parameters and BN buffers within rtol 2e-5 / atol 2e-6 (the JAX
dry run's bar); and every rank must hold the same bits. Momentum, because it
is linear in the gradient: Adam's first steps turn reduction-order noise of
order 1e-7 into updates of order the learning rate. Several steps, because a
fault in replicated state (solver moments, BN buffers) shows from step 2.

The bar is only as good as the reference's conditioning: a trajectory that
passes near a tie of a max pool or a ReLU carries a rounding difference in
step 1 into a finite one by step 3, whatever computes it. So the dry run
also runs one process with every third parameter nudged by one ulp after
step 1, and raises if that control misses the bar. (With this model's head
at 64 or 512 units per direction the control misses, by 4.4e-6 in one
bias, on CPU; at 16 it holds, so the dry run uses 16.)

Run::

    python -m lstm_ctc_ocr_torch.parallel.dryrun [N]
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

STEPS, WIDTH = 3, 64
PATHS = ('host', 'replicated_store', 'sharded_store')


def _cfg():
    from ..config import load_cfg
    return load_cfg(None, ['TRAIN.DTYPE', "'float32'", 'TRAIN.SOLVER',
                           "'Momentum'", 'TRAIN.LEARNING_RATE', '0.001',
                           'TRAIN.GAMMA', '1.0', 'TRAIN.NUM_HID', '16'])


def _batches(batch):
    """The JAX dry run's three batches: f32 images [B, 64, 32], labels of
    4-6 ids in 1..19."""
    rng = np.random.RandomState(0)
    out = []
    for _ in range(STEPS):
        out.append((
            rng.rand(batch, WIDTH, 32).astype(np.float32),
            rng.randint(1, 20, size=(batch, 6)).astype(np.int32),
            rng.randint(4, 7, size=(batch,)).astype(np.int32),
            np.full((batch,), WIDTH // 4 - 1, np.int32)))
    return out


def _fresh(cfg):
    from ..engine.train import make_optimizer
    from ..models.factory import get_network
    model = get_network('LSTM_train', cfg, generator=torch.Generator()
                        .manual_seed(0)).train()
    return model, make_optimizer(model, cfg)


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@torch.no_grad()
def nudge(model, seed=0):
    """Move about a third of every parameter's nonzero entries up by one
    ulp (an exact zero stays: a bias at zero is a dead ReLU channel on
    every path, and a denormal would bring it to life)."""
    g = torch.Generator().manual_seed(seed)
    for p in model.parameters():
        up = torch.nextafter(p, torch.full_like(p, float('inf')))
        pick = (torch.rand(p.shape, generator=g).to(p.device) < 0.3) \
            & (p != 0)
        p.copy_(torch.where(pick, up, p))


def one_process(batch, nudged=False):
    """Three steps of one process on the global batches: (losses, state);
    ``nudged``: with :func:`nudge` after the first."""
    from ..engine.train import make_train_step
    cfg = _cfg()
    model, optimizer = _fresh(cfg)
    step = make_train_step(model, optimizer, cfg, None)
    losses = []
    for b in _batches(batch):
        losses.append(float(step(*(torch.from_numpy(a) for a in b))[0]))
        if nudged and len(losses) == 1:
            nudge(model)
    return losses, _state(model)


def check_against(what, losses, state, ref_losses, ref_state):
    """The dry run's bar: losses rtol 1e-5; state rtol 2e-5, atol 2e-6."""
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5,
                               err_msg='{}: losses'.format(what))
    for key, want in ref_state.items():
        np.testing.assert_allclose(
            state[key].numpy(), want.numpy(), rtol=2e-5, atol=2e-6,
            err_msg='{}: {} after {} steps'.format(what, key, STEPS))


def _rank_main(rank, n, init_file, out_dir):
    from . import mesh as pmesh
    torch.set_num_threads(1)
    pmesh.init_distributed('file://' + init_file, n, rank, device='cpu')
    try:
        mesh = pmesh.make_mesh('cpu')
        cfg = _cfg()
        batch = 2 * n
        batches = _batches(batch)
        # the replicated store: every batch's rows, global row ids
        store = tuple(torch.from_numpy(np.concatenate([b[i] for b in batches]))
                      for i in range(4))
        # the sharded store: block d holds rank d's rows of every batch
        b_dev = batch // n
        blocks = [np.stack([np.concatenate([b[i][d * b_dev:(d + 1) * b_dev]
                                            for b in batches])
                            for d in range(n)]) for i in range(4)]
        own = tuple(torch.from_numpy(a[pmesh.block_sharded(mesh)])
                    for a in blocks)
        results = {}
        for path in PATHS:
            model, optimizer = _fresh(cfg)
            pmesh.replicated(mesh, list(model.parameters())
                             + list(model.buffers()))
            if path == 'host':
                step = pmesh.make_parallel_train_step(model, optimizer, cfg,
                                                      None, mesh)
            elif path == 'replicated_store':
                step = pmesh.make_parallel_train_step_gather(
                    model, optimizer, cfg, None, mesh)
            else:
                step = pmesh.make_parallel_train_step_gather_sharded(
                    model, optimizer, cfg, None, mesh)
            losses = []
            for it in range(STEPS):
                if path == 'host':
                    args = pmesh.shard_batch(mesh, *batches[it])
                elif path == 'replicated_store':
                    idx = np.arange(it * batch, (it + 1) * batch,
                                    dtype=np.int32)
                    args = store + pmesh.shard_batch(mesh, idx)
                else:
                    idx = np.arange(it * b_dev, (it + 1) * b_dev,
                                    dtype=np.int32)
                    args = own + (torch.from_numpy(idx),)
                losses.append(float(step(*args)[0]))
            results[path] = (losses, _state(model))
        torch.save(results, os.path.join(out_dir, 'rank{}.pt'.format(rank)))
    finally:
        torch.distributed.destroy_process_group()


def dryrun_multichip(n_devices: int) -> dict:
    """Three DP steps over ``n_devices`` gloo CPU ranks on each data path,
    held to one process on the global batch; raises ``AssertionError`` on a
    mismatch. Returns the losses by path (and ``one_process``)."""
    import torch.multiprocessing as mp
    n = int(n_devices)
    ref_losses, ref_state = one_process(2 * n)
    check_against('the one-ulp control against one process',
                  *one_process(2 * n, nudged=True), ref_losses, ref_state)
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_main,
                           args=(n, os.path.join(tmp, 'init'), tmp),
                           nprocs=n, join=True, start_method='spawn')
        ranks = [torch.load(os.path.join(tmp, 'rank{}.pt'.format(r)))
                 for r in range(n)]
    out = {'one_process': ref_losses}
    for path in PATHS:
        losses, state = ranks[0][path]
        check_against(path + ' against one process', losses, state,
                      ref_losses, ref_state)
        for r in range(1, n):
            other_losses, other = ranks[r][path]
            if other_losses != losses or not all(
                    torch.equal(other[k], state[k]) for k in state):
                raise AssertionError('{}: rank {} differs from rank 0'.format(
                    path, r))
        out[path] = losses
        print('dryrun_multichip({}): {} path, {} steps, losses {} == one '
              'process {}; final parameters and BN buffers within 2e-5, '
              'ranks bit-identical'.format(
                  n, path, STEPS, ['{:.6f}'.format(t) for t in losses],
                  ['{:.6f}'.format(t) for t in ref_losses]), flush=True)
    return out


if __name__ == '__main__':
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
