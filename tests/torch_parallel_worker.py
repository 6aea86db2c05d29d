"""Rank bodies for the port's data-parallel tests (not a test file).

``run_ranks(tmp_path, name, world, **kwargs)`` starts ``world`` spawned CPU
processes joined by gloo through a ``file://`` rendezvous under
``tmp_path`` (so parallel test workers never contend for a port); rank r
runs ``name(mesh, **kwargs)`` from this module and its return value comes
back as element r of the list. This module imports torch and the port
only: the ranks never load JAX.
"""

import os
import shutil

import numpy as np
import torch

from lstm_ctc_ocr_torch.config import load_cfg
from lstm_ctc_ocr_torch.engine import train
from lstm_ctc_ocr_torch.models.factory import get_network
from lstm_ctc_ocr_torch.parallel import mesh as pmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YML = os.path.join(REPO, 'lstm', 'lstm.yml')


def _entry(rank, world, tmp, name, kwargs):
    torch.set_num_threads(1)
    pmesh.init_distributed('file://' + os.path.join(tmp, 'rendezvous'),
                           world, rank, device='cpu')
    try:
        out = globals()[name](pmesh.make_mesh('cpu'), **kwargs)
        torch.save(out, os.path.join(tmp, 'result{}.pt'.format(rank)))
    finally:
        torch.distributed.destroy_process_group()


def run_ranks(tmp_path, name, world=2, **kwargs):
    import torch.multiprocessing as mp
    tmp = str(tmp_path / 'ranks_{}'.format(name))
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    mp.start_processes(_entry, args=(world, tmp, name, kwargs), nprocs=world,
                       join=True, start_method='spawn')
    return [torch.load(os.path.join(tmp, 'result{}.pt'.format(r)),
                       weights_only=False) for r in range(world)]


def port_cfg(*overrides):
    """lstm.yml in f32 with a 16-unit head, Momentum at lr 1e-3 and the
    overrides."""
    return load_cfg(YML, ['TRAIN.DTYPE', "'float32'", 'TRAIN.NUM_HID', '16',
                          'TRAIN.SOLVER', "'Momentum'",
                          'TRAIN.LEARNING_RATE', '0.001', 'TRAIN.GAMMA',
                          '1.0'] + list(overrides))


def model_from(cfg, state_path):
    model = get_network('LSTM_train', cfg)
    model.load_state_dict(torch.load(state_path))
    return model.train()


def state_of(model, optimizer=None):
    out = {k: v.detach().clone() for k, v in model.state_dict().items()}
    if optimizer is not None:
        for slot, tensors in optimizer.moments.items():
            for k, t in tensors.items():
                out['{}/{}'.format(slot, k)] = t.detach().clone()
        out['count'] = optimizer.count_t.clone()
    return out


# ---- rank bodies -----------------------------------------------------------

def dp_steps(mesh, state_path, batches, overrides=()):
    """Three DP steps on this rank's rows of the global ``batches``."""
    cfg = port_cfg(*overrides)
    model = model_from(cfg, state_path)
    optimizer = train.make_optimizer(model, cfg)
    step = pmesh.make_parallel_train_step(model, optimizer, cfg, None, mesh)
    losses, first = [], None
    for b in batches:
        losses.append(float(step(*pmesh.shard_batch(mesh, *b))[0]))
        if first is None:             # Momentum's trace: the clipped g
            first = {k: t.clone()
                     for k, t in optimizer.moments['trace'].items()}
    return losses, state_of(model, optimizer), first


def dp_variants(mesh, state_path, batches, k):
    """The chunk and gather variants on the same global batches: the
    K-step chunk of this rank's rows, the replicated store's gather step
    and K-step gather chunk (global row ids, this rank's part), and the
    sharded store's (this rank's block, local ids)."""
    cfg = port_cfg()
    n = batches[0][0].shape[0]
    b_dev = n // mesh.size
    stacked = [np.stack([b[i] for b in batches]) for i in range(4)]
    store = tuple(torch.from_numpy(np.concatenate(list(a))) for a in stacked)
    own = tuple(torch.from_numpy(np.concatenate(
        [a[j][mesh.rank * b_dev:(mesh.rank + 1) * b_dev]
         for j in range(len(batches))])) for a in stacked)
    out = {}

    def fresh():
        model = model_from(cfg, state_path)
        return model, train.make_optimizer(model, cfg)

    model, opt = fresh()
    chunk = pmesh.make_parallel_train_chunk_step(model, opt, cfg, None, mesh,
                                                 k)
    out['chunk'] = (chunk(*pmesh.shard_chunk(mesh, *stacked))[0].tolist(),
                    state_of(model, opt))

    model, opt = fresh()
    step = pmesh.make_parallel_train_step_gather(model, opt, cfg, None, mesh)
    losses = []
    for j in range(k):
        idx = np.arange(j * n, (j + 1) * n, dtype=np.int32)
        losses.append(float(step(*store, *pmesh.shard_batch(mesh, idx))[0]))
    out['gather'] = (losses, state_of(model, opt))

    model, opt = fresh()
    chunk = pmesh.make_parallel_train_chunk_step_gather(model, opt, cfg, None,
                                                        mesh, k)
    idxs = np.arange(k * n, dtype=np.int32).reshape(k, n)
    out['gather_chunk'] = (
        chunk(*store, *pmesh.shard_chunk(mesh, idxs))[0].tolist(),
        state_of(model, opt))

    model, opt = fresh()
    step = pmesh.make_parallel_train_step_gather_sharded(model, opt, cfg,
                                                         None, mesh)
    losses = []
    for j in range(k):
        idx = torch.arange(j * b_dev, (j + 1) * b_dev, dtype=torch.int32)
        losses.append(float(step(*own, idx)[0]))
    out['sharded'] = (losses, state_of(model, opt))

    model, opt = fresh()
    chunk = pmesh.make_parallel_train_chunk_step_gather_sharded(
        model, opt, cfg, None, mesh, k)
    idxs = torch.arange(k * b_dev, dtype=torch.int32).reshape(k, b_dev)
    out['sharded_chunk'] = (chunk(*own, idxs)[0].tolist(),
                            state_of(model, opt))
    return out


def small_checks(mesh, tmp, y, weights):
    """The cross-rank pieces on their own: BN moments and their gradient,
    ``global_accuracy``, the all-gather of rows, and the gates."""
    from lstm_ctc_ocr_torch.models.layers import batch_moments
    out = {}
    rows = pmesh.batch_sharded(mesh, y.shape[0])
    x = y[rows].clone().requires_grad_()
    mean, var = batch_moments(x, mesh.group)
    ((x - mean) * torch.rsqrt(var + 1e-3) * weights[rows]).sum().backward()
    out['mean'], out['var'] = mean.detach(), var.detach()
    out['grad'] = x.grad
    # rank r scores (r + 1) * 3 rows at accuracy 1 / (r + 1)
    out['accuracy'] = train.global_accuracy(1.0 / (mesh.rank + 1),
                                            3 * (mesh.rank + 1), mesh)
    out['gathered'] = pmesh.gather_rows(
        mesh, torch.full((2, 3), mesh.rank, dtype=torch.int32))
    out['init_again'] = pmesh.init_distributed()   # already a group
    errors = {}
    try:
        train.select_mesh(port_cfg('PARALLEL', "'off'"), torch.device('cpu'))
    except ValueError as e:
        errors['parallel_off'] = str(e)
    try:
        train.check_graph_collectives(mesh, torch.device('cuda'))
    except ValueError as e:
        errors['gloo_graph'] = str(e)
    sw = train.SolverWrapper(get_network('LSTM_train', port_cfg()), {}, None,
                             os.path.join(tmp, 'out_small'),
                             os.path.join(tmp, 'log_small{}'.format(
                                 mesh.rank)),
                             port_cfg('TRAIN.BATCH_SIZE', '3'), device='cpu')
    try:
        sw.train_model(3)
    except ValueError as e:
        errors['batch'] = str(e)
    out['errors'] = errors
    out['mesh'] = (mesh.size, mesh.rank, mesh.backend,
                   train.select_mesh(port_cfg(), torch.device('cpu')).size)
    return out


def solver(mesh, tmp, records_path, overrides, iters):
    """``train_net`` at this rank; each rank writes into its own output
    directory, so rank 1's stays empty unless a rank other than 0 wrote."""
    cfg = port_cfg('DATA_BACKEND', 'records', 'RECORDS_PATH', records_path,
                   'TRAIN.BATCH_SIZE', '4', 'VAL.BATCH_SIZE', '4',
                   'TRAIN.DISPLAY', '1', 'TRAIN.SNAPSHOT_ITERS', '3',
                   'VAL.VAL_STEP', '3', 'RENDERER', 'native', *overrides)
    out_dir = os.path.join(tmp, 'out{}'.format(mesh.rank))
    net = get_network('LSTM_train', cfg,
                      generator=torch.Generator().manual_seed(3))
    model, optimizer, losses = train.train_net(
        net, {}, None, out_dir, os.path.join(tmp, 'log{}'.format(mesh.rank)),
        cfg, max_iters=iters, device='cpu')
    files = sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else []
    return losses, state_of(model, optimizer), files


def dp_eval(mesh, val_dir, out_dir, batch):
    """``test_net`` at this rank on the release, BN_EVAL batch."""
    from lstm_ctc_ocr_torch.engine import test as port_test
    cfg = load_cfg(YML, ['TEST.BATCH_SIZE', str(batch), 'TRAIN.DTYPE',
                         "'float32'", 'DECODER', "'greedy'"])
    lines = []
    r = port_test.test_net(cfg, val_dir, out_dir, device='cpu',
                           echo=lines.append)
    return r.predictions, r.correct, r.decode_calls, lines


def sharded_store(mesh, tmp, images, labels, records_path):
    """The sharded store at this rank: its block of ``images[rank]`` and
    the samplers, the gather step against host batches of the same rows, a
    refresh flush, the partition-size checks, and the pool and records
    feeds."""
    from lstm_ctc_ocr_torch.data import device_store, gen
    cfg = port_cfg('RENDERER', "'native'", 'POOL_SIZE', '8',
                   'POOL_REFRESH', '3', 'RECORDS_PATH', records_path)
    r = mesh.rank
    out = {}
    store = device_store.ShardedDeviceStore(
        images[r], labels[r], 'uniform', 1, mesh, cfg, 'cpu', verbose=False)
    out['w_bucket'] = store.w_bucket
    out['block'] = [a.clone() for a in store.arrays]
    out['bucket_batch'] = gen.bucket_batch(images[r], labels[r], cfg,
                                           buckets=[store.w_bucket])
    plan = [store.next_indices(8, 1)[0] for _ in range(3)]
    out['uniform'] = plan

    # the block gather against host batches of the same rows (this rank's)
    losses = {}
    for path in ('gather', 'host'):
        model = get_network('LSTM_train', cfg,
                            generator=torch.Generator().manual_seed(0))
        opt = train.make_optimizer(model.train(), cfg)
        if path == 'gather':
            step = pmesh.make_parallel_train_step_gather_sharded(
                model, opt, cfg, None, mesh)
            got = [float(step(*store.arrays, torch.from_numpy(i))[0])
                   for i in plan]
        else:
            step = pmesh.make_parallel_train_step(model, opt, cfg, None, mesh)
            got = []
            for i in plan:
                b = gen.bucket_batch([images[r][j] for j in i],
                                     [labels[r][j] for j in i], cfg,
                                     buckets=[store.w_bucket])
                got.append(float(step(*pmesh.shard_host_batch(
                    mesh, b.image, b.label, b.label_len, b.time_step))[0]))
        losses[path] = (got, state_of(model, opt))
    out['train'] = losses

    epoch = device_store.ShardedDeviceStore(
        images[r], labels[r], 'epoch', 3, mesh, cfg, 'cpu', flush_every=1,
        verbose=False)
    out['epoch'] = [epoch.next_indices(8, 1)[0] for _ in range(4)]
    before = epoch.img.clone()
    fresh = np.full((32, 60), 7 + r, np.uint8)
    epoch.stage_refresh(2, fresh, 'zz')
    out['refresh'] = (before, epoch.img.clone(), epoch.lab_len.clone())
    errors = {}
    try:
        epoch.next_indices(2 * (len(images[r]) + 1))
    except ValueError as e:
        errors['shard'] = str(e)
    try:
        epoch.stage_refresh(0, np.zeros((32, epoch.w_bucket + 1), np.uint8),
                            'a')
    except ValueError as e:
        errors['wide'] = str(e)
    try:
        device_store.make_sharded_device_feed(
            port_cfg('DATA_DEVICE', "'on'", 'DATA_BACKEND', "'pool'",
                     'POOL_SIZE', '4'), 8, mesh, 'cpu')
    except ValueError as e:
        errors['feed'] = str(e)
    out['errors'] = errors

    pool = device_store.make_sharded_device_feed(
        port_cfg('DATA_DEVICE', "'on'", 'DATA_BACKEND', "'pool'",
                 'RENDERER', "'native'", 'POOL_SIZE', '8', 'POOL_REFRESH',
                 '3'), 4, mesh, 'cpu', verbose=False)
    out['pool_block'] = [a.clone() for a in pool.store.arrays]
    out['pool_indices'] = pool.store.next_indices(4, 2)
    pool.tick(2)
    out['pool_pending'] = [(row, im, s) for row, im, s in
                           pool.store._pending]
    rec = device_store.make_sharded_device_feed(
        port_cfg('DATA_DEVICE', "'on'", 'DATA_BACKEND', "'records'",
                 'RECORDS_PATH', records_path), 4, mesh, 'cpu',
        verbose=False)
    out['records_block'] = [a.clone() for a in rec.store.arrays]
    out['records_indices'] = rec.store.next_indices(4, 3)
    out['layouts'] = (pool.layout, rec.layout,
                      tuple(rec.step_indices(4).shape),
                      tuple(rec.chunk_indices(4, 3).shape))
    # the replicated store under a mesh: every rank draws the one stream's
    # global indices and takes its rows of them
    cfg = port_cfg('DATA_DEVICE', "'on'", 'DATA_BACKEND', "'records'",
                   'RECORDS_PATH', records_path)
    one = device_store.make_device_feed(cfg, 'cpu', verbose=False)
    both = device_store.make_device_feed(cfg, 'cpu', verbose=False,
                                         mesh=mesh)
    out['replicated'] = (one.chunk_indices(4, 3), both.chunk_indices(4, 3),
                         one.step_indices(4), both.step_indices(4))
    return out
