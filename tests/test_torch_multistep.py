"""K steps per dispatch (``TRAIN.STEPS_PER_DISPATCH``) and the solver's
schedule state on the device.

* ``make_train_chunk`` on the CPU (host batches and store gather): the
  same losses and state as K single steps, bit for bit (the same ops).
* ``SolverWrapper`` at K=1 and K=3 on the CPU, ``SNAPSHOT_ITERS 4`` and
  ``VAL_STEP 8``: the same losses, displayed iterations and snapshot names,
  on the records device feed and on synthetic host batches whose bucket
  changes mid-group (the counterpart of the JAX package's
  ``tests/test_multistep.py::test_solver_multistep_matches_single_dispatch``).
* The device-side update count: the learning rate of the host schedule
  (``lr_schedule``, which computed every update's rate before the count
  moved to the device) and optax's updates across a ``STEPSIZE`` boundary,
  for all three solvers.
* On the card (skipped without one): K graphed steps against K eager steps
  from one saved state, bit for bit, or within the difference two eager
  runs already show; and the kernels' launch counters counting replays.

The JAX package is imported inside the tests that compare with it, so the
card tests run where JAX is missing (``tests/test_torch_device_store.py``
says how).
"""

import copy
import os
import shutil

import numpy as np
import pytest
import torch

from lstm_ctc_ocr_torch.config import load_cfg
from lstm_ctc_ocr_torch.data import device_store, gen, records
from lstm_ctc_ocr_torch.engine import train
from lstm_ctc_ocr_torch.models.factory import get_network
from lstm_ctc_ocr_torch.ops import ctc_cuda, rnn_cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YML = os.path.join(REPO, 'lstm', 'lstm.yml')


@pytest.fixture(autouse=True)
def _one_thread():
    """One CPU thread a test: the suite runs in six processes at once
    (pytest-xdist), and torch's default of one thread a core in each made
    these small steps ~20x slower (CPU oversubscription)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: a CUDA graph has no CPU mode')
    return torch.device('cuda')


def _cfg(*overrides):
    return load_cfg(YML, ['TRAIN.DTYPE', "'float32'", 'TRAIN.NUM_HID', '16']
                    + list(overrides))


def _model(cfg, device='cpu'):
    return get_network('LSTM_train', cfg,
                       generator=torch.Generator().manual_seed(3)) \
        .to(device).train()


def _state(model, optimizer):
    """Every tensor a train step updates in place, and the count."""
    tensors = list(model.parameters()) + list(model.buffers()) \
        + [t for slot in optimizer.moments.values() for t in slot.values()]
    return tensors, optimizer.count


def _save(model, optimizer):
    tensors, count = _state(model, optimizer)
    return [t.detach().clone() for t in tensors], count


def _restore(model, optimizer, saved):
    tensors, _ = _state(model, optimizer)
    with torch.no_grad():
        for t, s in zip(tensors, saved[0]):
            t.copy_(s)
    optimizer.count = saved[1]


def _host_batches(k, n=4, w=64, seed=0):
    rng = np.random.RandomState(seed)
    label_len = rng.randint(3, 6, (k, n)).astype(np.int32)
    label = rng.randint(1, 63, (k, n, 6)).astype(np.int32)
    label[np.arange(6)[None, None, :] >= label_len[:, :, None]] = 0
    return (rng.randint(0, 256, (k, n, w, 32)).astype(np.uint8), label,
            label_len, rng.randint(w // 4 - 4, w // 4, (k, n))
            .astype(np.int32))


def _store(cfg, device, n_rows=10, seed=1):
    rng = np.random.RandomState(seed)
    imgs = [rng.randint(0, 256, (32, int(w)), np.uint8)
            for w in rng.randint(40, 64, n_rows)]
    labels = [''.join(rng.choice(list('abc049'), 4)) for _ in imgs]
    return device_store.DeviceStore(imgs, labels, 'epoch',
                                    np.random.RandomState(seed), cfg, device,
                                    verbose=False)


@pytest.mark.parametrize('gather', [False, True])
def test_chunk_on_cpu_is_k_single_steps(gather):
    """The CPU chunk is the step repeated: losses, parameters, moments, BN
    buffers and the count equal K single steps' exactly."""
    cfg = _cfg()
    k = 3
    model = _model(cfg)
    optimizer = train.make_optimizer(model, cfg)
    saved = _save(model, optimizer)
    store = _store(cfg, 'cpu')
    idx = torch.from_numpy(store.next_indices(4, k))
    batches = _host_batches(k)
    chunk = train.make_train_chunk(model, optimizer, cfg, None, k,
                                   gather=gather)
    totals, ctcs = chunk(*store.arrays, idx) if gather else chunk(*batches)
    assert totals.shape == ctcs.shape == (k,)
    after = _save(model, optimizer)
    assert after[1] == k == int(optimizer.count_t)

    _restore(model, optimizer, saved)
    if gather:
        step = train.make_train_step_gather(model, optimizer, cfg, None)
        singles = [step(*store.arrays, idx[j])[0] for j in range(k)]
    else:
        step = train.make_train_step(model, optimizer, cfg, None)
        singles = [step(*(torch.from_numpy(a[j]) for a in batches))[0]
                   for j in range(k)]
    assert torch.equal(torch.stack(singles), totals)
    for a, b in zip(after[0], _save(model, optimizer)[0]):
        assert torch.equal(a, b)


def _run_solver(cfg, out, log, max_iters, capsys):
    capsys.readouterr()
    net = _model(cfg)
    _, optimizer, losses = train.train_net(net, {}, None, out, log, cfg,
                                           max_iters=max_iters, device='cpu')
    text = capsys.readouterr().out
    return losses, optimizer.count, text, sorted(os.listdir(out))


def _displayed(text):
    return [ln.split(',')[0] for ln in text.splitlines()
            if ln.startswith('iter: ')]


@pytest.mark.parametrize('backend', ['records', 'synth'])
def test_solver_k3_matches_k1(tmp_path, capsys, backend):
    """K=3 against K=1: groups clipped before the snapshots at 4 and 8 and
    the validation at 8, the lagged group readback, and on the synthetic
    stream a bucket change that ends a group early (its odd batch carried
    into the next group)."""
    if backend == 'records':
        img_dir = tmp_path / 'imgs'
        img_dir.mkdir()
        val = os.path.join(REPO, 'data', 'val')
        for f in sorted(os.listdir(val))[:12]:
            shutil.copy(os.path.join(val, f), str(img_dir / f))
        path = str(tmp_path / 't.records')
        records.write_image_annotation_pairs_to_records(str(img_dir), path)
        overrides = ['DATA_BACKEND', 'records', 'RECORDS_PATH', path]
    else:
        overrides = ['DATA_BACKEND', 'synth', 'RENDERER', 'native',
                     'TRAIN.NUM_WORKERS', '0']
    base = overrides + ['TRAIN.BATCH_SIZE', '4', 'VAL.BATCH_SIZE', '4',
                        'TRAIN.DISPLAY', '1', 'TRAIN.SNAPSHOT_ITERS', '4',
                        'VAL.VAL_STEP', '8', 'RENDERER', 'native']
    max_iters = 11
    if backend == 'synth':
        # the premise: the stream changes bucket inside a K=3 group
        cfg = _cfg(*base)
        stream = gen.get_batch(cfg, num_workers=0, seed=int(cfg.RNG_SEED),
                               batch_size=4, bucketed=True)
        widths = [next(stream).image.shape[1] for _ in range(max_iters)]
        stream.close()
        assert len(set(widths)) > 1, widths
    runs = {}
    for k in (1, 3):
        cfg = _cfg(*base, 'TRAIN.STEPS_PER_DISPATCH', str(k))
        runs[k] = _run_solver(cfg, str(tmp_path / 'out{}'.format(k)),
                              str(tmp_path / 'log'), max_iters, capsys)
    (l1, c1, t1, s1), (l3, c3, t3, s3) = runs[1], runs[3]
    assert len(l1) == len(l3) == max_iters - 1 == c1 == c3
    np.testing.assert_allclose(l3, l1, rtol=1e-6)
    assert _displayed(t3) == _displayed(t1) != []
    assert s3 == s1 == ['lstm_ctc_iter_4.ckpt.npz', 'lstm_ctc_iter_8.ckpt.npz']
    assert t1.count('accuracy: ') == t3.count('accuracy: ') == 1
    if backend == 'records':
        assert 'device store: 12 rows @ bucket 128' in t3
    else:
        assert "DATA_DEVICE auto: using host batches — backend 'synth'" in t3


@pytest.mark.parametrize('solver', ['Adam', 'RMS', 'Momentum'])
def test_device_count_schedule_across_stepsize(solver):
    """Five updates with STEPSIZE 2 and GAMMA 0.5: the rate of each update
    is the host schedule's ``lr_schedule(count)``, and the updates are
    optax's, while ``count_t`` and its host mirror move together."""
    pytest.importorskip('jax')
    import jax.numpy as jnp
    import optax
    from lstm_ctc_ocr_tpu.config import cfg as jcfg
    from lstm_ctc_ocr_tpu.engine import train as jtrain
    old = copy.deepcopy(dict(jcfg))
    try:
        jcfg.TRAIN.SOLVER, jcfg.TRAIN.LEARNING_RATE = solver, 0.01
        jcfg.TRAIN.GAMMA, jcfg.TRAIN.STEPSIZE = 0.5, 2
        cfg = _cfg('TRAIN.SOLVER', repr(solver), 'TRAIN.LEARNING_RATE',
                   '0.01', 'TRAIN.GAMMA', '0.5', 'TRAIN.STEPSIZE', '2')
        rng = np.random.RandomState(0)
        shapes = {'a': (3, 4), 'b': (5,)}
        init = {k: rng.randn(*s).astype(np.float32)
                for k, s in shapes.items()}
        tx = jtrain.make_optimizer()
        jparams = {k: jnp.asarray(v) for k, v in init.items()}
        opt_state = tx.init(jparams)
        tparams = {k: torch.from_numpy(v.copy()).requires_grad_()
                   for k, v in init.items()}
        opt = train.Optimizer(tparams, cfg)
        lrs = []
        for i in range(5):
            gs = {k: (rng.randn(*s) * 0.1).astype(np.float32)
                  for k, s in shapes.items()}
            updates, opt_state = tx.update(
                {k: jnp.asarray(v) for k, v in gs.items()}, opt_state,
                jparams)
            jparams = optax.apply_updates(jparams, updates)
            before = {k: p.detach().clone() for k, p in tparams.items()}
            for k, v in gs.items():
                tparams[k].grad = torch.from_numpy(v.copy())
            assert int(opt.count_t) == opt.count == i
            opt.step()
            for k in shapes:
                np.testing.assert_allclose(tparams[k].detach().numpy(),
                                           np.asarray(jparams[k]), rtol=1e-6,
                                           atol=1e-6)
            if solver == 'Momentum':
                # the update is lr * trace: read the rate back (through
                # the parameters' f32 rounding, ~1e-4 of a step an entry;
                # the schedule's levels differ by 2x)
                step = before['a'] - tparams['a'].detach()
                trace = opt.moments['trace']['a']
                lrs.append(float((step * trace).sum() / (trace * trace)
                                 .sum()))
                np.testing.assert_allclose(
                    lrs[-1], train.lr_schedule(cfg, i), rtol=1e-3)
        assert opt.count == int(opt.count_t) == 5
        if lrs:
            assert lrs[1] > 1.5 * lrs[2] and lrs[3] > 1.5 * lrs[4]
        opt.count = 7
        assert int(opt.count_t) == 7
    finally:
        jcfg.clear()
        for k, v in old.items():
            jcfg[k] = v


def _graph_against_eager(model, optimizer, run_graph, run_eager):
    """(graph losses, eager losses, largest eager-vs-eager difference,
    largest graph-vs-eager difference) from one saved state: the graph
    once, the eager steps twice."""
    saved = _save(model, optimizer)
    g_losses = run_graph()
    g_state = _save(model, optimizer)
    runs = []
    for _ in range(2):
        _restore(model, optimizer, saved)
        losses = run_eager()
        runs.append((losses, _save(model, optimizer)))

    def diff(a_losses, a_state, b_losses, b_state):
        d = float((a_losses - b_losses).abs().max())
        for x, y in zip(a_state[0], b_state[0]):
            d = max(d, float((x.float() - y.float()).abs().max()))
        return d + abs(a_state[1] - b_state[1])
    eager_eager = diff(runs[0][0], runs[0][1], runs[1][0], runs[1][1])
    graph_eager = diff(g_losses, g_state, runs[0][0], runs[0][1])
    return eager_eager, graph_eager


@pytest.mark.parametrize('gather', [False, True])
@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
def test_graphed_chunk_matches_eager_steps(cuda_device, gather, dtype):
    """K=3 graphed steps against 3 eager steps from one saved state, at a
    small width (NUM_HID 64, batch 8): bit for bit, unless two eager runs
    already differ, and then within their difference."""
    cfg = _cfg('TRAIN.NUM_HID', '64', 'TRAIN.DTYPE', repr(dtype))
    dt = train.compute_dtype(cfg)
    k, n = 3, 8
    model = _model(cfg, cuda_device)
    optimizer = train.make_optimizer(model, cfg)
    chunk = train.make_train_chunk(model, optimizer, cfg, dt, k,
                                   gather=gather)
    store = _store(cfg, cuda_device, n_rows=24)
    batches = _host_batches(k, n=n)

    def args():
        if gather:
            return store.arrays + (torch.from_numpy(store.next_indices(n, k))
                                   .to(cuda_device),)
        return batches
    chunk(*args())                   # the first dispatch: eager, captured
    assert len(chunk.graphs) == 1
    a = args()

    def run_graph():
        return chunk(*a)[0]

    def run_eager():
        if gather:
            step = train.make_train_step_gather(model, optimizer, cfg, dt)
            return torch.stack([step(*store.arrays, a[4][j])[0]
                                for j in range(k)])
        step = train.make_train_step(model, optimizer, cfg, dt)
        return torch.stack([step(*(torch.from_numpy(x[j]).to(cuda_device)
                                   for x in a))[0] for j in range(k)])
    eager_eager, graph_eager = _graph_against_eager(model, optimizer,
                                                    run_graph, run_eager)
    assert graph_eager <= eager_eager, (graph_eager, eager_eager)
    assert len(chunk.graphs) == 1


def test_replays_count_kernel_launches(cuda_device):
    """The wrappers' launch counters count kernel launches on both paths: a
    capture adds nothing (it runs no kernel), each replay adds what one
    capture recorded, and the eager first dispatch counts as it runs."""
    cfg = _cfg('TRAIN.NUM_HID', '64', 'TRAIN.DTYPE', "'bfloat16'")
    k, n = 4, 8
    model = _model(cfg, cuda_device)
    optimizer = train.make_optimizer(model, cfg)
    store = _store(cfg, cuda_device, n_rows=24)
    chunk = train.make_train_chunk(model, optimizer, cfg, torch.bfloat16, k,
                                   gather=True)
    wrappers = (rnn_cuda.bilstm_fwd, rnn_cuda.bilstm_bwd,
                ctc_cuda.ctc_forward, ctc_cuda.ctc_backward)
    before = [w.launches for w in wrappers]
    for _ in range(3):
        chunk(*store.arrays, torch.from_numpy(store.next_indices(n, k))
              .to(cuda_device))
    torch.cuda.synchronize()
    assert [w.launches - b for w, b in zip(wrappers, before)] == [3 * k] * 4
    assert optimizer.count == int(optimizer.count_t) == 3 * k
    (graph,) = chunk.graphs.values()
    assert sorted((w.__name__, c) for w, c in graph.launches) == sorted(
        (w.__name__, k) for w in wrappers)
