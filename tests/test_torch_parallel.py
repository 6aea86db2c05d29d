"""The port's data parallelism (``parallel/mesh.py``, the cross-rank BN and
loss, the DP solver and eval) against the JAX package's mesh and the port's
own one-process step, at world 2 over gloo on the CPU.

Each multi-process check spawns two ranks (``torch_parallel_worker.py``)
joined through a ``file://`` rendezvous under ``tmp_path``, on tiny shapes:
lstm.yml's conv stack with a 16-unit head, batch 8, W=64, f32, Momentum at
lr 1e-3 (linear in the gradient, so reduction-order noise stays noise).
The JAX side runs on the CPU devices ``tests/conftest.py`` gives, weights
crossing through the npz bridge.

* Three DP steps (with and without weight decay) against the JAX
  ``make_parallel_train_step`` on a 2-device mesh and the port's one-process
  step on the global batch: the first step's gradients within 1e-5 of the
  largest (1e-4 against JAX, ``tests/test_torch_train.py``'s bar for the
  port's step against the JAX step); losses rtol 1e-5; parameters and BN
  buffers rtol 2e-5 / atol 2e-6 (``tests/test_parallel.py``'s bar); ranks
  bit for bit. A one-ulp nudge of the one-process run after its first
  step is held to the same bar first. A ReLU or a max pool within rounding
  of its kink turns a rounding difference into a finite one: at data seeds
  0 and 1 that control itself misses the bar, so there the bar would
  measure the trajectory's conditioning and not the DP path. The batches
  are seed 2's, where the control holds; the first step, which starts from
  the same parameters on every side, needs no such control.
* The chunk and gather variants against their one-device counterparts.
* The global BN statistics and their gradient, ``global_accuracy``, the
  row all-gather, ``init_distributed`` and the gates.
* ``test_net`` at world 2 against world 1 and the JAX DP eval; the solver
  at world 2 (snapshots from rank 0 only); the train CLI under two ranks;
  ``dryrun_multichip(2)``.
"""

import copy
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parallel_worker as worker
from lstm_ctc_ocr_tpu.config import cfg as jcfg
from lstm_ctc_ocr_tpu.engine import checkpoint as jcheckpoint
from lstm_ctc_ocr_torch.data import records
from lstm_ctc_ocr_torch.engine import checkpoint, train
from lstm_ctc_ocr_torch.models.factory import get_network
from lstm_ctc_ocr_torch.parallel import dryrun
from lstm_ctc_ocr_torch.parallel import mesh as pmesh

REPO = worker.REPO
N, W, STEPS = 8, 64, 3


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def jax_cfg():
    """The JAX package's global config as ``worker.port_cfg`` sets the
    port's; restored afterwards."""
    from lstm_ctc_ocr_tpu.config import cfg_from_file
    old = copy.deepcopy(dict(jcfg))
    cfg_from_file(worker.YML)
    jcfg.TRAIN.DTYPE = 'float32'
    jcfg.TRAIN.NUM_HID = 16
    jcfg.TRAIN.SOLVER = 'Momentum'
    jcfg.TRAIN.LEARNING_RATE = 0.001
    jcfg.TRAIN.GAMMA = 1.0
    yield jcfg
    jcfg.clear()
    for k, v in old.items():
        jcfg[k] = v


def _batches(k=STEPS, n=N, seed=2):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(k):
        label_len = rng.randint(3, 6, n).astype(np.int32)
        label = rng.randint(1, 63, (n, 6)).astype(np.int32)
        for i in range(n):
            label[i, label_len[i]:] = 0
        out.append((rng.rand(n, W, 32).astype(np.float32), label, label_len,
                    rng.randint(W // 4 - 4, W // 4, n).astype(np.int32)))
    return out


def _jax_init():
    from lstm_ctc_ocr_tpu.models.factory import get_network as jget_network
    net = jget_network('LSTM_train')
    params = net.init_params(jax.random.PRNGKey(0),
                             {'data': (N, W, 32), 'time_step_len': (N,)})
    return net, params, net.init_bn_state()


def _bridge(params, bn_state, path, cfg):
    """The JAX weights as a port state dict saved at ``path``."""
    model = get_network('LSTM_train', cfg)
    flat = jcheckpoint.flatten_state({'params': params, 'bn_state': bn_state})
    missing, unexpected = model.load_state_dict(
        checkpoint.params_from_flat(flat), strict=False)
    assert not missing and not unexpected
    torch.save(model.state_dict(), path)
    return path


def _one_process(cfg, state_path, batches, nudged=False, first=None):
    """Steps of one process on the global batches: (losses, state); with
    ``nudged``, :func:`dryrun.nudge` after the first; ``first`` (a dict)
    receives the first step's Momentum trace, its clipped gradient."""
    model = worker.model_from(cfg, state_path)
    optimizer = train.make_optimizer(model, cfg)
    step = train.make_train_step(model, optimizer, cfg, None)
    losses = []
    for b in batches:
        losses.append(float(step(*(torch.from_numpy(a) for a in b))[0]))
        if len(losses) == 1:
            if first is not None:
                first.update({k: t.clone() for k, t in
                              optimizer.moments['trace'].items()})
            if nudged:
                dryrun.nudge(model)
    return losses, worker.state_of(model, optimizer)


def _hold(losses, state, ref_losses, ref_state, what):
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5,
                               err_msg=what + ': losses')
    for key, want in ref_state.items():
        if key in state:
            np.testing.assert_allclose(
                np.asarray(state[key], np.float64),
                np.asarray(want, np.float64), rtol=2e-5, atol=2e-6,
                err_msg='{}: {}'.format(what, key))


def _same_ranks(results):
    l0, s0 = results[0][:2]
    for losses, state in (r[:2] for r in results[1:]):
        assert losses == l0
        assert all(torch.equal(state[k], s0[k]) for k in s0)


def _hold_gradients(got, want, what, bar):
    """Each gradient within ``bar`` of the largest entry of all of them."""
    g_max = max(float(t.abs().max()) for t in want.values())
    assert g_max > 0.1
    for key, g in want.items():
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(g),
                                   rtol=0, atol=bar * g_max,
                                   err_msg='{}: gradient of {}'.format(
                                       what, key))


@pytest.mark.parametrize('weight_decay', [0.0, 0.05])
def test_three_dp_steps_match_jax_mesh_and_one_process(jax_cfg, tmp_path,
                                                       weight_decay):
    """``weight_decay`` 0.05 is large enough that an L2 gradient counted on
    both ranks moves the parameters past the bar in three steps."""
    from lstm_ctc_ocr_tpu.engine import train as jtrain
    from lstm_ctc_ocr_tpu.parallel import mesh as jmesh
    jax_cfg.TRAIN.WEIGHT_DECAY = weight_decay
    overrides = ['TRAIN.WEIGHT_DECAY', repr(weight_decay)]
    cfg = worker.port_cfg(*overrides)
    net, params, bn_state = _jax_init()
    state_path = _bridge(params, bn_state, str(tmp_path / 'init.pt'), cfg)
    batches = _batches()

    first = {}
    ref = _one_process(cfg, state_path, batches, first=first)
    _hold(*_one_process(cfg, state_path, batches, nudged=True), *ref,
          'the one-ulp control')
    if weight_decay:
        assert float(get_network('LSTM_train', cfg).regularization_loss(
            weight_decay).detach()) > 1.0

    tx = jtrain.make_optimizer()
    mesh = jmesh.make_mesh(2)
    step = jmesh.make_parallel_train_step(net, tx, None, mesh)
    repl = jmesh.replicated(mesh)
    p, o, b = (jax.device_put(t, repl)
               for t in (params, tx.init(params), bn_state))
    jlosses, jfirst = [], None
    for it, arrays in enumerate(batches):
        p, o, b, total, _ = step(p, o, b, *jmesh.shard_batch(mesh, *arrays),
                                 it + 1)
        jlosses.append(float(total))
        if jfirst is None:            # optax's trace: the clipped gradient
            prefix = 'opt_state/1/0/.trace/'
            jfirst = checkpoint.params_from_flat({
                'params/' + k[len(prefix):]: np.asarray(v) for k, v in
                jcheckpoint.flatten_state({'opt_state': o}).items()
                if k.startswith(prefix)})
    jstate = {k: np.asarray(v) for k, v in checkpoint.params_from_flat(
        jcheckpoint.flatten_state({'params': p, 'bn_state': b})).items()}

    results = worker.run_ranks(tmp_path, 'dp_steps', state_path=state_path,
                               batches=batches, overrides=overrides)
    _same_ranks(results)
    losses, state, dp_first = results[0]
    _hold_gradients(dp_first, first, 'DP against one process, step 1', 1e-5)
    # the port's step against the JAX step: tests/test_torch_train.py's
    # first-step bar, 1e-4 of the largest gradient
    assert set(jfirst) == set(first), sorted(jfirst)[:3]
    _hold_gradients(dp_first, jfirst, 'DP against the JAX mesh, step 1', 1e-4)
    _hold(losses, state, *ref, 'DP against one process')
    _hold(losses, {k: v.numpy() for k, v in state.items()}, jlosses, jstate,
          'DP against the JAX mesh')
    assert int(state['count']) == STEPS


def test_chunk_and_gather_variants_match_one_device(tmp_path):
    cfg = worker.port_cfg()
    model = get_network('LSTM_train', cfg,
                        generator=torch.Generator().manual_seed(1))
    state_path = str(tmp_path / 'init.pt')
    torch.save(model.state_dict(), state_path)
    batches = _batches(seed=1)
    ref = _one_process(cfg, state_path, batches)
    _hold(*_one_process(cfg, state_path, batches, nudged=True), *ref,
          'the one-ulp control')
    # the one-device chunk is the one-device steps (tests/
    # test_torch_multistep.py); held to them here too
    model = worker.model_from(cfg, state_path)
    opt = train.make_optimizer(model, cfg)
    chunk = train.make_train_chunk(model, opt, cfg, None, STEPS)
    stacked = [np.stack([b[i] for b in batches]) for i in range(4)]
    assert chunk(*stacked)[0].tolist() == ref[0]

    results = worker.run_ranks(tmp_path, 'dp_variants', state_path=state_path,
                               batches=batches, k=STEPS)
    assert set(results[0]) == {'chunk', 'gather', 'gather_chunk', 'sharded',
                               'sharded_chunk'}
    for name in results[0]:
        _same_ranks([r[name] for r in results])
        _hold(*results[0][name], *ref, name + ' against one device')


@pytest.fixture(scope='module')
def small(tmp_path_factory):
    rng = np.random.RandomState(5)
    y = torch.from_numpy(rng.randn(6, 3, 5, 2).astype(np.float32) * 2 + 1)
    weights = torch.from_numpy(rng.randn(6, 3, 5, 2).astype(np.float32))
    tmp = tmp_path_factory.mktemp('small')
    return y, weights, worker.run_ranks(tmp, 'small_checks', tmp=str(tmp),
                                        y=y, weights=weights)


def test_global_bn_statistics_and_their_gradient(small):
    """Each rank holds 3 of 6 rows: its statistics are the 6 rows', within
    1e-6, and its rows' gradient is the one-process gradient's rows."""
    y, weights, results = small
    mean = y.mean(dim=(0, 2, 3), keepdim=True)
    var = y.var(dim=(0, 2, 3), unbiased=False, keepdim=True)
    x = y.clone().requires_grad_()
    m, v = (x.mean(dim=(0, 2, 3), keepdim=True),
            x.var(dim=(0, 2, 3), unbiased=False, keepdim=True))
    ((x - m) * torch.rsqrt(v + 1e-3) * weights).sum().backward()
    for r, out in enumerate(results):
        torch.testing.assert_close(out['mean'], mean, rtol=0, atol=1e-6)
        torch.testing.assert_close(out['var'], var, rtol=0, atol=1e-6)
        torch.testing.assert_close(out['grad'], x.grad[3 * r:3 * (r + 1)],
                                   rtol=1e-5, atol=1e-6)


def test_global_accuracy_weights_by_rows(small):
    _, _, results = small
    # rank 0: 3 rows at 1.0; rank 1: 6 rows at 0.5 -> 6 / 9
    assert [out['accuracy'] for out in results] == [6 / 9, 6 / 9]
    assert train.global_accuracy(0.25, 7) == 0.25
    assert train.global_accuracy(0.25, 7, pmesh.make_mesh('cpu')) == 0.25


def test_mesh_rows_and_init(small):
    _, _, results = small
    for r, out in enumerate(results):
        assert out['mesh'] == (2, r, 'gloo', 2)
        assert out['init_again'] == 2
        assert out['gathered'].tolist() == [[0] * 3] * 2 + [[1] * 3] * 2


def test_gates_raise_by_name(small):
    _, _, results = small
    for out in results:
        errors = out['errors']
        assert "PARALLEL 'off' under a process group of 2" in \
            errors['parallel_off']
        assert 'gloo group' in errors['gloo_graph']
        assert 'must both divide over the 2 ranks' in errors['batch']


def test_one_process_takes_the_one_device_step(monkeypatch):
    for var in ('JAX_COORDINATOR_ADDRESS', 'JAX_NUM_PROCESSES',
                'JAX_PROCESS_ID', 'MASTER_ADDR', 'WORLD_SIZE', 'RANK'):
        monkeypatch.delenv(var, raising=False)
    assert pmesh.init_distributed(device='cpu') == 1
    assert not torch.distributed.is_initialized()
    cfg = worker.port_cfg()
    assert train.select_mesh(cfg, torch.device('cpu')) is None
    mesh = pmesh.make_mesh('cpu')
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    a = np.arange(12).reshape(4, 3)
    assert pmesh.shard_batch(mesh, a)[0].tolist() == a.tolist()
    monkeypatch.setenv('JAX_NUM_PROCESSES', '2')
    with pytest.raises(ValueError, match='no coordinator'):
        pmesh.init_distributed(device='cpu')


def test_mesh_defaults_to_cuda_and_raises_without_it(monkeypatch):
    """``make_mesh()`` and ``Mesh()`` with no device take this process's
    CUDA device, as the entry points do; without CUDA they raise rather
    than land on the CPU. ``make_mesh('cpu')`` is as before."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        pmesh.make_mesh()
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        pmesh.Mesh()
    mesh = pmesh.make_mesh('cpu')
    assert (mesh.size, mesh.rank, mesh.group, mesh.backend) == \
        (1, 0, None, None)
    assert mesh.device == torch.device('cpu')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'current_device', lambda: 3)
    assert pmesh.make_mesh().device == torch.device('cuda', 3)
    assert pmesh.Mesh().device == torch.device('cuda', 3)


@pytest.fixture(scope='module')
def val_layout(tmp_path_factory):
    """An empty output dir (eval falls back to the tracked lstm_ctc release)
    and 20 images of data/val: two buckets, a short chunk in each."""
    root = tmp_path_factory.mktemp('eval')
    out_dir = root / 'output' / 'lstm_ctc'
    out_dir.mkdir(parents=True)
    (root / 'checkpoints').mkdir()
    os.symlink(os.path.join(REPO, 'checkpoints', 'lstm_ctc'),
               str(root / 'checkpoints' / 'lstm_ctc'))
    val = os.path.join(REPO, 'data', 'val')
    sub = root / 'val'
    sub.mkdir()
    for f in sorted(os.listdir(val))[:20]:
        shutil.copy(os.path.join(val, f), str(sub / f))
    return str(out_dir), str(sub), root


def test_dp_eval_matches_world_one_and_the_jax_dp_eval(val_layout, jax_cfg,
                                                       capsys):
    pytest.importorskip('cv2')
    from lstm_ctc_ocr_tpu.config import AttrDict
    from lstm_ctc_ocr_tpu.engine.test import test_net as jtest_net
    from lstm_ctc_ocr_tpu.models.factory import get_network as jget_network
    out_dir, sub, root = val_layout
    batch = 4
    jax_cfg.TRAIN.NUM_HID = 512
    jax_cfg.TEST.BATCH_SIZE = batch
    jax_cfg.DECODER = 'greedy'
    jax_cfg.PARALLEL = 'auto'
    jtest_net(jget_network('LSTM_test'), AttrDict({'name': 'x'}), sub,
              out_dir, None)
    text = capsys.readouterr().out
    assert 'eval DP mesh over 4 device(s)' in text
    want = {}
    for line in text.splitlines():
        fname, sep, res = line.partition('    res: ')
        if sep and fname.endswith('.png'):
            want[fname] = res

    one = worker.dp_eval(pmesh.make_mesh('cpu'), sub, out_dir, batch)
    results = worker.run_ranks(root, 'dp_eval', val_dir=sub, out_dir=out_dir,
                               batch=batch)
    assert len(want) == 20 and one[0] == want
    for r, (predictions, correct, calls, lines) in enumerate(results):
        assert predictions == want and correct == one[1] and calls == one[2]
        if r == 0:
            assert 'eval DP over 2 ranks (gloo)' in lines
            assert [x for x in lines if 'res: ' in x] == \
                [x for x in one[3] if 'res: ' in x]
            assert any(x.startswith('total acc:') for x in lines)
        else:
            assert lines == []


@pytest.fixture(scope='module')
def tiny_records(tmp_path_factory):
    root = tmp_path_factory.mktemp('records')
    img_dir = root / 'imgs'
    img_dir.mkdir()
    val = os.path.join(REPO, 'data', 'val')
    for f in sorted(os.listdir(val))[:12]:
        shutil.copy(os.path.join(val, f), str(img_dir / f))
    path = str(root / 'train.records')
    assert records.write_image_annotation_pairs_to_records(str(img_dir),
                                                           path) == 12
    return path


@pytest.mark.parametrize('overrides', [
    ['DATA_DEVICE', "'off'"],
    ['DATA_DEVICE', "'off'", 'TRAIN.STEPS_PER_DISPATCH', '2'],
    ['DATA_DEVICE', "'on'", 'TRAIN.STEPS_PER_DISPATCH', '2'],
], ids=['host_batches', 'host_batches_k2', 'sharded_store_k2'])
def test_solver_at_world_two(tiny_records, tmp_path, overrides):
    """``train_net`` on two ranks: the same losses and state on both, the
    snapshots of steps 3 and 6 written by rank 0 alone. With host batches
    and K=2, the ranks' streams (seeded apart) change bucket at different
    steps, and every rank must run the shortest group."""
    results = worker.run_ranks(tmp_path, 'solver', tmp=str(tmp_path),
                               records_path=tiny_records,
                               overrides=overrides, iters=7)
    (l0, s0, f0), (l1, s1, f1) = results
    assert len(l0) == 6 and np.isfinite(l0).all() and l0 == l1
    assert all(torch.equal(s0[k], s1[k]) for k in s0)
    assert int(s0['count']) == 6
    assert f0 == ['lstm_ctc_iter_3.ckpt.npz', 'lstm_ctc_iter_6.ckpt.npz']
    assert f1 == []


def test_train_cli_under_two_ranks(tiny_records, tmp_path):
    """``python -m lstm_ctc_ocr_torch.engine.train --device cpu`` as two
    processes joined through the JAX package's variables: rank 0 prints the
    display lines, rank 1 none."""
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1',
                   JAX_COORDINATOR_ADDRESS='file://' + str(tmp_path / 'rdv'),
                   JAX_NUM_PROCESSES='2', JAX_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, '-m', 'lstm_ctc_ocr_torch.engine.train',
             '--cfg', worker.YML, '--iters', '3', '--device', 'cpu', '--set',
             'DATA_BACKEND', 'records', 'RECORDS_PATH', tiny_records,
             'TRAIN.BATCH_SIZE', '4', 'VAL.BATCH_SIZE', '4', 'TRAIN.DTYPE',
             "'float32'", 'TRAIN.NUM_HID', '16', 'TRAIN.DISPLAY', '1',
             'RENDERER', 'native', 'ROOT_DIR', str(tmp_path), 'EXP_DIR',
             'cli', 'LOG_DIR', 'cli'],
            cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert 'data parallel over 2 ranks (gloo): 2 rows a rank a step' in outs[0]
    assert outs[0].count('iter: ') == 2 and 'iter: ' not in outs[1]


def test_dryrun_multichip_two_ranks():
    out = dryrun.dryrun_multichip(2)
    assert set(out) == {'one_process', 'host', 'replicated_store',
                        'sharded_store'}
