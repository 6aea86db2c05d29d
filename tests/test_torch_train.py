"""The port's train step and solver against the JAX package's.

* ``regularization_loss``, the ``bn_collect`` batch statistics, the
  learning-rate schedule and one-to-three updates of each solver (clip
  triggered and not) against the JAX network and the optax chain, <= 1e-6.
* The train step as a whole: five f32 train steps of the full-width model at
  N=4, W=64 from the same initial weights (through the weight bridge) on
  the same five batches, under Adam and under Momentum. Total loss per step
  within 1e-4 relative; the state afterwards (parameters, moving BN
  statistics, solver moments) as closely as the solver allows — the test
  says how close and why.
* Snapshots written by either package restore in the other, optimizer
  state included, for all three solvers.
* ``SolverWrapper`` on the CPU: snapshot names, the low-loss snapshot, the
  resume step, and what raises ``NotImplementedError`` by name.
"""

import copy
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from lstm_ctc_ocr_tpu.config import cfg as jcfg
from lstm_ctc_ocr_tpu.engine import checkpoint as jcheckpoint
from lstm_ctc_ocr_tpu.engine import train as jtrain
from lstm_ctc_ocr_tpu.models.factory import get_network as jget_network
from lstm_ctc_ocr_torch.config import load_cfg
from lstm_ctc_ocr_torch.data import records
from lstm_ctc_ocr_torch.engine import checkpoint, train
from lstm_ctc_ocr_torch.models.factory import get_network

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YML = os.path.join(REPO, 'lstm', 'lstm.yml')


@pytest.fixture
def jax_cfg():
    """The JAX package's global config with ``lstm/lstm.yml``'s solver
    settings in f32; restored afterwards."""
    old = copy.deepcopy(dict(jcfg))
    jcfg.TRAIN.DTYPE = 'float32'
    jcfg.TRAIN.SOLVER = 'Adam'
    jcfg.TRAIN.LEARNING_RATE = 0.0001
    jcfg.TRAIN.GAMMA = 1.0
    jcfg.TRAIN.STEPSIZE = 2000
    jcfg.TRAIN.WEIGHT_DECAY = 0.00001
    yield jcfg
    jcfg.clear()
    for k, v in old.items():
        jcfg[k] = v


def _port_cfg(*overrides):
    return load_cfg(YML, ['TRAIN.DTYPE', "'float32'"] + list(overrides))


def _jax_init(n=4, w=64):
    net = jget_network('LSTM_train')
    params = net.init_params(jax.random.PRNGKey(0),
                             {'data': (n, w, 32), 'time_step_len': (n,)})
    return net, params, net.init_bn_state()


def _port_model_from(cfg, params, bn_state):
    model = get_network('LSTM_train', cfg)
    flat = jcheckpoint.flatten_state({'params': params, 'bn_state': bn_state})
    missing, unexpected = model.load_state_dict(
        checkpoint.params_from_flat(flat), strict=False)
    assert not missing and not unexpected
    return model


def _batches(k, n=4, w=64, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(k):
        label_len = rng.randint(3, 6, n).astype(np.int32)
        label = rng.randint(1, 63, (n, 6)).astype(np.int32)
        for i in range(n):
            label[i, label_len[i]:] = 0
        out.append((rng.rand(n, w, 32).astype(np.float32), label,
                    label_len,
                    rng.randint(w // 4 - 4, w // 4, n).astype(np.int32)))
    return out


def test_regularization_loss_and_bn_statistics_match_jax(jax_cfg):
    net, params, bn_state = _jax_init()
    cfg = _port_cfg()
    model = _port_model_from(cfg, params, bn_state)
    want = float(net.regularization_loss(params))
    got = float(model.regularization_loss(
        float(cfg.TRAIN.WEIGHT_DECAY)).detach())
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert float(model.regularization_loss(0.0)) == 0.0

    image, _, _, time_step = _batches(1)[0]
    coll = {}
    net.apply(params, {'data': jnp.asarray(image),
                       'time_step_len': jnp.asarray(time_step)},
              train=True, dtype=None, bn_collect=coll)
    got_coll = []
    model(torch.from_numpy(image), torch.from_numpy(time_step),
          bn_collect=got_coll)
    assert [m for m, _, _ in got_coll] == [model.conv4_1, model.conv4_2]
    for (_, mean, var), name in zip(got_coll, ('conv4_1', 'conv4_2')):
        np.testing.assert_allclose(mean.numpy(), np.asarray(coll[name]['mean']),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(var.numpy(), np.asarray(coll[name]['var']),
                                   rtol=1e-4, atol=1e-6)


def test_lr_schedule_matches_jax(jax_cfg):
    jax_cfg.TRAIN.LEARNING_RATE, jax_cfg.TRAIN.GAMMA = 0.01, 0.1
    jax_cfg.TRAIN.STEPSIZE = 100
    cfg = _port_cfg('TRAIN.LEARNING_RATE', '0.01', 'TRAIN.GAMMA', '0.1',
                    'TRAIN.STEPSIZE', '100')
    for step in (0, 99, 100, 250, 1000):
        assert train.lr_schedule(cfg, step) == pytest.approx(
            float(jtrain.lr_schedule(step)), rel=1e-6)


@pytest.mark.parametrize('solver', ['Adam', 'RMS', 'Momentum'])
def test_solver_updates_match_optax(jax_cfg, solver):
    """Three updates; the first and third gradients exceed GRAD_CLIP."""
    jax_cfg.TRAIN.SOLVER = solver
    jax_cfg.TRAIN.LEARNING_RATE = 0.01
    cfg = _port_cfg('TRAIN.SOLVER', repr(solver), 'TRAIN.LEARNING_RATE',
                    '0.01')
    rng = np.random.RandomState(0)
    shapes = {'a': (3, 4), 'b': (5,), 'c': (2, 2, 3, 4)}
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * scale).astype(np.float32)
              for k, s in shapes.items()} for scale in (5.0, 0.1, 20.0)]
    norms = [np.sqrt(sum(float((g ** 2).sum()) for g in gs.values()))
             for gs in grads]
    assert norms[0] > 10 > norms[1] and norms[2] > 10

    tx = jtrain.make_optimizer()
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    opt_state = tx.init(jparams)
    tparams = {k: torch.from_numpy(v.copy()).requires_grad_()
               for k, v in init.items()}
    opt = train.Optimizer(tparams, cfg)
    for gs in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v)
                                        for k, v in gs.items()},
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, v in gs.items():
            tparams[k].grad = torch.from_numpy(v.copy())
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(tparams[k].detach().numpy(),
                                       np.asarray(jparams[k]), rtol=1e-6,
                                       atol=1e-6)
    assert opt.count == 3


@pytest.mark.parametrize('solver,lr', [('Adam', 0.0001), ('Momentum', 0.0001)])
def test_five_train_steps_match_jax(jax_cfg, solver, lr):
    jax_cfg.TRAIN.SOLVER, jax_cfg.TRAIN.LEARNING_RATE = solver, lr
    net, params, bn_state = _jax_init()
    init = {k: np.array(v) for k, v in
            jcheckpoint.flatten_state({'params': params}).items()}
    cfg = _port_cfg('TRAIN.SOLVER', repr(solver), 'TRAIN.LEARNING_RATE',
                    repr(lr))
    model = _port_model_from(cfg, params, bn_state)
    # What the two packages can agree to. The first step sees the same
    # weights, so it is held entrywise: gradients to 1e-4 of the largest,
    # parameters to 1e-5. From step 2 on a ReLU or a max pool that sits
    # within rounding of a tie flips on one side only, and single gradient
    # entries differ by more than rounding (measured here: up to 6e-3 in the
    # conv3_2 biases at step 2, beside a largest gradient of 1.4).
    # Momentum is linear in the gradient, so it holds the whole trajectory:
    # every entry of the state within 1e-6, each tensor within 1e-3 of its
    # movement, BN 1e-5. Adam divides by sqrt(nu) + 1e-8, a sign step of up
    # to lr for an entry whose gradient is rounding noise below that epsilon
    # (9 of 7.2 million entries after step 1, every one with |g| < 1e-8, and
    # the conv4 biases, whose true gradient is zero), so after five steps it
    # is held per tensor only: within 5% of its movement (L2), the moving BN
    # mean (which carries the noise-driven conv4 biases) 5e-5.
    adam = solver == 'Adam'
    rel, bn_tol = (5e-2, 5e-5) if adam else (1e-3, 1e-5)
    tx = jtrain.make_optimizer()
    opt_state = tx.init(params)
    jstep = jtrain.make_train_step(net, tx, None)
    optimizer = train.make_optimizer(model, cfg)
    step = train.make_train_step(model.train(), optimizer, cfg, None)

    def states():
        want = jcheckpoint.flatten_state({
            'params': params, 'bn_state': bn_state, 'opt_state': opt_state})
        got = checkpoint.flat_from_params(model.state_dict())
        got.update(checkpoint.opt_state_to_flat(optimizer))
        assert set(got) == set(want)
        return {k: np.array(v) for k, v in want.items()}, got

    def noise_only(key):
        # batch norm removes the bias of conv4_1 / conv4_2: its true gradient
        # is zero and both sides hold rounding noise
        return key.split('/')[-2:] in (['conv4_1', 'biases'],
                                       ['conv4_2', 'biases'])

    for i, batch in enumerate(_batches(5)):
        params, opt_state, bn_state, jtotal, jctc = jstep(
            params, opt_state, bn_state, *(jnp.asarray(a) for a in batch),
            i + 1)
        total, ctc = step(*(torch.from_numpy(a) for a in batch))
        np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-4)
        np.testing.assert_allclose(float(ctc), float(jctc), rtol=1e-4)
        if i == 0:
            _check_first_step(*states(), init, adam, noise_only)

    want, got = states()
    moved_any = False
    for key in sorted(want):
        w, g = want[key], got[key]
        if key.endswith('.count'):
            assert int(g) == int(w) == 5
        elif key.startswith('bn_state/'):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=bn_tol,
                                       err_msg=key)
        elif noise_only(key):
            # nothing to agree on but that it is noise: the moments show
            # that every one of the five gradients stayed below 1e-6 on
            # both sides (nu >= 0.001 * 0.999^4 * g^2); Momentum then leaves
            # the parameter where it was, Adam walks it by up to lr a step
            if '/.nu/' in key:
                assert max(float(g.max()), float(w.max())) < 1e-15, key
            elif key.startswith('opt_state/'):
                assert max(float(np.abs(g).max()),
                           float(np.abs(w).max())) < 5e-6, key
            elif not adam:
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-6,
                                           err_msg=key)
        elif key.startswith('params/'):
            move = float(np.linalg.norm(w - init[key]))
            moved_any = moved_any or move > 1e-3
            assert float(np.linalg.norm(g - w)) <= rel * move + 1e-7, key
            if not adam:
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-6,
                                           err_msg=key)
        else:                                  # the solver's moments
            assert float(np.linalg.norm(g - w)) <= \
                rel * float(np.linalg.norm(w)) + 1e-7, key
    assert moved_any                           # the comparison is not vacuous
    assert float(np.abs(got['bn_state/conv4_1/mean']).max()) > 0


def _check_first_step(want, got, init, adam, noise_only):
    """After one step from the same weights: the gradients (read back from
    the first moment, ``mu = 0.1 g`` under Adam, ``trace = g`` under
    Momentum) agree to 1e-4 of the largest, every parameter entry to 1e-5
    -- under Adam but for the entries whose gradient is below 1e-7 on both
    sides, where the update is a sign step of rounding noise: those moved
    by at most lr on either side, and are fewer than one in 100 000."""
    slot, scale = ('.mu', 10.0) if adam else ('.trace', 1.0)
    grads = {k.split(slot + '/')[1]: (scale * want[k], scale * got[k])
             for k in want if '/' + slot + '/' in k}
    assert grads
    g_max = max(float(np.abs(w).max()) for w, _ in grads.values())
    assert g_max > 0.1
    exempt = total = 0
    for path, (gw, gg) in sorted(grads.items()):
        key = 'params/' + path
        np.testing.assert_allclose(gg, gw, rtol=0, atol=1e-4 * g_max,
                                   err_msg=key)
        if noise_only(key):
            assert max(float(np.abs(gw).max()), float(np.abs(gg).max())) \
                < 1e-6, key
            if adam:
                continue
        diff = np.abs(got[key] - want[key])
        noise = (np.abs(gw) < 1e-7) & (np.abs(gg) < 1e-7) if adam \
            else np.zeros(diff.shape, bool)
        assert float(diff[~noise].max(initial=0.0)) <= 1e-5, key
        for side in (got, want):
            assert float(np.abs(side[key] - init[key])[noise]
                         .max(initial=0.0)) <= 1.001e-4, key
        exempt += int((noise & (diff > 1e-5)).sum())
        total += diff.size
    assert exempt * 100000 < total


@pytest.mark.parametrize('solver', ['Adam', 'RMS', 'Momentum'])
def test_snapshots_cross_restore_with_optimizer_state(jax_cfg, tmp_path,
                                                      solver):
    jax_cfg.TRAIN.SOLVER = solver
    jax_cfg.TRAIN.NUM_HID = 16
    cfg = _port_cfg('TRAIN.SOLVER', repr(solver), 'TRAIN.NUM_HID', '16')
    gen = torch.Generator().manual_seed(1)
    model = get_network('LSTM_train', cfg, generator=gen)
    optimizer = train.make_optimizer(model, cfg)
    with torch.no_grad():
        model.conv4_1.bn_mean.uniform_(-1, 1, generator=gen)
        model.conv4_2.bn_var.uniform_(0.5, 2, generator=gen)
        for slot in optimizer.moments.values():
            for t in slot.values():
                t.uniform_(0, 1, generator=gen)
    optimizer.count = 7
    ours = checkpoint.save(model, optimizer, str(tmp_path / 'port'), 8, cfg)
    assert os.path.basename(ours) == checkpoint.snapshot_name(cfg, 8) \
        == jcheckpoint.snapshot_name(8) == 'lstm_ctc_iter_8.ckpt.npz'

    # the JAX package restores the port's snapshot into its own state tree
    net, params, bn_state = _jax_init()
    template = {'params': params, 'bn_state': bn_state,
                'opt_state': jtrain.make_optimizer().init(params)}
    state, step = jcheckpoint.restore_latest(template, str(tmp_path / 'port'))
    assert step == 8
    flat = jcheckpoint.flatten_state(state)
    written = checkpoint.read_flat(ours)
    assert set(flat) == set(written)
    for key, arr in flat.items():
        np.testing.assert_array_equal(np.asarray(arr), written[key], key)
    counts = [k for k in flat if k.endswith('.count')]
    assert counts and all(int(flat[k]) == 7 for k in counts)

    # and the port restores the snapshot the JAX package writes from it
    theirs = jcheckpoint.save(state, str(tmp_path / 'jax'), 9)
    model2 = get_network('LSTM_train', cfg)
    optimizer2 = train.make_optimizer(model2, cfg)
    assert checkpoint.restore_latest(model2, optimizer2,
                                     str(tmp_path / 'jax')) == 9
    assert optimizer2.count == 7
    for (name, a), (_, b) in zip(model.state_dict().items(),
                                 model2.state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    for slot, tensors in optimizer.moments.items():
        for name, t in tensors.items():
            torch.testing.assert_close(t, optimizer2.moments[slot][name],
                                       rtol=0, atol=0, msg=slot + name)
    assert checkpoint.restore_latest(model2, optimizer2,
                                     str(tmp_path / 'none')) == 0
    assert os.path.basename(theirs) == 'lstm_ctc_iter_9.ckpt.npz'


def test_save_prunes_its_family_and_keeps_the_cadence(tmp_path):
    cfg = _port_cfg('TRAIN.NUM_HID', '16')
    model = get_network('LSTM_train', cfg)
    optimizer = train.make_optimizer(model, cfg)
    out = str(tmp_path)
    other = os.path.join(out, 'other_ctc_iter_1.ckpt.npz')
    open(other, 'wb').close()
    for step in (10, 11, 12, 13, 20, 21):
        checkpoint.save(model, optimizer, out, step, cfg, max_to_keep=3,
                        keep_every=10)
    steps = sorted(s for _, s in checkpoint.list_checkpoints(out))
    assert steps == [1, 10, 20, 21] and os.path.exists(other)
    rel = checkpoint.save_release(model, os.path.join(out, 'output', 'exp'),
                                  21, cfg)
    assert rel == os.path.join(out, 'checkpoints', 'exp',
                               'lstm_ctc_iter_21.ckpt.npz')
    flat = checkpoint.read_flat(rel)
    assert flat['params/conv1/kernel'].dtype == np.float16
    assert flat['bn_state/conv4_1/var'].dtype == np.float32
    assert not any(k.startswith('opt_state') for k in flat)


@pytest.fixture
def tiny_records(tmp_path):
    img_dir = tmp_path / 'imgs'
    img_dir.mkdir()
    val = os.path.join(REPO, 'data', 'val')
    for f in sorted(os.listdir(val))[:12]:
        shutil.copy(os.path.join(val, f), str(img_dir / f))
    path = str(tmp_path / 'train.records')
    assert records.write_image_annotation_pairs_to_records(str(img_dir),
                                                           path) == 12
    return path


def _solver_cfg(path, *overrides):
    return _port_cfg('DATA_BACKEND', 'records', 'RECORDS_PATH', path,
                     'TRAIN.BATCH_SIZE', '4', 'VAL.BATCH_SIZE', '4',
                     'TRAIN.NUM_HID', '16', 'TRAIN.DISPLAY', '1',
                     'TRAIN.SNAPSHOT_ITERS', '3', 'VAL.VAL_STEP', '3',
                     *overrides)


def test_solver_cadence_and_resume(tiny_records, tmp_path, capsys):
    cfg = _solver_cfg(tiny_records)
    out, log = str(tmp_path / 'out'), str(tmp_path / 'log')

    def run(max_iters, restore, cfg=cfg, out=out):
        net = get_network('LSTM_train', cfg,
                          generator=torch.Generator().manual_seed(3))
        return train.train_net(net, {}, None, out, log, cfg,
                               max_iters=max_iters, restore=restore,
                               device='cpu')
    _, optimizer, losses = run(7, False)
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert optimizer.count == 6
    assert sorted(os.listdir(out)) == ['lstm_ctc_iter_3.ckpt.npz',
                                       'lstm_ctc_iter_6.ckpt.npz']
    text = capsys.readouterr().out
    assert text.count('accuracy: ') == 2 and 'iter: 6 / 7' in text
    assert os.listdir(log)[0].startswith('events.out.tfevents')
    # the snapshot named 6 holds the state after step 5
    assert int(checkpoint.read_flat(os.path.join(
        out, 'lstm_ctc_iter_6.ckpt.npz'))['opt_state/1/1/.count']) == 5

    _, optimizer, losses = run(9, True)
    assert 'Restored step 6' in capsys.readouterr().out
    assert len(losses) == 3 and optimizer.count == 8
    assert 'lstm_ctc_iter_9.ckpt.npz' in os.listdir(out)
    with pytest.raises(RuntimeError, match='no checkpoint'):
        run(9, True, out=str(tmp_path / 'empty'))

    # a loss under LOSS_MIN_SNAPSHOT is seen one step late: the snapshot is
    # named for the step whose parameters it holds
    low = _solver_cfg(tiny_records, 'TRAIN.LOSS_MIN_SNAPSHOT', '1e9',
                      'TRAIN.SNAPSHOT_ITERS', '100', 'VAL.VAL_STEP', '100')
    run(3, False, cfg=low, out=str(tmp_path / 'low'))
    assert 'lstm_ctc_iter_3.ckpt.npz' in os.listdir(str(tmp_path / 'low'))


@pytest.mark.parametrize('overrides,pre_train,match', [
    (['PROFILE_DIR', 'prof'], None, 'PROFILE_DIR'),
    ([], 'weights.npy', 'npy'),
])
def test_unported_options_raise_by_name(tiny_records, tmp_path, overrides,
                                        pre_train, match):
    cfg = _solver_cfg(tiny_records, *overrides)
    net = get_network('LSTM_train', cfg)
    with pytest.raises(NotImplementedError, match=match):
        train.train_net(net, {}, pre_train, str(tmp_path / 'out'),
                        str(tmp_path / 'log'), cfg, max_iters=3,
                        device='cpu')


def test_solver_validation_decodes_with_beam(tiny_records, tmp_path, capsys):
    """``DECODER: beam`` in the solver's validation decode: it runs
    ``ops/beam.beam_decode`` with BEAM_WIDTH and BEAM_MERGE_REPEATED and
    scores its ids; the steps themselves do not depend on the decoder."""
    from lstm_ctc_ocr_torch.engine import test as port_test
    calls = []
    real = port_test.beam_decode

    def spy(logits, lens, beam_width, merge_repeated):
        calls.append((tuple(logits.shape), beam_width, merge_repeated))
        return real(logits, lens, beam_width=beam_width,
                    merge_repeated=merge_repeated)
    losses = {}
    for decoder, extra in (('greedy', []),
                           ('beam', ['BEAM_WIDTH', '4',
                                     'BEAM_MERGE_REPEATED', 'True'])):
        cfg = _solver_cfg(tiny_records, 'DECODER', repr(decoder), *extra)
        net = get_network('LSTM_train', cfg,
                          generator=torch.Generator().manual_seed(3))
        port_test.beam_decode = spy
        try:
            losses[decoder] = train.train_net(
                net, {}, None, str(tmp_path / decoder), str(tmp_path / 'log'),
                cfg, max_iters=4, device='cpu')[2]
        finally:
            port_test.beam_decode = real
        assert capsys.readouterr().out.count('accuracy: ') == 1
    assert len(calls) == 1 and calls[0][1:] == (4, True)
    assert calls[0][0][0] == 4 and calls[0][0][2] == 64      # [N, T, C]
    assert losses['beam'] == losses['greedy'] and len(losses['beam']) == 3


def test_train_entry_point_raises_without_cuda(tiny_records, tmp_path):
    if torch.cuda.is_available():
        pytest.skip('this machine has a GPU')
    cfg = _solver_cfg(tiny_records)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        train.train_net(get_network('LSTM_train', cfg), {}, None,
                        str(tmp_path / 'out'), str(tmp_path / 'log'), cfg,
                        max_iters=3)


def test_cli_trains_from_pretrained_weights(tiny_records, tmp_path, capsys):
    """``main`` with ``--pre_train``: parameters come from the release, the
    moving BN statistics start fresh, as in the JAX solver."""
    ckpt = os.path.join(REPO, 'checkpoints', 'lstm_ctc',
                        'lstm_ctc_iter_32207.ckpt.npz')
    exp = 'test_torch_train_{}'.format(os.getpid())
    out = os.path.join(REPO, 'output', exp)
    logs = os.path.join(REPO, 'logs', exp)
    try:
        rc = train.main([
            '--cfg', YML, '--iters', '3', '--pre_train', ckpt, '--device',
            'cpu', '--set', 'DATA_BACKEND', 'records', 'RECORDS_PATH',
            tiny_records, 'TRAIN.BATCH_SIZE', '4', 'VAL.BATCH_SIZE', '4',
            'TRAIN.DTYPE', "'float32'", 'TRAIN.DISPLAY', '1',
            'TRAIN.SNAPSHOT_ITERS', '2', 'EXP_DIR', exp, 'LOG_DIR', exp])
        assert rc == 0
        text = capsys.readouterr().out
        assert 'Loaded pre-trained weights' in text
        flat = checkpoint.read_flat(os.path.join(
            out, 'lstm_ctc_iter_2.ckpt.npz'))
        # one EMA step from the fresh (0, 1) statistics
        assert float(np.abs(flat['bn_state/conv4_1/mean']).max()) < 0.2
        assert 0.9 < float(flat['bn_state/conv4_1/var'].min())
        loss = float(text.split('total loss: ')[1].split(',')[0])
        assert loss < 5.0          # a trained model, not a fresh one (~70)
    finally:
        shutil.rmtree(out, ignore_errors=True)
        shutil.rmtree(logs, ignore_errors=True)


def test_full_f32_is_scoped_to_the_entry_point():
    """The entry points turn TF32 off for their own run and put the
    process's settings back, also when they raise."""
    from lstm_ctc_ocr_torch.engine.test import full_f32
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True

        @full_f32()
        def entry():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
            raise KeyError('stop')
        with pytest.raises(KeyError):
            entry()
        assert torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
