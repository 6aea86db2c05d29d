"""The port's device-resident dataset (``data/device_store.py``) and gather
step against the JAX package's.

* Store rows gathered by the port equal the JAX ``DeviceStore``'s and the
  port's ``bucket_batch`` at the store bucket, exactly.
* ``next_indices`` (``uniform`` and ``epoch``) and ``PoolDeviceFeed.tick``
  with a flush give the JAX package's indices, rows and staged images from
  the same seed.
* ``estimate_store_mb`` and the ``DATA_DEVICE`` gate's words equal the JAX
  package's.
* Five gather steps from bridged weights give the JAX gather steps' losses,
  f32, within 1e-5 relative.
* The two solvers on a records file whose rows span two buckets, from the
  same pre-train checkpoint, 6 steps, ``DATA_DEVICE auto``, Momentum:
  losses within 1e-5 relative (the JAX solver pads every batch to the
  store's bucket, and so must the port's).
* On the card (skipped without one): a flush is visible to the next replay
  of a captured K-step graph.

The JAX package is imported inside the tests that compare with it, so the
card test runs where JAX is missing::

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_device_store.py tests/test_torch_multistep.py
"""

import copy
import os
import re

import numpy as np
import pytest
import torch

from lstm_ctc_ocr_torch.config import load_cfg
from lstm_ctc_ocr_torch.data import device_store, gen, records
from lstm_ctc_ocr_torch.engine import checkpoint, train
from lstm_ctc_ocr_torch.models.factory import get_network

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
def jcfg():
    """The JAX package's global config, restored afterwards; skips where
    JAX is missing."""
    pytest.importorskip('jax')
    from lstm_ctc_ocr_tpu.config import cfg
    old = copy.deepcopy(dict(cfg))
    yield cfg
    cfg.clear()
    for k, v in old.items():
        cfg[k] = v


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: a CUDA graph has no CPU mode')
    return torch.device('cuda')


def _fake_images(widths, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (32, w), np.uint8) for w in widths]


def _write_records(path, widths, seed=3):
    rng = np.random.RandomState(seed)
    with records.RecordsWriter(path) as w:
        for img in _fake_images(widths, seed):
            w.add(''.join(rng.choice(list('abc049'), 4)), img)
    return path


def _both(jcfg, overrides=()):
    """(port config, JAX config): lstm.yml with the same overrides, f32."""
    from lstm_ctc_ocr_tpu.config import cfg_from_file, cfg_from_list
    overrides = ['TRAIN.DTYPE', "'float32'", 'PARALLEL', "'off'"] \
        + list(overrides)
    cfg_from_file(YML)
    cfg_from_list(overrides)
    return load_cfg(YML, overrides), jcfg


def test_store_rows_match_jax_and_bucket_batch(jcfg):
    from lstm_ctc_ocr_tpu.data.device_store import DeviceStore as JStore
    cfg, _ = _both(jcfg)
    imgs = _fake_images([53, 80, 91, 60])
    labels = ['ab', 'c0z', 'q', 'x9y']
    store = device_store.DeviceStore(imgs, labels, 'uniform',
                                     np.random.RandomState(0), cfg, 'cpu',
                                     verbose=False)
    jstore = JStore(imgs, labels, 'uniform', np.random.RandomState(0),
                    verbose=False)
    assert store.w_bucket == jstore.w_bucket == 96
    rows = [2, 0, 3]
    ref = gen.bucket_batch([imgs[i] for i in rows], [labels[i] for i in rows],
                           cfg, buckets=[store.w_bucket])
    got = train._gather(store.arrays, torch.tensor(rows, dtype=torch.int32))
    for name, g, j, r in zip(('image', 'label', 'label_len', 'time_step'),
                             got, jstore.arrays,
                             (ref.image, ref.label, ref.label_len,
                              ref.time_step)):
        assert g.dtype == torch.from_numpy(r).dtype, name
        np.testing.assert_array_equal(g.numpy(), r, err_msg=name)
        np.testing.assert_array_equal(g.numpy(), np.asarray(j)[rows],
                                      err_msg=name)
    assert store.nbytes == jstore.nbytes


@pytest.mark.parametrize('mode', ['uniform', 'epoch'])
def test_next_indices_match_jax(jcfg, mode):
    from lstm_ctc_ocr_tpu.data.device_store import DeviceStore as JStore
    cfg, _ = _both(jcfg)
    imgs = _fake_images([50] * 10)
    store = device_store.DeviceStore(imgs, ['ab'] * 10, mode,
                                     np.random.RandomState(7), cfg, 'cpu',
                                     verbose=False)
    jstore = JStore(imgs, ['ab'] * 10, mode, np.random.RandomState(7),
                    verbose=False)
    for k in (1, 3, 1, 2, 4):           # across epoch ends (10 rows, N=4)
        got, want = store.next_indices(4, k), jstore.next_indices(4, k)
        assert got.dtype == np.int32 and got.shape == (k, 4)
        np.testing.assert_array_equal(got, want)


def test_pool_feed_tick_and_flush_match_jax(jcfg, tmp_path, monkeypatch):
    """Sampling, refresh renders, staged rows and a flush (every 32 staged
    rows) from the same seed: the same indices and the same store rows,
    with a row staged twice in one flush keeping its later image."""
    from lstm_ctc_ocr_tpu.data import gen as jgen
    from lstm_ctc_ocr_tpu.data import pool as jpool
    from lstm_ctc_ocr_tpu.data.device_store import PoolDeviceFeed as JFeed
    from lstm_ctc_ocr_torch.data import pool
    monkeypatch.setattr(jgen, '_renderer_cache', {})
    cfg, _ = _both(jcfg, ['RENDERER', "'native'", 'POOL_REFRESH', '3'])
    (tmp_path / 'jax').mkdir()
    (tmp_path / 'port').mkdir()
    monkeypatch.chdir(tmp_path / 'jax')
    jfeed = JFeed(jpool.PoolSampler(12, seed=5, verbose=False),
                  verbose=False)
    monkeypatch.chdir(tmp_path / 'port')
    feed = device_store.PoolDeviceFeed(
        pool.PoolSampler(cfg, 12, seed=5, verbose=False), 'cpu',
        verbose=False)
    assert feed.store.w_bucket == jfeed.store.w_bucket

    def same_store():
        for got, want in zip(feed.store.arrays, jfeed.store.arrays):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    first = feed.store.img.clone()
    for k in (1, 4, 2, 4, 2):            # 39 refresh rows: one flush of 32
        np.testing.assert_array_equal(feed.next_indices(4, k),
                                      jfeed.next_indices(4, k))
        feed.tick(k)
        jfeed.tick(k)
        assert [(r, s) for r, _, s in feed.store._pending] == \
            [(r, s) for r, _, s in jfeed.store._pending]
        for (_, a, _), (_, b, _) in zip(feed.store._pending,
                                        jfeed.store._pending):
            np.testing.assert_array_equal(a, b)
    # rows wider than the bucket are skipped; the rest wait for a flush
    assert 0 < len(feed.store._pending) < 32
    assert not torch.equal(feed.store.img, first)
    same_store()                         # 32 rows into 12: rows repeat
    feed.store.flush_refresh()
    jfeed.store.flush_refresh()
    assert not feed.store._pending
    same_store()


def test_store_size_estimate_matches_jax(jcfg, tmp_path):
    from lstm_ctc_ocr_tpu.data.device_store import \
        estimate_store_mb as jestimate
    path = _write_records(str(tmp_path / 't.records'), [60, 88, 120, 71])
    cfg, _ = _both(jcfg, ['RECORDS_PATH', repr(path), 'POOL_SIZE', '300'])
    for backend in ('records', 'pool'):
        assert device_store.estimate_store_mb(cfg, backend) == \
            jestimate(backend) > 0


def test_auto_gate_declines_loudly_as_jax(jcfg, capsys):
    """'auto' prints which gate declined and 'on' raises with the same
    words, as the JAX package's gate does."""
    from lstm_ctc_ocr_tpu.data.device_store import make_device_feed as jmake

    def both(overrides, cap=2048):
        cfg, _ = _both(jcfg, overrides)
        cfg.DATA_DEVICE_MAX_MB = jcfg.DATA_DEVICE_MAX_MB = cap
        got = device_store.make_device_feed(cfg, 'cpu')
        got_out = capsys.readouterr().out
        want = jmake(8)
        return got, got_out, want, capsys.readouterr().out

    got, got_out, want, want_out = both(['DATA_DEVICE', "'auto'",
                                         'DATA_BACKEND', "'synth'"])
    assert got is None and want is None and got_out == want_out
    assert "DATA_DEVICE auto: using host batches — backend 'synth'" in got_out

    got, got_out, want, want_out = both(['DATA_BACKEND', "'pool'"],
                                        cap=0.0001)
    assert got is None and want is None and got_out == want_out
    assert 'exceeds DATA_DEVICE_MAX_MB' in got_out

    for backend in ('synth', 'scene'):
        cfg, _ = _both(jcfg, ['DATA_DEVICE', "'on'", 'DATA_BACKEND',
                              repr(backend)])
        with pytest.raises(ValueError) as got_err:
            device_store.make_device_feed(cfg, 'cpu')
        with pytest.raises(ValueError) as want_err:
            jmake(8)
        assert str(got_err.value) == str(want_err.value)
        assert str(got_err.value).startswith("DATA_DEVICE 'on': backend")
    cfg, _ = _both(jcfg, ['DATA_DEVICE', "'off'", 'DATA_BACKEND', "'pool'"])
    assert device_store.make_device_feed(cfg, 'cpu') is None


def test_gather_steps_match_jax(jcfg, tmp_path):
    """Five gather steps of each package on the same store from bridged
    weights, f32: the losses within 1e-5 relative, and the same rows."""
    import jax
    import jax.numpy as jnp
    from lstm_ctc_ocr_tpu.data.device_store import RecordsDeviceFeed as JFeed
    from lstm_ctc_ocr_tpu.data.records import RecordsDataset as JDataset
    from lstm_ctc_ocr_tpu.engine import checkpoint as jcheckpoint
    from lstm_ctc_ocr_tpu.engine import train as jtrain
    from lstm_ctc_ocr_tpu.models.factory import get_network as jget_network
    path = _write_records(str(tmp_path / 't.records'), [88, 100, 120, 64] * 3)
    cfg, _ = _both(jcfg, ['TRAIN.NUM_HID', '16'])
    n, steps, seed = 4, 5, 11

    net = jget_network('LSTM_train')
    params = net.init_params(jax.random.PRNGKey(0),
                             {'data': (n, 128, 32), 'time_step_len': (n,)})
    bn_state = net.init_bn_state()
    model = get_network('LSTM_train', cfg)
    model.load_state_dict(checkpoint.params_from_flat(
        jcheckpoint.flatten_state({'params': params,
                                   'bn_state': bn_state})))
    model.train()
    tx = jtrain.make_optimizer()
    opt_state = tx.init(params)

    jds = JDataset(path)
    jfeed = JFeed(jds, seed=seed, verbose=False)
    jds.close()
    ds = records.RecordsDataset(path, cfg)
    feed = device_store.RecordsDeviceFeed(ds, seed, 'cpu', verbose=False)
    ds.close()
    assert feed.store.w_bucket == jfeed.store.w_bucket == 128

    jstep = jtrain.make_train_step_gather(net, tx, None)
    step = train.make_train_step_gather(
        model, train.make_optimizer(model, cfg), cfg, None)
    got, want = [], []
    for i in range(steps):
        idx = feed.next_indices(n, 1)
        np.testing.assert_array_equal(idx, jfeed.next_indices(n, 1))
        params, opt_state, bn_state, total, _ = jstep(
            params, opt_state, bn_state, *jfeed.store.arrays,
            jnp.asarray(idx[0]), i)
        want.append(float(total))
        got.append(float(step(*feed.store.arrays,
                              torch.from_numpy(idx[0]))[0]))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _jax_solver_losses(tmp_path, pre_train, max_iters, capsys):
    from lstm_ctc_ocr_tpu.engine.train import SolverWrapper
    from lstm_ctc_ocr_tpu.models.factory import get_network as jget_network
    out = str(tmp_path / 'jax_out')
    os.makedirs(out)
    capsys.readouterr()
    SolverWrapper(jget_network('LSTM_train'), None, pre_train, out,
                  str(tmp_path / 'jax_log')).train_model(max_iters)
    text = capsys.readouterr().out
    return [float(v) for v in re.findall(r'total loss: ([0-9.]+)', text)], \
        text


def test_solver_matches_jax_on_two_buckets(jcfg, tmp_path, capsys):
    """The port's and the JAX solver on a records file of 9 rows in the 96
    bucket and 3 in the 128 one, batch 4, from one pre-train checkpoint, 6
    steps, DATA_DEVICE auto: both take the device store, pad every batch to
    128, and give the same losses within 1e-5 relative. (Host batches pad
    an all-narrow batch to 96, which changes training-mode batch norm's
    statistics: the port's solver did so before it had the store, and missed
    by 1.3e-3 from the first step.) Momentum, linear in the gradient, keeps
    the two packages' rounding differences at ~1e-6 over the 6 steps, where
    Adam's near-sign steps on noise-sized gradients let them grow to ~1e-5
    (tests/test_torch_train.py says how)."""
    widths = [88] * 9 + [120] * 3
    path = _write_records(str(tmp_path / 't.records'), widths)
    cfg, _ = _both(jcfg, [
        'DATA_BACKEND', "'records'", 'RECORDS_PATH', repr(path),
        'DATA_DEVICE', "'auto'", 'TRAIN.BATCH_SIZE', '4',
        'VAL.BATCH_SIZE', '4', 'TRAIN.NUM_HID', '16', 'TRAIN.DISPLAY', '1',
        'TRAIN.SNAPSHOT_ITERS', '100', 'VAL.VAL_STEP', '100',
        'TRAIN.SOLVER', "'Momentum'"])
    # the premise: the walk of the first two epochs holds a batch of
    # narrow rows only
    walk = np.random.RandomState(int(cfg.RNG_SEED))
    batches = [order[s:s + 4] for order in (walk.permutation(12),
                                            walk.permutation(12))
               for s in (0, 4, 8)]
    assert any(all(widths[i] <= 96 for i in b) for b in batches)

    model = get_network('LSTM_train', cfg,
                        generator=torch.Generator().manual_seed(5))
    pre_train = checkpoint.save(model, train.make_optimizer(model, cfg),
                                str(tmp_path / 'pre'), 1, cfg)
    steps = 6
    want, _ = _jax_solver_losses(tmp_path, pre_train, steps + 1, capsys)
    net = get_network('LSTM_train', cfg)
    got = train.train_net(net, {}, pre_train, str(tmp_path / 'out'),
                          str(tmp_path / 'log'), cfg, max_iters=steps + 1,
                          device='cpu')[2]
    assert 'device store: 12 rows @ bucket 128' in capsys.readouterr().out
    assert len(got) == len(want) == steps
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_flush_is_visible_to_the_next_replay(cuda_device, tmp_path):
    """A pool refresh flushed between two replays of the captured K-step
    gather graph changes what the next replay trains on: the store is
    updated in place, where the graph reads it."""
    cfg = load_cfg(YML, ['TRAIN.DTYPE', "'float32'", 'TRAIN.NUM_HID', '16',
                         'TRAIN.LEARNING_RATE', '0.0'])    # the state stays
    imgs = _fake_images([88] * 8)
    store = device_store.DeviceStore(imgs, ['ab04'] * 8, 'uniform',
                                     np.random.RandomState(0), cfg,
                                     cuda_device, flush_every=1000,
                                     verbose=False)
    model = get_network('LSTM_train', cfg,
                        generator=torch.Generator().manual_seed(1)) \
        .to(cuda_device).train()
    optimizer = train.make_optimizer(model, cfg)
    chunk = train.make_train_chunk(model, optimizer, cfg, None, 2,
                                   gather=True)
    idx = torch.tensor([[0, 1, 2, 3], [0, 1, 2, 3]], dtype=torch.int32,
                       device=cuda_device)
    chunk(*store.arrays, idx)               # eager first dispatch, capture
    before = chunk(*store.arrays, idx)[0].cpu()
    ptrs = [a.data_ptr() for a in store.arrays]
    for row in range(4):
        store.stage_refresh(row, _fake_images([60], seed=9 + row)[0], 'c9')
    store.flush_refresh()
    assert [a.data_ptr() for a in store.arrays] == ptrs
    after = chunk(*store.arrays, idx)[0].cpu()
    assert len(chunk.graphs) == 1
    # what eager steps on the refreshed rows give
    step = train.make_train_step_gather(model, optimizer, cfg, None)
    eager = torch.stack([step(*store.arrays, idx[j])[0] for j in range(2)])
    assert not torch.equal(before, after)
    torch.testing.assert_close(after, eager.cpu(), rtol=1e-5, atol=0)
