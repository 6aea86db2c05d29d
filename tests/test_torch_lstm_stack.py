"""The stacked unidirectional-LSTM model, port against JAX package.

A user of the JAX package reaches the stacked ``lstm`` head by writing a
``Network`` subclass that ends in ``.lstm(...)`` instead of ``.bi_lstm(...)``;
a user of the port overrides ``LSTM_train.make_head``. Both are written out
here, with the CRNN conv stack, 2 x 16 hidden units, batch 4 and W = 64, in
f32 on the CPU (the JAX side runs its ``lax.scan``, the port the plain
versions of its kernels):

* logits from the same weights (carried by ``params_from_flat``) within
  1e-5, and the L2 term within 1e-6;
* one train step against the JAX ``make_train_step``: loss within 1e-4,
  gradients within 1e-4 of the largest, parameters within 1e-5 (the bars of
  tests/test_torch_train.py);
* a snapshot written by either side restores on the other, list-indexed
  cells (``params/logits/cells/0/kernel``) and optimizer state included;
* the entry points: ``train_net`` with the subclass, then ``test_net`` on
  its snapshot.
"""

import copy
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lstm_ctc_ocr_tpu.config import cfg as jcfg
from lstm_ctc_ocr_tpu.engine import checkpoint as jcheckpoint
from lstm_ctc_ocr_tpu.engine import train as jtrain
from lstm_ctc_ocr_tpu.models.network import Network
from lstm_ctc_ocr_torch.config import load_cfg
from lstm_ctc_ocr_torch.data import records
from lstm_ctc_ocr_torch.engine import checkpoint, test as port_test, train
from lstm_ctc_ocr_torch.models.crnn import LSTM_train
from lstm_ctc_ocr_torch.models.layers import LSTM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YML = os.path.join(REPO, 'lstm', 'lstm.yml')
NUM_HID, NUM_LAYERS = 16, 2


class JaxStackedLSTM(Network):
    """The CRNN conv stack with the stacked ``lstm`` head."""

    input_names = ('data', 'time_step_len')

    def setup(self):
        (self.feed('data')
         .conv_single(3, 3, 64, 1, 1, name='conv1', c_i=jcfg.NCHANNELS)
         .max_pool(2, 2, 2, 2, padding='VALID', name='pool1')
         .conv_single(3, 3, 128, 1, 1, name='conv2')
         .max_pool(2, 2, 2, 2, padding='VALID', name='pool2')
         .conv_single(3, 3, 256, 1, 1, name='conv3_1')
         .conv_single(3, 3, 256, 1, 1, name='conv3_2')
         .max_pool(1, 2, 1, 2, padding='VALID', name='pool2')
         .conv_single(3, 3, 512, 1, 1, name='conv4_1', bn=True)
         .conv_single(3, 3, 512, 1, 1, name='conv4_2', bn=True)
         .max_pool(1, 2, 1, 2, padding='VALID', name='pool3')
         .conv_single(2, 2, 512, 1, 1, padding='VALID', name='conv5',
                      relu=False)
         .reshape_squeeze_layer(d=512, name='reshaped_layer'))
        (self.feed('reshaped_layer', 'time_step_len')
         .lstm(jcfg.TRAIN.NUM_HID, jcfg.TRAIN.NUM_LAYERS, name='logits'))


class StackedLSTM(LSTM_train):
    """The port's three-line counterpart."""

    def make_head(self, num_hid, nclasses, generator):
        return LSTM(512, num_hid, NUM_LAYERS, nclasses, generator)


def _port_model(generator=None):
    return StackedLSTM(num_hid=NUM_HID, generator=generator)


@pytest.fixture
def jax_cfg():
    old = copy.deepcopy(dict(jcfg))
    jcfg.TRAIN.DTYPE = 'float32'
    jcfg.TRAIN.SOLVER = 'Adam'
    jcfg.TRAIN.LEARNING_RATE = 0.0001
    jcfg.TRAIN.GAMMA = 1.0
    jcfg.TRAIN.STEPSIZE = 2000
    jcfg.TRAIN.WEIGHT_DECAY = 0.00001
    jcfg.TRAIN.NUM_HID = NUM_HID
    jcfg.TRAIN.NUM_LAYERS = NUM_LAYERS
    jcfg.LSTM_IMPL = 'jax'
    yield jcfg
    jcfg.clear()
    for k, v in old.items():
        jcfg[k] = v


def _port_cfg(*overrides):
    return load_cfg(YML, ['TRAIN.DTYPE', "'float32'", 'TRAIN.NUM_HID',
                          str(NUM_HID)] + list(overrides))


def _jax_init(n=4, w=64):
    net = JaxStackedLSTM()
    params = net.init_params(jax.random.PRNGKey(0),
                             {'data': (n, w, 32), 'time_step_len': (n,)})
    return net, params, net.init_bn_state()


def _port_model_from(params, bn_state):
    model = _port_model()
    flat = jcheckpoint.flatten_state({'params': params, 'bn_state': bn_state})
    assert 'params/logits/cells/1/kernel' in flat
    missing, unexpected = model.load_state_dict(
        checkpoint.params_from_flat(flat), strict=False)
    assert not missing and not unexpected
    return model


def _batch(n=4, w=64, seed=0):
    rng = np.random.RandomState(seed)
    label_len = rng.randint(3, 6, n).astype(np.int32)
    label = rng.randint(1, 63, (n, 6)).astype(np.int32)
    for i in range(n):
        label[i, label_len[i]:] = 0
    return (rng.rand(n, w, 32).astype(np.float32), label, label_len,
            rng.randint(w // 4 - 4, w // 4, n).astype(np.int32))


def test_model_layout_and_init():
    model = _port_model(torch.Generator().manual_seed(0))
    cells = model.logits.cells
    assert len(cells) == NUM_LAYERS
    assert tuple(cells[0].w.shape) == (512, 4 * NUM_HID)
    assert tuple(cells[1].w.shape) == (NUM_HID, 4 * NUM_HID)
    assert tuple(cells[1].u.shape) == (NUM_HID, 4 * NUM_HID)
    w = model.logits.weights.detach()
    assert tuple(w.shape) == (NUM_HID, 64)
    # truncated normal, stddev 0.1 cut at two standard deviations
    assert float(w.abs().max()) <= 0.2 and 0.06 < float(w.std()) < 0.1
    assert not model.logits.biases.any() and not cells[0].bias.any()


def test_logits_and_l2_match_jax(jax_cfg):
    net, params, bn_state = _jax_init()
    model = _port_model_from(params, bn_state)
    image, _, _, time_step = _batch()
    want = np.asarray(net.apply(
        params, {'data': jnp.asarray(image),
                 'time_step_len': jnp.asarray(time_step)},
        train=True, dtype=None)['logits'])
    with torch.no_grad():
        got = model(torch.from_numpy(image), torch.from_numpy(time_step))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == (15, 4, 64)       # time-major
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    cfg = _port_cfg()
    np.testing.assert_allclose(
        float(model.regularization_loss(
            float(cfg.TRAIN.WEIGHT_DECAY)).detach()),
        float(net.regularization_loss(params)), rtol=1e-6)


def test_one_train_step_matches_jax(jax_cfg):
    net, params, bn_state = _jax_init()
    model = _port_model_from(params, bn_state)
    cfg = _port_cfg()
    tx = jtrain.make_optimizer()
    opt_state = tx.init(params)
    batch = _batch()
    params, opt_state, bn_state, jtotal, jctc = jtrain.make_train_step(
        net, tx, None)(params, opt_state, bn_state,
                       *(jnp.asarray(a) for a in batch), 1)
    optimizer = train.make_optimizer(model, cfg)
    total, ctc = train.make_train_step(model.train(), optimizer, cfg, None)(
        *(torch.from_numpy(a) for a in batch))
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-4)
    np.testing.assert_allclose(float(ctc), float(jctc), rtol=1e-4)

    want = {k: np.array(v) for k, v in jcheckpoint.flatten_state(
        {'params': params, 'bn_state': bn_state,
         'opt_state': opt_state}).items()}
    got = checkpoint.flat_from_params(model.state_dict())
    got.update(checkpoint.opt_state_to_flat(optimizer))
    assert set(got) == set(want)
    # after one Adam step from zero moments mu = 0.1 g: the gradients
    grads = {k: (10.0 * want[k], 10.0 * got[k]) for k in want
             if '/.mu/' in k}
    assert any('logits/cells/1/kernel' in k for k in grads)
    g_max = max(float(np.abs(w).max()) for w, _ in grads.values())
    assert g_max > 0.01
    for key, (gw, gg) in sorted(grads.items()):
        np.testing.assert_allclose(gg, gw, rtol=0, atol=1e-4 * g_max,
                                   err_msg=key)
    # Adam turns a gradient below its epsilon into a step of up to lr in
    # either direction; everywhere else the parameters agree to 1e-5. Batch
    # norm removes the bias of conv4_1 / conv4_2: its true gradient is zero,
    # both sides hold rounding noise, and Adam walks it by up to lr.
    for key in (k for k in want if k.startswith('params/')):
        gw, gg = grads['opt_state/1/0/.mu/' + key[len('params/'):]]
        if key in ('params/conv4_1/biases', 'params/conv4_2/biases'):
            assert max(float(np.abs(gw).max()), float(np.abs(gg).max())) \
                < 1e-6, key
            continue
        noise = (np.abs(gw) < 1e-7) & (np.abs(gg) < 1e-7)
        diff = np.abs(got[key] - want[key])
        assert float(diff[~noise].max(initial=0.0)) <= 1e-5, key
        assert float(diff.max(initial=0.0)) <= 2.001e-4, key
    for key in (k for k in want if k.startswith('bn_state/')):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-5,
                                   err_msg=key)


def test_snapshots_cross_restore(jax_cfg, tmp_path):
    cfg = _port_cfg()
    gen = torch.Generator().manual_seed(1)
    model = _port_model(gen)
    optimizer = train.make_optimizer(model, cfg)
    with torch.no_grad():
        model.conv4_1.bn_mean.uniform_(-1, 1, generator=gen)
        for slot in optimizer.moments.values():
            for t in slot.values():
                t.uniform_(0, 1, generator=gen)
    optimizer.count = 7
    ours = checkpoint.save(model, optimizer, str(tmp_path / 'port'), 8, cfg)
    written = checkpoint.read_flat(ours)
    for i in range(NUM_LAYERS):
        for leaf in ('kernel', 'bias'):
            assert 'params/logits/cells/{}/{}'.format(i, leaf) in written
            assert 'opt_state/1/0/.nu/logits/cells/{}/{}'.format(i, leaf) \
                in written
    assert written['params/logits/cells/0/kernel'].shape == (512 + NUM_HID,
                                                             4 * NUM_HID)
    assert written['params/logits/cells/1/kernel'].shape == (2 * NUM_HID,
                                                             4 * NUM_HID)

    # the JAX package restores the port's snapshot into its own state tree
    net, params, bn_state = _jax_init()
    template = {'params': params, 'bn_state': bn_state,
                'opt_state': jtrain.make_optimizer().init(params)}
    state, step = jcheckpoint.restore_latest(template, str(tmp_path / 'port'))
    assert step == 8
    flat = jcheckpoint.flatten_state(state)
    assert set(flat) == set(written)
    for key, arr in flat.items():
        np.testing.assert_array_equal(np.asarray(arr), written[key], key)

    # and the port restores the snapshot the JAX package writes from it
    jcheckpoint.save(state, str(tmp_path / 'jax'), 9)
    model2 = _port_model()
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
    # the round trip through the bridge is exact
    again = checkpoint.flat_from_params(model2.state_dict())
    for key, arr in again.items():
        np.testing.assert_array_equal(arr, written[key], key)


def test_entry_points_take_the_subclass(tmp_path, capsys):
    """``train_net(network, ...)`` trains the subclass and snapshots it;
    ``test_net(..., model=network)`` restores that snapshot into a fresh
    instance and decodes; the default model cannot load it."""
    img_dir = tmp_path / 'imgs'
    img_dir.mkdir()
    val = os.path.join(REPO, 'data', 'val')
    for f in sorted(os.listdir(val))[:8]:
        shutil.copy(os.path.join(val, f), str(img_dir / f))
    rec = str(tmp_path / 'train.records')
    assert records.write_image_annotation_pairs_to_records(str(img_dir),
                                                           rec) == 8
    cfg = _port_cfg('DATA_BACKEND', 'records', 'RECORDS_PATH', rec,
                    'TRAIN.BATCH_SIZE', '4', 'VAL.BATCH_SIZE', '4',
                    'TEST.BATCH_SIZE', '4', 'TRAIN.DISPLAY', '1',
                    'TRAIN.SNAPSHOT_ITERS', '3', 'VAL.VAL_STEP', '3')
    out = str(tmp_path / 'out')
    net = _port_model(torch.Generator().manual_seed(3))
    _, optimizer, losses = train.train_net(net, {}, None, out,
                                           str(tmp_path / 'log'), cfg,
                                           max_iters=4, device='cpu')
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert optimizer.count == 3
    assert os.listdir(out) == ['lstm_ctc_iter_3.ckpt.npz']
    assert 'accuracy: ' in capsys.readouterr().out
    result = port_test.test_net(cfg, str(img_dir), out, device='cpu',
                                echo=lambda s: None, model=_port_model())
    assert result.total == 8 and len(result.predictions) == 8
    with pytest.raises(KeyError, match='cells'):
        port_test.test_net(cfg, str(img_dir), out, device='cpu',
                           echo=lambda s: None)
