"""The port's model DSL (``models/network.py``) against the fixed CRNN
modules and against the JAX package's ``Network``.

* A DSL transcription of the JAX ``crnn.LSTM_train`` chain (the chain
  verbatim, ``cfg`` read from ``self.cfg``) has the fixed
  ``models/crnn.py:LSTM_train``'s state-dict keys and, from one generator
  seed, its initial weights, and computes it bit for bit (``torch.equal``):
  logits, BN batch statistics, the L2 term, every gradient, and three
  solver steps' losses and final state. The same holds for a ``.lstm``
  head against the ``make_head`` stacked model, and ``test_net(model=)``
  on release weights gives the fixed model's strings.
* At a narrow width the same chain (and its stacked ``.lstm`` variant)
  matches the JAX ``Network.apply``: every layer's output and the
  gradients of a seeded weighted sum of them, with the JAX parameters
  loaded through the weight bridge, within 1e-5 of each tensor's scale
  (f32; ``LSTM_IMPL: jax``, the plain scan, on the JAX side).
* ``fc``, ``softmax`` and ``avg_pool`` (SAME and VALID, odd and even
  windows, stride 2) likewise; ``dropout``'s semantics (identity outside
  training and at ``keep_prob`` 1, inverted scaling, seeded masks, masks
  keyed by the step and the layer, a K-step dispatch taken);
  ``regularization_loss`` against the
  JAX ``reg_paths``; the ``pool2`` quirk, unnamed layers, the
  ``reshape_squeeze`` and 3-D ``c_i`` asserts and unknown names as in JAX.
"""

import glob
import os
import shutil

import numpy as np
import pytest
import torch

import jax

from lstm_ctc_ocr_torch.config import default_cfg, load_cfg
from lstm_ctc_ocr_torch.engine import checkpoint, train
from lstm_ctc_ocr_torch.engine import test as test_mod
from lstm_ctc_ocr_torch.models import crnn, layers
from lstm_ctc_ocr_torch.models.network import Network

from torch_dsl_cases import (JaxCfg, JChain, PChain, compare_chain,
                             perturbed_params, port_from_jax)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YML = os.path.join(REPO, 'lstm', 'lstm.yml')
NUM_HID = 32


class LSTM_train(Network):
    """The JAX package's ``crnn.LSTM_train`` chain, verbatim."""

    def setup(self):
        cfg = self.cfg
        (self.feed('data')
         .conv_single(3, 3, 64, 1, 1, name='conv1', c_i=cfg.NCHANNELS)
         .max_pool(2, 2, 2, 2, padding='VALID', name='pool1')
         .conv_single(3, 3, 128, 1, 1, name='conv2')
         .max_pool(2, 2, 2, 2, padding='VALID', name='pool2')
         .conv_single(3, 3, 256, 1, 1, name='conv3_1')
         .conv_single(3, 3, 256, 1, 1, name='conv3_2')
         .max_pool(1, 2, 1, 2, padding='VALID', name='pool2')  # dup name
         .conv_single(3, 3, 512, 1, 1, name='conv4_1', bn=True)
         .conv_single(3, 3, 512, 1, 1, name='conv4_2', bn=True)
         .max_pool(1, 2, 1, 2, padding='VALID', name='pool3')
         .conv_single(2, 2, 512, 1, 1, padding='VALID', name='conv5',
                      relu=False)
         .reshape_squeeze_layer(d=512, name='reshaped_layer'))
        (self.feed('reshaped_layer', 'time_step_len')
         .bi_lstm(cfg.TRAIN.NUM_HID, cfg.TRAIN.NUM_LAYERS, name='logits'))


class StackedDSL(LSTM_train):
    """The same chain with a stacked unidirectional head."""

    def setup(self):
        super().setup()
        self.specs.pop()
        self.layer_order.pop()
        (self.feed('reshaped_layer', 'time_step_len')
         .lstm(self.cfg.TRAIN.NUM_HID, 2, name='logits'))


class StackedFixed(crnn.LSTM_train):
    def make_head(self, num_hid, nclasses, generator):
        return layers.LSTM(512, num_hid, 2, nclasses, generator)


def _cfg(*overrides):
    return load_cfg(YML, ['TRAIN.DTYPE', "'float32'", 'TRAIN.NUM_HID',
                          str(NUM_HID)] + list(overrides))


def _pair(dsl_cls, fixed_cls, cfg, seed=3):
    dsl = dsl_cls(cfg, generator=torch.Generator().manual_seed(seed))
    fixed = fixed_cls(int(cfg.NCHANNELS), int(cfg.TRAIN.NUM_HID),
                      int(cfg.NCLASSES),
                      generator=torch.Generator().manual_seed(seed))
    return dsl, fixed


def _batch(n=3, w=64, seed=0, l_max=5):
    rng = np.random.RandomState(seed)
    image = torch.from_numpy(rng.rand(n, w, 32).astype(np.float32))
    steps = torch.tensor([w // 4 - 1, w // 4 - 3, 6][:n], dtype=torch.int32)
    label_len = torch.tensor([l_max, 3, 1][:n], dtype=torch.int32)
    label = torch.from_numpy(rng.randint(1, 60, (n, l_max)).astype(np.int32))
    return image, label, label_len, steps


@pytest.mark.parametrize('dsl_cls,fixed_cls', [(LSTM_train, crnn.LSTM_train),
                                               (StackedDSL, StackedFixed)])
def test_transcription_is_the_fixed_model_bit_for_bit(dsl_cls, fixed_cls):
    cfg = _cfg()
    dsl, fixed = _pair(dsl_cls, fixed_cls, cfg)
    a, b = dsl.state_dict(), fixed.state_dict()
    assert list(a) == list(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert [k for k, _ in dsl.named_parameters()] == \
        [k for k, _ in fixed.named_parameters()]
    image, label, label_len, steps = _batch()
    for moving in (False, True):
        sa, sb = [], []
        ya = dsl(image, steps, moving_bn=moving, bn_collect=sa)
        yb = fixed(image, steps, moving_bn=moving, bn_collect=sb)
        assert torch.equal(ya, yb)
        assert len(sa) == len(sb) == (0 if moving else 2)
        for (_, m1, v1), (_, m2, v2) in zip(sa, sb):
            assert torch.equal(m1, m2) and torch.equal(v1, v2)
    # uint8 pixels are divided by 255 on both sides
    raw = (image * 255).to(torch.uint8)
    assert torch.equal(dsl(raw, steps), fixed(raw, steps))
    ra, rb = dsl.regularization_loss(5e-4), fixed.regularization_loss(5e-4)
    assert torch.equal(ra, rb)
    (ya.square().sum() + ra).backward()
    (yb.square().sum() + rb).backward()
    for (k, p), (_, q) in zip(dsl.named_parameters(),
                              fixed.named_parameters()):
        assert torch.equal(p.grad, q.grad), k

    # three solver steps (clip, Adam, BN moving statistics)
    dsl, fixed = _pair(dsl_cls, fixed_cls, cfg)
    losses = []
    for model in (dsl, fixed):
        model.train()
        opt = train.make_optimizer(model, cfg)
        step = train.make_train_step(model, opt, cfg, None)
        losses.append([step(*_batch(seed=s))[0] for s in range(3)])
    assert all(torch.equal(x, y) for x, y in zip(*losses))
    a, b = dsl.state_dict(), fixed.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_release_strings_through_test_net(tmp_path):
    """``test_net(model=)`` with the DSL transcription restores the
    ``lstm_ctc`` release through the bridge and decodes the fixed model's
    strings (8 val images, f32, on the CPU)."""
    cfg = load_cfg(YML, ['TRAIN.DTYPE', "'float32'", 'TEST.BATCH_SIZE', '4'])
    for f in sorted(glob.glob(os.path.join(REPO, 'data', 'val',
                                           '*.png')))[:8]:
        shutil.copy(f, str(tmp_path))
    out = [test_mod.test_net(cfg, str(tmp_path),
                             os.path.join(REPO, 'checkpoints', 'lstm_ctc'),
                             device='cpu', echo=lambda s: None, model=m)
           for m in (LSTM_train(cfg), crnn.LSTM_train())]
    assert out[0].total == 8
    assert out[0].predictions == out[1].predictions


# --- against the JAX Network at a narrow width --------------------------------

def _crnn_steps(head='bi_lstm', c=8):
    return [
        (('data',), 'conv_single', (3, 3, c, 1, 1), {'name': 'conv1',
                                                     'c_i': 1}),
        (None, 'max_pool', (2, 2, 2, 2), {'padding': 'VALID',
                                          'name': 'pool1'}),
        (None, 'conv_single', (3, 3, c, 1, 1), {'name': 'conv2'}),
        (None, 'max_pool', (2, 2, 2, 2), {'padding': 'VALID',
                                          'name': 'pool2'}),
        (None, 'conv_single', (3, 3, 2 * c, 1, 1), {'name': 'conv3_1'}),
        (None, 'conv_single', (3, 3, 2 * c, 1, 1), {'name': 'conv3_2'}),
        (None, 'max_pool', (1, 2, 1, 2), {'padding': 'VALID',
                                          'name': 'pool2'}),
        (None, 'conv_single', (3, 3, 2 * c, 1, 1), {'name': 'conv4_1',
                                                    'bn': True}),
        (None, 'conv_single', (3, 3, 2 * c, 1, 1), {'name': 'conv4_2',
                                                    'bn': True}),
        (None, 'max_pool', (1, 2, 1, 2), {'padding': 'VALID',
                                          'name': 'pool3'}),
        (None, 'conv_single', (2, 2, 2 * c, 1, 1), {'padding': 'VALID',
                                                    'name': 'conv5',
                                                    'relu': False}),
        (None, 'reshape_squeeze_layer', (), {'d': 2 * c,
                                             'name': 'reshaped_layer'}),
        (('reshaped_layer', 'time_step_len'), head, (16, 2),
         {'name': 'logits'})]


CRNN_IN = ('data', 'time_step_len')


def _crnn_inputs(n=2, w=32):
    rng = np.random.RandomState(5)
    return {'data': rng.rand(n, w, 32).astype(np.float32),
            'time_step_len': np.array([w // 4 - 1, 4][:n], np.int32)}


@pytest.mark.parametrize('head', ['bi_lstm', 'lstm'])
def test_narrow_crnn_matches_jax(head):
    inputs = _crnn_inputs()
    shapes = {k: v.shape for k, v in inputs.items()}
    jnet, pnet, params = compare_chain(_crnn_steps(head), shapes, inputs,
                                       input_names=CRNN_IN)
    assert pnet.output_shape('logits') == jnet.output_shape('logits')
    assert pnet.layer_order == jnet.layer_order


def test_regularization_loss_matches_jax():
    inputs = _crnn_inputs()
    shapes = {k: v.shape for k, v in inputs.items()}
    with JaxCfg(TRAIN__WEIGHT_DECAY=3e-4):
        jnet = JChain(_crnn_steps(), CRNN_IN)
        params = perturbed_params(jnet, shapes)
        want = float(jnet.regularization_loss(params))
    pnet = port_from_jax(PChain(_crnn_steps(), shapes, CRNN_IN), params)
    assert pnet.reg_paths == [(a, tuple(b), c) for a, b, c in jnet.reg_paths]
    assert [e[0] for e in pnet.reg_paths] == [
        'conv1', 'conv2', 'conv3_1', 'conv3_2', 'conv4_1', 'conv4_2', 'conv5',
        'logits']
    got = float(pnet.regularization_loss(3e-4).detach())
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert float(pnet.regularization_loss(0.0)) == 0.0


S4 = (2, 7, 6, 4)


@pytest.mark.parametrize('steps', [
    [(('data',), 'avg_pool', (2, 2, 2, 2), {'name': 'out'})],
    [(('data',), 'avg_pool', (3, 3, 2, 2), {'name': 'out'})],
    [(('data',), 'avg_pool', (3, 2, 2, 2), {'padding': 'VALID',
                                            'name': 'out'})],
    [(('data',), 'avg_pool', (2, 3, 1, 2), {'name': 'out'})],
    [(('data',), 'max_pool', (2, 3, 2, 2), {'name': 'out'})],
    [(('data',), 'max_pool', (3, 3, 2, 1), {'padding': 'VALID',
                                            'name': 'out'})],
    [(('data',), 'conv_single', (4, 3, 5, 2, 2), {'name': 'out',
                                                  'bn': True})],
    [(('data',), 'conv_single', (2, 2, 5, 2, 1), {'name': 'out',
                                                  'biased': False})],
    [(('data',), 'fc', (5,), {'name': 'out'})],
    [(('data',), 'fc', (5,), {'relu': False, 'name': 'fc'}),
     (None, 'softmax', (), {'name': 'out'})],
    [(('data',), 'dropout', (0.5,), {'name': 'out'}),
     (None, 'relu', (), {})],
], ids=['avg_same_even', 'avg_same_odd', 'avg_valid', 'avg_stride_1x2',
        'max_same', 'max_valid_stride_2x1', 'conv_same_stride2_bn',
        'conv_even_stride_2x1_unbiased', 'fc_4d', 'fc_softmax',
        'dropout_eval'])
def test_dsl_layer_matches_jax(steps):
    compare_chain(steps, {'data': S4}, {'data': np.random.RandomState(1)
                                        .randn(*S4).astype(np.float32)})


def test_fc_and_softmax_on_sequences_match_jax():
    shape = (5, 3, 6)
    steps = [(('data',), 'fc', (7,), {'name': 'fc1'}),
             (None, 'fc', (4,), {'relu': False, 'name': 'fc2'}),
             (None, 'softmax', (), {'name': 'prob'})]
    compare_chain(steps, {'data': shape},
                  {'data': np.random.RandomState(2).randn(*shape)
                   .astype(np.float32)})


# --- dropout -------------------------------------------------------------------

class _Drop(Network):
    input_names = ('data',)

    def __init__(self, keep, cfg=None):
        self.keep = keep
        super().__init__(cfg, input_shapes={'data': (4, 8, 8, 16)})

    def setup(self):
        self.feed('data').dropout(self.keep, name='drop')


def test_dropout_semantics():
    x = torch.randn(4, 16, 8, 8) + 3.0
    net = _Drop(0.5)
    assert torch.equal(net.eval()(x), x)             # eval: identity
    assert torch.equal(_Drop(1.0).train()(x), x)     # keep_prob 1: identity
    net.train()
    y = net(x)
    kept = y != 0
    assert torch.allclose(y[kept], x[kept] / 0.5, rtol=0, atol=0)
    frac = kept.float().mean().item()
    assert 0.4 < frac < 0.6, frac
    y2 = net(x)
    assert not torch.equal(y, y2)                    # the generator moves on
    again = _Drop(0.5).train()
    assert torch.equal(again(x), y) and torch.equal(again(x), y2)
    again.seed_dropout(7)
    assert not torch.equal(again(x), y)
    assert _Drop(0.5).has_dropout() and not _Drop(1.0).has_dropout()
    # bf16 stays bf16
    assert _Drop(0.5).train()(x.bfloat16()).dtype == torch.bfloat16


def test_dropout_refuses_k_step_dispatch():
    """No longer refused: the masks are a function of (seed, layer, step),
    whatever the order of the calls, an int step or a tensor one, on any
    device, so a K-step dispatch builds (``tests/test_torch_train.py``
    holds its masks to single steps')."""
    cfg = _cfg()
    net = PChain([(('data',), 'dropout', (0.5,), {'name': 'd1'}),
                  (None, 'dropout', (0.5,), {'name': 'd2'}),
                  (None, 'fc', (3,), {})], {'data': (2, 5)}, cfg=cfg).train()
    opt = train.make_optimizer(net, cfg)
    assert callable(train.make_train_chunk(net, opt, cfg, None, 3))
    x = torch.rand(64, 5) + 1.0

    def masks(step):
        outs = net.outputs(x, dropout_step=step)
        return (outs['d1'] != 0), (outs['d2'] != 0) | (outs['d1'] == 0)
    later = masks(torch.tensor(5, dtype=torch.int32))
    first = masks(4)
    assert all(torch.equal(a, b) for a, b in zip(masks(5), later))
    assert all(torch.equal(a, b) for a, b in zip(masks(4), first))
    assert not torch.equal(first[0], later[0])      # steps differ
    d1, d2 = layers.dropout_key(cfg.RNG_SEED, 0, 4), \
        layers.dropout_key(cfg.RNG_SEED, 1, 4)
    assert int(d1) != int(d2)                       # and so do the layers
    kept = layers.dropout_mask((64, 5), 0.5, d1, 'cpu')
    assert torch.equal(kept, first[0])
    assert 0.4 < kept.float().mean().item() < 0.6


def test_decode_runs_in_eval_mode():
    """The solver's validation decode turns a DSL net's dropout off and
    leaves the net training."""
    cfg = _cfg()

    class WithDrop(LSTM_train):
        def setup(self):
            super().setup()
            spec = self.specs.pop()
            self.layer_order.pop()
            self.feed('reshaped_layer').dropout(0.5, name='drop')
            self.feed('drop', 'time_step_len').bi_lstm(
                spec.kwargs['num_hids'], 2, name='logits')
    net = WithDrop(cfg, generator=torch.Generator().manual_seed(0)).train()
    ref = LSTM_train(cfg, generator=torch.Generator().manual_seed(0)).eval()
    image, _, _, steps = _batch()
    decode = test_mod.make_decode_step(net, cfg, 'cpu')
    got = decode(image.numpy(), steps.numpy())
    want = test_mod.make_decode_step(ref, cfg, 'cpu')(image.numpy(),
                                                      steps.numpy())
    assert np.array_equal(got, want) and net.training


# --- the JAX quirks --------------------------------------------------------------

def test_duplicate_pool2_and_unique_names():
    net = LSTM_train(_cfg())
    assert net.layer_order.count('pool2') == 2
    image, _, _, steps = _batch()
    out = net.outputs(image, steps)
    assert tuple(out['pool2'].shape) == (3, 256, 16, 4)   # the second pool2
    with JaxCfg():
        jnet = JChain([(('data',), 'conv', (1, 1, 2, 1, 1), {}),
                       (None, 'relu', (), {}), (None, 'conv', (1, 1, 2, 1, 1),
                                                {})])
    pnet = PChain(jnet._steps, {'data': S4})
    assert pnet.layer_order == jnet.layer_order == ['conv_1', 'relu_1',
                                                    'conv_2']


@pytest.mark.parametrize('steps,shape,exc', [
    ([(('data',), 'conv_single', (3, 3, 4, 1, 1), {'c_i': 3})], (2, 8, 8),
     AssertionError),
    ([(('data',), 'conv_single', (3, 3, 4, 1, 1), {}),
      (None, 'reshape_squeeze_layer', (), {'d': 16})], (2, 8, 8),
     AssertionError),
    ([(('nope',), 'relu', (), {})], (2, 8, 8), KeyError),
])
def test_asserts_and_unknown_names_as_jax(steps, shape, exc):
    with JaxCfg():
        with pytest.raises(exc):
            JChain(steps).init_params(jax.random.PRNGKey(0), {'data': shape})
    with pytest.raises(exc):
        PChain(steps, {'data': shape})


def test_layer_named_like_a_dsl_method():
    """A layer may be named ``fc`` or ``scale``: it is reached through the
    module table, and its keys read ``fc.weights``."""
    net = PChain([(('data',), 'fc', (3,), {'name': 'fc'}),
                  (None, 'scale', (3,), {'name': 'scale'})],
                 {'data': (2, 5)})
    assert sorted(net.state_dict()) == ['fc.biases', 'fc.weights',
                                        'scale.alpha', 'scale.beta']
    assert callable(net.fc)
    assert net(torch.randn(2, 5)).shape == (2, 3)


def test_default_input_shapes_and_cfg():
    net = LSTM_train()
    assert net.cfg == default_cfg()
    assert net.output_shape('data') == (1, 64, 32)
    assert net.output_shape('logits') == (15, 1, 64)
    assert sorted(checkpoint.flat_from_params(net.state_dict())) == sorted(
        checkpoint.flat_from_params(crnn.LSTM_train().state_dict()))
