"""The shifted-matmul conv lowering (``CONV_IMPL: shifted``,
``lstm_ctc_ocr_torch/ops/conv.py``) against the JAX package's.

* ``conv2d_shifted`` on the JAX test's cases (``tests/test_conv_shifted.py``:
  the CRNN's convs at W=96, strides, even kernels, odd sizes, SAME and
  VALID), the same seeded numpy inputs through both: in f32 the output and
  the gradients of a seeded weighted sum (``dx``, ``dW``, against
  ``jax.grad``) within 1e-5 of each tensor's largest entry (the port sums
  the taps in one GEMM, JAX tap by tap); in bf16 every output within one
  bf16 ulp (adjacent representable values) of JAX's, both rounding an f32
  tap sum once.
* The dispatch: under ``shifted`` the CRNN's conv2 to conv5 take the
  lowering and conv1 (``k*k*c_i = 9 < 256``) stays on ``F.conv2d``; an
  unknown value raises by name; the DSL chain switches with the fixed
  model and computes it bit for bit; the legacy convs never switch.
* The model: the full CRNN forward under ``shifted`` against the JAX
  model under it (weights through the npz bridge, f32, 1e-5 of the
  logits' scale), and five Adam train steps against JAX's, loss by loss
  within 1e-5 relative.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lstm_ctc_ocr_tpu.config import cfg as jcfg
from lstm_ctc_ocr_tpu.engine import checkpoint as jcheckpoint
from lstm_ctc_ocr_tpu.engine import train as jtrain
from lstm_ctc_ocr_tpu.models.factory import get_network as jget_network
from lstm_ctc_ocr_tpu.ops.conv import conv2d_shifted as jconv2d_shifted
from lstm_ctc_ocr_torch.config import load_cfg
from lstm_ctc_ocr_torch.engine import checkpoint, train
from lstm_ctc_ocr_torch.models import crnn, layers
from lstm_ctc_ocr_torch.models.factory import get_network
from lstm_ctc_ocr_torch.ops.conv import conv2d_shifted

from test_conv_shifted import CASES
from test_torch_network import LSTM_train as DslLSTMTrain
from torch_dsl_cases import assert_close, to_jax_layout


@pytest.fixture
def jax_shifted():
    """The JAX package's global cfg under ``CONV_IMPL shifted``, f32, the
    plain scans for the LSTM and the CTC; restored afterwards."""
    old = copy.deepcopy(dict(jcfg))
    jcfg.CONV_IMPL = 'shifted'
    jcfg.TRAIN.DTYPE = 'float32'
    jcfg.LSTM_IMPL = 'jax'
    jcfg.TRAIN.NUM_HID = 16
    yield jcfg
    jcfg.clear()
    for k, v in old.items():
        jcfg[k] = v


def _cfg(*overrides):
    return load_cfg(None, ['CONV_IMPL', "'shifted'", 'TRAIN.DTYPE',
                           "'float32'", 'TRAIN.NUM_HID', '16']
                    + list(overrides))


def _port_conv(x, k, strides, padding):
    """The port's lowering on JAX-layout tensors (NHWC / HWIO)."""
    return conv2d_shifted(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1),
                          strides, padding).permute(0, 2, 3, 1)


@pytest.mark.parametrize('in_shape,k_shape,strides,padding', CASES)
def test_f32_forward_and_gradients_match_jax(in_shape, k_shape, strides,
                                             padding):
    rng = np.random.RandomState(0)
    x = rng.randn(*in_shape).astype(np.float32)
    k = rng.randn(*k_shape).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, b: jconv2d_shifted(
        a, b, strides, padding))(jnp.asarray(x), jnp.asarray(k)))
    ct = rng.randn(*want.shape).astype(np.float32)
    gx_want, gk_want = jax.jit(jax.grad(
        lambda a, b: jnp.vdot(jconv2d_shifted(a, b, strides, padding), ct),
        argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(k))

    tx = torch.from_numpy(x).requires_grad_()
    tk = torch.from_numpy(k).requires_grad_()
    got = _port_conv(tx, tk, strides, padding)
    assert got.dtype == torch.float32
    assert_close(got.detach().numpy(), want, 1e-5, 'forward')
    (got * torch.from_numpy(ct)).sum().backward()
    assert_close(tx.grad.numpy(), gx_want, 1e-5, 'dx')
    assert_close(tk.grad.numpy(), gk_want, 1e-5, 'dW')


@pytest.mark.parametrize('in_shape,k_shape,strides,padding', CASES)
def test_bf16_within_one_ulp_of_jax(in_shape, k_shape, strides, padding):
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(*in_shape).astype(np.float32)).bfloat16()
    k = torch.from_numpy(rng.randn(*k_shape).astype(np.float32)).bfloat16()
    want = jconv2d_shifted(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                           jnp.asarray(k.float().numpy(), jnp.bfloat16),
                           strides, padding)
    assert want.dtype == jnp.bfloat16
    want = torch.from_numpy(np.array(want.astype(jnp.float32))).bfloat16()
    got = _port_conv(x, k, strides, padding)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    # adjacent bf16 values differ by one in their bit patterns (same sign)
    bits = (got.contiguous().view(torch.int16).int()
            - want.view(torch.int16).int()).abs()
    same_sign = torch.signbit(got) == torch.signbit(want)
    assert bool(((bits <= 1) & same_sign | (got == want)).all()), \
        int(bits.max())


def test_conv1_stays_on_conv2d_and_the_rest_switch(monkeypatch):
    model = get_network('LSTM_train', _cfg())
    convs = {n: m for n, m in model.named_children()
             if isinstance(m, layers.ConvSingle)}
    assert [n for n, m in convs.items() if not m.shifted] == ['conv1']
    assert not any(m.shifted for m in get_network(
        'LSTM_train', _cfg('CONV_IMPL', "'xla'")).children()
        if isinstance(m, layers.ConvSingle))
    calls = {'conv2d': 0, 'shifted': 0}
    real_conv2d, real_shifted = layers.F.conv2d, layers.conv2d_shifted

    def count(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped
    monkeypatch.setattr(layers.F, 'conv2d', count('conv2d', real_conv2d))
    monkeypatch.setattr(layers, 'conv2d_shifted',
                        count('shifted', real_shifted))
    model(torch.rand(2, 64, 32), torch.full((2,), 15, dtype=torch.int32))
    assert calls == {'conv2d': 1, 'shifted': 6}
    with pytest.raises(ValueError, match='CONV_IMPL'):
        get_network('LSTM_train', _cfg('CONV_IMPL', "'cudnn'"))


def test_dsl_chain_switches_with_the_fixed_model():
    """The JAX ``LSTM_train`` chain as a port DSL net under ``shifted``: the
    same convs switch, and it computes the fixed model bit for bit; a
    legacy conv stays on ``F.conv2d`` (``layers_legacy``)."""
    from torch_dsl_cases import PChain
    cfg = _cfg()
    dsl = DslLSTMTrain(cfg, generator=torch.Generator().manual_seed(0))
    fixed = crnn.LSTM_train(num_hid=16, conv_impl='shifted',
                            generator=torch.Generator().manual_seed(0))
    assert [n for n, m in dsl.named_children()
            if isinstance(m, layers.ConvSingle) and m.shifted] == \
        ['conv2', 'conv3_1', 'conv3_2', 'conv4_1', 'conv4_2', 'conv5']
    x = torch.rand(2, 64, 32)
    lens = torch.full((2,), 15, dtype=torch.int32)
    assert torch.equal(dsl.train()(x, lens), fixed.train()(x, lens))
    legacy = PChain([(('data',), 'conv', (3, 3, 64, 1, 1), {})],
                    {'data': (1, 8, 8, 64)}, cfg=cfg)
    assert not any(getattr(m, 'shifted', False) for m in legacy.modules())


def _jax_init(n=2, w=64):
    net = jget_network('LSTM_train')
    params = net.init_params(jax.random.PRNGKey(0),
                             {'data': (n, w, 32), 'time_step_len': (n,)})
    return net, params, net.init_bn_state()


def _port_from(cfg, params, bn_state):
    model = get_network('LSTM_train', cfg)
    missing, unexpected = model.load_state_dict(checkpoint.params_from_flat(
        jcheckpoint.flatten_state({'params': params, 'bn_state': bn_state})),
        strict=False)
    assert not missing and not unexpected
    return model


def test_crnn_forward_matches_jax_under_shifted(jax_shifted):
    net, params, bn_state = _jax_init()
    model = _port_from(_cfg(), params, bn_state).eval()
    rng = np.random.RandomState(2)
    x = rng.rand(2, 64, 32).astype(np.float32)
    lens = np.array([15, 12], np.int32)
    want = np.asarray(jax.jit(lambda p, feed: net.apply(
        p, feed, train=False)['logits'])(
            params, {'data': jnp.asarray(x),
                     'time_step_len': jnp.asarray(lens)}))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(lens))
    assert_close(to_jax_layout(got), want, 1e-5, 'logits')


def test_five_train_steps_match_jax_under_shifted(jax_shifted):
    jax_shifted.TRAIN.SOLVER, jax_shifted.TRAIN.LEARNING_RATE = 'Adam', 1e-4
    net, params, bn_state = _jax_init()
    cfg = _cfg('TRAIN.SOLVER', "'Adam'", 'TRAIN.LEARNING_RATE', '0.0001')
    model = _port_from(cfg, params, bn_state).train()
    tx = jtrain.make_optimizer()
    opt_state = tx.init(params)
    jstep = jtrain.make_train_step(net, tx, None)
    step = train.make_train_step(model, train.make_optimizer(model, cfg),
                                 cfg, None)
    rng = np.random.RandomState(0)
    losses = []
    for i in range(5):
        label_len = rng.randint(3, 6, 2).astype(np.int32)
        label = rng.randint(1, 63, (2, 6)).astype(np.int32)
        for j in range(2):
            label[j, label_len[j]:] = 0
        batch = (rng.rand(2, 64, 32).astype(np.float32), label, label_len,
                 rng.randint(12, 16, 2).astype(np.int32))
        params, opt_state, bn_state, jtotal, _ = jstep(
            params, opt_state, bn_state, *(jnp.asarray(a) for a in batch),
            i + 1)
        total, _ = step(*(torch.from_numpy(a) for a in batch))
        losses.append((float(total), float(jtotal)))
    got, want = np.array(losses).T
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert np.isfinite(got).all() and got[-1] != got[0]
