"""Every hidden width the JAX package runs, in the port.

* The BiLSTM (``ops/rnn.bilstm``) and the stacked head's scan
  (``ops/rnn.lstm``) at H in {5, 12, 20} per direction -- widths that are no
  multiple of the kernels' 16 bytes -- against the JAX package's
  ``ops/rnn.bilstm`` / ``lstm_scan`` and ``rnn_pallas.bilstm`` /
  ``lstm_scan`` (in Pallas interpret mode off the TPU, as
  tests/test_rnn_pallas.py runs them): outputs and gradients, 1e-5 absolute
  and relative in f32.
* ``rnn_cuda.resize_hidden``, the zero padding the CUDA wrappers put around
  a width that is no multiple of 8 (bf16) or 4 (f32): pad then cut gives
  the input back bit for bit; the plain versions on the padded operands give
  exact zeros in every padded unit and the unpadded results in the real
  ones. Where the plain version's arithmetic does not depend on the width
  the results are bit for bit the same (bf16 forward); elsewhere torch's
  CPU matmul and column sums choose their blocking by shape, so the zero
  rows and columns can change the order in which the real terms are summed:
  f32 within 1e-5 of each output's largest entry, bf16 within 4 bf16 ulps of
  it.
* The CRNN at ``TRAIN.NUM_HID`` 10 and 24 (H = 5 and 12 a direction): the
  JAX forward and three JAX train steps against the port's, from the same
  weights through the weight bridge (``engine/checkpoint.py:
  params_from_flat``), f32: logits within 2e-4 (tests/test_torch_model.py's
  bar), each step's loss within 1e-4 relative, and under Momentum every
  parameter within 1e-6 after the three steps (tests/test_torch_train.py's
  bars, the batch-norm-removed conv4 biases excepted as there).

The CUDA kernels at these widths are held against their plain versions on
the card by tests/test_torch_cuda.py (skipped without a GPU) and by
chip_smoke.py's phase 14.
"""

import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lstm_ctc_ocr_tpu.config import cfg as jcfg
from lstm_ctc_ocr_tpu.engine import checkpoint as jcheckpoint
from lstm_ctc_ocr_tpu.engine import train as jtrain
from lstm_ctc_ocr_tpu.models.factory import get_network as jget_network
from lstm_ctc_ocr_tpu.ops import rnn as jrnn
from lstm_ctc_ocr_tpu.ops import rnn_pallas
from lstm_ctc_ocr_torch.config import load_cfg
from lstm_ctc_ocr_torch.engine import checkpoint, train
from lstm_ctc_ocr_torch.models.factory import get_network
from lstm_ctc_ocr_torch.ops import rnn, rnn_cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 12
WIDTHS = [5, 12, 20]


def _cell(rng, h):
    return {'kernel': (rng.randn(D + h, 4 * h) * 0.3).astype(np.float32),
            'bias': (rng.randn(4 * h) * 0.1).astype(np.float32)}


def _torch_cell(cell, leaves):
    c = {'w': torch.from_numpy(cell['kernel'][:D].copy()),
         'u': torch.from_numpy(cell['kernel'][D:].copy()),
         'bias': torch.from_numpy(cell['bias'].copy())}
    for p in ('w', 'u', 'bias'):
        c[p].requires_grad_()
        leaves.append(c[p])
    return c


def _lens(rng, t, n):
    lens = rng.randint(0, t + 1, size=n).astype(np.int32)
    lens[0], lens[1], lens[2] = 0, t, 1       # empty, full, one frame
    return lens


def _jax_grads(fn, params, x, lens, wgt):
    def loss(p, xx):
        return jnp.sum(fn(p, xx, jnp.asarray(lens)) * wgt)
    out = fn(params, jnp.asarray(x), jnp.asarray(lens))
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    return np.asarray(out), gp, np.asarray(gx)


def _split(g):
    """JAX ``kernel`` [D+H, 4H] gradient -> the port's (w, u) halves."""
    k = np.asarray(g['kernel'])
    return [k[:D], k[D:], np.asarray(g['bias'])]


@pytest.mark.parametrize('h', WIDTHS)
def test_bilstm_matches_jax_at_width(h):
    rng = np.random.RandomState(h)
    t, n = 9, 5
    cells = {k: _cell(rng, h) for k in ('fw', 'bw')}
    x = rng.randn(n, t, D).astype(np.float32)
    lens = _lens(rng, t, n)
    wgt = rng.randn(n, t, 2 * h).astype(np.float32)
    jparams = {k: {p: jnp.asarray(v) for p, v in c.items()}
               for k, c in cells.items()}

    leaves = []
    tcells = {k: _torch_cell(c, leaves) for k, c in cells.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out = rnn.bilstm(tcells, xt, torch.from_numpy(lens))
    (out * torch.from_numpy(wgt)).sum().backward()
    got = [out.detach().numpy(), xt.grad.numpy()] + [
        leaf.grad.numpy() for leaf in leaves]
    assert out.shape == (n, t, 2 * h)
    assert np.all(got[0][np.arange(t)[None, :] >= lens[:, None]] == 0.0)

    for fn in (rnn_pallas.bilstm, jrnn.bilstm, jrnn.bilstm_scan_pair):
        jout, gp, gx = _jax_grads(fn, jparams, x, lens, wgt)
        want = [jout, gx] + _split(gp['fw']) + _split(gp['bw'])
        for name, g, w in zip(['out', 'x', 'fw.w', 'fw.u', 'fw.bias', 'bw.w',
                               'bw.u', 'bw.bias'], got, want):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg='{} {}'.format(fn, name))
    assert rnn_cuda.bilstm_fwd.launches == rnn_cuda.bilstm_bwd.launches == 0


@pytest.mark.parametrize('h', WIDTHS)
def test_lstm_matches_jax_at_width(h):
    rng = np.random.RandomState(100 + h)
    t, n = 9, 5
    cell = _cell(rng, h)
    x = rng.randn(t, n, D).astype(np.float32)
    lens = _lens(rng, t, n)
    wgt = rng.randn(t, n, h).astype(np.float32)
    jparams = {p: jnp.asarray(v) for p, v in cell.items()}

    leaves = []
    tcell = _torch_cell(cell, leaves)
    xt = torch.from_numpy(x).requires_grad_()
    out = rnn.lstm(tcell, xt, torch.from_numpy(lens))
    (out * torch.from_numpy(wgt)).sum().backward()
    got = [out.detach().numpy(), xt.grad.numpy()] + [
        leaf.grad.numpy() for leaf in leaves]
    assert out.shape == (t, n, h)

    for fn in (rnn_pallas.lstm_scan, jrnn.lstm_scan):
        jout, gp, gx = _jax_grads(fn, jparams, x, lens, wgt)
        want = [jout, gx] + _split(gp)
        for name, g, w in zip(['out', 'x', 'w', 'u', 'bias'], got, want):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg='{} {}'.format(fn, name))
    assert rnn_cuda.lstm_fwd.launches == rnn_cuda.lstm_bwd.launches == 0


@pytest.mark.parametrize('kind,shape', [('units', (3, 2, 5)),
                                        ('gates', (3, 2, 20)),
                                        ('u', (5, 20))])
def test_resize_hidden_pads_each_gate_and_cuts_back(kind, shape):
    x = torch.from_numpy(np.random.RandomState(1).randn(*shape)
                         .astype(np.float32))
    wide = rnn_cuda.resize_hidden(x, kind, 5, 8)
    assert wide.shape == {'units': (3, 2, 8), 'gates': (3, 2, 32),
                          'u': (8, 32)}[kind]
    assert torch.equal(rnn_cuda.resize_hidden(wide, kind, 8, 5), x)
    if kind == 'units':
        assert torch.equal(wide[..., :5], x) and not wide[..., 5:].any()
    else:
        real = wide[:5] if kind == 'u' else wide
        blocks = real.reshape(*real.shape[:-1], 4, 8)
        assert torch.equal(blocks[..., :5], x.reshape(*x.shape[:-1], 4, 5))
        assert not blocks[..., 5:].any()
        assert kind == 'gates' or not wide[5:].any()
    assert rnn_cuda.resize_hidden(x, kind, 5, 5) is x


def _bar(ref, dtype):
    scale = max(float(ref.float().abs().max()), 1e-6)
    return (1e-5 if dtype == torch.float32 else 4 / 256) * scale


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('h', WIDTHS + [50])
def test_padded_plain_version_gives_the_unpadded_results(dtype, h):
    """What the wrappers do on the card, with the plain versions in the
    kernels' place: pad H to the kernels' step, run, cut back."""
    dt = getattr(torch, dtype)
    step = rnn_cuda.hidden_step(dt)
    width = -(-h // step) * step
    if width == h:
        width += step
    rng = np.random.RandomState(h)
    t, n = 9, 5

    def mk(*shape, scale=0.5):
        return torch.from_numpy((rng.randn(*shape) * scale)
                                .astype(np.float32)).to(dt)
    lens = torch.from_numpy(_lens(rng, t, n))
    xpf, xpb = mk(t, n, 4 * h), mk(t, n, 4 * h)
    uf, ub, bf, bb = mk(h, 4 * h), mk(h, 4 * h), mk(4 * h), mk(4 * h)

    def pad(x, kind):
        return rnn_cuda.resize_hidden(x, kind, h, width)

    # a padded unit's gates: i, j, f, o of a zero pre-activation
    zero_unit = torch.sigmoid(torch.tensor([0.0, 0.0, 1.0, 0.0]))
    zero_unit[1] = 0.0

    def check(padded, want, kinds, exact, forward):
        for p, w, kind in zip(padded, want, kinds):
            cut = rnn_cuda.resize_hidden(p, kind, width, h)
            if exact:
                assert torch.equal(cut, w), kind
            else:
                torch.testing.assert_close(cut.float(), w.float(), rtol=0,
                                           atol=_bar(w, dt))
            # every padded unit holds exactly what a unit that is zero
            # throughout holds: zero h, c, output and gradients
            expect = pad(cut, kind)
            if forward and kind == 'gates':
                blocks = expect.view(*expect.shape[:-1], 4, width)
                blocks[..., h:] = zero_unit.to(dt)[:, None]
            assert torch.equal(expect, p), kind

    want = rnn_cuda.bilstm_fwd_reference(xpf, xpb, uf, ub, bf, bb, lens,
                                         save_residuals=True)
    got = rnn_cuda.bilstm_fwd_reference(
        pad(xpf, 'gates'), pad(xpb, 'gates'), pad(uf, 'u'), pad(ub, 'u'),
        pad(bf, 'gates'), pad(bb, 'gates'), lens, save_residuals=True)
    check(got, want, ('units', 'gates', 'units', 'units') * 2,
          exact=dt == torch.bfloat16, forward=True)

    of, gf, hf, cf, ob, gb, hb, cb = want
    dof, dob = mk(t, n, h), mk(t, n, h)
    want = rnn_cuda.bilstm_bwd_reference(dof, dob, gf, hf, cf, gb, hb, cb,
                                         uf, ub, lens)
    got = rnn_cuda.bilstm_bwd_reference(
        pad(dof, 'units'), pad(dob, 'units'), pad(gf, 'gates'),
        pad(hf, 'units'), pad(cf, 'units'), pad(gb, 'gates'),
        pad(hb, 'units'), pad(cb, 'units'), pad(uf, 'u'), pad(ub, 'u'), lens)
    check(got, want, ('gates', 'gates', 'u', 'gates', 'u', 'gates'),
          exact=False, forward=False)

    want = rnn_cuda.lstm_fwd_reference(xpf, uf, bf, lens, save_residuals=True)
    got = rnn_cuda.lstm_fwd_reference(pad(xpf, 'gates'), pad(uf, 'u'),
                                      pad(bf, 'gates'), lens,
                                      save_residuals=True)
    check(got, want, ('units', 'gates', 'units', 'units'),
          exact=dt == torch.bfloat16, forward=True)
    out, gates, hs, cs = want
    want = rnn_cuda.lstm_bwd_reference(dof, gates, hs, cs, uf, lens)
    got = rnn_cuda.lstm_bwd_reference(pad(dof, 'units'), pad(gates, 'gates'),
                                      pad(hs, 'units'), pad(cs, 'units'),
                                      pad(uf, 'u'), lens)
    check(got, want, ('gates', 'u', 'gates'), exact=False, forward=False)


@pytest.mark.parametrize('dtype,h,path', [
    (torch.bfloat16, 256, 'cluster'), (torch.bfloat16, 512, 'cluster'),
    (torch.bfloat16, 505, 'cluster'), (torch.bfloat16, 1, 'cluster'),
    (torch.bfloat16, 513, 'wide'), (torch.bfloat16, 1024, 'wide'),
    (torch.float32, 8, 'wide'), (torch.float32, 256, 'wide'),
    (torch.float32, 513, 'wide'), (torch.float32, 8192, 'wide')])
def test_kernel_path_by_width(dtype, h, path):
    """The bf16 cluster kernels keep the main path's widths (H = 256 a
    direction, 512 stacked) and take every padded width up to 512; the wide
    recurrence takes the rest, and f32 at every width."""
    assert rnn_cuda.kernel_path(dtype, h) == path


# --- the CRNN at narrow widths -------------------------------------------

@pytest.fixture
def jax_momentum_cfg():
    """The JAX package's global config with ``lstm/lstm.yml``'s solver
    settings in f32 under Momentum; restored afterwards."""
    old = copy.deepcopy(dict(jcfg))
    jcfg.TRAIN.DTYPE = 'float32'
    jcfg.TRAIN.SOLVER = 'Momentum'
    jcfg.TRAIN.LEARNING_RATE = 0.0001
    jcfg.TRAIN.GAMMA = 1.0
    jcfg.TRAIN.STEPSIZE = 2000
    jcfg.TRAIN.WEIGHT_DECAY = 0.00001
    yield jcfg
    jcfg.clear()
    for k, v in old.items():
        jcfg[k] = v


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


@pytest.mark.parametrize('num_hid', [10, 24])
def test_crnn_at_width_matches_jax(jax_momentum_cfg, num_hid):
    jax_momentum_cfg.TRAIN.NUM_HID = num_hid
    net = jget_network('LSTM_train')
    params = net.init_params(jax.random.PRNGKey(0),
                             {'data': (4, 64, 32), 'time_step_len': (4,)})
    bn_state = net.init_bn_state()
    assert params['logits']['cells']['fw']['bias'].shape == (2 * num_hid,)
    cfg = load_cfg(os.path.join(REPO, 'lstm', 'lstm.yml'),
                   ['TRAIN.DTYPE', "'float32'", 'TRAIN.SOLVER', "'Momentum'",
                    'TRAIN.LEARNING_RATE', '0.0001', 'TRAIN.NUM_HID',
                    str(num_hid)])
    model = get_network('LSTM_train', cfg)
    flat = jcheckpoint.flatten_state({'params': params, 'bn_state': bn_state})
    missing, unexpected = model.load_state_dict(
        checkpoint.params_from_flat(flat), strict=False)
    assert not missing and not unexpected
    batches = _batches(3)

    # the forward, batch statistics (train mode)
    x, _, _, lens = batches[0]
    want = np.asarray(net.apply(
        params, {'data': jnp.asarray(x), 'time_step_len': jnp.asarray(lens)},
        dtype=None, bn_stats=None)['logits'])
    with torch.no_grad():
        got = model.train()(torch.from_numpy(x), torch.from_numpy(lens))
    assert got.shape == want.shape == (15, 4, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)

    # three train steps
    init = {k: np.array(v) for k, v in
            jcheckpoint.flatten_state({'params': params}).items()}
    tx = jtrain.make_optimizer()
    opt_state = tx.init(params)
    jstep = jtrain.make_train_step(net, tx, None)
    optimizer = train.make_optimizer(model, cfg)
    step = train.make_train_step(model.train(), optimizer, cfg, None)
    for i, batch in enumerate(batches):
        params, opt_state, bn_state, jtotal, jctc = jstep(
            params, opt_state, bn_state, *(jnp.asarray(a) for a in batch),
            i + 1)
        total, ctc_loss = step(*(torch.from_numpy(a) for a in batch))
        np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-4)
        np.testing.assert_allclose(float(ctc_loss), float(jctc), rtol=1e-4)
    want = jcheckpoint.flatten_state({'params': params})
    got = checkpoint.flat_from_params(model.state_dict())
    moved = False
    for key, w in want.items():
        if key.split('/')[-2:] in (['conv4_1', 'biases'],
                                   ['conv4_2', 'biases']):
            continue            # batch norm removes them: rounding noise
        np.testing.assert_allclose(got[key], np.asarray(w), rtol=0,
                                   atol=1e-6, err_msg=key)
        moved = moved or float(np.abs(np.asarray(w) - init[key]).max()) > 1e-6
    assert moved
