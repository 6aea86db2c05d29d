"""The port's measurement tools (``lstm_ctc_ocr_torch/tools``) on the CPU.

Each tool's ``main(argv)`` runs in this process with ``--device cpu`` at a
tiny size and one window of one call: every line it prints parses as JSON
and carries the key set of the JAX tool's line of the same kind, cited
below by file and line. On the CPU the kernels' wrappers take their plain
versions, so this checks the plumbing; times are the card's business.

Beside the keys:

* ``bench_fold_h``: the port's baseline and folded late stacks both equal
  the JAX tool's ``late_stack_baseline`` (``tools/bench_fold_h.py:82``) in
  f32, on the JAX tool's own ``make_params`` (``:50``), within its gate,
  1e-4 relative; the port's own gate passes.
* ``attrib_step``'s ``ctc=none`` loss equals the JAX tool's dummy loss
  (``tools/attrib_step.py:60-66``: ``mean(logits^2)`` + the L2 term) on the
  same bridged weights and batch, within 1e-5.
* ``bench_data`` keeps an error line for a renderer that cannot import, as
  the JAX tool does.
* The FLOP count adds the hand kernels' work per launch, and the peak
  lookup knows the H100 and nothing else.
"""

import importlib.util
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lstm_ctc_ocr_tpu.config import cfg as jcfg
from lstm_ctc_ocr_tpu.engine import checkpoint as jcheckpoint
from lstm_ctc_ocr_tpu.models.factory import get_network as jget_network
from lstm_ctc_ocr_torch.config import load_cfg
from lstm_ctc_ocr_torch.data import gen, records
from lstm_ctc_ocr_torch.engine import checkpoint
from lstm_ctc_ocr_torch.models.factory import get_network
from lstm_ctc_ocr_torch.tools import (_common, attrib_step, bench_ctc,
                                      bench_data, bench_decode, bench_fold_h,
                                      bench_rnn, profile_step)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the JAX tools' JSON lines, by the keys they print
JAX_KEYS = {
    # tools/bench_ctc.py:75-83, :91-98, :99-100
    'ctc_impl': {'impl', 'fwd_ms', 'fwd_bwd_ms'},
    'ctc_piece': {'piece', 'ms'},
    'ctc_device': {'device', 'shape'},
    # tools/bench_rnn.py:85-88, :90-92
    'rnn_impl': {'impl', 'fwd_ms', 'fwd_bwd_ms', 'shape', 'hidden', 'dtype',
                 'device'},
    'rnn_speedup': {'speedup_fwd', 'speedup_fwd_bwd'},
    # tools/bench_decode.py:90-96, :126-132, :183
    'decode_row': {'shape', 'width', 'batch', 'decoder', 'beam_width',
                   'scope', 'p50_sec_per_batch', 'p50_ms_per_image',
                   'images_per_sec'},
    'decode_frozen': {'shape', 'width', 'batch', 'decoder', 'variant',
                      'p50_sec_per_batch', 'p50_ms_per_image',
                      'images_per_sec'},
    'decode_ratio': {'beam_over_greedy_full_step'},
    # tools/profile_step.py:58-64 (flops and a known peak: every key),
    # :159-161
    'profile_piece': {'piece', 'ms', 'gflops', 'tflops_achieved', 'mfu'},
    'profile_device': {'device', 'batch', 'width', 'lstm_impl', 'ctc_impl'},
    # tools/attrib_step.py:123, :126-133
    'attrib_variant': {'variant', 'ms_per_step'},
    'attrib_delta': {'delta_ctc_pallas_vs_scan_ms',
                     'delta_ctc_pallas_vs_none_ms',
                     'delta_lstm_pallas_vs_scan_ms', 'device'},
    # tools/bench_data.py:45, :112, :85-87, :121
    'data_renderer': {'renderer', 'img_per_sec'},
    'data_renderer_error': {'renderer', 'error'},
    'data_backend': {'backend', 'batch', 'batches_per_sec', 'img_per_sec'},
    'data_backend_error': {'backend', 'error'},
    # tools/bench_fold_h.py:169-170, :189-191
    'fold_check': {'check', 'rel_err', 'shape'},
    'fold_variant': {'variant', 'batch', 'w', 'fwd_ms', 'fwd_bwd_ms'},
}

TINY_MODEL = ['RENDERER', 'native', 'TRAIN.NUM_HID', '16', 'TRAIN.DTYPE',
              "'float32'"]
ONE = ['--device', 'cpu', '--windows', '1', '--calls', '1']


def _lines(main, argv, capsys):
    capsys.readouterr()
    assert main(argv) == 0
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith('{')]


def _keys(lines):
    return [set(line) for line in lines]


def test_bench_ctc_lines(capsys):
    lines = _lines(bench_ctc.main, ONE + ['--batch', '3', '--frames', '7',
                                          '--classes', '8', '--maxlen', '3'],
                   capsys)
    assert _keys(lines) == [JAX_KEYS['ctc_impl']] * 2 \
        + [JAX_KEYS['ctc_piece']] * 2 + [JAX_KEYS['ctc_device']]
    assert [line['impl'] for line in lines[:2]] == ['plain', 'kernels']
    assert lines[-1] == {'device': 'cpu', 'shape': [3, 7, 8]}


def test_bench_rnn_lines(capsys):
    lines = _lines(bench_rnn.main, ONE + [
        '--batch', '2', '--frames', '5', '--input-dim', '16', '--hidden', '8',
        '--dtype', 'float32'], capsys)
    assert _keys(lines) == [JAX_KEYS['rnn_impl']] * 2 \
        + [JAX_KEYS['rnn_speedup']]
    assert [line['impl'] for line in lines[:2]] == ['scan_pair', 'fused']
    assert lines[0]['shape'] == [2, 5, 16] and lines[0]['device'] == 'cpu'


def test_bench_decode_lines(capsys):
    lines = _lines(bench_decode.main, ONE + ['--batch', '2'], capsys)
    assert _keys(lines) == [JAX_KEYS['decode_row']] * 8 \
        + [JAX_KEYS['decode_ratio']]
    assert [(r['shape'], r['decoder'], r['scope']) for r in lines[:8]] == [
        (s, d, sc) for s in ('default_W96', 'longline_W448')
        for d in ('greedy', 'beam') for sc in ('full_step', 'decoder_only')]
    assert set(lines[-1]['beam_over_greedy_full_step']) == {
        'default_W96', 'longline_W448'}


def test_bench_decode_frozen_lines(capsys):
    """Live against the frozen artifact, beam at W=96; no portable-program
    line (the port's artifact holds the kernels as custom ops)."""
    lines = _lines(bench_decode.main, ONE + ['--batch', '2', '--frozen'],
                   capsys)
    assert _keys(lines) == [JAX_KEYS['decode_frozen']] * 2
    assert [(r['variant'], r['decoder']) for r in lines] == [
        ('live_kernels', 'beam'), ('frozen_artifact', 'beam')]


def test_profile_step_lines(capsys):
    lines = _lines(profile_step.main, ONE + [
        '--batch', '2', '--width', '64', '--set'] + TINY_MODEL, capsys)
    assert _keys(lines) == [JAX_KEYS['profile_piece']] * 5 \
        + [JAX_KEYS['profile_device']]
    assert [r['piece'] for r in lines[:5]] == [
        'fwd_loss (model+ctc)', 'model_fwd (cnn+bilstm+proj)', 'ctc_fwd',
        'ctc_fwd_bwd', 'full_step (fwd+bwd+adam)']
    assert lines[-1]['lstm_impl'] == lines[-1]['ctc_impl'] == 'plain'
    # the CPU has no peak in the table: no MFU, but a FLOP count
    assert all(r['mfu'] is None for r in lines[:5])
    assert lines[4]['gflops'] > lines[1]['gflops'] > 0


def test_attrib_step_lines(capsys):
    lines = _lines(attrib_step.main, ONE + [
        '--batch', '2', '--width', '64', '--warm', '1', '--set'] + TINY_MODEL,
        capsys)
    assert _keys(lines) == [JAX_KEYS['attrib_variant']] * 5 \
        + [JAX_KEYS['attrib_delta']]
    assert [r['variant'] for r in lines[:5]] == [
        'ctc=kernel lstm=kernel', 'ctc=plain lstm=kernel',
        'ctc=kernel lstm=plain', 'ctc=none lstm=kernel', 'conv=shifted']
    assert lines[-1]['device'] == 'cpu'


@pytest.fixture
def val_records(tmp_path):
    img_dir = tmp_path / 'imgs'
    img_dir.mkdir()
    val = os.path.join(REPO, 'data', 'val_digit4')
    for f in sorted(os.listdir(val))[:12]:
        shutil.copy(os.path.join(val, f), str(img_dir / f))
    path = str(tmp_path / 'val.records')
    assert records.write_image_annotation_pairs_to_records(str(img_dir),
                                                           path) == 12
    return path


def test_bench_data_lines(capsys, monkeypatch, tmp_path, val_records):
    """``--renderers native``: the native renderer's rate, then the three
    backends rendered with it (the pool's cache goes under the working
    directory)."""
    monkeypatch.chdir(tmp_path)
    lines = _lines(bench_data.main, [
        '--device', 'cpu', '--batch', '4', '--batches', '2', '--images', '2',
        '--pool-size', '8', '--renderers', 'native', '--set', 'RECORDS_PATH',
        val_records, 'TRAIN.NUM_WORKERS', '0'], capsys)
    assert _keys(lines) == [JAX_KEYS['data_renderer']] \
        + [JAX_KEYS['data_backend']] * 3
    assert [r['backend'] for r in lines[1:]] == ['synth', 'pool', 'records']
    assert os.listdir(str(tmp_path / 'data' / 'pool_cache'))


def test_bench_data_keeps_an_error_line(capsys, monkeypatch, val_records):
    """A renderer whose import fails prints its error line, as in JAX, and
    the run goes on."""
    real = gen._renderer

    def no_pillow(cfg):
        if str(cfg.RENDERER) == 'captcha':
            raise ImportError('RENDERER captcha: no Pillow here')
        return real(cfg)
    monkeypatch.setattr(gen, '_renderer', no_pillow)
    lines = _lines(bench_data.main, [
        '--device', 'cpu', '--batch', '4', '--batches', '2', '--images', '2',
        '--renderers', 'native,captcha', '--backends', 'records', '--set',
        'RECORDS_PATH', val_records], capsys)
    assert _keys(lines) == [JAX_KEYS['data_renderer'],
                            JAX_KEYS['data_renderer_error'],
                            JAX_KEYS['data_backend']]
    assert 'no Pillow' in lines[1]['error']


def test_bench_fold_h_lines(capsys):
    lines = _lines(bench_fold_h.main, ONE + ['--batch', '2', '--width', '4'],
                   capsys)
    assert _keys(lines) == [JAX_KEYS['fold_check']] \
        + [JAX_KEYS['fold_variant']] * 2
    assert lines[0]['rel_err'] < 1e-4
    assert [r['variant'] for r in lines[1:]] == ['baseline_H4', 'fold_h_H1']


@pytest.fixture(scope='module')
def jax_fold():
    spec = importlib.util.spec_from_file_location(
        'jax_bench_fold_h', os.path.join(REPO, 'tools', 'bench_fold_h.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize('batch,width', [(2, 6), (3, 24)])
def test_fold_h_stacks_equal_jax_baseline(jax_fold, batch, width):
    rng = np.random.RandomState(batch)
    jparams = jax_fold.make_params(rng)
    params = bench_fold_h.params_from_hwio(
        {k: {n: np.asarray(v) for n, v in p.items()}
         for k, p in jparams.items()})
    x = rng.randn(batch, width, 4, 256).astype(np.float32)
    with jax.default_matmul_precision('float32'):
        want = np.asarray(jax_fold.late_stack_baseline(jparams,
                                                       jnp.asarray(x)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        for stack in (bench_fold_h.late_stack_baseline,
                      bench_fold_h.late_stack_folded):
            got = stack(params, xt).permute(0, 2, 3, 1).numpy()
            assert got.shape == want.shape == (batch, width - 1, 1, 512)
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err < 1e-4, (stack.__name__, err)


def test_fold_tridiag_matches_jax(jax_fold):
    k = np.random.RandomState(0).randn(3, 3, 5, 7).astype(np.float32)
    want = np.asarray(jax_fold.fold_tridiag(jnp.asarray(k), 4))
    got = bench_fold_h.fold_tridiag(
        torch.from_numpy(k).permute(3, 2, 0, 1), 4)
    # [4*Co, 4*Ci, kW, 1] against HWIO [kW, 1, 4*Ci, 4*Co]
    np.testing.assert_array_equal(got.permute(2, 3, 1, 0).numpy(), want)


@pytest.fixture
def jax_tiny():
    """The JAX config with a 16-unit head and the plain ``lax.scan``
    BiLSTM; restored afterwards."""
    saved = (jcfg.TRAIN.NUM_HID, jcfg.LSTM_IMPL)
    jcfg.TRAIN.NUM_HID, jcfg.LSTM_IMPL = 16, 'scan'
    yield
    jcfg.TRAIN.NUM_HID, jcfg.LSTM_IMPL = saved


def test_ctc_none_loss_equals_jax_dummy(jax_tiny):
    cfg = load_cfg(None, TINY_MODEL)
    b = _common.build_batches(cfg, 3, 64, n_batches=1, seed=1)[0]
    image = (b.image.astype(np.float32) / 255.0)
    w = image.shape[1]
    net = jget_network('LSTM_train')
    params = net.init_params(jax.random.PRNGKey(0),
                             {'data': (3, w, 32), 'time_step_len': (3,)})
    out = net.apply(params, {'data': jnp.asarray(image),
                             'time_step_len': jnp.asarray(b.time_step)},
                    train=True, rng=jax.random.PRNGKey(1), dtype=None)
    lg = out['logits'].astype(jnp.float32)
    want = float(jnp.mean(lg * lg) + net.regularization_loss(params))

    model = get_network('LSTM_train', cfg)
    flat = jcheckpoint.flatten_state({'params': params,
                                      'bn_state': net.init_bn_state()})
    missing, unexpected = model.load_state_dict(
        checkpoint.params_from_flat(flat), strict=False)
    assert not missing and not unexpected
    total, ctc, bn_batch = attrib_step.dummy_loss_fn(model, cfg, None)(
        torch.from_numpy(b.image), torch.from_numpy(b.label),
        torch.from_numpy(b.label_len), torch.from_numpy(b.time_step))
    assert bn_batch == [] and ctc is total
    np.testing.assert_allclose(float(total.detach()), want, rtol=1e-5)


def test_flop_count_adds_kernel_work(monkeypatch):
    """``count_flops``: the counter's matmul FLOPs plus the per-launch work
    of each kernel the call launches (here a stand-in that moves the
    ``bilstm_fwd`` counter)."""
    a = torch.ones(4, 8)

    def fn():
        _common.KERNELS['bilstm_fwd'].launches += 1
        return a @ a.T
    per = _common.kernel_flops(live_steps=10, hidden=4, n=2, t_len=5,
                               s_len=3)
    assert per['bilstm_fwd'] == 2 * 2 * 10 * 4 * 16
    assert per['bilstm_bwd'] == 2 * per['bilstm_fwd']
    assert per['ctc_fwd'] == per['ctc_bwd'] == 14 * 2 * 5 * 3
    monkeypatch.setattr(_common.KERNELS['bilstm_fwd'], 'launches',
                        _common.KERNELS['bilstm_fwd'].launches)
    assert _common.count_flops(fn, per_launch=per) == \
        2 * 4 * 8 * 4 + per['bilstm_fwd']


def test_peak_lookup_and_timing():
    assert _common.peak_flops_for('NVIDIA H100 80GB HBM3') == 989e12
    assert _common.peak_flops_for('NVIDIA A100-SXM4-80GB') is None
    assert _common.peak_flops_for('cpu') is None
    assert _common.device_name('cpu') == 'cpu'
    calls = []
    ms = _common.timed_ms(lambda v: calls.append(v) or torch.zeros(1), 3,
                          windows=3, calls=2)
    assert ms >= 0 and calls == [3] * 7


@pytest.mark.parametrize('tool', [bench_ctc, bench_rnn, bench_decode,
                                  profile_step, attrib_step, bench_data,
                                  bench_fold_h])
def test_tools_raise_without_cuda(tool, monkeypatch):
    """Every tool runs on CUDA unless asked for the CPU, and raises
    without it."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        tool.main([])
