"""The serving export of the port (``engine/serve.py``) and the decode
kernels as custom ops (``ops/custom_ops.py``), on the CPU.

Small shapes: f32, batch 2, buckets [64, 96], beam width 4. The weights are
the JAX package's ``init_params`` from one seed, carried across by the
bridge (``engine/checkpoint.py:params_from_flat``), so the port's artifact
and the JAX package's (``platforms=('cpu',)``, as tests/test_export.py
runs it) decode the same model. Ids and strings are compared exactly: both
run the same f32 arithmetic on the same inputs, and a decoded id is an
argmax or a beam choice, not a float.
"""

import copy
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax

from lstm_ctc_ocr_tpu.config import cfg as jcfg
from lstm_ctc_ocr_tpu.engine import checkpoint as jcheckpoint
from lstm_ctc_ocr_tpu.engine import serve as jserve
from lstm_ctc_ocr_tpu.models.factory import get_network as jget_network
from lstm_ctc_ocr_torch.config import load_cfg
from lstm_ctc_ocr_torch.engine import checkpoint, graphs, serve
from lstm_ctc_ocr_torch.engine import test as port_test
from lstm_ctc_ocr_torch.models import crnn, layers
from lstm_ctc_ocr_torch.models.factory import get_network
from lstm_ctc_ocr_torch.ops import custom_ops, rnn, rnn_cuda
from lstm_ctc_ocr_torch.utils import profiler

BUCKETS, BATCH = [64, 96], 2


@pytest.fixture
def jax_cfg():
    old = copy.deepcopy(dict(jcfg))
    jcfg.TRAIN.DTYPE = 'float32'
    jcfg.TEST.BATCH_SIZE = BATCH
    jcfg.LSTM_IMPL = 'jax'
    jcfg.BEAM_WIDTH = 4
    yield jcfg
    jcfg.clear()
    for k, v in old.items():
        jcfg[k] = v


def _port_cfg(decoder='greedy', *extra):
    return load_cfg(None, ['TRAIN.DTYPE', "'float32'", 'TEST.BATCH_SIZE',
                           str(BATCH), 'DECODER', repr(decoder),
                           'BEAM_WIDTH', '4'] + list(extra))


def _jax_params():
    net = jget_network('LSTM_test')
    params = net.init_params(
        jax.random.PRNGKey(1),
        {'data': (BATCH, BUCKETS[0], jcfg.NUM_FEATURES),
         'time_step_len': (BATCH,)})
    return net, params


def _port_model(cfg, params):
    """The port's model holding the JAX ``params`` (BN buffers initial)."""
    model = get_network('LSTM_test', cfg)
    state = checkpoint.params_from_flat(
        jcheckpoint.flatten_state({'params': params}))
    missing, unexpected = model.load_state_dict(state, strict=False)
    assert not unexpected and all('.bn_' in k for k in missing)
    return model.eval()


@pytest.fixture
def port_model(jax_cfg):
    _, params = _jax_params()
    return lambda cfg: _port_model(cfg, params)


def _images(rng):
    """Raw grayscale images off the model grid: uint8, 0..1 floats and
    0..255-scale floats, heights 60 and 32, widths that land in both
    buckets."""
    return [(rng.rand(60, 90) * 255).astype(np.uint8),
            rng.rand(32, 70).astype(np.float32),
            (rng.rand(60, 150) * 255).astype(np.uint8),
            (rng.rand(32, 50) * 255.0).astype(np.float64),
            (rng.rand(60, 40) * 255).astype(np.uint8)]


# --- the custom ops --------------------------------------------------------

def _op_args(t_len, n, h, with_xp8, seed):
    rng = np.random.RandomState(seed)

    def mk(*shape, scale=1.0):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32) * scale)
    lens = rng.randint(0, t_len + 1, n).astype(np.int32)
    lens[0] = 0                                   # an empty row
    lens[-1] = t_len
    u = [mk(h, 4 * h, scale=h ** -0.5) for _ in range(2)]
    b = [mk(4 * h, scale=0.1) for _ in range(2)]
    if with_xp8:
        return (mk(t_len, n, 8 * h), u[0], u[1], b[0], b[1],
                torch.from_numpy(lens), 1.0)
    return (mk(t_len, n, 4 * h), u[0], b[0], torch.from_numpy(lens), 1.0)


@pytest.mark.parametrize('t_len,n', [(7, 5), (1, 3)])
def test_opcheck_bilstm_fwd(t_len, n):
    torch.library.opcheck(custom_ops.bilstm_fwd,
                          _op_args(t_len, n, 16, True, t_len))


@pytest.mark.parametrize('t_len,n', [(7, 5), (1, 3)])
def test_opcheck_lstm_fwd(t_len, n):
    torch.library.opcheck(custom_ops.lstm_fwd,
                          _op_args(t_len, n, 16, False, t_len))


def test_ops_are_the_plain_versions_on_the_cpu():
    xp, uf, ub, bf, bb, lens, fb = _op_args(6, 4, 8, True, 0)
    of, ob = custom_ops.bilstm_fwd(xp, uf, ub, bf, bb, lens, fb)
    ref = rnn_cuda.bilstm_fwd_reference(xp[..., :32], xp[..., 32:], uf, ub,
                                        bf, bb, lens, fb)
    assert torch.equal(of, ref[0]) and torch.equal(ob, ref[1])
    x, u, b, lens, fb = _op_args(6, 4, 8, False, 1)
    assert torch.equal(custom_ops.lstm_fwd(x, u, b, lens, fb),
                       rnn_cuda.lstm_fwd_reference(x, u, b, lens, fb))


def test_rnn_takes_the_ops_without_a_gradient(monkeypatch):
    """``rnn.bilstm`` / ``rnn.lstm`` call the custom ops under no_grad and
    the autograd cores (with residuals) when a gradient is needed, with the
    same outputs."""
    rng = np.random.RandomState(3)
    d, h, t_len, n = 12, 8, 5, 3

    def cell():
        return {'w': torch.from_numpy(rng.randn(d, 4 * h).astype(np.float32)),
                'u': torch.from_numpy(rng.randn(h, 4 * h).astype(np.float32)
                                      * 0.3),
                'bias': torch.from_numpy(rng.randn(4 * h).astype(np.float32)
                                         * 0.1)}
    cells = {'fw': cell(), 'bw': cell()}
    x = torch.from_numpy(rng.randn(n, t_len, d).astype(np.float32))
    lens = torch.tensor([5, 0, 3], dtype=torch.int32)
    calls = []
    for mod, kind in ((custom_ops, 'op'), (rnn_cuda, 'wrapper')):
        for name in ('bilstm_fwd', 'lstm_fwd'):
            def spy(*args, _real=getattr(mod, name), _tag=(kind, name), **kw):
                calls.append(_tag + (kw.get('save_residuals', False),))
                return _real(*args, **kw)
            monkeypatch.setattr(mod, name, spy)
    with torch.no_grad():
        bi_ng = rnn.bilstm(cells, x, lens)
        uni_ng = rnn.lstm(cells['fw'], x.transpose(0, 1), lens)
    assert calls == [('op', 'bilstm_fwd', False), ('op', 'lstm_fwd', False)]
    calls.clear()
    for c in cells.values():
        for t in c.values():
            t.requires_grad_(True)
    bi = rnn.bilstm(cells, x, lens)
    uni = rnn.lstm(cells['fw'], x.transpose(0, 1), lens)
    assert calls == [('wrapper', 'bilstm_fwd', True),
                     ('wrapper', 'lstm_fwd', True)]
    torch.testing.assert_close(bi.detach(), bi_ng, rtol=0, atol=1e-6)
    torch.testing.assert_close(uni.detach(), uni_ng, rtol=0, atol=1e-6)


# --- export, reload, decode --------------------------------------------------

@pytest.mark.parametrize('decoder', ['greedy', 'beam'])
def test_export_roundtrip_matches_live_decode(port_model, decoder, tmp_path):
    cfg = _port_cfg(decoder)
    buckets = BUCKETS if decoder == 'greedy' else BUCKETS[:1]
    model = port_model(cfg)
    manifest = serve.export_decoder(model, cfg, str(tmp_path),
                                    buckets=buckets, batch=BATCH,
                                    device='cpu')
    assert manifest['buckets'] == buckets
    assert manifest['platforms'] == ['cpu']
    assert manifest['decoder'] == decoder
    live = port_test.make_decode_step(model, cfg, 'cpu')
    dec = serve.ExportedDecoder(str(tmp_path), device='cpu')
    rng = np.random.RandomState(0)
    for w in buckets:
        img = rng.rand(BATCH, w, 32).astype(np.float32)
        ts = np.array([w // 4 - 1, w // 8], np.int32)
        np.testing.assert_array_equal(dec.run(img, ts), live(img, ts))
    assert dec.calls == len(buckets)


def test_program_holds_the_kernels_as_ops(port_model, tmp_path):
    """The exported BiLSTM program calls ``lstm_ctc_ocr_torch::bilstm_fwd``
    (kernel 1 on the card), the stacked model's ``::lstm_fwd`` once per
    layer: the hand kernels are in the artifact, not a traced plain walk."""
    cfg = _port_cfg()
    serve.export_decoder(port_model(cfg), cfg, str(tmp_path / 'bi'),
                         buckets=[64], batch=BATCH, device='cpu')

    class Stacked(crnn.LSTM_test):
        def make_head(self, num_hid, nclasses, generator):
            return layers.LSTM(512, 32, 2, nclasses, generator)
    stacked = Stacked(generator=torch.Generator().manual_seed(0)).eval()
    serve.export_decoder(stacked, cfg, str(tmp_path / 'uni'), buckets=[64],
                         batch=BATCH, device='cpu')

    def targets(d):
        ep = torch.export.load(str(tmp_path / d / 'decode_w64.pt2'))
        return [str(n.target) for n in ep.graph.nodes
                if n.op == 'call_function' and 'lstm_ctc_ocr_torch' in
                str(n.target)]
    assert targets('bi') == ['lstm_ctc_ocr_torch.bilstm_fwd.default']
    assert targets('uni') == ['lstm_ctc_ocr_torch.lstm_fwd.default'] * 2

    live = port_test.make_decode_step(stacked, cfg, 'cpu')
    img = np.random.RandomState(1).rand(BATCH, 64, 32).astype(np.float32)
    ts = np.array([15, 9], np.int32)
    dec = serve.ExportedDecoder(str(tmp_path / 'uni'), device='cpu')
    np.testing.assert_array_equal(dec.run(img, ts), live(img, ts))


def test_beam_program_holds_one_beam_op(port_model, tmp_path):
    """An exported beam decoder calls ``lstm_ctc_ocr_torch::beam_decode``
    once, after the BiLSTM's op: no frame loop is unrolled into the
    program (no sort, no per-frame gathers), and it decodes as the live
    path does."""
    cfg = _port_cfg('beam')
    model = port_model(cfg)
    serve.export_decoder(model, cfg, str(tmp_path), buckets=[96],
                         batch=BATCH, device='cpu')
    ep = torch.export.load(str(tmp_path / 'decode_w96.pt2'))
    calls = [str(n.target) for n in ep.graph.nodes
             if n.op == 'call_function']
    assert [c for c in calls if 'lstm_ctc_ocr_torch' in c] == [
        'lstm_ctc_ocr_torch.bilstm_fwd.default',
        'lstm_ctc_ocr_torch.beam_decode.default']
    assert not [c for c in calls if 'sort' in c or 'gather' in c]
    img = np.random.RandomState(3).rand(BATCH, 96, 32).astype(np.float32)
    ts = np.array([23, 17], np.int32)
    live = port_test.make_decode_step(model, cfg, 'cpu')
    dec = serve.ExportedDecoder(str(tmp_path), device='cpu')
    np.testing.assert_array_equal(dec.run(img, ts), live(img, ts))


@pytest.mark.parametrize('decoder', ['greedy', 'beam'])
def test_decode_images_match_the_jax_package(jax_cfg, decoder, tmp_path):
    """Same weights, same raw images of assorted sizes and types: the JAX
    artifact and the port's return the same strings."""
    jax_cfg.DECODER = decoder
    cfg = _port_cfg(decoder)
    buckets = BUCKETS if decoder == 'greedy' else BUCKETS[:1]
    net, params = _jax_params()
    jserve.export_decoder(net, params, str(tmp_path / 'jax'),
                          buckets=buckets, batch=BATCH, platforms=('cpu',))
    serve.export_decoder(_port_model(cfg, params), cfg,
                         str(tmp_path / 'torch'), buckets=buckets,
                         batch=BATCH, device='cpu')
    imgs = _images(np.random.RandomState(2))
    if decoder == 'beam':                 # within the one exported bucket
        imgs = [im for im in imgs if int(32 / im.shape[0] * im.shape[1])
                <= buckets[0]]
    assert len(imgs) >= 3
    want = jserve.ExportedDecoder(str(tmp_path / 'jax')).decode_images(imgs)
    got = serve.ExportedDecoder(str(tmp_path / 'torch'),
                                device='cpu').decode_images(imgs)
    assert got == want
    assert any(want)


def test_exported_decoder_rejects_oversize(port_model, tmp_path):
    cfg = _port_cfg()
    serve.export_decoder(port_model(cfg), cfg, str(tmp_path), buckets=[64],
                         batch=1, device='cpu')
    dec = serve.ExportedDecoder(str(tmp_path), device='cpu')
    with pytest.raises(ValueError, match='exceeds largest exported bucket'):
        dec.decode_images([np.zeros((32, 500), np.uint8)])


def test_exported_decoder_charset_from_manifest(port_model, tmp_path):
    """The loader decodes with the MANIFEST's charset: a config changed
    after the export, as another process would hold, changes nothing."""
    cfg = _port_cfg()
    serve.export_decoder(port_model(cfg), cfg, str(tmp_path), buckets=[64],
                         batch=1, device='cpu')
    img = [(np.random.RandomState(5).rand(32, 60) * 255).astype(np.uint8)]
    baseline = serve.ExportedDecoder(str(tmp_path),
                                     device='cpu').decode_images(img)
    assert baseline[0]
    cfg.CHARSET = '!@#$%^&*()'
    assert serve.ExportedDecoder(str(tmp_path),
                                 device='cpu').decode_images(img) == baseline
    with open(tmp_path / serve.MANIFEST) as f:
        manifest = json.load(f)
    charset = manifest['charset']
    manifest['charset'] = charset[::-1]
    with open(tmp_path / serve.MANIFEST, 'w') as f:
        json.dump(manifest, f)
    assert serve.ExportedDecoder(str(tmp_path), device='cpu').decode_images(
        img) == [''.join(charset[::-1][charset.index(c)]
                         for c in baseline[0])]


def test_export_sorts_buckets(port_model, tmp_path):
    cfg = _port_cfg()
    m = serve.export_decoder(port_model(cfg), cfg, str(tmp_path),
                             buckets=[96, 64], batch=1, device='cpu')
    assert m['buckets'] == [64, 96]
    assert set(m['export_seconds']) == {'64', '96'}
    assert serve.ExportedDecoder(str(tmp_path),
                                 device='cpu')._pick_bucket(50) == 64


def test_moving_export_needs_bn_state(port_model, tmp_path):
    cfg = _port_cfg('greedy', 'BN_EVAL', "'moving'")
    model = port_model(cfg)
    assert not serve.has_bn_state(model)
    with pytest.raises(ValueError, match='requires bn_state'):
        serve.export_decoder(model, cfg, str(tmp_path), buckets=[64],
                             batch=BATCH, device='cpu')
    with torch.no_grad():
        model.conv4_1.bn_mean.fill_(0.25)
        model.conv4_2.bn_var.fill_(2.0)
    assert serve.has_bn_state(model)
    serve.export_decoder(model, cfg, str(tmp_path), buckets=[64],
                         batch=BATCH, device='cpu')
    # frozen moving statistics: a row decodes alike whatever its batch
    dec = serve.ExportedDecoder(str(tmp_path), device='cpu')
    rng = np.random.RandomState(4)
    img = rng.rand(BATCH, 64, 32).astype(np.float32)
    ts = np.full((BATCH,), 15, np.int32)
    other = img.copy()
    other[1] = rng.rand(64, 32)
    np.testing.assert_array_equal(dec.run(img, ts)[0], dec.run(other, ts)[0])


def test_loader_refuses_another_device(port_model, tmp_path):
    cfg = _port_cfg()
    serve.export_decoder(port_model(cfg), cfg, str(tmp_path), buckets=[64],
                         batch=1, device='cpu')
    with open(tmp_path / serve.MANIFEST) as f:
        manifest = json.load(f)
    manifest['platforms'] = ['cuda']
    with open(tmp_path / serve.MANIFEST, 'w') as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match=r"exported for \['cuda'\]"):
        serve.ExportedDecoder(str(tmp_path), device='cpu')


def test_entry_points_default_to_cuda(port_model, tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a GPU is present: the default device works here')
    cfg = _port_cfg()
    model = port_model(cfg)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        serve.export_decoder(model, cfg, str(tmp_path), buckets=[64])
    serve.export_decoder(model, cfg, str(tmp_path), buckets=[64],
                         device='cpu')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        serve.ExportedDecoder(str(tmp_path))


def test_cpu_decoder_never_captures(port_model, tmp_path, monkeypatch):
    """On the CPU the programs run eagerly: no CUDA graph is made, and
    ``serve.graph_replays`` stays 0 under a trace."""
    cfg = _port_cfg()
    serve.export_decoder(port_model(cfg), cfg, str(tmp_path),
                         buckets=BUCKETS, batch=BATCH, device='cpu')

    def refuse(*args, **kwargs):
        raise AssertionError('a CUDA graph on the CPU path')
    monkeypatch.setattr(torch.cuda, 'CUDAGraph', refuse)
    monkeypatch.setattr(graphs, 'capture', refuse)
    dec = serve.ExportedDecoder(str(tmp_path), device='cpu')
    rng = np.random.RandomState(6)
    calls = [(rng.rand(BATCH, w, 32).astype(np.float32),
              np.array([w // 4 - 1, w // 8], np.int32))
             for w in BUCKETS * 2]
    before = profiler.counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        got = [dec.run(*c) for c in calls]
    for (img, ts), ids in zip(calls, got):
        np.testing.assert_array_equal(
            ids, dec._programs[img.shape[1]](torch.from_numpy(img),
                                             torch.from_numpy(ts)).numpy())
    assert dec._graphs == {} and dec.calls == len(calls)
    assert profiler.counters().get('serve.graph_replays', 0) == \
        before.get('serve.graph_replays', 0)
    assert profiler.counters()['serve.rows'] - before.get('serve.rows', 0) \
        == len(calls) * BATCH


def test_a_decoder_serves_one_caller_at_a_time(port_model, tmp_path):
    """Threads sharing a decoder take turns in ``run``: no two program
    calls overlap, and each thread gets the strings one thread gets."""
    cfg = _port_cfg()
    serve.export_decoder(port_model(cfg), cfg, str(tmp_path),
                         buckets=BUCKETS, batch=BATCH, device='cpu')
    dec = serve.ExportedDecoder(str(tmp_path), device='cpu')
    requests = [_images(np.random.RandomState(i)) for i in range(3)]
    want = [dec.decode_images(r) for r in requests]
    inside, most = [0], [0]

    def one_at_a_time(program):
        def call(x, lens):
            inside[0] += 1
            most[0] = max(most[0], inside[0])
            time.sleep(0.002)          # lets another thread reach a call
            try:
                return program(x, lens)
            finally:
                inside[0] -= 1
        return call
    dec._programs = {w: one_at_a_time(p) for w, p in dec._programs.items()}
    got = [[] for _ in requests]

    def serve_requests(i):
        for _ in range(3):
            got[i].append(dec.decode_images(requests[i]))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=serve_requests, args=(i,))
                   for i in range(len(requests))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert most[0] == 1
    assert got == [[w] * 3 for w in want]
