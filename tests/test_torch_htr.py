"""Puigcerver's handwriting model in the port (``models/htr.py``, the
stacked head ``models/layers.py:StackedBiLSTM``) on the CPU, at a small
size: lines 16 high (160 features a frame), two BiLSTM layers of 8 units a
direction, f32.

The port is held against the plain reference ``benchmark/reference/htr.py``
(its own forward pass, masks, CTC and training step, plain PyTorch) on the
same weights: logits, a training step with dropout on, and the dropout
masks bit for bit. The tolerances are f32's: both sides compute the same
f32 arithmetic in another order (the port's fused matmul over both
directions, its own CTC), so they agree to a few ulps of the values
compared, far inside what a bf16 cast of any input (2^-8 relative) would
move them. The CRNN keeps its keys and outputs under ``TRAIN.NUM_LAYERS``,
and the model runs through the port's entry points: ``get_network``, the
solver, the eval driver and the serving export.
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from benchmark.reference import ctc as ref_ctc  # noqa: E402
from benchmark.reference import htr as ref_htr  # noqa: E402
from lstm_ctc_ocr_torch.config import default_cfg, load_cfg  # noqa: E402
from lstm_ctc_ocr_torch.data import records  # noqa: E402
from lstm_ctc_ocr_torch.engine import graphs, serve, train  # noqa: E402
from lstm_ctc_ocr_torch.engine import test as port_test  # noqa: E402
from lstm_ctc_ocr_torch.models import crnn, htr, layers  # noqa: E402
from lstm_ctc_ocr_torch.models.factory import get_network  # noqa: E402
from lstm_ctc_ocr_torch.ops import rnn  # noqa: E402
from lstm_ctc_ocr_torch.utils import profiler  # noqa: E402

HEIGHT, NUM_HID, LAYERS = 16, 16, 2
# f32 on both sides, summed in another order
RTOL, ATOL = 1e-5, 1e-6


def small_cfg(**over):
    cfg = load_cfg(os.path.join(REPO, 'lstm', 'htr.yml'), [])
    cfg.IMG_HEIGHT, cfg.NUM_FEATURES = HEIGHT, HEIGHT
    cfg.TRAIN.NUM_HID, cfg.TRAIN.NUM_LAYERS = NUM_HID, LAYERS
    cfg.TRAIN.DTYPE = 'float32'
    cfg.BUCKETS = [64, 96, 128]
    for k, v in over.items():
        d = cfg
        *path, leaf = k.split('__')
        for p in path:
            d = d[p]
        d[leaf] = v
    return cfg


def small_model(seed=0, kind='LSTM_train', cfg=None):
    """The port's model with the reference's weights of ``seed``."""
    model = get_network(kind, cfg or small_cfg())
    params = ref_htr.make_params(seed, 'cpu', num_hid=NUM_HID,
                                 num_layers=LAYERS, height=HEIGHT)
    model.load_state_dict(params, strict=True)
    return model, params


def lines(widths, seed=0):
    """Random lines ``[N, max(widths), HEIGHT]`` uint8, zero past each
    row's width, and their frames ``W // 8``."""
    rng = np.random.RandomState(seed)
    img = np.zeros((len(widths), max(widths), HEIGHT), np.uint8)
    for i, w in enumerate(widths):
        img[i, :w] = rng.randint(0, 256, (w, HEIGHT))
    return (torch.from_numpy(img),
            torch.tensor([w // 8 for w in widths], dtype=torch.int32))


# --- the factory and the published widths -----------------------------------

@pytest.mark.parametrize('kind,cls', [('LSTM_train', htr.HTR_train),
                                      ('LSTM_test', htr.HTR_test)])
def test_net_name_htr_selects_the_handwriting_model(kind, cls):
    model = get_network(kind, small_cfg())
    assert type(model) is cls
    assert model.logits.forget_bias == 0.0
    assert len(model.logits.layers) == LAYERS
    for name in ('lstm', 'LSTM'):
        cfg = small_cfg(NET_NAME=name)
        assert isinstance(get_network(kind, cfg), crnn.LSTM_train)


def test_published_widths():
    """Height 128, 16/32/48/64/80 filters, 1,280 features, 5 x BiLSTM
    2 x 256, 80 classes: 9,581,248 parameters (the paper's ~9.6 M)."""
    cfg = load_cfg(os.path.join(REPO, 'lstm', 'htr.yml'), [])
    model = get_network('LSTM_train', cfg)
    state = model.state_dict()
    assert [tuple(state['conv{}.kernel'.format(i)].shape)[:2]
            for i in range(1, 6)] == [(16, 1), (32, 16), (48, 32), (64, 48),
                                      (80, 64)]
    assert 'conv1.biases' not in state
    assert tuple(state['logits.layers.0.cells.fw.w'].shape) == (1280, 1024)
    assert tuple(state['logits.layers.4.cells.bw.u'].shape) == (256, 1024)
    assert tuple(state['logits.weights'].shape) == (512, 80)
    assert sum(p.numel() for p in model.parameters()) == 9581248
    assert {k for k in state if k.startswith('logits.layers.')} == {
        'logits.layers.{}.cells.{}.{}'.format(i, d, leaf)
        for i in range(5) for d in ('fw', 'bw') for leaf in ('w', 'u',
                                                             'bias')}
    assert set(state) == set(ref_htr.param_shapes())


CRNN_KEYS = sorted(
    ['{}.{}'.format(c, leaf) for c in ('conv1', 'conv2', 'conv3_1',
                                       'conv3_2', 'conv4_1', 'conv4_2',
                                       'conv5')
     for leaf in ('kernel', 'biases')]
    + ['{}.{}'.format(c, leaf) for c in ('conv4_1', 'conv4_2')
       for leaf in ('bn_gamma', 'bn_beta', 'bn_mean', 'bn_var')]
    + ['logits.cells.{}.{}'.format(d, leaf) for d in ('fw', 'bw')
       for leaf in ('w', 'u', 'bias')] + ['logits.weights', 'logits.biases'])


@pytest.mark.parametrize('num_layers', [2, 5])
def test_the_crnn_ignores_num_layers(num_layers):
    cfg = default_cfg()
    cfg.TRAIN.NUM_HID, cfg.TRAIN.NUM_LAYERS = 16, num_layers
    model = get_network('LSTM_train', cfg,
                        generator=torch.Generator().manual_seed(3))
    base = default_cfg()
    base.TRAIN.NUM_HID = 16
    ref = get_network('LSTM_train', base,
                      generator=torch.Generator().manual_seed(3))
    assert sorted(model.state_dict()) == CRNN_KEYS
    for k, v in ref.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    x = torch.rand(2, 64, 32)
    lens = torch.tensor([15, 11], dtype=torch.int32)
    assert torch.equal(model(x, lens), ref(x, lens))


def test_bilstm_is_its_time_major_form_transposed():
    g = torch.Generator().manual_seed(1)
    cells = {d: {'w': torch.randn(12, 32, generator=g),
                 'u': torch.randn(8, 32, generator=g),
                 'bias': torch.randn(32, generator=g)} for d in ('fw', 'bw')}
    x = torch.randn(3, 9, 12, generator=g)
    lens = torch.tensor([9, 4, 6], dtype=torch.int32)
    tm = rnn.bilstm_tm(cells, x.transpose(0, 1).contiguous(), lens)
    assert torch.equal(rnn.bilstm(cells, x, lens), tm.transpose(0, 1))


# --- against the plain reference --------------------------------------------

@pytest.mark.parametrize('seed,layer,step', [(3, 0, 1), (3, 7, 12345),
                                             (2**31 + 5, 2, 9),
                                             (2**33 + 17, 4, 2**32 + 3)])
def test_dropout_masks_equal_the_reference_bit_for_bit(seed, layer, step):
    shape = (3, 5, 7, 11)
    key = layers.dropout_key(seed, layer, torch.tensor(step))
    assert int(key) == ref_htr.dropout_key(seed, layer, step)
    assert int(layers.dropout_key(seed, layer, step)) == int(key)
    for keep in (0.8, 0.5):
        port = layers.dropout_mask(shape, keep, key, 'cpu')
        ref = ref_htr.dropout_mask(shape, keep, int(key), 'cpu')
        assert torch.equal(port, ref)
        assert abs(port.float().mean().item() - keep) < 0.06


@pytest.mark.parametrize('widths', [(72, 96, 88), (128,), (40, 64, 128, 9)])
def test_eval_logits_match_the_reference(widths):
    model, params = small_model(seed=sum(widths))
    model.eval()
    x, lens = lines(widths)
    with torch.no_grad():
        port = model(x, lens)
        ref = ref_htr.forward(params, x, lens)
    assert port.shape == (max(widths) // 8, len(widths), 80)
    torch.testing.assert_close(port, ref, rtol=RTOL, atol=ATOL)


def test_training_logits_with_dropout_match_the_reference():
    model, params = small_model(seed=4)
    x, lens = lines((96, 120, 128, 64), seed=1)
    port = model(x, lens, dropout_step=torch.tensor(7))
    ref = ref_htr.forward(params, x, lens, step=7, seed=model.dropout_seed)
    torch.testing.assert_close(port, ref, rtol=RTOL, atol=ATOL)
    # another step draws other masks
    other = model(x, lens, dropout_step=torch.tensor(8))
    assert (other - port).abs().max() > 1e-3


def test_dropout_is_off_in_eval_mode():
    model, _ = small_model()
    x, lens = lines((96, 80))
    model.eval()
    with torch.no_grad():
        a = model(x, lens, dropout_step=3)
        b = model(x, lens)
    assert torch.equal(a, b)


def _batch(widths, seed=0):
    x, lens = lines(widths, seed)
    rng = np.random.RandomState(seed + 1)
    label_len = rng.randint(3, 6, len(widths)).astype(np.int32)
    label = np.zeros((len(widths), 24), np.int64)
    for i, n in enumerate(label_len):
        label[i, :n] = rng.randint(1, 79, n)
    return x, torch.from_numpy(label), torch.from_numpy(label_len), lens


def test_a_training_step_with_dropout_matches_the_reference():
    """One solver step (``make_train_step``: CTC, clip, Adam, the moving
    statistics) after two earlier updates, so that dropout draws step 3's
    masks: the loss, Adam's first moment and every parameter's and
    statistic's change."""
    cfg = small_cfg()
    model, params = small_model(seed=11, cfg=cfg)
    opt = train.make_optimizer(model, cfg)
    opt.count = 2
    step = train.make_train_step(model, opt, cfg, None)
    batch = _batch((96, 128, 104), seed=5)
    total, _ = step(*batch)
    hp = {'lr': cfg.TRAIN.LEARNING_RATE, 'gamma': cfg.TRAIN.GAMMA,
          'stepsize': cfg.TRAIN.STEPSIZE, 'clip': cfg.TRAIN.GRAD_CLIP,
          'weight_decay': cfg.TRAIN.WEIGHT_DECAY,
          'bn_momentum': cfg.BN_MOMENTUM}
    zeros = {k: torch.zeros_like(v) for k, v in params.items()
             if not ref_htr.is_buffer(k)}
    losses, (mu, _), after = ref_htr.train_steps(
        params, [batch], hp, model.dropout_seed, moments=(zeros, zeros),
        count0=2)
    assert abs(float(total) - losses[0]) <= RTOL * abs(losses[0])
    for k, v in opt.moments['mu'].items():
        torch.testing.assert_close(v, mu[k], rtol=1e-4, atol=1e-7)
    # Adam moves a parameter by about lr * g / |g|, which rounding of a g
    # near Adam's epsilon can flip: each leaf's change is held as a whole,
    # to a thousandth of its norm
    state = model.state_dict()
    for k, v in after.items():
        want = v - params[k]
        gap = (state[k] - params[k] - want).norm()
        assert gap <= 1e-3 * want.norm() + 1e-12, (k, float(gap))


def test_the_reference_ctc_is_the_ports_on_its_logits():
    """The loss the two training steps compare starts from the same CTC:
    the reference's plain recursion against the port's plain one."""
    from lstm_ctc_ocr_torch.ops import ctc as port_ctc
    x, label, label_len, lens = _batch((96, 128, 104), seed=2)
    model, params = small_model(seed=2)
    logits = ref_htr.forward(params, x, lens).transpose(0, 1).detach()
    a = ref_ctc.ctc_loss(logits, label, label_len, lens)
    b = port_ctc.ctc_loss(logits, label, label_len, lens)
    torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


# --- tracing ----------------------------------------------------------------

def test_the_head_counts_its_layer_frames_and_spans_its_stack():
    model, _ = small_model()
    x, lens = lines((96, 128, 64))
    before = profiler.counters().get('rnn.layer_frames', 0)
    model(x, lens, dropout_step=1)                   # no trace: no count
    assert profiler.counters().get('rnn.layer_frames', 0) == before
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        model(x, lens, dropout_step=1)
    frames = profiler.counters()['rnn.layer_frames'] - before
    assert frames == LAYERS * 3 * (128 // 8)
    assert 'rnn.stack' in {e.name for e in prof.events()}


def test_a_graph_replay_adds_what_its_capture_counted():
    """Counts made inside ``capture_counts`` go to its tally whether or not
    a trace records; a ``Graph``'s replay adds them while one does."""
    with profiler.capture_counts() as tally:
        profiler.count('rnn.layer_frames', 40)
        with profiler.capture_counts() as inner:
            profiler.count('rnn.layer_frames', 2)
        profiler.count('rnn.layer_frames', 5)
    assert tally == {'rnn.layer_frames': 45} and inner == {
        'rnn.layer_frames': 2}

    class Replayable:
        replays = 0

        def replay(self):
            self.replays += 1
    g = graphs.Graph(Replayable(), (), (), [], tally)
    before = profiler.counters().get('rnn.layer_frames', 0)
    g.replay()
    assert profiler.counters().get('rnn.layer_frames', 0) == before
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        g.replay()
        g.replay()
    assert profiler.counters()['rnn.layer_frames'] - before == 90
    assert g.graph.replays == 3


# --- the entry points -------------------------------------------------------

def test_export_round_trip_at_one_bucket(tmp_path):
    cfg = small_cfg()
    model, _ = small_model(seed=6, kind='LSTM_test', cfg=cfg)
    model.eval()
    manifest = serve.export_decoder(model, cfg, str(tmp_path),
                                    buckets=[128], batch=2, device='cpu')
    assert manifest['pool_scale'] == 8 and manifest['offset_time_step'] == 0
    assert manifest['img_height'] == HEIGHT
    ep = torch.export.load(str(tmp_path / 'decode_w128.pt2'))
    ops = [str(n.target) for n in ep.graph.nodes
           if n.op == 'call_function' and 'lstm_ctc_ocr_torch' in
           str(n.target)]
    assert ops == ['lstm_ctc_ocr_torch.bilstm_fwd.default'] * LAYERS
    live = port_test.make_decode_step(model, cfg, 'cpu')
    dec = serve.ExportedDecoder(str(tmp_path), device='cpu')
    img = np.random.RandomState(0).rand(2, 128, HEIGHT).astype(np.float32)
    ts = np.array([16, 11], np.int32)
    np.testing.assert_array_equal(dec.run(img, ts), live(img, ts))


def test_train_net_and_test_net_run_it(tmp_path):
    """The solver trains it from a records file of lines at height 32 (a
    K=2 chunk on the device store, then single steps) and snapshots it;
    the eval driver restores the snapshot through ``get_network``."""
    img_dir = tmp_path / 'lines'
    img_dir.mkdir()
    val = os.path.join(REPO, 'data', 'val_longline')
    for f in sorted(os.listdir(val))[:6]:
        shutil.copy(os.path.join(val, f), str(img_dir / f))
    rec = str(tmp_path / 'lines.records')
    assert records.write_image_annotation_pairs_to_records(
        str(img_dir), rec) == 6
    cfg = small_cfg(IMG_HEIGHT=32, NUM_FEATURES=32, BUCKETS=[448],
                    RECORDS_PATH=rec, TRAIN__BATCH_SIZE=3,
                    TRAIN__STEPS_PER_DISPATCH=2, TRAIN__SNAPSHOT_ITERS=4,
                    TRAIN__DISPLAY=1, TEST__BATCH_SIZE=3)
    out = str(tmp_path / 'out')
    net = get_network('LSTM_train', cfg,
                      generator=torch.Generator().manual_seed(3))
    _, optimizer, losses = train.train_net(net, {}, None, out,
                                           str(tmp_path / 'log'), cfg,
                                           max_iters=5, device='cpu')
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert optimizer.count == 4
    assert os.listdir(out) == ['htr_ctc_iter_4.ckpt.npz']
    result = port_test.test_net(cfg, str(img_dir), out, device='cpu',
                                echo=lambda s: None)
    assert result.total == 6 and len(result.predictions) == 6
