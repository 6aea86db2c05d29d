"""The benchmark's plain reference against the program's plain CPU path at
small sizes, and its FLOP count against PyTorch's ``FlopCounterMode``."""

import os
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
sys.path.insert(0, REPO)

from benchmark import common, flops, judge  # noqa: E402
from benchmark.reference import ckpt, ctc, decode, model, png  # noqa: E402
from benchmark.reference import train as ref_train  # noqa: E402
from lstm_ctc_ocr_torch.config import load_cfg  # noqa: E402
from lstm_ctc_ocr_torch.data import image  # noqa: E402
from lstm_ctc_ocr_torch.engine import checkpoint  # noqa: E402
from lstm_ctc_ocr_torch.engine import train as port_train  # noqa: E402
from lstm_ctc_ocr_torch.models.factory import get_network  # noqa: E402
from lstm_ctc_ocr_torch.ops import beam as port_beam  # noqa: E402
from lstm_ctc_ocr_torch.ops import decoder as port_decoder  # noqa: E402

RELEASE = os.path.join(REPO, 'checkpoints/lstm_ctc/lstm_ctc_iter_32207'
                       '.ckpt.npz')


def test_png_reader_and_resize_match_the_program():
    d = os.path.join(REPO, 'data/val')
    for f in sorted(os.listdir(d))[:5]:
        a = png.load_image(os.path.join(d, f))
        np.testing.assert_array_equal(a, image.load_image(os.path.join(d, f)))
        w = int(32 / a.shape[0] * a.shape[1])
        np.testing.assert_array_equal(png.resize_linear(a, w, 32),
                                      image.resize_linear(a, w, 32))


def test_release_keys_match_the_program_bridge():
    ref = ckpt.load_release(RELEASE, 'cpu')
    port = checkpoint.params_from_flat(checkpoint.read_flat(RELEASE))
    assert set(ref) == set(port)
    for k in ref:
        torch.testing.assert_close(ref[k], port[k], rtol=0, atol=0)


def _port_model(cfg, params):
    m = get_network('LSTM_train', cfg)
    m.load_state_dict(params, strict=True)
    return m


def _cfg(num_hid=16):
    return load_cfg(os.path.join(REPO, 'lstm/lstm.yml'),
                    ['TRAIN.NUM_HID', str(num_hid), 'TRAIN.DTYPE',
                     "'float32'"])


def _batch(n=3, width=64, seed=0):
    g = np.random.default_rng(seed)
    img = g.integers(0, 256, (n, width, 32), dtype=np.uint8)
    steps = np.array([width // 4 - 1 - i for i in range(n)], np.int32)
    lab = np.zeros((n, 6), np.int64)
    lens = np.array([4, 5, 6][:n], np.int32)
    for i in range(n):
        lab[i, :lens[i]] = g.integers(1, 63, lens[i])
    return [torch.from_numpy(a) for a in (img, lab, lens, steps)]


def test_forward_matches_the_program():
    cfg = _cfg()
    params = model.make_params(7, 'cpu', num_hid=16)
    port = _port_model(cfg, params).eval()
    img, _, _, steps = _batch()
    with torch.no_grad():
        want = port(img, steps)
        got = model.forward(params, img, steps)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_train_steps_match_the_program():
    cfg = _cfg()
    params = model.make_params(11, 'cpu', num_hid=16)
    port = _port_model(cfg, params).train()
    opt = port_train.make_optimizer(port, cfg)
    step = port_train.make_train_step(port, opt, cfg, None)
    batches = [_batch(seed=s) for s in range(3)]
    want = [float(step(*b)[0]) for b in batches]
    hp = {'lr': float(cfg.TRAIN.LEARNING_RATE), 'gamma': float(
        cfg.TRAIN.GAMMA), 'stepsize': int(cfg.TRAIN.STEPSIZE),
          'weight_decay': float(cfg.TRAIN.WEIGHT_DECAY), 'clip': 10.0,
          'bn_momentum': 0.99}
    losses, (mu, _), after = ref_train.train_steps(params, batches, hp)
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    # Adam's first step moves every element by the learning rate whatever
    # its gradient's size, so an element whose gradient is rounding noise
    # may move the other way: compare each leaf's change by its norm, as
    # the benchmark does
    state = port.state_dict()
    delta = {k: state[k] - params[k] for k in after}
    ref_delta = {k: after[k] - params[k] for k in after}
    quiet = common.quiet_leaves(mu)
    assert quiet == {'conv4_1.biases', 'conv4_2.biases'}
    assert common.leaf_gap(delta, ref_delta, skip=quiet)[0] < 1e-3
    assert common.leaf_gap(opt.moments['mu'], mu, skip=quiet)[0] < 1e-4


def test_faults_and_control_move_the_numbers():
    params = model.make_params(3, 'cpu', num_hid=16)
    batches = [_batch(seed=s) for s in range(2)]
    hp = {'lr': 1e-2, 'gamma': 1.0, 'stepsize': 10, 'weight_decay': 1e-5,
          'clip': 10.0, 'bn_momentum': 0.99}
    base = ref_train.train_steps(params, batches, hp)
    frozen = ref_train.train_steps(params, batches, hp, fault='frozen')
    assert all(torch.equal(frozen[2][k], params[k]) for k in params)
    half = ref_train.train_steps(params, batches, hp, fault='half')
    assert half[0][0] != base[0][0]
    low = ref_train.train_steps(params, batches, hp, prec='fp8')
    assert common.leaf_gap(low[1][0], base[1][0])[0] > 0.01


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_decoders_match_the_program(seed):
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(3, 20, 8, generator=g) * 3
    lens = torch.tensor([20, 13, 7], dtype=torch.int32)
    torch.testing.assert_close(decode.greedy_decode(logits, lens),
                               port_decoder.greedy_decode(logits, lens))
    torch.testing.assert_close(decode.beam_decode(logits, lens, 4),
                               port_beam.beam_decode(logits, lens, 4))


def test_ctc_matches_the_program_and_scores_agree():
    from lstm_ctc_ocr_torch.ops import ctc as port_ctc
    g = torch.Generator().manual_seed(5)
    logits = torch.randn(3, 12, 6, generator=g)
    labels = torch.tensor([[1, 2, 2], [3, 0, 0], [4, 5, 1]])
    llen = torch.tensor([3, 1, 3], dtype=torch.int32)
    lens = torch.tensor([12, 9, 4], dtype=torch.int32)
    torch.testing.assert_close(ctc.ctc_loss(logits, labels, llen, lens),
                               port_ctc.ctc_loss(logits, labels, llen, lens))
    logp = torch.log_softmax(logits, -1)
    ids = [[1, 2, 2], [3], [4, 5, 1]]
    torch.testing.assert_close(ctc.label_logprob(logp, ids, lens),
                               -port_ctc.ctc_loss(logits, labels, llen, lens))
    # the best path's own label: its best alignment is the best path
    best = decode.greedy_decode(logits, lens)
    own = [judge.strip(r) for r in best.numpy()]
    vit = ctc.label_viterbi(logp, own, lens)
    path = torch.stack([logp[i, :lens[i]].max(-1).values.sum()
                        for i in range(3)])
    torch.testing.assert_close(vit, path, rtol=1e-6, atol=1e-5)
    assert judge.gaps(logits.transpose(0, 1), lens, own, own, 'greedy') \
        == [0.0, 0.0, 0.0]
    worse = judge.gaps(logits.transpose(0, 1), lens, judge.altered(own), own,
                       'greedy')
    assert worse[0] > 0


@pytest.mark.parametrize('train', [False, True])
def test_flops_match_flop_counter(train):
    """At a width with no padding the analytic count is what PyTorch counts
    for the reference's convs and products."""
    width, n = 64, 2
    params = model.make_params(1, 'cpu', num_hid=512)
    if train:
        params = {k: v.requires_grad_(not model.is_buffer(k))
                  for k, v in params.items()}
    x = torch.rand(n, width, 32)
    lens = torch.full((n,), width // 4 - 1, dtype=torch.int32)
    counter = FlopCounterMode(display=False)
    with counter:
        out = model.forward(params, x, lens)
        if train:
            out.sum().backward()
    want = n * flops.model_flops(width, 512, 64, train=train)
    assert counter.get_total_flops() == want


def test_bounds_count_own_frames_and_states():
    a = flops.ctc_bound([10, 20], [2, 3], False)[0]
    b = flops.ctc_bound([10, 20, 0], [2, 3, 0], False)[0]
    assert b >= a
    t1, kind = flops.bilstm_fwd_bound([30] * 64, 256)
    t2, _ = flops.bilstm_fwd_bound([15] * 64, 256)
    assert t2 < t1 and kind in ('bytes', 'operations')
    assert flops.frames(160) == 39
    assert common.pick_bucket(137, [64, 96, 128, 160]) == 160
