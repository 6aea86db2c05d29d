"""The port's CTC beam search against the JAX package's.

``ops/beam.beam_decode`` must return the JAX ``beam_decode``'s ids, entry
for entry, on seeded random logits (many and few classes, beam widths 16 and
1, ragged lengths, both ``merge_repeated`` settings), pass the hand cases of
tests/test_beam.py, and give the JAX evaluation's strings on the 64-image
``data/val`` slice under ``DECODER: beam``.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lstm_ctc_ocr_tpu.config import AttrDict, cfg as jcfg, cfg_from_file
from lstm_ctc_ocr_tpu.ops.beam import beam_decode as jbeam_decode
from lstm_ctc_ocr_torch.config import load_cfg
from lstm_ctc_ocr_torch.engine import test as port_test
from lstm_ctc_ocr_torch.ops.beam import beam_decode
from lstm_ctc_ocr_torch.ops.decoder import greedy_decode

from test_torch_eval import REPO, _jcfg_guard, release_layout  # noqa: F401


def _decode(logits, lens, **kw):
    out = beam_decode(torch.from_numpy(logits), torch.from_numpy(lens), **kw)
    assert out.dtype == torch.int32 and tuple(out.shape) == logits.shape[:2]
    return out.numpy()


def _strip(row):
    return [int(v) for v in row if v != 0]


@pytest.mark.parametrize('merge_repeated', [False, True])
@pytest.mark.parametrize('c,k,scale', [(64, 16, 1.0), (12, 16, 1.0),
                                       (64, 1, 2.0), (12, 1, 0.5),
                                       (64, 16, 4.0), (5, 4, 0.5)])
def test_ids_identical_to_jax_beam_decode(c, k, scale, merge_repeated):
    """With 12 classes fewer than 16 candidates are alive at t = 0, so the
    pruning picks among NEG_INF ties every time: the ids agree only if ties
    go to the lowest candidate index on both sides."""
    rng = np.random.RandomState(c * k)
    n, t = 8, 21
    logits = (rng.randn(n, t, c) * scale).astype(np.float32)
    lens = rng.randint(1, t + 1, n).astype(np.int32)
    lens[0], lens[1] = t, 1
    want = np.asarray(jbeam_decode(jnp.asarray(logits), jnp.asarray(lens),
                                   beam_width=k,
                                   merge_repeated=merge_repeated))
    got = _decode(logits, lens, beam_width=k, merge_repeated=merge_repeated)
    np.testing.assert_array_equal(got, want)


def test_beam_equals_greedy_on_peaked_logits():
    rng = np.random.RandomState(0)
    n, t, c = 6, 15, 10
    ids = rng.randint(0, c, size=(n, t))
    logits = np.full((n, t, c), -8.0, np.float32)
    for i in range(n):
        logits[i, np.arange(t), ids[i]] = 8.0
    lens = np.array([15, 12, 9, 15, 4, 1], np.int32)
    g = greedy_decode(torch.from_numpy(logits), torch.from_numpy(lens)).numpy()
    b = _decode(logits, lens, beam_width=8)
    for i in range(n):
        assert _strip(g[i]) == _strip(b[i]), i


def test_beam_beats_greedy_classic_case():
    """p(blank)=.6,.6 / p(a)=.4,.4 per frame: best path is blank-blank ->
    greedy decodes [], but p([a]) = .4*.4 + .4*.6 + .6*.4 = .64 > .36."""
    logits = np.log(np.array([[[0.6, 0.4], [0.6, 0.4]]], np.float32))
    lens = np.array([2], np.int32)
    g = greedy_decode(torch.from_numpy(logits), torch.from_numpy(lens)).numpy()
    assert _strip(g[0]) == []
    assert _strip(_decode(logits, lens, beam_width=4)[0]) == [1]


@pytest.mark.parametrize('path,length,classes,want', [
    ([1, 1, 0, 1], 4, 3, [1, 1]),     # a repeat needs a blank in between
    ([2, 0, 1, 1], 1, 4, [2]),        # frames past the length are masked
])
def test_beam_repeats_and_length_mask(path, length, classes, want):
    logits = np.full((1, 4, classes), -9.0, np.float32)
    for t, k in enumerate(path):
        logits[0, t, k] = 9.0
    out = _decode(logits, np.array([length], np.int32), beam_width=4)
    assert _strip(out[0]) == want


def test_beam_width_one_is_greedy_like():
    rng = np.random.RandomState(2)
    logits = rng.randn(3, 10, 6).astype(np.float32) * 4
    lens = np.array([10, 10, 10], np.int32)
    b1 = _decode(logits, lens, beam_width=1)
    g = greedy_decode(torch.from_numpy(logits), torch.from_numpy(lens)).numpy()
    assert sum(_strip(b1[i]) == _strip(g[i]) for i in range(3)) >= 2


def test_merge_repeated_collapses_after_the_search():
    logits = np.full((1, 4, 3), -9.0, np.float32)
    for t, k in enumerate([1, 0, 1, 2]):       # label "1 1 2" vs merged "1 2"
        logits[0, t, k] = 9.0
    lens = np.array([4], np.int32)
    assert _strip(_decode(logits, lens, beam_width=4)[0]) == [1, 1, 2]
    assert _strip(_decode(logits, lens, beam_width=4,
                          merge_repeated=True)[0]) == [1, 2]


def test_beam_eval_slice_matches_jax_eval(release_layout, _jcfg_guard,  # noqa: F811
                                          capsys):
    """``test_net`` under ``DECODER: beam`` (width 16) on the 64-image
    slice: every file decodes to the JAX ``test_net``'s string."""
    pytest.importorskip('cv2')
    out_dir, sub = release_layout
    cfg_from_file(os.path.join(REPO, 'lstm', 'lstm.yml'))
    jcfg.TEST.BATCH_SIZE = 16
    jcfg.TRAIN.DTYPE = 'float32'
    jcfg.DECODER = 'beam'
    jcfg.PARALLEL = 'off'
    from lstm_ctc_ocr_tpu.engine.test import test_net as jtest_net
    from lstm_ctc_ocr_tpu.models.factory import get_network
    jacc, _ = jtest_net(get_network('LSTM_test'), AttrDict({'name': 'x'}),
                        sub, out_dir, None)
    want = {}
    for line in capsys.readouterr().out.splitlines():
        fname, sep, res = line.partition('    res: ')
        if sep and fname.endswith('.png'):
            want[fname] = res

    cfg = load_cfg(os.path.join(REPO, 'lstm', 'lstm.yml'),
                   ['TEST.BATCH_SIZE', '16', 'TRAIN.DTYPE', "'float32'",
                    'DECODER', "'beam'"])
    assert int(cfg.BEAM_WIDTH) == int(jcfg.BEAM_WIDTH) == 16
    result = port_test.test_net(cfg, sub, out_dir, device='cpu',
                                echo=lambda s: None)
    assert len(want) == result.total == 64
    assert result.predictions == want
    assert result.acc == pytest.approx(jacc)
