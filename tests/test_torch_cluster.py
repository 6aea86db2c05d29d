"""The geometry and index formulas of the bf16 cluster recurrence that the
two LSTM forward kernels share (``csrc/lstm_fwd_cluster.cuh``), without a
card: the CUDA code cannot run here, so its loops' index arithmetic is
transcribed below and held against ``rnn_cuda.pack_u_slices`` and against
the tiling it must cover. The kernels themselves are held against their
plain versions on the card by ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from lstm_ctc_ocr_torch.ops import _build, rnn_cuda

GROUP_ROWS, SPLITS, MAX_DEPTH = 16, 4, 512     # the header's constants

HIDDEN = [8, 16, 40, 128, 136, 200, 256, 264, 392, 512]


def _depth(h, ub):
    """``lstm_fwd_cluster::depth``: CS UB rounded up to the k16 steps."""
    return (-(-h // ub) * ub + 15) // 16 * 16


@pytest.mark.parametrize('h', HIDDEN)
def test_units_per_block_fits_one_cluster(h):
    """Every H the kernels take (a multiple of 8 up to 512) gives a cluster
    of at most 16 blocks of at most 512 threads, whose warps split into
    column groups of 32 columns with one warp per depth quarter, and a
    product depth of at most 512."""
    ub = rnn_cuda.units_per_block(h)
    cs = -(-h // ub)
    assert ub % 8 == 0 and ub <= 32 and cs <= 16
    assert (cs - 1) * ub < h <= cs * ub           # the last block owns units
    warps = GROUP_ROWS * ub // 32
    assert warps == SPLITS * (4 * ub // 32)       # 4 warps per 32 columns
    assert _depth(h, ub) <= MAX_DEPTH and _depth(h, ub) >= cs * ub


@pytest.mark.parametrize('h', HIDDEN)
def test_kernel_u_copy_is_the_packed_slice(h):
    """The cluster block's cp.async loop (16-byte chunks, row k, gate q,
    units j..j+7 from U [H, 4H], zero-filled past H) builds in shared
    memory exactly ``pack_u_slices(U, UB)[rank]``, zero rows up to the
    product's depth."""
    ub = rnn_cuda.units_per_block(h)
    cs, kp = -(-h // ub), _depth(h, ub)
    u = np.random.RandomState(h).randn(h, 4 * h).astype(np.float32)
    flat = u.reshape(-1)
    packed = rnn_cuda.pack_u_slices(torch.from_numpy(u), ub).numpy()
    cpg = ub // 8
    cpr = 4 * cpg
    for rank in range(cs):
        image = np.full((kp, 4 * ub), np.nan, dtype=np.float32)
        for i in range(kp * cpr):                 # the kernel's loop
            k, q, j = i // cpr, (i % cpr) // cpg, (i % cpg) * 8
            unit = rank * ub + j
            if k < h and unit < h:
                src = k * 4 * h + q * h + unit
                image[k, q * ub + j:q * ub + j + 8] = flat[src:src + 8]
            else:
                image[k, q * ub + j:q * ub + j + 8] = 0.0
        np.testing.assert_array_equal(image[:h], packed[rank])
        assert not image[h:].any()


@pytest.mark.parametrize('h', HIDDEN)
def test_kernel_h_pull_fills_the_a_tile_once(h):
    """The exchange's pull (chunk i of CS x 16 rows x UB / 8, at most two a
    thread) writes every column of the A tile below CS UB exactly once,
    from the owning block's row and units, and nothing past it."""
    ub = rnn_cuda.units_per_block(h)
    cs, kp = -(-h // ub), _depth(h, ub)
    threads, cpb = GROUP_ROWS * ub, ub // 8
    total = cs * GROUP_ROWS * cpb
    assert total <= 2 * threads
    hits = np.zeros((GROUP_ROWS, kp), dtype=int)
    for tid in range(threads):
        for e in range(2):
            i = tid + e * threads
            if i >= total:
                continue
            src, rem = i // (GROUP_ROWS * cpb), i % (GROUP_ROWS * cpb)
            row, col = rem // cpb, (rem % cpb) * 8
            assert src < cs and col + 8 <= ub     # inside block src's slice
            hits[row, src * ub + col:src * ub + col + 8] += 1
    assert (hits[:, :cs * ub] == 1).all() and not hits[:, cs * ub:].any()


@pytest.mark.parametrize('h', HIDDEN)
def test_product_splits_cover_the_depth_once(h):
    """The four depth quarters (``per`` k16 steps each, unrolled to at most
    eight) take every k16 step of the product exactly once, and each column
    group's four n8 tiles stay inside the block's 4 UB columns."""
    ub = rnn_cuda.units_per_block(h)
    n_steps = _depth(h, ub) // 16
    per = -(-n_steps // SPLITS)
    assert per <= MAX_DEPTH // 16 // SPLITS
    taken = []
    for split in range(SPLITS):
        for i in range(MAX_DEPTH // 16 // SPLITS):
            ks = split * per + i
            if i >= per or ks >= n_steps:
                break
            taken.append(ks)
    assert sorted(taken) == list(range(n_steps))
    warps = GROUP_ROWS * ub // 32
    cols = sorted(c for w in range(warps) if w % SPLITS == 0
                  for c in range((w // SPLITS) * 32, (w // SPLITS) * 32 + 32))
    assert cols == list(range(4 * ub))


def test_launch_error_names_the_cluster(monkeypatch):
    """A failed launch raises with its cudaError and, for a bf16 cluster
    launch, the cluster's shape as the kernel library reports it."""
    class Lib:
        @staticmethod
        def lstm_fwd_cluster_smem(h, ub):
            return 1000 * h + ub

        @staticmethod
        def lstm_fwd_max_clusters(h, ub):
            return 0
    monkeypatch.setattr(_build, 'library', lambda name: Lib)
    rep = rnn_cuda.cluster_report('lstm_fwd', 512, 32)
    assert rep == {'units_per_block': 32, 'blocks': 16, 'threads': 512,
                   'dynamic_smem': 512032, 'max_active_clusters': 0}
    err = rnn_cuda._launch_failed('lstm_fwd', 2, 512, 32)
    assert isinstance(err, RuntimeError)
    assert str(err).startswith('lstm_fwd kernel launch failed: cudaError 2 ')
    assert '16 blocks of 512 threads' in str(err)
    assert 'holds 0 such clusters' in str(err)
    assert str(rnn_cuda._launch_failed('lstm_fwd', 2, 512)) == \
        'lstm_fwd kernel launch failed: cudaError 2'
