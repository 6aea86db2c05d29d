"""The geometry and index formulas of the bf16 cluster recurrence that the
two LSTM backward kernels share (``csrc/lstm_bwd_cluster.cuh``; kernel 6,
``lstm_bwd``, runs one direction, kernel 2, ``bilstm_bwd``, two), without a
card: the CUDA code cannot run here, so its loops' index arithmetic is
transcribed below and held against ``rnn_cuda.pack_u_slices``, the tiling
it must cover and, run as a whole in numpy, the plain backward walk
``rnn_cuda._bwd_walk`` (which ``tests/test_torch_rnn_bwd.py`` holds to the
JAX package). The kernels themselves are held against their plain versions
on the card by ``tests/test_torch_cuda.py``. Tolerance of the whole-walk
emulation: 1e-5 of each output's largest entry, in f32 (the partial
products sum in another order than one matmul).
"""

import numpy as np
import pytest
import torch

from lstm_ctc_ocr_torch.ops import rnn_cuda

GROUP_ROWS, MAX_UNITS = 16, 32                 # the header's constants

TWO_DIRECTIONS = [8, 16, 40, 128, 136, 200, 256]   # bilstm_bwd: H <= 256
ONE_DIRECTION = [264, 392, 512]                    # lstm_bwd only
CASES = ([(h, bw) for h in TWO_DIRECTIONS for bw in (False, True)]
         + [(h, False) for h in ONE_DIRECTION])


def _geometry(h):
    ub = rnn_cuda.units_per_block(h)
    return ub, -(-h // ub)


def _u_copy(u, h, ub, rank):
    """The block's cp.async loop: 16-byte chunks of row n, gate q, units
    c..c+7 from U [H, 4H] into u_s[n][q UB + c], zero-filled past H."""
    flat = u.reshape(-1)
    image = np.full((h, 4 * ub), np.nan, dtype=u.dtype)
    cpg = ub // 8
    cpr = 4 * cpg
    for i in range(h * cpr):
        row, q, c = i // cpr, (i % cpr) // cpg, (i % cpg) * 8
        unit = rank * ub + c
        if unit < h:
            src = row * 4 * h + q * h + unit
            image[row, q * ub + c:q * ub + c + 8] = flat[src:src + 8]
        else:
            image[row, q * ub + c:q * ub + c + 8] = 0.0
    return image


def _walk(t_len, bw):
    """The recurrence's loop and its fetch: step s visits row t and takes
    its carry from row tp, or from the zero state (None)."""
    steps = []
    for s in range(t_len):
        t = s if bw else t_len - 1 - s
        tp = t + 1 if bw else t - 1
        steps.append((t, tp if 0 <= tp < t_len else None))
    return steps


@pytest.mark.parametrize('h,bw', CASES)
def test_kernel_u_copy_is_the_packed_slice(h, bw):
    """Each cluster block's copy of its 4 UB gate columns straight from U
    builds exactly ``pack_u_slices(U, UB)[rank]`` (the image the wrappers
    packed before the kernels copied U themselves), for each direction's
    U."""
    ub, cs = _geometry(h)
    assert ub % 8 == 0 and ub <= MAX_UNITS and cs <= 16
    u = np.random.RandomState(h + bw).randn(h, 4 * h).astype(np.float32)
    packed = rnn_cuda.pack_u_slices(torch.from_numpy(u), ub).numpy()
    for rank in range(cs):
        np.testing.assert_array_equal(_u_copy(u, h, ub, rank), packed[rank])


@pytest.mark.parametrize('t_len', [1, 2, 7])
@pytest.mark.parametrize('bw', [False, True])
def test_time_order_and_carry_rows(t_len, bw):
    """The forward direction walks t descending with its carry from row t-1
    (zero at t = 0), the BiLSTM's backward direction t ascending from row
    t+1 (zero at t = T-1): the plain walk's order and carries. The dU
    launch's operand offsets (h_prev rows from N rows on for the backward
    direction, dx rows from N rows on for the forward one, over (T-1) N
    rows) pair each row of dx with its carry and drop the zero-carry step."""
    steps = _walk(t_len, bw)
    order = list(range(t_len)) if bw else list(reversed(range(t_len)))
    assert [t for t, _ in steps] == order
    for t, tp in steps:
        assert tp == (None if t == (t_len - 1 if bw else 0)
                      else (t + 1 if bw else t - 1))
    n = 3
    h_off, dx_off = (n, 0) if bw else (0, n)
    pairs = sorted((dx_off // n + i, h_off // n + i) for i in range(t_len - 1))
    assert pairs == sorted((t, tp) for t, tp in steps if tp is not None)


@pytest.mark.parametrize('h', TWO_DIRECTIONS + ONE_DIRECTION)
def test_partial_products_and_pull_cover_the_rows_once(h):
    """Each block's warps store the n8 tiles of the partial product [16, H]
    that lie below H exactly once, from U rows below H (the clamp of rows
    past H touches only tiles that are never stored); the k16 steps take the
    depth 4 UB once; and the pull, thread (r, j) of block b adding
    P_b'[r][b UB + j] over the cluster's blocks, reads every entry of every
    block's [16, H] partial exactly once."""
    ub, cs = _geometry(h)
    threads, n_tiles = GROUP_ROWS * ub, h // 8
    k_len = 4 * ub
    steps = [kk for kk in range(0, MAX_UNITS // 4 * 16, 16) if kk < k_len]
    assert steps == list(range(0, k_len, 16))
    stored = np.zeros((GROUP_ROWS, h), dtype=int)
    for warp in range(threads // 32):
        if warp * 4 >= n_tiles:
            continue
        for lane in range(32):
            mi, mj = lane // 8, lane % 8
            for p in range(2):
                row = (warp * 4 + 2 * p) * 8 + (mi // 2) * 8 + mj
                if row >= h:                  # clamped: its tile is unstored
                    assert warp * 4 + 2 * p + mi // 2 >= n_tiles
            for i in range(4):
                nt = warp * 4 + i
                if nt >= n_tiles:
                    continue
                col = nt * 8 + (lane % 4) * 2
                for r in (lane // 4, lane // 4 + 8):
                    stored[r, col:col + 2] += 1
    assert (stored == 1).all()
    reads = np.zeros((cs, GROUP_ROWS, h), dtype=int)
    for b in range(cs):
        for tid in range(threads):
            r, j = tid // ub, tid % ub
            k = b * ub + j
            if k < h:
                reads[:, r, k] += 1
    assert (reads == 1).all()


def _emulate(dout, gates, cs_res, u, lens, bw):
    """The cluster recurrence in numpy, f32, loop by loop: per row group and
    step the thread-local dg, the blocks' A tiles and partial products
    against their copied U columns, and the ascending sum of the pull.
    Returns (dx, db), as the kernel writes dx and db_part."""
    t_len, n_rows, h = dout.shape
    ub, cs = _geometry(h)
    images = [_u_copy(u, h, ub, rank) for rank in range(cs)]
    dx = np.zeros((t_len, n_rows, 4 * h), np.float32)
    db_part = np.zeros((n_rows, 4 * h), np.float32)
    for g0 in range(0, n_rows, GROUP_ROWS):
        rows = np.arange(g0, min(g0 + GROUP_ROWS, n_rows))
        dh = np.zeros((len(rows), h), np.float32)
        dc = np.zeros_like(dh)
        for t, tp in _walk(t_len, bw):
            live = (lens[rows] > t)[:, None]
            gi, gj, gf, go = np.split(gates[t, rows], 4, axis=1)
            c_prev = cs_res[tp, rows] if tp is not None else np.zeros_like(dh)
            tanh_c = np.tanh(gf * c_prev + gi * gj)
            g_hnew = dh + dout[t, rows]
            do_ = g_hnew * tanh_c
            dc_tot = dc + g_hnew * go * (1 - tanh_c * tanh_c)
            dg = np.concatenate([dc_tot * gj * gi * (1 - gi),
                                 dc_tot * gi * (1 - gj * gj),
                                 dc_tot * c_prev * gf * (1 - gf),
                                 do_ * go * (1 - go)], axis=1)
            dg = np.where(live, dg, 0).astype(np.float32)
            dc = np.where(live, dc_tot * gf, dc)
            dx[t, rows] = dg
            db_part[rows] += dg
            total = np.zeros_like(dh)
            for b in range(cs):                   # ascending, as the pull
                a_tile = np.zeros((len(rows), 4 * ub), np.float32)
                for q in range(4):
                    units = np.arange(b * ub, min((b + 1) * ub, h))
                    a_tile[:, q * ub:q * ub + len(units)] = dg[:, q * h + units]
                total += a_tile @ images[b].T     # P_b, [rows, H]
            dh = total + np.where(live, 0, dh)
    return dx, db_part.sum(axis=0)


@pytest.mark.parametrize('h,bw', CASES)
def test_emulated_recurrence_matches_the_plain_walk(h, bw):
    """The transcribed recurrence (U copy, partial products, pull) run in
    numpy over a ragged batch of two row groups (the second partial, rows
    of length 0 and T) gives the plain walk's dx and db; dU from the dU
    launch's operand offsets gives its dU."""
    t_len, n_rows = 5, 20
    rng = np.random.RandomState(h * 2 + bw)
    gates = rng.rand(t_len, n_rows, 4 * h).astype(np.float32)
    hs = (rng.randn(t_len, n_rows, h) * 0.5).astype(np.float32)
    cs_res = (rng.randn(t_len, n_rows, h) * 0.5).astype(np.float32)
    dout = (rng.randn(t_len, n_rows, h) * 0.1).astype(np.float32)
    u = (rng.randn(h, 4 * h) * h ** -0.5).astype(np.float32)
    lens = rng.randint(0, t_len + 1, n_rows).astype(np.int32)
    lens[0], lens[1], lens[17] = 0, t_len, 2
    dx, db = _emulate(dout, gates, cs_res, u, lens, bw)
    want_dx, want_du, want_db = rnn_cuda._bwd_walk(
        *(torch.from_numpy(a) for a in (dout, gates, hs, cs_res, u, lens)),
        fw=not bw)
    # dU over the (T-1) N rows at the launch's offsets
    a_rows = hs[1:] if bw else hs[:-1]
    b_rows = dx[:-1] if bw else dx[1:]
    du = a_rows.reshape(-1, h).T @ b_rows.reshape(-1, 4 * h)
    for got, want in ((dx, want_dx), (db, want_db), (du, want_du)):
        want = want.numpy()
        scale = max(float(np.abs(want).max()), 1e-6)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    assert not dx[np.arange(t_len)[:, None] >= lens[None, :]].any()
