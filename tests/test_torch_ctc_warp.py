"""The CTC kernels' warp paths (``csrc/ctc.cu:ctc_fwd_warp_kernel`` and
``ctc_bwd_warp_kernel``), for S <= 64, without a card: the CUDA code cannot
run here, so its structure is transcribed below in numpy -- one warp (and
block) per example, lane l holding the K consecutive states l K .. l K +
K - 1 (K = 1 up to S = 32, 2 up to 64); the forward's s-1 / s-2
neighbours from the lane's own registers or from the previous lanes
(``__shfl_up_sync``, NEG below lane 0), the backward's s+1 / s+2 from the
next lanes (``__shfl_down_sync``, NEG past the warp); the two-stage ring of
kChunk time steps that stages g (the forward, ascending, each chunk
shifted as ``stage_copy`` shifts it) or g and alphas (the backward,
descending) one chunk ahead; the forward's unclamped first row and its
warp reduction of logZ -- and held to the plain versions
``ctc_forward_reference`` / ``ctc_backward_reference`` (which the kernels
are held to on the card) and to the JAX package's TPU kernels
``ctc_pallas._run_forward`` / ``_run_backward`` (in interpret mode off the
TPU, as ``tests/test_torch_ctc.py`` runs them). Tolerance 1e-5 absolute
and relative, f32, the repo's standing CTC bar; every batch is ragged,
with an empty label, an infeasible example and a one-frame example.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lstm_ctc_ocr_tpu.ops import ctc_pallas
from lstm_ctc_ocr_torch.ops import ctc

NEG = np.float32(-1e30)
CHUNK, WARP_MAX_STATES = 16, 64                # ctc.cu's constants


def _lse3(a, b, c):
    """ctc.cu's lse3 in f32, elementwise."""
    m = np.maximum(np.maximum(a, b), c)
    ms = np.maximum(m, NEG)
    # where m is NEG the sum can be 0: log gives -inf there, as logf does,
    # and the where below drops it
    with np.errstate(divide='ignore'):
        out = ms + np.log(np.exp(a - ms) + np.exp(b - ms) + np.exp(c - ms))
    return np.where(m > np.float32(0.5) * NEG, out, NEG).astype(np.float32)


def _shift_lanes(x, by):
    """``__shfl_down_sync(x, by)`` over the warp's 32 lanes, NEG where the
    source lane is past the warp. x: [32, ...]."""
    out = np.full_like(x, NEG)
    out[:32 - by] = x[by:]
    return out


def _shift_up_lanes(x, by):
    """``__shfl_up_sync(x, by)`` over the warp's 32 lanes, NEG where the
    source lane is below lane 0. x: [32, ...]."""
    out = np.full_like(x, NEG)
    out[by:] = x[:32 - by]
    return out


def _neighbours_below(alpha):
    """The s-1 and s-2 neighbours of each state of ``alpha`` [32, K], as the
    forward's lanes get them: from the lane's own registers or from the
    previous lanes' by ``__shfl_up_sync``, NEG below lane 0."""
    pv = _shift_up_lanes(alpha, 1)
    if alpha.shape[1] == 1:
        return pv, _shift_up_lanes(alpha, 2)
    return (np.stack([pv[:, 1], alpha[:, 0]], axis=1),
            np.stack([pv[:, 0], pv[:, 1]], axis=1))


def _stage_floats(s_len):
    """ctc.cu's stage_floats: floats of one ring stage's rows of g."""
    return (CHUNK * s_len + 3 + 3) // 4 * 4


def _stage_copy(dst, src, off, count):
    """ctc.cu's stage_copy of ``count`` floats of ``src`` from ``off`` (a
    float index from a 16-byte aligned base) into the stage ``dst`` at its
    shift ``off % 4``, in the pieces the warp's lanes issue: 4-byte copies
    up to a 16-byte boundary, 16-byte copies, 4-byte copies of the rest."""
    shift = off % 4
    d = shift                                  # dst + shift_of(src)
    head = min((4 - shift) & 3, count)
    vecs = (count - head) // 4
    tail = head + 4 * vecs
    for lane in range(32):
        if lane < head:
            dst[d + lane] = src[off + lane]
        for i in range(lane, vecs, 32):
            lo = head + 4 * i
            assert (d + lo) % 4 == 0 and (off + lo) % 4 == 0   # 16 bytes
            dst[d + lo:d + lo + 4] = src[off + lo:off + lo + 4]
        if lane < count - tail:
            dst[d + tail + lane] = src[off + tail + lane]
    assert d + count <= len(dst)


def _warp_forward(g, skip, valid, fin):
    """ctc_fwd_warp_kernel<K> in numpy, block (example) by block: returns
    (logz [N], alphas [N, T, S])."""
    n_rows, t_len, s_len = g.shape
    assert s_len <= WARP_MAX_STATES
    k_per = 1 if s_len <= 32 else 2
    logz = np.full(n_rows, np.nan, np.float32)
    alphas = np.full(g.shape, np.nan, np.float32)
    n_chunks = -(-t_len // CHUNK)
    stage = _stage_floats(s_len)
    flat = np.ascontiguousarray(g).reshape(-1)
    lanes = np.arange(32)
    for n in range(n_rows):
        states = np.arange(32 * k_per).reshape(32, k_per)   # [lane, k]
        act = states < s_len
        col = np.minimum(states, s_len - 1)    # the clamped column
        sk, va, fi = (np.where(act, m[n][col], NEG) for m in (skip, valid,
                                                              fin))
        base = n * t_len * s_len
        ring = np.full((2, stage), np.nan, np.float32)
        held = [None, None]                    # the chunk each stage holds

        def issue(c):
            if c < n_chunks:
                # a stage is refilled only after its chunk was read
                assert held[c % 2] is None or held[c % 2] == c - 2
                lo = c * CHUNK
                ring[c % 2] = np.nan           # what was not copied is NaN
                _stage_copy(ring[c % 2], flat, base + lo * s_len,
                            (min(lo + CHUNK, t_len) - lo) * s_len)
                held[c % 2] = c

        def read(c, row):
            """this lane's g of one step: row ``row`` of chunk c's rows"""
            assert held[c % 2] == c
            idx = (base + c * CHUNK * s_len) % 4 + row + col   # rows_g(c)
            return np.where(act, ring[c % 2][idx], NEG)
        issue(0)
        issue(1)

        # step 0 is not clamped: NEG + valid past state 1
        alpha = (np.where(states <= 1, read(0, 0), NEG) + va).astype(
            np.float32)
        alphas[n, 0] = alpha.reshape(-1)[:s_len]
        for c in range(n_chunks):
            lo, hi = c * CHUNK, min((c + 1) * CHUNK, t_len)
            for t in range(1 if c == 0 else lo, hi):
                gt = read(c, (t - lo) * s_len)
                one, two = _neighbours_below(alpha)
                alpha = np.maximum(gt + _lse3(alpha, one, two + sk) + va,
                                   NEG).astype(np.float32)
                alphas[n, t] = alpha.reshape(-1)[:s_len]
            issue(c + 2)

        # logZ: each lane over its K states, then the butterfly over lanes
        x = (alpha + fi).astype(np.float32)
        m = x.max(axis=1)
        for d in (16, 8, 4, 2, 1):
            m = np.maximum(m, m[lanes ^ d])
        ms = np.maximum(m, NEG)
        total = np.zeros(32, np.float32)
        for k in range(k_per):
            total = (total + np.exp(x[:, k] - ms)).astype(np.float32)
        for d in (16, 8, 4, 2, 1):
            total = (total + total[lanes ^ d]).astype(np.float32)
        logz[n] = (ms[0] + np.log(total[0]) if m[0] > np.float32(0.5) * NEG
                   else NEG)
    return logz, alphas


def _warp_backward(g, skip, valid, fin, alphas, logz, lens):
    """ctc_bwd_warp_kernel<K> in numpy, block (example) by block: returns
    grad [N, T, S]."""
    n_rows, t_len, s_len = g.shape
    assert s_len <= WARP_MAX_STATES
    k_per = 1 if s_len <= 32 else 2
    grad = np.full(g.shape, np.nan, np.float32)
    n_chunks = -(-t_len // CHUNK)
    for n in range(n_rows):
        states = np.arange(32 * k_per).reshape(32, k_per)   # [lane, k]
        act = states < s_len

        def row_of(x, fill=NEG):
            padded = np.full(32 * k_per + 2, fill, np.float32)
            padded[:s_len] = x
            return padded
        sk_fwd = row_of(skip[n])[states + 2]          # skip[s+2], NEG past S
        va = np.where(act, row_of(valid[n])[states], NEG)
        fi = np.where(act, row_of(fin[n])[states], NEG)
        lz = logz[n]
        feasible = np.float32(1.0 if lz > 0.5 * NEG else 0.0)
        ring = [None, None]                      # (chunk, lo, g, alphas)

        def bounds(c):
            hi = t_len - 1 - c * CHUNK
            return max(hi - CHUNK + 1, 0), hi

        def issue(c):
            if c < n_chunks:
                lo, hi = bounds(c)
                # a stage is refilled only after its chunk was read
                assert ring[c % 2] is None or ring[c % 2][0] == c - 2
                ring[c % 2] = (c, lo, g[n, lo:hi + 1].copy(),
                               alphas[n, lo:hi + 1].copy())
        issue(0)
        issue(1)

        def emit(t, beta, gt, at):
            live = np.float32(1.0 if t < lens[n] else 0.0)
            lg = at + beta - gt - lz
            post = np.where(lg > np.float32(0.5) * NEG,
                            np.exp(np.minimum(lg, 0)), 0)
            out = (-post * feasible * live).astype(np.float32)
            grad[n, t] = out.reshape(-1)[:s_len]

        # step T-1 starts the walk; each later step t computes beta[t]
        # and emits step t+1's gradient, from beta[t+1]
        chunk, lo, g_rows, a_rows = ring[0]
        assert chunk == 0
        gp = np.where(act, row_of(g_rows[t_len - 1 - lo])[states], NEG)
        ap = np.where(act, row_of(a_rows[t_len - 1 - lo])[states], NEG)
        beta = np.maximum(gp + fi + va, NEG)
        tp = t_len - 1
        for c in range(n_chunks):
            chunk, lo, g_rows, a_rows = ring[c % 2]
            assert chunk == c                     # the stage holds c
            hi = bounds(c)[1] - (1 if c == 0 else 0)
            for t in range(hi, lo - 1, -1):
                gt = np.where(act, row_of(g_rows[t - lo])[states], NEG)
                at = np.where(act, row_of(a_rows[t - lo])[states], NEG)
                nx = _shift_lanes(beta, 1)
                if k_per == 1:
                    one, two = nx, _shift_lanes(beta, 2)
                else:
                    one = np.stack([beta[:, 1], nx[:, 0]], axis=1)
                    two = np.stack([nx[:, 0], nx[:, 1]], axis=1)
                nb = np.maximum(gt + _lse3(beta, one, two + sk_fwd) + va,
                                NEG).astype(np.float32)
                emit(tp, beta, gp, ap)
                beta, gp, ap, tp = nb, gt, at, t
            issue(c + 2)
        emit(tp, beta, gp, ap)
    return grad


def _case(seed, n, t_len, l_max, c=12):
    """A ragged batch: a repeated label (row 0), an empty label (row 1), an
    infeasible example (row 2) and a one-frame example (row 3)."""
    rng = np.random.RandomState(seed)
    logits = (rng.randn(n, t_len, c) * 2).astype(np.float32)
    labels = rng.randint(1, c, (n, l_max)).astype(np.int32)
    label_lens = rng.randint(0, l_max + 1, n).astype(np.int32)
    logit_lens = rng.randint(max(1, t_len // 2), t_len + 1, n).astype(np.int32)
    if l_max > 1:
        labels[0, 1] = labels[0, 0]
    label_lens[0], logit_lens[0] = l_max, t_len
    label_lens[1] = 0
    if l_max > 1:
        label_lens[2], logit_lens[2] = l_max, l_max - 1
    label_lens[3], logit_lens[3] = min(l_max, 1), 1
    for i in range(n):
        labels[i, label_lens[i]:] = 0
    return logits, labels, label_lens, logit_lens


# (L, T, N): S = 2L+1 from 1 to 63, each path (K = 1: S <= 32; K = 2: S <=
# 64) on both sides of its boundary; T from one chunk short of a chunk to
# three chunks
CASES = [(0, 5, 6), (1, 17, 9), (6, 23, 10), (15, 33, 8), (16, 40, 7),
         (24, 50, 10), (31, 70, 5)]


def _inputs(l_max, t_len, n):
    """The kernels' inputs from :func:`_case`: g, skip, valid, final and
    the frame counts, torch tensors on the CPU."""
    logits, labels, label_lens, logit_lens = _case(l_max * 7 + t_len, n,
                                                   t_len, l_max)
    s_len = 2 * l_max + 1
    logp = torch.log_softmax(torch.from_numpy(logits), -1)
    ext = ctc.extended_labels(torch.from_numpy(labels))
    # a one-state row (L = 0) gets a two-wide skip mask from the shared
    # _transition_masks (the JAX package's does the same); the one state's
    # is its first column
    skip, final, valid = (ctc._as_additive(m)[:, :s_len].contiguous()
                          for m in ctc._transition_masks(
                              ext, torch.from_numpy(label_lens)))
    lens = torch.from_numpy(logit_lens)
    g = ctc._gather_logp(logp, ext, lens).contiguous()
    return g, skip, valid, final, lens


def _tpu_padded(n, s_len, cubes, rows):
    """Tensors padded as ctc_pallas._pad_args pads them for the TPU
    kernels: N to a multiple of 8 rows, S to 128 lanes of NEG."""
    n_pad = -(-n // ctc_pallas.TILE_N) * ctc_pallas.TILE_N
    pad_n, pad_s = (0, n_pad - n), (0, ctc_pallas.LANES - s_len)
    return ([jnp.pad(jnp.asarray(x.numpy()), (pad_n, (0, 0), pad_s),
                     constant_values=NEG) for x in cubes]
            + [jnp.pad(jnp.asarray(x.numpy()), (pad_n, pad_s),
                       constant_values=NEG) for x in rows])


@pytest.mark.parametrize('l_max,t_len,n', CASES)
def test_warp_path_matches_plain_and_tpu_backward(l_max, t_len, n):
    g, skip, valid, final, lens = _inputs(l_max, t_len, n)
    s_len, logit_lens = 2 * l_max + 1, lens.numpy()
    logz, alphas = ctc.ctc_forward_reference(g, skip, valid, final)
    want = ctc.ctc_backward_reference(g, skip, valid, final, alphas, logz,
                                      lens).numpy()
    got = _warp_backward(*(x.numpy() for x in (
        g, skip, valid, final, alphas, logz, lens)))
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if l_max > 1:
        assert float(logz[2]) <= ctc.NEG_INF / 2 and not got[2].any()
    assert not got[np.arange(t_len)[None, :] >= logit_lens[:, None]].any()

    # the TPU backward kernel on the same inputs (the plain forward's alphas
    # and logZ among them, as the backward's contract takes them)
    jg, jalphas, jskip, jvalid, jfinal = _tpu_padded(
        n, s_len, [g, alphas], [skip, valid, final])
    n_pad = jg.shape[0]
    jlogz = jnp.pad(jnp.asarray(logz.numpy()), (0, n_pad - n),
                    constant_values=NEG)[:, None]
    jlens = jnp.pad(jnp.asarray(logit_lens), (0, n_pad - n),
                    constant_values=1)[:, None]
    jgrad = ctc_pallas._run_backward(jg, jskip, jvalid, jfinal, jalphas,
                                     jlogz, jlens)
    np.testing.assert_allclose(got, np.asarray(jgrad)[:n, :, :s_len],
                               rtol=1e-5, atol=1e-5)


# the forward also at T = 1 (no step after the first row) and at T a whole
# number of chunks (16, 32)
FWD_CASES = CASES + [(3, 1, 5), (10, 16, 4), (20, 32, 6)]


@pytest.mark.parametrize('l_max,t_len,n', FWD_CASES)
def test_warp_forward_matches_plain_and_tpu_forward(l_max, t_len, n):
    g, skip, valid, final, _ = _inputs(l_max, t_len, n)
    s_len = 2 * l_max + 1
    want_z, want_a = ctc.ctc_forward_reference(g, skip, valid, final)
    got_z, got_a = _warp_forward(*(x.numpy() for x in (g, skip, valid,
                                                         final)))
    assert not np.isnan(got_a).any() and not np.isnan(got_z).any()
    np.testing.assert_allclose(got_a, want_a.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_z, want_z.numpy(), rtol=1e-5, atol=1e-5)
    assert np.isfinite(got_a).all() and -1e30 < got_z[1] < 0   # empty label
    if l_max > 1:
        assert got_z[2] <= ctc.NEG_INF / 2                       # infeasible

    # the TPU forward kernel on the same inputs
    jz, ja = ctc_pallas._run_forward(*_tpu_padded(
        n, s_len, [g], [skip, valid, final]))
    np.testing.assert_allclose(got_a, np.asarray(ja)[:n, :, :s_len],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_z, np.asarray(jz)[:n, 0], rtol=1e-5,
                               atol=1e-5)


def test_lanes_hold_consecutive_states_and_neighbours():
    """With K states a lane, lane l's neighbours s+1 and s+2 of each of its
    states are the next states in order, from its own registers or the next
    lane's, and NEG past the warp: the shift of the state row by one and by
    two."""
    for k_per in (1, 2):
        beta = np.arange(32 * k_per, dtype=np.float32).reshape(32, k_per)
        nx = _shift_lanes(beta, 1)
        if k_per == 1:
            one, two = nx, _shift_lanes(beta, 2)
        else:
            one = np.stack([beta[:, 1], nx[:, 0]], axis=1)
            two = np.stack([nx[:, 0], nx[:, 1]], axis=1)
        row = np.concatenate([beta.reshape(-1), [NEG, NEG]])
        states = np.arange(32 * k_per).reshape(32, k_per)
        np.testing.assert_array_equal(one, row[states + 1])
        np.testing.assert_array_equal(two, row[states + 2])


def test_lanes_hold_consecutive_states_and_previous_neighbours():
    """The forward's view of the same layout: lane l's neighbours s-1 and
    s-2 of each of its states are the previous states in order, from its
    own registers or the previous lane's, and NEG below lane 0: the shift
    of the state row by one and by two the other way."""
    for k_per in (1, 2):
        alpha = np.arange(32 * k_per, dtype=np.float32).reshape(32, k_per)
        one, two = _neighbours_below(alpha)
        row = np.concatenate([[NEG, NEG], alpha.reshape(-1)])
        states = np.arange(32 * k_per).reshape(32, k_per)
        np.testing.assert_array_equal(one, row[states + 1])
        np.testing.assert_array_equal(two, row[states])
