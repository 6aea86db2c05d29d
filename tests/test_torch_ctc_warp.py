"""The CTC backward's warp path (``csrc/ctc.cu:ctc_bwd_warp_kernel``), for
S <= 64, without a card: the CUDA code cannot run here, so its structure
is transcribed below in numpy -- one warp (and block) per example, lane l
holding the K consecutive states l K .. l K + K - 1 (K = 1 up to
S = 32, 2 up to 64), the s+1 / s+2 neighbours from the lane's own
registers or from the next lanes (``__shfl_down_sync``, NEG past the
warp), and the two-stage ring of kChunk time steps that stages g and alphas
one chunk ahead -- and held to the plain version ``ctc_backward_reference``
(which the kernel is held to on the card) and to the JAX package's TPU
kernel ``ctc_pallas._run_backward`` (in interpret mode off the TPU, as
``tests/test_torch_ctc.py`` runs it). Tolerance 1e-5 absolute and relative,
f32, the repo's standing CTC bar; every batch is ragged, with an
infeasible example and a one-frame example.
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
    out = ms + np.log(np.exp(a - ms) + np.exp(b - ms) + np.exp(c - ms))
    return np.where(m > np.float32(0.5) * NEG, out, NEG).astype(np.float32)


def _shift_lanes(x, by):
    """``__shfl_down_sync(x, by)`` over the warp's 32 lanes, NEG where the
    source lane is past the warp. x: [32, ...]."""
    out = np.full_like(x, NEG)
    out[:32 - by] = x[by:]
    return out


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


@pytest.mark.parametrize('l_max,t_len,n', CASES)
def test_warp_path_matches_plain_and_tpu_backward(l_max, t_len, n):
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
    # and logZ among them, as the backward's contract takes them), padded as
    # ctc_pallas._pad_args pads them: N to a multiple of 8 rows, S to 128
    # lanes of NEG
    n_pad = -(-n // ctc_pallas.TILE_N) * ctc_pallas.TILE_N
    rows, lanes = (0, n_pad - n), (0, ctc_pallas.LANES - s_len)
    jg = jnp.pad(jnp.asarray(g.numpy()), (rows, (0, 0), lanes),
                 constant_values=NEG)
    jskip, jvalid, jfinal = (jnp.pad(jnp.asarray(m.numpy()), (rows, lanes),
                                     constant_values=NEG)
                             for m in (skip, valid, final))
    jalphas = jnp.pad(jnp.asarray(alphas.numpy()), (rows, (0, 0), lanes),
                      constant_values=NEG)
    jlogz = jnp.pad(jnp.asarray(logz.numpy()), rows,
                    constant_values=NEG)[:, None]
    jlens = jnp.pad(jnp.asarray(logit_lens), rows,
                    constant_values=1)[:, None]
    jgrad = ctc_pallas._run_backward(jg, jskip, jvalid, jfinal, jalphas,
                                     jlogz, jlens)
    np.testing.assert_allclose(got, np.asarray(jgrad)[:n, :, :s_len],
                               rtol=1e-5, atol=1e-5)


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
