"""The beam search's custom op and its CUDA kernel (``csrc/beam.cu``).

On the CPU: the op ``lstm_ctc_ocr_torch::beam_decode`` returns
``ops/beam.py:beam_decode_reference``'s ids (the grid of
tests/test_torch_beam.py), its fake gives the shape and dtype, the counter
``beam.kernel_frames`` moves only on the CUDA route, and the wrapper
raises past each of the kernel's limits, naming it.

On the card (skipped without one): the kernel's ids equal the plain
version's, entry for entry, over K in {1, 2, 16}, C in {2, 12, 64}, T in
{1, 23, 111, 191, 1209}, ragged lengths with 0 and T, logits at scales 1
and 10, both ``merge_repeated`` settings, f32 and bf16 logits and N in {1,
64, 300}; at the longline cell's shapes (T = 79, 95, 111) the same, and
two calls give the same bits; the wrapper's shared-memory total
equals the built kernel's; and the 200 ``data/val_longline``
lines through the tracked longline release decode to the plain version's
strings. The file imports no JAX, so it runs on the GPU machine::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_beam_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from lstm_ctc_ocr_torch.ops import beam, beam_cuda, custom_ops
from lstm_ctc_ocr_torch.utils import profiler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernel has no CPU mode')
    return torch.device('cuda')


def _logits(n, t, c, seed, scales=(1.0,)):
    """[N, T, C] f32 logits, row r at ``scales[r % len(scales)]``, and
    ragged [N] int32 lengths with T first and 0 second."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, t, c).astype(np.float32)
    x *= np.array([scales[r % len(scales)] for r in range(n)],
                  np.float32)[:, None, None]
    lens = rng.randint(0, t + 1, n).astype(np.int32)
    lens[0] = t
    if n > 1:
        lens[1] = 0
    return torch.from_numpy(x), torch.from_numpy(lens)


# --- on the CPU --------------------------------------------------------------

@pytest.mark.parametrize('merge_repeated', [False, True])
@pytest.mark.parametrize('c,k,scale', [(64, 16, 1.0), (12, 16, 1.0),
                                       (64, 1, 2.0), (12, 1, 0.5),
                                       (64, 16, 4.0), (5, 4, 0.5)])
def test_op_cpu_is_the_plain_version(c, k, scale, merge_repeated):
    logits, lens = _logits(8, 21, c, c * k, (scale,))
    got = custom_ops.beam_decode(logits, lens, k, 0, merge_repeated)
    want = beam.beam_decode_reference(logits, lens, k, 0, merge_repeated)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(beam.beam_decode(logits, lens, beam_width=k,
                                        merge_repeated=merge_repeated), want)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_fake_gives_shape_and_dtype(dtype):
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        out = custom_ops.beam_decode(torch.empty(5, 7, 12, dtype=dtype),
                                     torch.empty(5, dtype=torch.int32), 16,
                                     0, False)
    assert tuple(out.shape) == (5, 7) and out.dtype == torch.int32


def test_op_passes_opcheck():
    logits, lens = _logits(3, 6, 5, 0)
    torch.library.opcheck(custom_ops.beam_decode, (logits, lens, 4, 0, True))


def _counted(fn):
    before = profiler.counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    return out, {k: v - before.get(k, 0)
                 for k, v in profiler.counters().items()
                 if v != before.get(k)}


def test_kernel_frames_counted_on_the_cuda_route_only(monkeypatch):
    logits, lens = _logits(4, 9, 6, 1)
    want = beam.beam_decode_reference(logits, lens, 4)
    got, counts = _counted(lambda: beam.beam_decode(logits, lens,
                                                    beam_width=4))
    assert torch.equal(got, want) and counts == {}
    # the op's CUDA implementation, its kernel replaced by the plain search
    monkeypatch.setattr(beam_cuda, 'beam_decode',
                        beam.beam_decode_reference)
    got, counts = _counted(lambda: custom_ops._beam_decode_cuda(
        logits, lens, 4, 0, False))
    assert torch.equal(got, want) and counts == {'beam.kernel_frames': 9}
    _, counts = _counted(lambda: None)
    assert counts == {}


@pytest.mark.parametrize('shape,k,limit', [
    ((1, 1, 1025), 16, 'MAX_CLASSES'),
    ((1, 3, 8), 257, 'MAX_BEAM_WIDTH'),
    ((1, 3, 300), 64, 'MAX_CANDIDATES'),
    ((1, 4097, 2), 16, 'MAX_NODES'),
    ((1, 4000, 2), 16, 'MAX_SHARED_BYTES'),
])
def test_wrapper_names_the_limit(shape, k, limit):
    logits = torch.zeros(shape)
    lens = torch.zeros(shape[0], dtype=torch.int32)
    with pytest.raises(ValueError, match=limit):
        beam_cuda.beam_decode(logits, lens, k)


def test_longline_shapes_fit():
    """Every configuration's widest bucket fits: C 12-64, K 16, T up to
    191 (longline's 768), and the L=600 row's T = 1,209."""
    for t in (191, 1209):
        for c in (12, 64):
            beam_cuda.check_limits(t, 16, c)
    assert beam_cuda.shared_bytes(1209, 16, 64) < 100_000


def test_wrapper_takes_only_cuda_tensors():
    logits, lens = _logits(2, 5, 4, 0)
    with pytest.raises(ValueError, match='CUDA'):
        beam_cuda.beam_decode(logits, lens, 4)


# --- on the card -------------------------------------------------------------

def _case(k, c, t):
    """Which of the grid's settings a (K, C, T) case takes: every pair of
    dtype and merge setting, N cycling through 1, 64, 300."""
    i = (k * 7 + c * 3 + t) % 3
    flip = (k + c + t) % 2
    return ([(torch.float32, bool(flip)), (torch.bfloat16, not flip)],
            (1, 64, 300)[i])


@pytest.mark.parametrize('t', [1, 23, 111, 191, 1209])
@pytest.mark.parametrize('c', [2, 12, 64])
@pytest.mark.parametrize('k', [1, 2, 16])
def test_kernel_ids_equal_the_plain_version(cuda_device, k, c, t):
    settings, n = _case(k, c, t)
    for dtype, merge in settings:
        logits, lens = _logits(n, t, c, k * 1000 + c * 10 + t, (1.0, 10.0))
        logits = logits.to(cuda_device, dtype)
        lens = lens.to(cuda_device)
        before = beam_cuda.beam_decode.launches
        got = beam.beam_decode(logits, lens, beam_width=k,
                               merge_repeated=merge)
        assert beam_cuda.beam_decode.launches == before + 1
        want = beam.beam_decode_reference(logits, lens, k, 0, merge)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and got.shape == (n, t)
        bad = (got != want).any(dim=1).nonzero().flatten().tolist()
        assert not bad, (dtype, merge, bad[:8])


def test_shared_bytes_equal_the_kernels_layout(cuda_device):
    """The wrapper's copy of the shared-memory layout and the built
    kernel's agree over the limits' range."""
    for t in (1, 23, 111, 191, 1209, 4000):
        for k in (1, 2, 16, 64, 256):
            for c in (2, 12, 64, 1024):
                assert beam_cuda.shared_bytes(t, k, c) == \
                    beam_cuda.kernel_shared_bytes(t, k, c), (t, k, c)


@pytest.mark.parametrize('t,dtype,merge', [
    (79, 'float32', False), (79, 'bfloat16', False), (95, 'float32', False),
    (95, 'bfloat16', False), (111, 'float32', False),
    (111, 'bfloat16', False), (111, 'float32', True)])
def test_kernel_is_deterministic_and_takes_strided_logits(cuda_device, t,
                                                          dtype, merge):
    """At the crnn_longline.eval_beam cell's shapes (N = 64, K = 16, C = 64,
    T = 79, 95 and 111, its buckets' frames): the ids equal the plain
    search's, and a second call and time-major logits give the same bits,
    one launch a call."""
    logits, lens = _logits(64, t, 64, 5, (1.0, 10.0))
    logits = logits.to(cuda_device, getattr(torch, dtype))
    lens = lens.to(cuda_device)
    before = beam_cuda.beam_decode.launches
    a = beam.beam_decode(logits, lens, merge_repeated=merge)
    b = beam.beam_decode(logits, lens, merge_repeated=merge)
    # time-major storage, as the model hands logits over
    strided = logits.transpose(0, 1).contiguous().transpose(0, 1)
    c = beam.beam_decode(strided, lens, merge_repeated=merge)
    assert beam_cuda.beam_decode.launches == before + 3
    want = beam.beam_decode_reference(logits, lens, 16, 0, merge)
    torch.cuda.synchronize()
    assert torch.equal(a, want)
    assert torch.equal(a, b) and torch.equal(a, c)


def test_longline_val_strings_equal_the_plain_version(cuda_device,
                                                      monkeypatch):
    from lstm_ctc_ocr_torch.config import load_cfg
    from lstm_ctc_ocr_torch.engine import test as port_test
    cfg = load_cfg(os.path.join(REPO, 'lstm', 'longline.yml'),
                   ['TEST.BATCH_SIZE', '64'])
    assert str(cfg.DECODER) == 'beam' and int(cfg.BEAM_WIDTH) == 16

    def run():
        return port_test.test_net(
            cfg, os.path.join(REPO, 'data', 'val_longline'),
            os.path.join(REPO, 'checkpoints', cfg.EXP_DIR), device='cuda',
            echo=lambda s: None)
    before = beam_cuda.beam_decode.launches
    got = run()
    assert beam_cuda.beam_decode.launches - before == got.decode_calls
    monkeypatch.setattr(port_test, 'beam_decode', beam.beam_decode_reference)
    want = run()
    assert got.total == want.total == 200
    assert got.predictions == want.predictions
