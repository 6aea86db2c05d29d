"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so it runs on the GPU machine without the repo's conftest::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: f32 max |difference| <= 1e-4 (the kernel and the plain version
sum the recurrent product in different orders); bf16 <= 4 bf16 ulps of each
output's magnitude, 4 * max|ref| / 256, as tests/test_rnn_pallas.py
defines it.
"""

import numpy as np
import pytest
import torch

from lstm_ctc_ocr_torch.ops import rnn, rnn_cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernel has no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _atol(ref, dtype):
    if dtype == torch.float32:
        return 1e-4
    return 4 * max(float(ref.abs().max()), 1.0) / 256.0


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('t,n', [(23, 64), (7, 37)])
def test_bilstm_kernel_matches_reference(cuda_device, dtype, t, n):
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(t * n)
    h = 256

    def mk(*shape, scale=1.0):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                * scale).to(cuda_device, dt)
    lens = rng.randint(0, t + 1, n).astype(np.int32)
    lens[0] = 0
    args = (mk(t, n, 4 * h), mk(t, n, 4 * h), mk(h, 4 * h, scale=h ** -0.5),
            mk(h, 4 * h, scale=h ** -0.5), mk(4 * h, scale=0.1),
            mk(4 * h, scale=0.1), torch.from_numpy(lens).to(cuda_device))
    for residuals in (False, True):
        before = rnn_cuda.bilstm_fwd.launches
        got = rnn_cuda.bilstm_fwd(*args, save_residuals=residuals)
        assert rnn_cuda.bilstm_fwd.launches == before + 1
        want = rnn_cuda.bilstm_fwd_reference(*args, save_residuals=residuals)
        torch.cuda.synchronize()
        assert len(got) == len(want) == (8 if residuals else 2)
        for g, w in zip(got, want):
            assert g.dtype == dt and g.shape == w.shape
            w = w.float()
            assert float((g.float() - w).abs().max()) <= _atol(w, dt)


def test_bilstm_dispatch_launches_kernel(cuda_device):
    """``ops/rnn.bilstm`` on CUDA tensors goes through the kernel once and
    agrees with the same call on CPU tensors (the plain version) in f32."""
    g = torch.Generator().manual_seed(0)
    d, h, n, t = 32, 16, 5, 9
    cells = {k: {'w': torch.randn(d, 4 * h, generator=g) * 0.3,
                 'u': torch.randn(h, 4 * h, generator=g) * 0.3,
                 'bias': torch.randn(4 * h, generator=g) * 0.1}
             for k in ('fw', 'bw')}
    x = torch.randn(n, t, d, generator=g)
    lens = torch.tensor([9, 0, 4, 1, 7], dtype=torch.int32)
    want = rnn.bilstm(cells, x, lens)
    before = rnn_cuda.bilstm_fwd.launches
    got = rnn.bilstm({k: {p: v.to(cuda_device) for p, v in c.items()}
                      for k, c in cells.items()},
                     x.to(cuda_device), lens.to(cuda_device))
    assert rnn_cuda.bilstm_fwd.launches == before + 1
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)


def test_bilstm_kernel_rejects_bad_inputs(cuda_device):
    x = torch.zeros(3, 2, 4 * 512, device=cuda_device)
    u = torch.zeros(512, 4 * 512, device=cuda_device)
    b = torch.zeros(4 * 512, device=cuda_device)
    lens = torch.ones(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match='hidden size'):
        rnn_cuda.bilstm_fwd(x, x, u, u, b, b, lens)
    with pytest.raises(ValueError, match='lens'):
        rnn_cuda.bilstm_fwd(x[..., :1024], x[..., :1024], u[:256, :1024],
                            u[:256, :1024], b[:1024], b[:1024], lens.long())
