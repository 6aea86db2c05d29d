"""The handwriting model's stacked BiLSTM head on the card's kernels 1 and 2
(``csrc/bilstm_fwd.cu``, ``csrc/bilstm_bwd.cu``) at the published widths:
batch 16, T = 224 (a 1,792 px line at height 128), five layers of 2 x 256
units, the first reading 1,280 features, forget bias 0.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor the JAX package, so on the card it runs alone::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_htr_cuda.py

The reference is the plain scan of ``benchmark/reference/htr.py`` in f32
with TF32 off, computed in blocks of one layer: each layer of the port is
fed the input the port's layer before produced and compared with the
reference layer on that input, forward and, with the same output gradient,
backward (the input's gradient, which the layer below's backward takes, and
the layer's own weights'). So each comparison holds one layer's kernels,
and an error does not compound through the stack. A test runs the whole
head against the reference stack, and a last one holds kernels 1 and 2 on
two layers chained against their plain versions (``ops/rnn_cuda.py``).

Tolerances, each with its reason:

* f32 (the wide recurrence): the kernels sum the same f32 products in
  another order over 224 steps, so outputs and gradients (summed over 224
  steps and 16 rows) hold to ``F32_RTOL`` of their norm;
* bf16 (the cluster recurrence on tensor cores): inputs, weights and each
  step's h are rounded to 8 bits of mantissa (2^-8 relative), so they hold
  to ``BF16_RTOL`` of their norm; the bf16 results must *fail* the f32
  tolerance, which shows that it is tight enough to see a cast to bf16.

Norms, not elements: a layer's outputs run from ~1e-3 to ~0.1, so an
absolute bound tight enough for the small ones would be loose for the large
(a bf16 layer's largest element gap, 1.3e-4, fell inside an f32 bound of
2e-4 set that way).
"""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from benchmark.reference import htr as ref_htr  # noqa: E402
from lstm_ctc_ocr_torch.models import layers  # noqa: E402
from lstm_ctc_ocr_torch.ops import rnn, rnn_cuda  # noqa: E402

N, T, LAYERS, NUM_HID, FEATURES = 16, 224, 5, 512, 1280
F32_RTOL, BF16_RTOL = 1e-4, 0.05


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernel has no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _setup(dev):
    params = ref_htr.make_params(5, dev, num_hid=NUM_HID, num_layers=LAYERS)
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(T, N, FEATURES, generator=g, device=dev)
    lens = np.linspace(137, T, N).astype(np.int32)
    lens[3] = T
    return params, x, torch.from_numpy(lens).to(dev)


def _cells(params, i, dtype):
    """Layer ``i``'s f32 leaves (requiring grad) and the cells the port's
    layer takes, cast to ``dtype``."""
    leaves = {d: {k: params['logits.layers.{}.cells.{}.{}'.format(i, d, k)]
                  .clone().requires_grad_(True) for k in ('w', 'u', 'bias')}
              for d in ('fw', 'bw')}
    cells = {d: {k: v.to(dtype) for k, v in c.items()}
             for d, c in leaves.items()}
    return leaves, cells


def _norm_gap(a, b):
    return float((a.float() - b).norm() / b.norm())


def _layer_gaps(params, i, x_tm, lens, dtype):
    """Layer ``i`` of the port in ``dtype`` and of the reference in f32 on
    the same input: ``(output gap, [gradient gaps], port output)``."""
    leaves, cells = _cells(params, i, dtype)
    xin = x_tm.detach().clone().requires_grad_(True)
    out = rnn.bilstm_tm(cells, xin.to(dtype), lens, 0.0)
    dout = torch.randn(out.shape, device=out.device,
                       generator=torch.Generator(device=out.device)
                       .manual_seed(i))
    out.float().backward(dout)
    ref_leaves, _ = _cells(params, i, torch.float32)
    p = {'logits.layers.{}.cells.{}.{}'.format(i, d, k): v
         for d, c in ref_leaves.items() for k, v in c.items()}
    ref_x = x_tm.detach().clone().requires_grad_(True)
    ref = ref_htr.bilstm_layer(p, i, ref_x, lens, lambda t: t)
    ref.backward(dout)
    torch.cuda.synchronize()
    out_gap = _norm_gap(out.detach(), ref.detach())
    grads = [_norm_gap(xin.grad, ref_x.grad)] + [
        _norm_gap(leaves[d][k].grad, ref_leaves[d][k].grad)
        for d in ('fw', 'bw') for k in ('w', 'u', 'bias')]
    return out_gap, grads, out.detach().float()


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_each_layer_of_the_stack_matches_the_reference(cuda_device, dtype):
    dt = getattr(torch, dtype)
    params, x, lens = _setup(cuda_device)
    fwd, bwd = rnn_cuda.bilstm_fwd.launches, rnn_cuda.bilstm_bwd.launches
    x_tm = x
    for i in range(LAYERS):
        out_gap, grads, x_tm = _layer_gaps(params, i, x_tm, lens, dt)
        assert x_tm.shape == (T, N, NUM_HID)
        past = torch.arange(T, device=cuda_device)[:, None] >= lens[None, :]
        assert float(x_tm[past].abs().max()) == 0.0
        print('layer', i, dtype, 'output gap', out_gap, 'gradient gaps',
              grads)
        if dt == torch.float32:
            assert max([out_gap] + grads) <= F32_RTOL, (i, out_gap, grads)
        else:
            assert max([out_gap] + grads) <= BF16_RTOL, (i, out_gap, grads)
            # a bf16 layer is outside the f32 tolerance, output and
            # every gradient
            assert min([out_gap] + grads) > F32_RTOL, (i, out_gap, grads)
    assert rnn_cuda.bilstm_fwd.launches == fwd + LAYERS
    assert rnn_cuda.bilstm_bwd.launches == bwd + LAYERS


def test_the_head_matches_the_reference_stack(cuda_device):
    """The whole head (``layers.StackedBiLSTM``) in f32, eval mode, against
    the reference's five layers and projection; its input's and first
    layer's gradients after the backward through all five."""
    params, x, lens = _setup(cuda_device)
    head = layers.StackedBiLSTM(FEATURES, NUM_HID, LAYERS, 80,
                                forget_bias=0.0, keep_prob=0.5)
    head.load_state_dict({k[len('logits.'):]: v for k, v in params.items()
                          if k.startswith('logits.')})
    head = head.to(cuda_device).eval()
    xb = x.transpose(0, 1).detach().clone().requires_grad_(True)
    out = head(xb, lens)
    dout = torch.randn(out.shape, device=cuda_device,
                       generator=torch.Generator(device=cuda_device)
                       .manual_seed(11))
    out.backward(dout)
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()
         if k.startswith('logits.')}
    ref_x = x.detach().clone().requires_grad_(True)
    h = ref_x
    for i in range(LAYERS):
        h = ref_htr.bilstm_layer(p, i, h, lens, lambda t: t)
    ref = h @ p['logits.weights'] + p['logits.biases']
    ref.backward(dout)
    torch.cuda.synchronize()
    # five f32 layers, each within F32_RTOL, one after another: the
    # logits and the gradients at the bottom hold to five times that
    gaps = [_norm_gap(out.detach(), ref.detach()),
            _norm_gap(xb.grad.transpose(0, 1), ref_x.grad),
            _norm_gap(head.layers[0]['cells']['fw'].w.grad,
                      p['logits.layers.0.cells.fw.w'].grad)]
    print('head gaps: logits, input gradient, layer 0 w', gaps)
    assert max(gaps) <= 5 * F32_RTOL, gaps


def _two_layers(fwd, bwd, first, top, lens, dout):
    """Two BiLSTM layers chained as the head chains them, through ``fwd`` and
    ``bwd`` (kernels 1 and 2 or their plain versions), forget bias 0: layer
    1 on the projections and weights ``first``, layer 2 on its outputs
    through ``top``'s W; layer 2's backward from ``dout``, its input
    gradient split by direction into layer 1's backward. Returns layer 2's
    outputs, layer 1's backward inputs and layer 1's gradients."""
    t, n, four_h = first[0].shape
    h = four_h // 4
    r1 = fwd(*first, lens, 0.0, save_residuals=True)
    x2 = torch.cat([r1[0], r1[4]], dim=-1).reshape(t * n, 2 * h)
    xp2 = (x2 @ top['w']).reshape(t, n, 2 * four_h)
    r2 = fwd(xp2[:, :, :four_h], xp2[:, :, four_h:], *top['cells'], lens,
             0.0, save_residuals=True)
    g2 = bwd(*dout, *r2[1:4], *r2[5:8], *top['cells'][:2], lens)
    dx2 = (g2[0].reshape(t * n, four_h) @ top['w'][:, :four_h].t()
           + g2[1].reshape(t * n, four_h) @ top['w'][:, four_h:].t()
           ).reshape(t, n, 2 * h)
    back = (dx2[:, :, :h].contiguous(), dx2[:, :, h:].contiguous(),
            *r1[1:4], *r1[5:8], *first[2:4], lens)
    return (r2[0], r2[4]), back, bwd(*back)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_two_layers_chained_match_the_plain_kernels(cuda_device, dtype):
    """Kernels 1 and 2 on two layers chained at the cell's widths (layer 1
    reading 1,280 features, each line its own 137-222 frames of T): layer
    1's backward, fed layer 2's input gradient, holds the one-layer bar of
    tests/test_torch_cuda.py against the plain backward on the same inputs
    (1e-4 in f32, 4 bf16 ulps in bf16, of each output's largest entry), and
    the chain's layer-2 outputs and layer-1 gradients hold twice it against
    the plain versions chained; each kernel call and each chain gives the
    same bits twice, and the kernels launch exactly as called."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(24)
    h = NUM_HID // 2

    def rnd(*shape, scale):
        return (torch.randn(*shape, generator=gen, device=cuda_device)
                * scale).to(dt)

    def direction_weights():          # U and b of both directions
        return (rnd(h, 4 * h, scale=h ** -0.5), rnd(h, 4 * h, scale=h ** -0.5),
                rnd(4 * h, scale=0.1), rnd(4 * h, scale=0.1))
    xp = (rnd(T * N, FEATURES, scale=0.5)
          @ rnd(FEATURES, 8 * h, scale=FEATURES ** -0.5)).reshape(T, N, 8 * h)
    first = (xp[:, :, :4 * h], xp[:, :, 4 * h:]) + direction_weights()
    top = {'w': rnd(2 * h, 8 * h, scale=(2 * h) ** -0.5),
           'cells': direction_weights()}
    lens = torch.from_numpy(np.linspace(137, 222, N).astype(np.int32)) \
        .to(cuda_device)
    dout = (rnd(T, N, h, scale=0.1), rnd(T, N, h, scale=0.1))
    fwd0, bwd0 = rnn_cuda.bilstm_fwd.launches, rnn_cuda.bilstm_bwd.launches
    got = _two_layers(rnn_cuda.bilstm_fwd, rnn_cuda.bilstm_bwd, first, top,
                      lens, dout)
    again = _two_layers(rnn_cuda.bilstm_fwd, rnn_cuda.bilstm_bwd, first, top,
                        lens, dout)
    block = rnn_cuda.bilstm_bwd(*got[1])
    block_again = rnn_cuda.bilstm_bwd(*got[1])
    assert rnn_cuda.bilstm_fwd.launches == fwd0 + 4
    assert rnn_cuda.bilstm_bwd.launches == bwd0 + 6
    block_want = rnn_cuda.bilstm_bwd_reference(*got[1])
    want = _two_layers(rnn_cuda.bilstm_fwd_reference,
                       rnn_cuda.bilstm_bwd_reference, first, top, lens, dout)
    torch.cuda.synchronize()
    bar = 1e-4 if dt == torch.float32 else 4 / 256
    for layers, outs, twice, refs in (
            (1, block, block_again, block_want),
            (2, got[0] + got[2], again[0] + again[2], want[0] + want[2])):
        for i, (g, a, w) in enumerate(zip(outs, twice, refs)):
            assert torch.equal(g, a), (layers, i)
            w = w.float()
            gap = float((g.float() - w).abs().max())
            assert gap <= layers * bar * (float(w.abs().max()) or 1.0), \
                (layers, i, gap)
