"""The port's fused conv3x3+BN+ReLU against the JAX package's.

``conv_bn_cuda.conv3x3_bn_relu_reference`` — the plain version the CUDA
kernel ``csrc/conv_bn.cu`` is held to on the card (tests/test_torch_cuda.py)
— is compared with the TPU kernel ``conv_bn_pallas.conv3x3_bn_relu`` (in
Pallas interpret mode off the TPU, as tests/test_conv_bn_pallas.py runs it)
and with both packages' unfused conv layer, on that test's three shapes in
f32 (2e-5 absolute and relative) and its bf16 case (2e-2). The port's
layout is [N, C, W, H] with kernels [C_out, C_in, 3, 3]; the JAX package's
is [N, W, H, C] with kernels [3, 3, C_in, C_out].
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lstm_ctc_ocr_tpu.models.layers import conv_single_apply
from lstm_ctc_ocr_tpu.ops.conv_bn_pallas import conv3x3_bn_relu as jfused
from lstm_ctc_ocr_torch.models.layers import ConvSingle
from lstm_ctc_ocr_torch.ops import conv_bn_cuda
from lstm_ctc_ocr_torch.tools import bench_conv_bn


def _case(seed, shape, co, plain_affine=False):
    """JAX-layout inputs, as tests/test_conv_bn_pallas.py draws them."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    params = {
        'kernel': rng.randn(3, 3, shape[-1], co).astype(np.float32) * 0.1,
        'biases': rng.randn(co).astype(np.float32) * 0.1,
        'bn_gamma': 1.0 + 0.1 * rng.randn(co).astype(np.float32),
        'bn_beta': 0.1 * rng.randn(co).astype(np.float32)}
    if plain_affine:
        params['bn_gamma'] = np.ones(co, np.float32)
        params['bn_beta'] = np.zeros(co, np.float32)
    return x, params


def _jax_outputs(x, params, dtype):
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    xj = jnp.asarray(x) if dtype is None else jnp.asarray(x, dtype)
    fused = jfused(xj, jp['kernel'], jp['biases'], jp['bn_gamma'],
                   jp['bn_beta'])
    unfused = conv_single_apply(jp, jnp.asarray(x), {'dtype': dtype}, 3, 3,
                                params['kernel'].shape[-1], 1, 1, bn=True,
                                biased=True, relu=True, padding='SAME')
    return (np.asarray(fused).astype(np.float32),
            np.asarray(unfused).astype(np.float32))


def _port_outputs(x, params, dtype):
    """The port's plain fused version, its dispatch and its unfused layer,
    each moved back to the JAX layout [N, W, H, C]."""
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)            # [N, C, W, H]
    kernel = torch.from_numpy(params['kernel']).permute(3, 2, 0, 1)
    args = (xt if dtype is None else xt.to(dtype), kernel,
            torch.from_numpy(params['biases']),
            torch.from_numpy(params['bn_gamma']),
            torch.from_numpy(params['bn_beta']))
    before = conv_bn_cuda.conv3x3_bn_relu.launches
    plain = conv_bn_cuda.conv3x3_bn_relu_reference(*args)
    dispatched = conv_bn_cuda.conv3x3_bn_relu(*args)
    assert conv_bn_cuda.conv3x3_bn_relu.launches == before   # CPU: no launch
    assert torch.equal(plain, dispatched)
    assert plain.dtype == args[0].dtype
    co, ci = kernel.shape[:2]
    layer = ConvSingle(ci, co, 3, bn=True)
    layer.load_state_dict({'kernel': kernel, 'biases': args[2],
                           'bn_gamma': args[3], 'bn_beta': args[4]},
                          strict=False)
    with torch.no_grad():
        unfused = layer(xt, dtype)
    return tuple(t.float().permute(0, 2, 3, 1).numpy()
                 for t in (plain, unfused))


@pytest.mark.parametrize('shape,co', [
    ((16, 24, 4, 32), 48),    # conv4_1-like geometry, small channels
    ((8, 12, 2, 64), 64),     # conv4_2-after-pool H=2 geometry
    ((6, 10, 4, 16), 32),     # n not a multiple of the TPU kernel's tile
])
def test_reference_matches_tpu_kernel_and_unfused_layers_f32(shape, co):
    x, params = _case(0, shape, co)
    jax_fused, jax_unfused = _jax_outputs(x, params, None)
    plain, unfused = _port_outputs(x, params, None)
    assert plain.shape == jax_fused.shape == shape[:3] + (co,)
    for want in (jax_fused, jax_unfused, unfused):
        np.testing.assert_allclose(plain, want, rtol=2e-5, atol=2e-5)


def test_reference_matches_tpu_kernel_and_unfused_layers_bf16():
    x, params = _case(1, (16, 24, 4, 32), 48, plain_affine=True)
    jax_fused, jax_unfused = _jax_outputs(x, params, jnp.bfloat16)
    plain, unfused = _port_outputs(x, params, torch.bfloat16)
    # bf16 activations: stats/normalize agree to bf16 resolution
    for want in (jax_fused, jax_unfused, unfused):
        np.testing.assert_allclose(plain, want, rtol=2e-2, atol=2e-2)


def test_bench_tool_runs_on_the_cpu(capsys):
    """``tools/bench_conv_bn`` off the card: both implementations agree, no
    time is printed under a device metric's name, and the default device
    raises without CUDA."""
    rows = bench_conv_bn.run('tiny', 2, 6, 4, 16, 32, torch.float32, 'cpu')
    assert [r['impl'] for r in rows] == ['unfused', 'fused']
    assert all(r['ms'] is None and r['device'] == 'cpu' for r in rows)
    assert rows[1]['rel_err_vs_unfused'] < 2e-5
    assert rows[1]['max_abs_err_vs_plain'] == 0.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            bench_conv_bn.main(['--batch', '1'])
