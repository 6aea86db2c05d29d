"""The port's legacy DSL vocabulary (``models/layers_legacy.py`` through
``models/network.py``) against the JAX package's, layer by layer.

Each case is one short chain built by both packages' ``Network`` at a
small shape, with the JAX parameters (seeded, perturbed) loaded into the
port through the weight bridge (``tests/torch_dsl_cases.py``). Outputs in
the JAX layout, and the gradients of a seeded weighted sum of them with
respect to every parameter and the input, agree within 1e-5, absolute or
relative to each tensor's largest entry past 1 (f32; the two sides' convs
sum in another order, and four inception stacks add up to outputs of
~20). Then: the
shape checks raise as in JAX, ``smooth_l1_dist`` is the JAX formula, the
composite blocks' L2 entries are the JAX ``reg_paths``, and the frozen
batch-norm statistics stay frozen through every solver and are written
under ``params/`` in snapshots.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lstm_ctc_ocr_tpu.models import layers_legacy as JLL
from lstm_ctc_ocr_torch.config import load_cfg
from lstm_ctc_ocr_torch.engine import checkpoint, train
from lstm_ctc_ocr_torch.models import layers_legacy as LL

from torch_dsl_cases import JaxCfg, JChain, PChain, compare_chain


def _one(method, *args, **kwargs):
    kwargs.setdefault('name', 'out')
    return [(('data',), method, args, kwargs)]


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


S4 = (2, 7, 6, 4)          # odd and even spatial sizes: TF SAME is asymmetric

CASES = {
    'relu': (_one('relu'), S4),
    'conv_3x3': (_one('conv', 3, 3, 5, 1, 1), S4),
    'conv_4x2_stride2': (_one('conv', 4, 2, 5, 2, 2, relu=False), S4),
    'conv_valid_no_bias': (_one('conv', 2, 3, 5, 1, 2, biased=False,
                                padding='VALID'), S4),
    'conv_declared_c_i': (_one('conv', 1, 1, 3, 1, 1, c_i=4), S4),
    'conv_zero': (_one('conv_zero', 3, 3, 5, 1, 1, relu=False), S4),
    'conv_norm_bn': (_one('conv_norm', 3, 3, 6, 1, 1), S4),
    'conv_norm_crelu': (_one('conv_norm', 3, 3, 6, 1, 1, biased=False), S4),
    'conv_norm_plain': (_one('conv_norm', 3, 3, 6, 2, 2, relu=False), S4),
    'conv_final': (_one('conv_final', 1, 1, 4, 1, 1), (1, 3, 2, 128)),
    'upconv': (_one('upconv', None, 3), S4),
    'upconv_k3_s2_biased': (_one('upconv', None, 3, ksize=3, stride=2,
                                 biased=True, relu=False), S4),
    'upconv_shape': (_one('upconv', (2, 13, 11, 3), 3, ksize=4, stride=2),
                     S4),
    'upconv_shape_k5_s3': (_one('upconv', (2, 20, 17, 3), 3, ksize=5,
                                stride=3), S4),
    'lrn': (_one('lrn', 2, 1e-3, 0.75, bias=1.5), S4),
    'reshape_layer': (_one('reshape_layer', 2), (2, 3, 5, 4)),
    'reshape_layer_rpn': ([(('data',), 'reshape_layer', (2,),
                            {'name': 'rpn_cls_prob_reshape'})], (2, 3, 5, 4)),
    'spatial_reshape_layer': (_one('spatial_reshape_layer', 2),
                              (2, 3, 5, 4)),
    'spatial_softmax': (_one('spatial_softmax'), S4),
    'negation': (_one('negation'), S4),
    'scale': (_one('scale', 4), S4),
    'batch_normalization_frozen': (_one('batch_normalization'), S4),
    'batch_normalization_training': (
        _one('batch_normalization', relu=False, is_training=True), S4),
    'bn_scale_combo': (_one('bn_scale_combo', 4), S4),
    'bn_scale_combo_no_relu': (_one('bn_scale_combo', 4, relu=False), S4),
    'pva_negation_block': (_one('pva_negation_block', 3, 3, 5, 1, 1), S4),
    'pva_negation_block_plain': (
        _one('pva_negation_block', 3, 3, 5, 2, 2, scale=False,
             negation=False), S4),
    'pva_negation_block_v2': (
        _one('pva_negation_block_v2', 3, 3, 5, 1, 1, 4, scale=False), S4),
    'pva_negation_block_v2_plain': (
        _one('pva_negation_block_v2', 1, 1, 5, 2, 2, 4, negation=False), S4),
    'pva_inception_res_stack': (
        _one('pva_inception_res_stack', 256), (1, 3, 2, 256)),
    'pva_inception_res_stack_start_conv4_1': (
        [(('data',), 'pva_inception_res_stack', (128,),
          {'block_start': True, 'name': 'conv4_1'})], (1, 5, 4, 128)),
    'pva_inception_res_stack_conv5_4_b': (
        [(('data',), 'pva_inception_res_stack', (384,),
          {'type': 'b', 'name': 'conv5_4'})], (1, 2, 2, 384)),
    'pva_inception_res_block': (_one('pva_inception_res_block'),
                                (1, 3, 4, 128)),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_layer_matches_jax(case):
    steps, shape = CASES[case]
    compare_chain(steps, {'data': shape}, {'data': _x(shape)})


def test_add_takes_two_inputs():
    steps = [(('a', 'b'), 'add', (), {'name': 'sum'}),
             (None, 'conv', (1, 1, 3, 1, 1), {'name': 'after'})]
    compare_chain(steps, {'a': S4, 'b': S4},
                  {'a': _x(S4, 1), 'b': _x(S4, 2)}, input_names=('a', 'b'))


def test_chain_of_legacy_layers_matches_jax():
    """The layers of chip_smoke's phase 12 net, chained (its inception
    block is ``test_layer_matches_jax[pva_inception_res_block]``)."""
    steps = [(('data',), 'conv_norm', (3, 3, 8, 1, 1), {'name': 'cn'}),
             (None, 'conv_norm', (3, 3, 8, 2, 2), {'biased': False,
                                                 'name': 'crelu'}),
             (None, 'lrn', (2, 1e-4, 0.75), {'name': 'lrn'}),
             (None, 'batch_normalization', (), {'name': 'bn'}),
             (None, 'pva_negation_block_v2', (3, 3, 12, 1, 1, 16),
              {'name': 'neg'}),
             (None, 'upconv', (None, 6), {'name': 'up'}),
             (None, 'avg_pool', (2, 2, 2, 2), {'name': 'avg'}),
             (None, 'fc', (10,), {'name': 'fc'})]
    shape = (1, 8, 6, 3)
    compare_chain(steps, {'data': shape}, {'data': _x(shape)})


@pytest.mark.parametrize('steps,shape,exc', [
    (_one('conv_final', 3, 3, 8, 1, 1), S4, ValueError),       # c_i != 128
    (_one('conv', 3, 3, 8, 1, 1, c_i=3), S4, ValueError),
    (_one('upconv', (2, 16, 12, 3), 3), S4, ValueError),       # 16 > 7 * 2
    (_one('upconv', (2, 12, 10, 3), 3), S4, ValueError),       # 12 <= 6 * 2
    ([(('data',), 'nope_layer', (), {})], S4, AttributeError),
    ([(('missing',), 'relu', (), {})], S4, KeyError),
])
def test_shape_checks_raise_as_jax(steps, shape, exc):
    with JaxCfg():
        with pytest.raises(exc):
            JChain(steps).init_params(jax.random.PRNGKey(0), {'data': shape})
    with pytest.raises(exc):
        PChain(steps, {'data': shape})


def test_upconv_output_shapes_as_jax():
    for shape, ksize, stride in [(None, 4, 2), ((2, 13, 11, 3), 4, 2),
                                 ((2, 21, 18, 3), 3, 3), (None, 2, 1)]:
        net = PChain(_one('upconv', shape, 3, ksize=ksize, stride=stride),
                     {'data': S4})
        y = net.outputs(torch.randn(2, 4, 7, 6))['out']
        assert tuple(y.permute(0, 2, 3, 1).shape) == net.output_shape('out')


def test_smooth_l1_dist_matches_jax():
    d = _x((64,)) * 0.3
    for sigma2 in (9.0, 1.0):
        np.testing.assert_allclose(
            LL.smooth_l1_dist(torch.from_numpy(d), sigma2).numpy(),
            np.asarray(JLL.smooth_l1_dist(jnp.asarray(d), sigma2)),
            rtol=1e-6, atol=1e-7)


def test_composite_reg_entries_match_jax():
    """The L2 collection of the composite blocks and scale layers: the same
    (layer, path, coefficient) entries as the JAX ``reg_paths``, and the
    same loss within 1e-5, at WEIGHT_DECAY 1e-3; 0 turns it all off."""
    steps = [(('data',), 'conv', (3, 3, 8, 1, 1), {'name': 'c'}),
             (None, 'scale', (8,), {'name': 's'}),
             (None, 'pva_negation_block', (3, 3, 8, 1, 1), {'name': 'nb'}),
             (None, 'pva_negation_block_v2', (1, 1, 128, 1, 1, 16),
              {'name': 'nb2'}),
             (None, 'pva_inception_res_block', (), {'name': 'blk'})]
    shape = (1, 4, 4, 3)
    jnet, pnet, params = compare_chain(steps, {'data': shape},
                                       {'data': _x(shape)}, grads=False)
    want = [(layer, tuple(path), coeff) for layer, path, coeff in
            jnet.reg_paths]
    assert pnet.reg_paths == want
    for wd in (1e-3, 0.0):
        with JaxCfg(TRAIN__WEIGHT_DECAY=wd):
            jl = float(jnet.regularization_loss(params))
        pl = float(pnet.regularization_loss(wd).detach())
        np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=0)
        if wd == 0.0:
            assert pl == 0.0


@pytest.mark.parametrize('solver', ['Adam', 'RMS', 'Momentum'])
def test_frozen_statistics_stay_frozen(tmp_path, solver):
    """Three solver steps with weight decay move every parameter of a net
    with ``batch_normalization`` and a composite block, and none of the
    frozen ``bn_moving_*`` statistics; a snapshot writes them under
    ``params/`` and restores them."""
    cfg = load_cfg(None, ['TRAIN.SOLVER', repr(solver),
                          'TRAIN.WEIGHT_DECAY', '0.01'])
    steps = [(('data',), 'conv', (3, 3, 8, 1, 1), {'name': 'c'}),
             (None, 'batch_normalization', (), {'name': 'bn'}),
             (None, 'pva_negation_block', (3, 3, 4, 1, 1), {'name': 'nb'})]
    net = PChain(steps, {'data': (2, 6, 5, 3)}, cfg=cfg,
                 generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, b in net.named_buffers():
            b.add_(torch.rand(b.shape))
    frozen = {k: b.clone() for k, b in net.named_buffers()}
    assert sorted(frozen) == ['bn.bn_moving_mean', 'bn.bn_moving_var',
                              'nb.bn.bn_moving_mean', 'nb.bn.bn_moving_var']
    before = {k: p.detach().clone() for k, p in net.named_parameters()}
    opt = train.make_optimizer(net, cfg)
    x = torch.randn(2, 3, 6, 5)
    for _ in range(3):
        net.zero_grad()
        loss = (net(x) ** 2).mean() + net.regularization_loss(0.01)
        loss.backward()
        opt.step()
    for k, p in net.named_parameters():
        assert not torch.equal(p, before[k]), k
    for k, b in net.named_buffers():
        assert torch.equal(b, frozen[k]), k
    assert set(opt.moments[opt._SLOTS.get(solver, ('trace',))[0]]) == \
        set(before)
    path = checkpoint.save(net, opt, str(tmp_path), 3, cfg)
    flat = checkpoint.read_flat(path)
    for k in frozen:
        key = 'params/' + k.replace('.', '/')
        np.testing.assert_array_equal(flat[key], frozen[k].numpy())
    fresh = PChain(steps, {'data': (2, 6, 5, 3)}, cfg=cfg)
    checkpoint.load_into(fresh, path, need_bn_state=False)
    for k, b in fresh.named_buffers():
        assert torch.equal(b, frozen[k]), k


@pytest.mark.parametrize('solver', ['Adam', 'Momentum'])
def test_port_snapshot_restores_in_jax_with_its_optimizer_state(tmp_path,
                                                                solver):
    """A port snapshot of a net with frozen batch-norm statistics holds the
    moments the JAX optax state has for them (zeros), so the JAX package's
    ``checkpoint.restore`` takes it whole, optimizer state included, into
    its own state tree; the port reads the JAX snapshot back the same."""
    from lstm_ctc_ocr_tpu.engine import checkpoint as jcheckpoint
    from lstm_ctc_ocr_tpu.engine import train as jtrain
    from torch_dsl_cases import JaxCfg, JChain, perturbed_params, \
        port_from_jax
    steps = [(('data',), 'conv', (3, 3, 8, 1, 1), {'name': 'c'}),
             (None, 'batch_normalization', (), {'name': 'bn'}),
             (None, 'pva_negation_block', (3, 3, 4, 1, 1), {'name': 'nb'})]
    shapes = {'data': (2, 6, 5, 3)}
    cfg = load_cfg(None, ['TRAIN.SOLVER', repr(solver)])
    with JaxCfg(TRAIN__SOLVER=solver):
        jnet = JChain(steps)
        params = perturbed_params(jnet, shapes)
        template = {'params': params, 'bn_state': jnet.init_bn_state(),
                    'opt_state': jtrain.make_optimizer().init(params)}
        net = port_from_jax(PChain(steps, shapes, cfg=cfg), params)
        opt = train.make_optimizer(net, cfg)
        for _ in range(2):
            net.zero_grad()
            (net(torch.randn(2, 3, 6, 5)) ** 2).mean().backward()
            opt.step()
        path = checkpoint.save(net, opt, str(tmp_path / 'port'), 3, cfg)
        state = jcheckpoint.restore(template, path)
    flat = jcheckpoint.flatten_state(state)
    written = checkpoint.read_flat(path)
    assert set(flat) == set(written)
    for key, arr in flat.items():
        np.testing.assert_array_equal(np.asarray(arr), written[key], key)
    frozen = [k for k in flat if k.startswith('opt_state/')
              and 'bn_moving_' in k]
    assert len(frozen) == 4 * len(opt.moments)
    assert all(not np.asarray(flat[k]).any() for k in frozen)
    assert any(np.asarray(flat[k]).any() for k in flat
               if k.startswith('opt_state/') and k not in frozen
               and not k.endswith('.count'))

    theirs = jcheckpoint.save(state, str(tmp_path / 'jax'), 3)
    net2 = PChain(steps, shapes, cfg=cfg)
    opt2 = train.make_optimizer(net2, cfg)
    checkpoint.restore(net2, opt2, theirs)
    assert opt2.count == opt.count == 2
    for slot, tensors in opt.moments.items():
        for name, t in tensors.items():
            assert torch.equal(t, opt2.moments[slot][name]), slot + name
