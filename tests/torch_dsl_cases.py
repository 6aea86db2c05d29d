"""Shared by the DSL tests (``test_torch_network.py``,
``test_torch_legacy_layers.py``): one chain of DSL calls built by both
packages' ``Network``, the JAX parameters (perturbed from a numpy seed, so
that no bias is zero and no statistic is trivial) loaded into the port
through the weight bridge, and the two packages' outputs and gradients
side by side in the JAX layout.

A chain is a list of ``(feed, method, args, kwargs)``: ``feed`` (a tuple
of names, or None to go on from the previous layer) re-roots the chain
before the call.
"""

import copy

import numpy as np
import torch

import jax
import jax.numpy as jnp

from lstm_ctc_ocr_tpu.config import cfg as jcfg
from lstm_ctc_ocr_tpu.engine.checkpoint import flatten_state, unflatten_like
from lstm_ctc_ocr_tpu.models.network import Network as JNetwork
from lstm_ctc_ocr_torch.config import default_cfg
from lstm_ctc_ocr_torch.engine import checkpoint
from lstm_ctc_ocr_torch.models.network import Network


def run_steps(net, steps):
    for feed, method, args, kwargs in steps:
        if feed is not None:
            net.feed(*feed)
        getattr(net, method)(*args, **kwargs)


class JChain(JNetwork):
    def __init__(self, steps, input_names=('data',)):
        self._steps = steps
        self.input_names = input_names
        super().__init__()

    def setup(self):
        run_steps(self, self._steps)


class PChain(Network):
    def __init__(self, steps, input_shapes, input_names=('data',), cfg=None,
                 generator=None):
        self._steps = steps
        self.input_names = input_names
        super().__init__(cfg, generator=generator, input_shapes=input_shapes)

    def setup(self):
        run_steps(self, self._steps)


class JaxCfg:
    """Context manager: set JAX ``cfg`` keys (dotted), restore on exit."""

    def __init__(self, **keys):
        self.keys = keys

    def __enter__(self):
        self.old = copy.deepcopy(dict(jcfg))
        jcfg.LSTM_IMPL = 'jax'
        for k, v in self.keys.items():
            node = jcfg
            parts = k.split('__')
            for p in parts[:-1]:
                node = node[p]
            node[parts[-1]] = v
        return jcfg

    def __exit__(self, *exc):
        jcfg.clear()
        for k, v in self.old.items():
            jcfg[k] = v


def perturbed_params(jnet, input_shapes, seed=0):
    """JAX ``init_params`` with every leaf moved by a seeded draw: biases,
    shifts and means by N(0, 0.1), scales by 1 + N(0, 0.1), variances
    scaled into [0.5, 1.5)."""
    params = jnet.init_params(jax.random.PRNGKey(seed), input_shapes)
    rng = np.random.RandomState(seed + 1)
    flat = flatten_state({'params': params})
    out = {}
    for key, v in sorted(flat.items()):
        v = np.asarray(v, np.float32)
        if key.endswith('var'):
            v = v * (0.5 + rng.rand(*v.shape)).astype(np.float32)
        else:
            v = v + (0.1 * rng.randn(*v.shape)).astype(np.float32)
        out[key] = v
    return unflatten_like({'params': params}, out)['params']


def port_from_jax(pnet, params):
    """Load the JAX ``params`` tree into ``pnet`` through the bridge; every
    key must map (only the ``bn=True`` convs' moving statistics, which JAX
    keeps outside ``params``, may stay as they are)."""
    state = checkpoint.params_from_flat(flatten_state({'params': params}))
    missing, unexpected = pnet.load_state_dict(state, strict=False)
    assert not unexpected, unexpected
    assert all(k.endswith(('.bn_mean', '.bn_var')) for k in missing), missing
    return pnet


def to_jax_layout(t):
    a = t.detach().cpu().float().numpy()
    return a.transpose(0, 2, 3, 1) if a.ndim == 4 else a


def to_port(x):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.permute(0, 3, 1, 2).contiguous() if t.dim() == 4 else t


def assert_close(got, want, tol, what):
    """``|got - want| <= tol * max(1, max |want|)``: ``tol`` absolute for a
    tensor of unit scale, relative to its largest entry past that."""
    want = np.asarray(want, np.float64)
    bar = tol * max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    err = float(np.abs(np.asarray(got, np.float64) - want).max()) \
        if want.size else 0.0
    assert np.shape(got) == want.shape, (what, np.shape(got), want.shape)
    assert err <= bar, '{}: max |difference| {:.3g} > {:.3g}'.format(
        what, err, bar)


def compare_chain(steps, input_shapes, inputs, input_names=('data',),
                  names=None, jax_keys=None, tol=1e-5, grads=True, seed=0,
                  train=False):
    """Build ``steps`` in both packages at the JAX-layout ``input_shapes``,
    run them on ``inputs`` (numpy, JAX layout), and hold every named
    output (``names``, default all layers) within ``tol``
    (:func:`assert_close`); with ``grads``, also the gradients of
    ``sum(out * w)`` over those outputs (``w`` seeded) with respect to
    every parameter and every float input. Returns the two nets and the
    JAX params."""
    with JaxCfg(**(jax_keys or {})):
        jnet = JChain(steps, input_names)
        params = perturbed_params(jnet, input_shapes, seed)
        pnet = port_from_jax(PChain(steps, input_shapes, input_names,
                                    default_cfg()), params)
        pnet.train(train)
        names = names or [n for n in jnet.layer_order]
        jin = {k: jnp.asarray(v) for k, v in inputs.items()}
        # one jitted program each: op-by-op dispatch compiles every op
        jout = jax.jit(lambda p, x: jnet.apply(p, x, train=train))(params,
                                                                   jin)
        rng = np.random.RandomState(seed + 2)
        weights = {n: rng.randn(*np.shape(jout[n])).astype(np.float32)
                   for n in names}

        pin = {k: to_port(v).requires_grad_(v.dtype == np.float32)
               for k, v in inputs.items()}
        pout = pnet.outputs(pin)
        for n in names:
            assert_close(to_jax_layout(pout[n]), jout[n], tol, n)
        if not grads:
            return jnet, pnet, params

        def jloss(p, x):
            out = jnet.apply(p, x, train=train)
            return sum(jnp.sum(out[n] * weights[n]) for n in names)
        float_in = {k: v for k, v in jin.items() if v.dtype == jnp.float32}
        gp, gx = jax.jit(jax.grad(lambda p, xf: jloss(p, dict(jin, **xf)),
                                  argnums=(0, 1)))(params, float_in)
        loss = sum(torch.sum(pout[n] * to_port(weights[n])) for n in names)
        loss.backward()
        want = flatten_state({'params': gp})
        got = checkpoint.flat_from_params(
            {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in pnet.named_parameters()})
        assert set(got) <= set(want), sorted(set(got) - set(want))
        # a gradient that is zero in exact arithmetic (a bias that batch
        # norm on the batch's statistics removes) is rounding noise on both
        # sides, ~1e-7 of the largest gradient: it must stay noise-sized
        big = max([float(np.abs(np.asarray(want[k])).max()) for k in got],
                  default=0.0)
        for k in got:
            if float(np.abs(np.asarray(want[k])).max()) <= 1e-6 * big:
                assert float(np.abs(got[k]).max()) <= 1e-6 * big, k
            else:
                assert_close(got[k], want[k], tol, 'grad ' + k)
        for k, g in gx.items():
            assert_close(to_jax_layout(pin[k].grad), g, tol, 'd/d' + k)
        return jnet, pnet, params
