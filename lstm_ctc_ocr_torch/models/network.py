"""The chained-layer model DSL as an ``nn.Module``.

Counterpart of the JAX package's ``models/network.py``. A model is a
:class:`Network` subclass whose ``setup()`` writes a chain::

    class LSTM_train(Network):
        def setup(self):
            cfg = self.cfg
            (self.feed('data')
             .conv_single(3, 3, 64, 1, 1, name='conv1', c_i=cfg.NCHANNELS)
             .max_pool(2, 2, 2, 2, padding='VALID', name='pool1')
             ...
             .reshape_squeeze_layer(d=512, name='reshaped_layer'))
            (self.feed('reshaped_layer', 'time_step_len')
             .bi_lstm(cfg.TRAIN.NUM_HID, cfg.TRAIN.NUM_LAYERS, name='logits'))

    net = LSTM_train(cfg, generator=torch.Generator().manual_seed(3))

Each chained call records a :class:`LayerSpec` and re-feeds the layer's
name; ``feed`` re-roots the chain and takes several names for a layer with
several inputs (``bi_lstm``, ``lstm``, ``add``). The JAX chain reads the
module-global ``cfg``; the port passes ``cfg`` to the constructor, and
``setup`` reads ``self.cfg``.

Construction walks the specs with the JAX ``init_params``'s shape
inference over ``input_shapes`` (JAX shapes: ``data`` ``(N, W, H)`` or
``(N, A1, A2, C)``; by default ``(1, BUCKETS[0], NUM_FEATURES)`` and
``time_step_len`` ``(1,)``) and makes each layer with parameters a
submodule under its layer name, drawing from ``generator`` in chain order.
State-dict keys are the JAX tree's paths with dots (``conv1.kernel``,
``logits.cells.fw.w``, ``stack1.t0_conv.kernel``), so the weight bridge
(``engine/checkpoint.py``) maps a JAX checkpoint of the same chain onto the
module. ``conv_single`` and ``max_pool`` at the CRNN's geometry are
``layers.ConvSingle`` and ``layers.max_pool``, so the JAX ``LSTM_train``
chain computes ``models/crnn.py:LSTM_train`` bit for bit, from the same
generator too; ``conv_single`` takes ``cfg.CONV_IMPL``'s lowering, as the
JAX chain takes its global cfg's.

Layout: a 4-D tensor is ``[N, C, A1, A2]`` (``models/layers.py``); the JAX
package's ``[N, A1, A2, C]`` is ``x.permute(0, 2, 3, 1)`` of it, and a 4-D
input is fed in the port's layout. 3-D tensors (``[N, W, H]`` data,
``[N, T, D]`` sequences, ``[T, N, C]`` logits) are as in JAX.

:meth:`Network.forward` takes the inputs of ``input_names`` in order
(uint8 ones are divided by 255 first, as JAX ``apply`` does) and returns
the ``'logits'`` layer's output (the last layer's where there is none):
the contract of ``engine/train.py``, ``engine/test.py`` and
``engine/serve.py``. :meth:`Network.outputs` returns every named layer's
output, as JAX ``apply`` does. ``dropout`` acts only in training mode. Its
masks are a hash of ``dropout_seed`` (``RNG_SEED`` by default), the layer's
place among the dropout layers and a step (``layers.dropout_key``), as the
JAX masks are ``fold_in(PRNGKey(RNG_SEED), step)`` split once a layer: the
solver passes the step it takes (``dropout_step``, from its update count
on the device), so K steps in one dispatch, eager or as a CUDA graph, and
a run resumed at step n draw what single steps and an uninterrupted run
draw; a call without ``dropout_step`` takes the network's own count of
such calls.

The JAX quirks the JAX tests pin are kept: a duplicate layer name
overwrites in the outputs but not in the chain (``LSTM_train``'s two
``pool2``), ``get_unique_name`` numbers unnamed layers per kind, a 3-D
input to ``conv_single`` implies one input channel, and
``reshape_squeeze_layer`` asserts that each time step is exactly one
``(H, C)`` slice. Layers are reached by name through the module table
(``net._modules['fc']`` where ``net.fc`` is the DSL method).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

import torch
from torch import nn

from ..config import default_cfg
from . import layers as L
from . import layers_legacy as LL


@dataclass
class LayerSpec:
    name: str
    kind: str
    inputs: List[str]
    kwargs: Dict[str, Any]
    reg_keys: Tuple[str, ...] = ()   # parameters that carry L2 weight decay


def layer(op):
    """DSL method decorator: consume ``self.inputs``, record a spec and
    re-feed the layer's name for chaining."""
    def wrapped(self, *args, **kwargs):
        name = kwargs.pop('name', None) or self.get_unique_name(op.__name__)
        spec = op(self, list(self.inputs), name, *args, **kwargs)
        self.specs.append(spec)
        self.layer_order.append(name)
        self.inputs = [name]
        return self
    wrapped.__name__, wrapped.__doc__ = op.__name__, op.__doc__
    return wrapped


class Network(nn.Module):
    """Base class; subclasses define the graph in ``setup()``. The layer
    methods take the JAX signatures; ``trainable`` is taken and ignored,
    and so is ``bi_lstm``'s ``num_layers``, as in the JAX package."""

    input_names: Sequence[str] = ('data', 'time_step_len')

    # the legacy scale layers' fixed decay rates (the reference's
    # network.py:510-513 and 617-622, and 529-532)
    _SCALE_WD = 1e-5
    _SCALE_WD_V2 = 4e-5

    def __init__(self, cfg=None, generator=None, input_shapes=None):
        super().__init__()
        self.cfg = default_cfg() if cfg is None else cfg
        self.specs: List[LayerSpec] = []
        self.layer_order: List[str] = []
        self.inputs: List[str] = []
        self._name_counts: Dict[str, int] = {}
        self._shapes: Dict[str, Tuple[int, ...]] = {}
        # (layer, attribute path, coefficient); None = the weight decay
        self.reg_paths: List[Tuple[str, Tuple[str, ...], Any]] = []
        self.dropout_seed = int(self.cfg.RNG_SEED)
        self._dropout_calls = 0
        self.setup()
        if input_shapes is None:
            if tuple(self.input_names) != ('data', 'time_step_len'):
                raise ValueError('input_shapes is needed for the inputs {}'
                                 .format(tuple(self.input_names)))
            input_shapes = {
                'data': (1, int(self.cfg.BUCKETS[0]),
                         int(self.cfg.NUM_FEATURES)),
                'time_step_len': (1,)}
        self._build(dict(input_shapes), generator)

    def setup(self):
        raise NotImplementedError('Must be subclassed')

    # -- chaining ------------------------------------------------------------

    def feed(self, *names: str) -> 'Network':
        for n in names:
            assert isinstance(n, str), 'feed() takes layer/input names'
        self.inputs = list(names)
        return self

    def get_unique_name(self, prefix: str) -> str:
        self._name_counts[prefix] = self._name_counts.get(prefix, 0) + 1
        return '{}_{}'.format(prefix, self._name_counts[prefix])

    # -- layer vocabulary ------------------------------------------------------

    @layer
    def conv_single(self, inputs, name, k_h, k_w, c_o, s_h, s_w, c_i=None,
                    bn=False, biased=True, relu=True, padding='SAME',
                    trainable=True):
        return LayerSpec(name, 'conv_single', inputs,
                         dict(k_h=k_h, k_w=k_w, c_o=c_o, s_h=s_h, s_w=s_w,
                              c_i=c_i, bn=bn, biased=biased, relu=relu,
                              padding=padding), reg_keys=('kernel',))

    @layer
    def max_pool(self, inputs, name, k_h, k_w, s_h, s_w, padding='SAME'):
        return LayerSpec(name, 'max_pool', inputs,
                         dict(k_h=k_h, k_w=k_w, s_h=s_h, s_w=s_w,
                              padding=padding))

    @layer
    def avg_pool(self, inputs, name, k_h, k_w, s_h, s_w, padding='SAME'):
        return LayerSpec(name, 'avg_pool', inputs,
                         dict(k_h=k_h, k_w=k_w, s_h=s_h, s_w=s_w,
                              padding=padding))

    @layer
    def reshape_squeeze_layer(self, inputs, name, d):
        return LayerSpec(name, 'reshape_squeeze', inputs, dict(d=d))

    @layer
    def bi_lstm(self, inputs, name, num_hids, num_layers, trainable=True):
        return LayerSpec(name, 'bi_lstm', inputs,
                         dict(num_hids=num_hids, num_layers=num_layers,
                              nclasses=int(self.cfg.NCLASSES)), reg_keys=('weights',))

    @layer
    def lstm(self, inputs, name, num_hids, num_layers, trainable=True):
        return LayerSpec(name, 'lstm', inputs,
                         dict(num_hids=num_hids, num_layers=num_layers,
                              nclasses=int(self.cfg.NCLASSES)), reg_keys=('weights',))

    @layer
    def fc(self, inputs, name, num_out, relu=True, trainable=True):
        return LayerSpec(name, 'fc', inputs, dict(num_out=num_out, relu=relu), reg_keys=('weights',))

    @layer
    def softmax(self, inputs, name):
        return LayerSpec(name, 'softmax', inputs, {})

    @layer
    def dropout(self, inputs, name, keep_prob):
        return LayerSpec(name, 'dropout', inputs, dict(keep_prob=keep_prob))

    # -- legacy vocabulary (models/layers_legacy.py) ---------------------------

    @layer
    def relu(self, inputs, name):
        return LayerSpec(name, 'relu', inputs, {})

    @layer
    def conv(self, inputs, name, k_h, k_w, c_o, s_h, s_w, c_i=None,
             biased=True, relu=True, padding='SAME', trainable=True):
        return LayerSpec(name, 'conv', inputs,
                         dict(k_h=k_h, k_w=k_w, c_o=c_o, s_h=s_h, s_w=s_w,
                              c_i=c_i, biased=biased, relu=relu,
                              padding=padding), reg_keys=('kernel',))

    @layer
    def conv_zero(self, inputs, name, k_h, k_w, c_o, s_h, s_w, biased=True,
                  relu=True, padding='SAME', trainable=True):
        return LayerSpec(name, 'conv_zero', inputs,
                         dict(k_h=k_h, k_w=k_w, c_o=c_o, s_h=s_h, s_w=s_w,
                              biased=biased, relu=relu, padding=padding), reg_keys=('kernel',))

    @layer
    def conv_norm(self, inputs, name, k_h, k_w, c_o, s_h, s_w, biased=True,
                  relu=True, padding='SAME', trainable=True):
        return LayerSpec(name, 'conv_norm', inputs,
                         dict(k_h=k_h, k_w=k_w, c_o=c_o, s_h=s_h, s_w=s_w,
                              biased=biased, relu=relu, padding=padding), reg_keys=('kernel',))

    @layer
    def conv_final(self, inputs, name, k_h, k_w, c_o, s_h, s_w, biased=True,
                   relu=True, padding='SAME', trainable=True):
        return LayerSpec(name, 'conv_final', inputs,
                         dict(k_h=k_h, k_w=k_w, c_o=c_o, s_h=s_h, s_w=s_w,
                              biased=biased, relu=relu, padding=padding), reg_keys=('kernel',))

    @layer
    def upconv(self, inputs, name, shape, c_o, ksize=4, stride=2,
               biased=False, relu=True, padding='SAME', trainable=True):
        return LayerSpec(name, 'upconv', inputs,
                         dict(shape=shape, c_o=c_o, ksize=ksize,
                              stride=stride, biased=biased, relu=relu), reg_keys=('kernel',))

    @layer
    def lrn(self, inputs, name, radius, alpha, beta, bias=1.0):
        return LayerSpec(name, 'lrn', inputs,
                         dict(radius=radius, alpha=alpha, beta=beta,
                              bias=bias))

    @layer
    def reshape_layer(self, inputs, name, d):
        return LayerSpec(name, 'reshape_layer', inputs,
                         dict(d=d, name=name))

    @layer
    def spatial_reshape_layer(self, inputs, name, d):
        return LayerSpec(name, 'spatial_reshape_layer', inputs, dict(d=d))

    @layer
    def spatial_softmax(self, inputs, name):
        return LayerSpec(name, 'spatial_softmax', inputs, {})

    @layer
    def add(self, inputs, name):
        return LayerSpec(name, 'add', inputs, {})

    @layer
    def negation(self, inputs, name):
        return LayerSpec(name, 'negation', inputs, {})

    @layer
    def scale(self, inputs, name, c_in):
        return LayerSpec(name, 'scale', inputs, dict(c_in=c_in))

    @layer
    def batch_normalization(self, inputs, name, relu=True, is_training=False):
        return LayerSpec(name, 'batch_normalization', inputs,
                         dict(relu=relu, is_training=is_training))

    @layer
    def bn_scale_combo(self, inputs, name, c_in, relu=True):
        return LayerSpec(name, 'bn_scale_combo', inputs,
                         dict(c_in=c_in, relu=relu))

    @layer
    def pva_negation_block(self, inputs, name, k_h, k_w, c_o, s_h, s_w,
                           biased=True, padding='SAME', trainable=True,
                           scale=True, negation=True):
        return LayerSpec(name, 'pva_negation_block', inputs,
                         dict(k_h=k_h, k_w=k_w, c_o=c_o, s_h=s_h, s_w=s_w,
                              biased=biased, padding=padding, scale=scale,
                              negation=negation))

    @layer
    def pva_negation_block_v2(self, inputs, name, k_h, k_w, c_o, s_h, s_w,
                              c_in, biased=True, padding='SAME',
                              trainable=True, scale=True, negation=True):
        # `scale` is taken and ignored, as in the reference
        return LayerSpec(name, 'pva_negation_block_v2', inputs,
                         dict(k_h=k_h, k_w=k_w, c_o=c_o, s_h=s_h, s_w=s_w,
                              c_in=c_in, biased=biased, padding=padding,
                              negation=negation))

    @layer
    def pva_inception_res_stack(self, inputs, name, c_in, block_start=False,
                                type='a'):
        return LayerSpec(name, 'pva_inception_res_stack', inputs,
                         dict(c_in=c_in, block_start=block_start, type=type,
                              name=name))

    @layer
    def pva_inception_res_block(self, inputs, name, name_prefix='conv4_',
                                type='a'):
        return LayerSpec(name, 'pva_inception_res_block', inputs,
                         dict(name_prefix=name_prefix, type=type))

    # -- build ----------------------------------------------------------------

    def _build(self, shapes, generator):
        """Walk the specs with shape inference; make and register the
        layers with parameters."""
        for spec in self.specs:
            in_shapes = [shapes[n] for n in spec.inputs]
            module, out_shape = self._make_layer(spec, in_shapes, generator)
            if module is not None:
                self._register(spec.name, module)
                for k in spec.reg_keys:
                    self.reg_paths.append((spec.name, (k,), None))
                for path, coeff in self._composite_reg_entries(spec, module):
                    self.reg_paths.append((spec.name, path, coeff))
            shapes[spec.name] = out_shape
        self._shapes = shapes

    def _register(self, name, module):
        # straight into the module table, so that a layer may share its
        # name with a DSL method (a layer named 'fc', say); a duplicate
        # name replaces the earlier layer, as it does in the JAX tree
        self._modules[name] = module

    def _composite_reg_entries(self, spec, module):
        """The legacy layers' L2 entries: each inner conv kernel at the
        weight decay, the scale layers' alpha and beta at their fixed
        rates (the JAX ``_composite_reg_entries``)."""
        kind = spec.kind
        if kind == 'scale':
            return [(('alpha',), self._SCALE_WD), (('beta',), self._SCALE_WD)]
        if kind == 'pva_negation_block':
            out = [(('conv', 'kernel'), None)]
            if spec.kwargs['scale']:
                out += [(('scale', 'alpha'), self._SCALE_WD),
                        (('scale', 'beta'), self._SCALE_WD)]
            return out
        if kind == 'pva_negation_block_v2':
            out = [(('conv', 'kernel'), None)]
            if spec.kwargs['negation']:
                out += [(('scale', 'alpha'), self._SCALE_WD_V2),
                        (('scale', 'beta'), self._SCALE_WD_V2)]
            return out
        if kind == 'pva_inception_res_stack':
            return self._incep_stack_reg_entries(module)
        if kind == 'pva_inception_res_block':
            out = []
            for i in range(1, 5):
                key = 'stack{}'.format(i)
                out += [((key,) + path, coeff) for path, coeff in
                        self._incep_stack_reg_entries(getattr(module, key))]
            return out
        return []

    def _incep_stack_reg_entries(self, stack):
        out = [((k, 'kernel'), None) for k, m in
               sorted(stack.named_children()) if 'kernel' in m._parameters]
        out += [(('bn_scale', 'alpha'), self._SCALE_WD),
                (('bn_scale', 'beta'), self._SCALE_WD)]
        return out

    def _make_layer(self, spec, in_shapes, g):
        """``(module or None, JAX-layout output shape)`` of one spec."""
        kw = spec.kwargs
        s = in_shapes[0]
        if spec.kind == 'conv_single':
            if len(s) == 3:
                # 3-D inputs expand to ONE channel at apply time
                assert kw['c_i'] in (None, 1), \
                    'conv_single on 3D input implies c_i=1, got {}'.format(
                        kw['c_i'])
                s = tuple(s) + (1,)
            c_i = s[3] if kw['c_i'] is None else kw['c_i']
            return (L.ConvSingle(c_i, kw['c_o'], kw['k_h'], bn=kw['bn'],
                                 relu=kw['relu'], padding=kw['padding'],
                                 generator=g, k2=kw['k_w'],
                                 stride=(kw['s_h'], kw['s_w']),
                                 biased=kw['biased'],
                                 conv_impl=str(self.cfg.CONV_IMPL)),
                    (s[0], L.out_dim(s[1], kw['k_h'], kw['s_h'],
                                     kw['padding']),
                     L.out_dim(s[2], kw['k_w'], kw['s_w'], kw['padding']),
                     kw['c_o']))
        if spec.kind in ('max_pool', 'avg_pool'):
            return None, L.pool_out_shape(s, kw['k_h'], kw['k_w'], kw['s_h'],
                                          kw['s_w'], kw['padding'])
        if spec.kind == 'reshape_squeeze':
            n, w, h, c = s
            # strict: each time step must be exactly one (h, c) slice
            assert h * c == kw['d'], \
                'reshape_squeeze: h*c = {}*{} != d={} (time axis would ' \
                'not align with time_step_len)'.format(h, c, kw['d'])
            return None, (n, w * h * c // kw['d'], kw['d'])
        if spec.kind == 'bi_lstm':
            n, t, d = s
            return (L.BiLSTM(d, kw['num_hids'], kw['nclasses'], generator=g),
                    (t, n, kw['nclasses']))
        if spec.kind == 'lstm':
            n, t, d = s
            return (L.LSTM(d, kw['num_hids'], kw['num_layers'],
                           kw['nclasses'], g), (t, n, kw['nclasses']))
        if spec.kind == 'fc':
            return (L.FC(s[-1], kw['num_out'], kw['relu'], g),
                    tuple(s[:-1]) + (kw['num_out'],))
        if spec.kind in ('softmax', 'dropout'):
            return None, s
        return LL.build(spec.kind, kw, in_shapes, g)

    # -- forward ----------------------------------------------------------------

    def seed_dropout(self, seed: int) -> None:
        """Reseed the dropout masks; the count of calls without a step
        starts again."""
        self.dropout_seed = int(seed)
        self._dropout_calls = 0

    def has_dropout(self) -> bool:
        """Whether a dropout layer would draw in training mode."""
        return any(s.kind == 'dropout' and s.kwargs['keep_prob'] < 1.0
                   for s in self.specs)

    def outputs(self, *inputs, dtype=None, moving_bn=False, bn_collect=None,
                bn_group=None, dropout_step=None) -> Dict[str, torch.Tensor]:
        """Every named layer's output (and the inputs), the JAX ``apply``.

        ``inputs``: tensors in ``input_names``' order, or one dict by name.
        ``dtype``: the compute dtype (None: f32); ``moving_bn``: the
        ``bn=True`` convs take their moving statistics; ``bn_collect`` (a
        list) receives their batch statistics; ``bn_group``: the process
        group whose ranks' rows share them (``models/layers.py``).
        ``dropout_step``: the step that keys the dropout masks in training
        (an int or an integer tensor, the JAX ``fold_in`` step); None takes
        the count of such calls, which then moves on by one."""
        if len(inputs) == 1 and isinstance(inputs[0], dict):
            feeds = dict(inputs[0])
        else:
            feeds = dict(zip(self.input_names, inputs))
        out = {k: (v.float() / 255.0 if v.dtype == torch.uint8 else v)
               for k, v in feeds.items()}
        bn = (moving_bn, bn_collect, bn_group)
        # each dropout layer's place in the chain keys its masks
        order = {id(s): i for i, s in enumerate(
            s for s in self.specs if s.kind == 'dropout')}
        step = dropout_step
        if step is None and self.training and self.has_dropout():
            step = self._dropout_calls
            self._dropout_calls += 1
        for spec in self.specs:
            xs = [out[n] for n in spec.inputs]
            key = None
            if id(spec) in order and step is not None:
                key = L.dropout_key(self.dropout_seed, order[id(spec)], step)
            out[spec.name] = self._apply_layer(spec, xs, dtype, bn, key)
        return out

    def forward(self, *inputs, **kwargs) -> torch.Tensor:
        """The ``'logits'`` layer's output (the last layer's where there is
        none); the arguments are :meth:`outputs`'."""
        name = 'logits' if 'logits' in self.layer_order \
            else self.layer_order[-1]
        return self.outputs(*inputs, **kwargs)[name]

    def _apply_layer(self, spec, xs, dtype, bn, key=None):
        kw = spec.kwargs
        module = self._modules.get(spec.name)
        x = xs[0]
        if spec.kind == 'conv_single':
            if x.dim() == 3:             # [N, W, H] -> [N, 1, W, H]
                x = x.unsqueeze(1)
            return module(x, dtype, *bn)
        if spec.kind == 'max_pool':
            return L.max_pool(x, kw['k_h'], kw['k_w'], kw['s_h'], kw['s_w'],
                              kw['padding'])
        if spec.kind == 'avg_pool':
            return L.avg_pool(x, kw['k_h'], kw['k_w'], kw['s_h'], kw['s_w'],
                              kw['padding'])
        if spec.kind == 'reshape_squeeze':
            return L.reshape_squeeze(x, kw['d'])
        if spec.kind in ('bi_lstm', 'lstm'):
            return module(x, xs[1], dtype)
        if spec.kind == 'fc':
            return module(x, dtype)
        if spec.kind == 'softmax':
            return L.softmax(x)
        if spec.kind == 'dropout':
            return L.dropout(x, kw['keep_prob'], self.training, key)
        return LL.apply(spec.kind, module, xs, kw, dtype)

    # -- losses ------------------------------------------------------------------

    def regularization_loss(self, weight_decay) -> torch.Tensor:
        """Sum of ``c * sum(w^2) / 2`` in f32 over the L2 entries: conv
        kernels and projection weights at ``weight_decay``, the legacy
        scale layers at their fixed rates. ``weight_decay <= 0`` turns off
        the whole collection, the fixed-rate entries included."""
        first = next(self.parameters(), None)
        total = torch.zeros((), dtype=torch.float32) if first is None \
            else first.new_zeros((), dtype=torch.float32)
        if weight_decay <= 0:
            return total
        for layer_name, path, coeff in self.reg_paths:
            w = self._modules[layer_name]
            for key in path:
                w = getattr(w, key)
            c = weight_decay if coeff is None else coeff
            total = total + c * 0.5 * torch.sum(torch.square(w.float()))
        return total

    def output_shape(self, name: str):
        """The JAX-layout shape inferred for ``name`` at construction."""
        return self._shapes.get(name)
