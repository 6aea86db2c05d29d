"""Checkpoint files and the weight bridge between the JAX layout and the port.

Counterpart of the JAX package's ``engine/checkpoint.py``. A checkpoint is a
flat ``.npz`` whose keys are ``/``-joined tree paths (``params/conv1/kernel``,
``params/logits/cells/fw/kernel``, ``bn_state/conv4_1/mean``, ...), named
``*_iter_<step>.ckpt.npz``. Training snapshots live in ``output/<EXP_DIR>/``;
the tracked release weights in ``checkpoints/<EXP_DIR>/`` are the fallback
for eval. Releases store float leaves in f16.

The bridge, :func:`params_from_flat` and its exact inverse
:func:`flat_from_params`, maps those keys 1:1 onto the port's
``state_dict`` names (``models/crnn.py``, and any tree of the model DSL,
``models/network.py``): ``params/a/b/.../leaf`` <-> ``a.b.....leaf``, with
these leaf rules:

* a 4-D ``kernel``, HWIO ``[kW, kH, C_in, C_out]`` <-> ``[C_out, C_in, kW,
  kH]`` (``permute(3, 2, 0, 1)``; the first spatial axis stays the width
  axis); the DSL's transposed conv (``upconv``) keeps TF's ``[k, k, C_out,
  C_in]``, which the same permute maps onto ``F.conv_transpose2d``'s
  ``[C_in, C_out, k, k]`` (``models/layers_legacy.py:UpConv``);
* an LSTM cell's ``kernel [D+H, 4H]`` (a leaf under ``.../cells/<cell>/``)
  <-> ``w = kernel[:D]`` and ``u = kernel[D:]``, gate order unchanged; the
  cells of a BiLSTM are keyed by direction (``params/logits/cells/fw/kernel``
  <-> ``logits.cells.fw.w``), those of the stacked ``lstm`` head by their
  index in the list (``params/logits/cells/0/kernel`` <-> ``logits.cells.0.w``);
* ``bn_state/<layer>/{mean,var}`` <-> the ``<layer>.bn_{mean,var}`` buffers;
  the legacy layers' frozen ``bn_moving_{mean,var}`` are ``params/`` leaves,
  as in the JAX tree;
* 1-D and 2-D leaves keep their layout; float leaves (f16 in releases)
  become f32.

:func:`load_npy_pretrained` loads the ``{layer: {param: ndarray}}`` dict
that ``tools/convert_ckpt2npy.py`` writes.

A training snapshot also holds the optimizer state under the keys the JAX
package's optax chain flattens to: ``opt_state/1/0/.mu/<path>``,
``opt_state/1/0/.nu/<path>`` and ``opt_state/1/0/.count`` for Adam
(``.trace`` for Momentum, ``.nu`` alone for RMS) and the schedule's
``opt_state/1/1/.count``. A moment has its parameter's shape and goes
through the same bridge (:func:`opt_state_to_flat`,
:func:`opt_state_from_flat`), so a snapshot written by either package
restores in the other, optimizer state included. The legacy layers' frozen
``bn_moving_{mean,var}`` are buffers of the port, which its solver does
not update, and parameters of the JAX tree, whose optax state holds their
moments (zeros: their gradient is stopped); a port snapshot writes those
zeros, and a JAX snapshot's are read and left out.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

_CKPT_RE = re.compile(r'_iter_(\d+)\.ckpt\.npz$')


def read_flat(path: str) -> Dict[str, np.ndarray]:
    """All arrays of a flat ``.npz`` checkpoint, keyed by tree path."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def list_checkpoints(output_dir: str):
    """(path, step) of every ``*_iter_<step>.ckpt.npz`` in ``output_dir``."""
    if not os.path.isdir(output_dir):
        return []
    out = []
    for f in os.listdir(output_dir):
        m = _CKPT_RE.search(f)
        if m:
            out.append((os.path.join(output_dir, f), int(m.group(1))))
    return out


def latest_checkpoint(output_dir: str) -> Optional[Tuple[str, int]]:
    ckpts = list_checkpoints(output_dir)
    return max(ckpts, key=lambda x: x[1]) if ckpts else None


def release_dir(output_dir: str) -> str:
    """``checkpoints/<EXP_DIR>`` beside an ``output/<EXP_DIR>`` directory."""
    parent, exp = os.path.split(os.path.normpath(output_dir))
    root = os.path.dirname(parent) if os.path.basename(parent) == 'output' \
        else parent
    return os.path.join(root, 'checkpoints', exp)


def latest_eval_checkpoint(output_dir: str) -> Optional[Tuple[str, int]]:
    """Newest snapshot for eval: ``output/<EXP_DIR>/`` first, else the
    tracked release in ``checkpoints/<EXP_DIR>/``."""
    found = latest_checkpoint(output_dir)
    if found is None:
        found = latest_checkpoint(release_dir(output_dir))
    return found


def _f32(arr: np.ndarray) -> torch.Tensor:
    if np.issubdtype(arr.dtype, np.floating):
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr))


def _is_cell_leaf(parts) -> bool:
    """``<...>/cells/<cell>/<leaf>``: a leaf of an LSTM cell."""
    return len(parts) >= 4 and parts[-3] == 'cells'


def params_from_flat(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """JAX flat checkpoint keys -> the port's ``state_dict`` entries.

    Keys outside ``params/`` and ``bn_state/`` (a training snapshot's
    optimizer state) are not model state and are left out."""
    out: Dict[str, torch.Tensor] = {}
    for key, arr in flat.items():
        parts = key.split('/')
        if parts[0] == 'bn_state' and len(parts) >= 3:
            out['{}.bn_{}'.format('.'.join(parts[1:-1]), parts[-1])] = \
                _f32(arr)
        elif parts[0] == 'params' and len(parts) >= 3:
            prefix, leaf = '.'.join(parts[1:-1]), parts[-1]
            if leaf == 'kernel' and _is_cell_leaf(parts) and arr.ndim == 2:
                h_dim = arr.shape[1] // 4
                d = arr.shape[0] - h_dim
                out[prefix + '.w'] = _f32(arr[:d])
                out[prefix + '.u'] = _f32(arr[d:])
                continue
            t = _f32(arr)
            if leaf == 'kernel' and t.dim() == 4:
                t = t.permute(3, 2, 0, 1).contiguous()
            out['{}.{}'.format(prefix, leaf)] = t
        elif parts[0] == 'params':
            raise KeyError('unexpected parameter path in checkpoint: ' + key)
    return out


def flat_from_params(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's ``state_dict`` -> JAX flat checkpoint keys (f32 leaves);
    the exact inverse of :func:`params_from_flat`."""
    out: Dict[str, np.ndarray] = {}
    cells: Dict[str, Dict[str, np.ndarray]] = {}
    for name, t in state.items():
        arr = t.detach().cpu().numpy()
        parts = name.split('.')
        if _is_cell_leaf(parts) and parts[-1] in ('w', 'u'):
            base = 'params/{}/'.format('/'.join(parts[:-1]))
            cells.setdefault(base, {})[parts[-1]] = arr
        elif parts[-1] in ('bn_mean', 'bn_var'):
            out['bn_state/{}/{}'.format('/'.join(parts[:-1]),
                                        parts[-1][3:])] = arr
        else:
            if parts[-1] == 'kernel' and arr.ndim == 4:
                arr = np.ascontiguousarray(arr.transpose(2, 3, 1, 0))
            out['params/' + '/'.join(parts)] = arr
    for base, wu in cells.items():
        out[base + 'kernel'] = np.concatenate([wu['w'], wu['u']], axis=0)
    return out


def load_npy_pretrained(model: torch.nn.Module, path: str,
                        ignore_missing: bool = False) -> torch.nn.Module:
    """Load a ``{layer: {param: ndarray}}`` ``.npy`` dict in the JAX
    layouts (``tools/convert_ckpt2npy.py``'s, nested as the JAX tree, a
    stacked ``lstm`` layer's cells under digit keys) into ``model``, in
    place, through the bridge; the JAX ``load_npy_pretrained``.

    A name the model lacks raises ``KeyError('pretrained var not in model:
    <path>')`` and a shape (in the JAX layout) that differs raises
    ``ValueError``, unless ``ignore_missing``: then the one is skipped and
    the other skipped with the JAX line ``skipping <path>: ckpt shape ...
    vs model ...``."""
    d = np.load(path, allow_pickle=True).item()
    model_flat = {k[len('params/'):]: v
                  for k, v in flat_from_params(model.state_dict()).items()
                  if k.startswith('params/')}
    nodes = {'/'.join(k.split('/')[:i]) for k in model_flat
             for i in range(1, k.count('/') + 1)}
    take: Dict[str, np.ndarray] = {}

    def assign(src, prefix):
        for name, val in src.items():
            where = prefix + '/' + str(name) if prefix else str(name)
            if isinstance(val, dict):
                if where not in nodes:
                    if ignore_missing:
                        continue
                    raise KeyError(
                        'pretrained var not in model: {}'.format(where))
                assign(val, where)
                continue
            if where not in model_flat:
                if ignore_missing:
                    continue
                raise KeyError('pretrained var not in model: {}'.format(where))
            cur = model_flat[where]
            if tuple(np.shape(cur)) != tuple(np.shape(val)):
                if ignore_missing:
                    print('skipping {}: ckpt shape {} vs model {}'.format(
                        where, np.shape(val), np.shape(cur)))
                    continue
                raise ValueError('shape mismatch for {}: {} vs {}'.format(
                    where, np.shape(val), np.shape(cur)))
            take['params/' + where] = np.asarray(val)

    assign(d, '')
    state = model.state_dict()
    with torch.no_grad():
        for name, t in params_from_flat(take).items():
            state[name].copy_(t)
    return model


def load_into(model: torch.nn.Module, path: str, need_bn_state: bool,
              params_only: bool = False):
    """Restore ``model`` from the checkpoint at ``path``.

    Every parameter must be in the file. The moving BN statistics may be
    missing only when ``need_bn_state`` is false; the model then keeps its
    initial ones (the JAX eval path reads them only under ``BN_EVAL:
    moving``). ``params_only`` leaves the file's moving statistics out, as
    a warm start from pre-trained weights does."""
    state = params_from_flat(read_flat(path))
    if params_only:
        state = {k: v for k, v in state.items()
                 if '.bn_mean' not in k and '.bn_var' not in k}
    missing, unexpected = model.load_state_dict(state, strict=False)
    if unexpected:
        raise KeyError('checkpoint {} has keys the model lacks: {}'.format(
            path, unexpected))
    missing_bn = [k for k in missing if '.bn_mean' in k or '.bn_var' in k]
    if len(missing_bn) != len(missing):
        raise KeyError('checkpoint {} is missing parameters: {}'.format(
            path, sorted(set(missing) - set(missing_bn))))
    if missing_bn and need_bn_state:
        raise RuntimeError(
            'BN_EVAL=moving but {} has no bn_state: estimate it with '
            'tools/calibrate_bn.py, or evaluate with BN_EVAL=batch'.format(path))


# --- optimizer state -------------------------------------------------------------

_OPT = 'opt_state/1/0/'
_OPT_COUNT = ('opt_state/1/0/.count', 'opt_state/1/1/.count')


def opt_state_to_flat(optimizer, model=None) -> Dict[str, np.ndarray]:
    """The solver's state (``engine/train.py:Optimizer``: ``moments``, a
    dict of per-parameter tensors for each of its slots, and ``count``)
    under the JAX snapshot keys; with ``model``, also the zero moments of
    its buffers that are parameters of the JAX tree (the legacy layers'
    frozen statistics)."""
    frozen = {}
    if model is not None:
        frozen = {k: torch.zeros_like(b) for k, b in model.named_buffers()
                  if not k.endswith(('.bn_mean', '.bn_var'))}
    out: Dict[str, np.ndarray] = {}
    for slot, tensors in optimizer.moments.items():
        for key, arr in flat_from_params(dict(tensors, **frozen)).items():
            out['{}.{}/{}'.format(_OPT, slot, key[len('params/'):])] = arr
    counts = _OPT_COUNT if 'mu' in optimizer.moments else _OPT_COUNT[1:]
    for key in counts:
        out[key] = np.asarray(optimizer.count, np.int32)
    return out


def opt_state_from_flat(optimizer, flat: Dict[str, np.ndarray], path=''):
    """Load the solver's state from JAX snapshot keys, in place. Every slot
    of every parameter and the step count must be in ``flat``."""
    for slot, tensors in optimizer.moments.items():
        prefix = '{}.{}/'.format(_OPT, slot)
        loaded = params_from_flat({'params/' + k[len(prefix):]: v
                                   for k, v in flat.items()
                                   if k.startswith(prefix)})
        missing = sorted(set(tensors) - set(loaded))
        if missing:
            raise KeyError('checkpoint {} is missing optimizer state {} for '
                           '{}'.format(path, slot, missing))
        with torch.no_grad():
            for name, t in tensors.items():
                if tuple(loaded[name].shape) != tuple(t.shape):
                    raise ValueError('shape mismatch for {} {}: ckpt {} vs '
                                     'model {}'.format(
                                         slot, name, tuple(loaded[name].shape),
                                         tuple(t.shape)))
                t.copy_(loaded[name])
    if _OPT_COUNT[1] not in flat:
        raise KeyError('checkpoint {} has no optimizer step count'.format(path))
    optimizer.count = int(flat[_OPT_COUNT[1]])


# --- training snapshots ------------------------------------------------------------

def snapshot_name(cfg, step: int) -> str:
    infix = ('_' + cfg.TRAIN.SNAPSHOT_INFIX) if cfg.TRAIN.SNAPSHOT_INFIX else ''
    return '{}_ctc{}_iter_{:d}.ckpt.npz'.format(
        cfg.TRAIN.SNAPSHOT_PREFIX, infix, step)


def _family_checkpoints(cfg, output_dir: str):
    """(path, step) of the snapshots of the configured PREFIX/INFIX family."""
    stem = re.escape(snapshot_name(cfg, 0)[:-len('0.ckpt.npz')])
    pattern = re.compile('^' + stem + r'(\d+)\.ckpt\.npz$')
    out = []
    for f in os.listdir(output_dir):
        m = pattern.search(f)
        if m:
            out.append((os.path.join(output_dir, f), int(m.group(1))))
    return out


def write_npz(fname: str, flat: Dict[str, np.ndarray], compressed=False):
    tmp = fname + '.tmp'
    with open(tmp, 'wb') as f:
        (np.savez_compressed if compressed else np.savez)(f, **flat)
    os.replace(tmp, fname)


def save(model, optimizer, output_dir: str, step: int, cfg,
         max_to_keep: int = 100, keep_every: int = 0) -> str:
    """Write the snapshot of ``step`` (parameters, moving BN statistics,
    optimizer state) and prune the family's older ones beyond
    ``max_to_keep``. ``keep_every`` (the solver passes SNAPSHOT_ITERS)
    exempts on-cadence snapshots from pruning, so low-loss snapshots near
    convergence cannot evict the periodic history. Another experiment's
    files in the same directory are never touched."""
    os.makedirs(output_dir, exist_ok=True)
    fname = os.path.join(output_dir, snapshot_name(cfg, step))
    flat = flat_from_params(model.state_dict())
    flat.update(opt_state_to_flat(optimizer, model))
    write_npz(fname, flat)
    ckpts = sorted(_family_checkpoints(cfg, output_dir), key=lambda x: x[1])
    prunable = [c for c in ckpts
                if not (keep_every and c[1] % keep_every == 0)]
    n_spare = max_to_keep - (len(ckpts) - len(prunable))
    for path, _ in prunable[:-n_spare] if max_to_keep and n_spare > 0 \
            else (prunable if max_to_keep else []):
        try:
            os.remove(path)
        except OSError:
            pass
    return fname


def restore(model, optimizer, path: str):
    """Load a training snapshot into ``model`` and ``optimizer``. Moving BN
    statistics may be missing (an older snapshot): the model keeps its
    own and the EMA re-converges."""
    load_into(model, path, need_bn_state=False)
    opt_state_from_flat(optimizer, read_flat(path), path)


def restore_latest(model, optimizer, output_dir: str) -> int:
    """Restore the newest snapshot in ``output_dir``; returns its step, or
    0 when there is none."""
    found = latest_checkpoint(output_dir)
    if found is None:
        return 0
    restore(model, optimizer, found[0])
    return found[1]


def save_release(model, output_dir: str, step: int, cfg,
                 dtype: str = 'float16', with_bn_state: bool = True) -> str:
    """Write a params-only release checkpoint to ``checkpoints/<EXP_DIR>/``.

    Float leaves are stored in ``dtype`` (leaves that are not finite or
    exceed f16's range stay f32); the moving BN statistics, when kept, stay
    f32."""
    rel_dir = release_dir(output_dir)
    os.makedirs(rel_dir, exist_ok=True)
    out = {}
    for k, v in flat_from_params(model.state_dict()).items():
        if k.startswith('bn_state/'):
            if with_bn_state:
                out[k] = v
        elif dtype and v.dtype == np.float32 and np.all(np.isfinite(v)) \
                and np.abs(v).max() < 6e4:
            out[k] = v.astype(dtype)
        else:
            out[k] = v
    fname = os.path.join(rel_dir, snapshot_name(cfg, step))
    write_npz(fname, out, compressed=True)
    return fname
