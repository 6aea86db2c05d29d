"""Checkpoint files and the weight bridge between the JAX layout and the port.

Counterpart of the JAX package's ``engine/checkpoint.py``. A checkpoint is a
flat ``.npz`` whose keys are ``/``-joined tree paths (``params/conv1/kernel``,
``params/logits/cells/fw/kernel``, ``bn_state/conv4_1/mean``, ...), named
``*_iter_<step>.ckpt.npz``. Training snapshots live in ``output/<EXP_DIR>/``;
the tracked release weights in ``checkpoints/<EXP_DIR>/`` are the fallback
for eval. Releases store float leaves in f16.

The bridge, :func:`params_from_flat` and its exact inverse
:func:`flat_from_params`, maps those keys 1:1 onto the port's
``state_dict`` names (``models/crnn.py``):

* an HWIO conv kernel ``[kW, kH, C_in, C_out]`` <-> ``[C_out, C_in, kW, kH]``
  (``permute(3, 2, 0, 1)``; the first spatial axis stays the width axis);
* an LSTM ``kernel [D+H, 4H]`` <-> ``w = kernel[:D]`` and ``u = kernel[D:]``,
  gate order unchanged;
* ``bn_state/<layer>/{mean,var}`` <-> the ``<layer>.bn_{mean,var}`` buffers;
* float leaves (f16 in releases) become f32.
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


def params_from_flat(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """JAX flat checkpoint keys -> the port's ``state_dict`` entries.

    Keys outside ``params/`` and ``bn_state/`` (a training snapshot's
    optimizer state) are not model state and are left out."""
    out: Dict[str, torch.Tensor] = {}
    for key, arr in flat.items():
        parts = key.split('/')
        if parts[0] == 'bn_state' and len(parts) == 3:
            out['{}.bn_{}'.format(parts[1], parts[2])] = _f32(arr)
        elif parts[0] == 'params' and parts[2:3] == ['cells']:
            layer, direction, leaf = parts[1], parts[3], parts[4]
            prefix = '{}.cells.{}.'.format(layer, direction)
            if leaf == 'kernel':
                h_dim = arr.shape[1] // 4
                d = arr.shape[0] - h_dim
                out[prefix + 'w'] = _f32(arr[:d])
                out[prefix + 'u'] = _f32(arr[d:])
            else:
                out[prefix + leaf] = _f32(arr)
        elif parts[0] == 'params' and len(parts) == 3:
            t = _f32(arr)
            if parts[2] == 'kernel' and t.dim() == 4:
                t = t.permute(3, 2, 0, 1).contiguous()
            out['{}.{}'.format(parts[1], parts[2])] = t
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
        if parts[1:2] == ['cells']:
            layer, direction, leaf = parts[0], parts[2], parts[3]
            base = 'params/{}/cells/{}/'.format(layer, direction)
            if leaf in ('w', 'u'):
                cells.setdefault(base, {})[leaf] = arr
            else:
                out[base + leaf] = arr
        elif parts[1] in ('bn_mean', 'bn_var'):
            out['bn_state/{}/{}'.format(parts[0], parts[1][3:])] = arr
        else:
            if parts[1] == 'kernel' and arr.ndim == 4:
                arr = np.ascontiguousarray(arr.transpose(2, 3, 1, 0))
            out['params/{}/{}'.format(parts[0], parts[1])] = arr
    for base, wu in cells.items():
        out[base + 'kernel'] = np.concatenate([wu['w'], wu['u']], axis=0)
    return out


def load_into(model: torch.nn.Module, path: str, need_bn_state: bool):
    """Restore ``model`` from the checkpoint at ``path``.

    Every parameter must be in the file. The moving BN statistics may be
    missing only when ``need_bn_state`` is false; the model then keeps its
    initial ones (the JAX eval path reads them only under ``BN_EVAL:
    moving``)."""
    state = params_from_flat(read_flat(path))
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
