"""A released ``.ckpt.npz`` as the reference's dictionary of tensors.

The file's keys are the JAX package's: ``params/<layer>/kernel`` in HWIO
``[kW, kH, C_in, C_out]``, ``params/<layer>/biases``, the BN scale and
shift, ``params/logits/cells/<dir>/kernel`` ``[D + H, 4H]`` (input rows,
then recurrent rows) and ``bias``, ``params/logits/weights`` / ``biases``,
and ``bn_state/<layer>/mean`` / ``var``. Leaves may be stored in float16;
they are read as float32.
"""

from __future__ import annotations

import numpy as np
import torch


def load_release(path, device):
    """``{key: f32 tensor on device}`` in :mod:`model`'s naming."""
    out = {}
    with np.load(path) as z:
        for key in z.files:
            arr = np.asarray(z[key]).astype(np.float32)
            parts = key.split('/')
            if parts[0] == 'bn_state':
                out['{}.bn_{}'.format(parts[1], parts[2])] = arr
                continue
            if parts[0] != 'params':
                continue
            layer, leaf = '.'.join(parts[1:-1]), parts[-1]
            if len(parts) >= 4 and parts[-3] == 'cells' and leaf == 'kernel':
                h = arr.shape[1] // 4
                out[layer + '.w'] = arr[:arr.shape[0] - h]
                out[layer + '.u'] = arr[arr.shape[0] - h:]
            elif leaf == 'kernel':
                out[layer + '.kernel'] = arr.transpose(3, 2, 0, 1)
            else:
                out['{}.{}'.format(layer, leaf)] = arr
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in out.items()}
