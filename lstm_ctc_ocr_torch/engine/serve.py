"""Serving export: freeze the decode path into one program per width bucket.

Counterpart of the JAX package's ``engine/serve.py``, with the same names.
:func:`export_decoder` wraps the live decode (``engine/test.py:decode_fn``:
the forward, logits to time-major, then greedy or beam decode as
``DECODER`` says) in a module and exports it with ``torch.export.export``
once per bucket, at a static ``[batch, W, NUM_FEATURES]`` shape, so a server
never traces again; ``torch.export.save`` writes each program, parameters
and (under ``BN_EVAL: moving``) the moving statistics included, as
``decode_w{W}.pt2`` beside a ``manifest.json`` with the JAX manifest's keys.
:class:`ExportedDecoder` loads such a directory and serves decode requests
with eval's preprocessing.

Where the JAX package exports its portable ``lax.scan`` path, the port's
program keeps the hand kernels: the BiLSTM and LSTM recurrences are the
custom ops ``lstm_ctc_ocr_torch::bilstm_fwd`` / ``::lstm_fwd``
(``ops/custom_ops.py``), one node each, which on the card launch kernels 1
and 5 and on the CPU run their plain versions. Loading an artifact
therefore needs ``lstm_ctc_ocr_torch`` importable: this module imports the
ops before ``torch.export.load``. A program runs on the device type it was
exported for (``platforms`` in the manifest); the loader raises for
another.

As in the JAX package, under the default ``BN_EVAL: batch`` batch norm
uses the batch's statistics, so a decoded string can depend on what else
is in its batch; the loader pads a short chunk with copies of its last
image, as eval does, so that serving a directory in eval's order gives
eval's batches. Export under ``BN_EVAL: moving`` (a checkpoint with moving
statistics, e.g. from ``tools/calibrate_bn.py``) for strings that do not.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Sequence

import numpy as np
import torch
from torch import nn

from ..data.image import preprocess_image
from ..models.layers import ConvSingle
from ..ops import custom_ops  # noqa: F401  (registers the programs' ops)
from ..utils.profiler import count, span
from . import graphs
from .test import decode_fn, decode_ids, full_f32, resolve_device

MANIFEST = 'manifest.json'


def _artifact_name(width: int) -> str:
    return 'decode_w{}.pt2'.format(width)


def has_bn_state(model: nn.Module) -> bool:
    """Whether some batch-norm layer's moving statistics differ from their
    initial values (mean 0, var 1): what a restored ``bn_state`` or the
    train step's moving average leaves and a fresh model lacks."""
    return any(bool((m.bn_mean != 0).any()) or bool((m.bn_var != 1).any())
               for m in model.modules() if isinstance(m, ConvSingle) and m.bn)


class _Decode(nn.Module):
    """The live decode as one module: (images [N, W, F] f32, steps [N]
    int32) -> ids [N, T] int32, under ``torch.no_grad`` (export does not
    take ``inference_mode``)."""

    def __init__(self, model, cfg):
        super().__init__()
        self.model = model
        self._decode = decode_fn(model, cfg)

    def forward(self, images, steps):
        return self._decode(images, steps)


def export_decoder(model, cfg, out_dir: str,
                   buckets: Sequence[int] | None = None,
                   batch: int | None = None, device='cuda') -> Dict:
    """Write per-bucket decode programs + manifest; returns the manifest.

    ``model`` (an ``LSTM_test`` or a ``make_head`` subclass) is moved to
    ``device`` and frozen into each program with its parameters and BN
    buffers. ``cfg`` gives the decoder, compute dtype, ``BN_EVAL``, charset
    and preprocessing. Under ``BN_EVAL: moving`` the model must carry moving
    statistics (:func:`has_bn_state`), else ``ValueError``. The manifest
    also records each bucket's export seconds (``export_seconds``)."""
    dev = resolve_device(device)
    buckets = sorted(int(b) for b in (buckets or cfg.BUCKETS))
    batch = int(batch or cfg.TEST.BATCH_SIZE)
    if str(cfg.BN_EVAL) == 'moving' and not has_bn_state(model):
        raise ValueError('BN_EVAL=moving export requires bn_state (restore a '
                         'bn_state-bearing checkpoint or run '
                         'tools/calibrate_bn.py)')
    os.makedirs(out_dir, exist_ok=True)
    program = _Decode(model.to(dev).eval(), cfg)
    seconds = {}
    for w in buckets:
        images = torch.zeros(batch, w, int(cfg.NUM_FEATURES), device=dev)
        steps = torch.full((batch,), w // int(cfg.POOL_SCALE)
                           + int(cfg.OFFSET_TIME_STEP), dtype=torch.int32,
                           device=dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            exported = torch.export.export(program, (images, steps),
                                           strict=False)
        torch.export.save(exported, os.path.join(out_dir, _artifact_name(w)))
        seconds[str(w)] = time.perf_counter() - t0

    manifest = {
        'buckets': buckets,
        'batch': batch,
        'platforms': [dev.type],
        'charset': str(cfg.CHARSET),
        'nclasses': int(cfg.NCLASSES),
        'decoder': str(cfg.DECODER),
        'img_height': int(cfg.IMG_HEIGHT),
        'num_features': int(cfg.NUM_FEATURES),
        'pool_scale': int(cfg.POOL_SCALE),
        'offset_time_step': int(cfg.OFFSET_TIME_STEP),
        'bn_eval': str(cfg.BN_EVAL),
        'export_seconds': seconds,
    }
    with open(os.path.join(out_dir, MANIFEST), 'w') as f:
        json.dump(manifest, f, indent=1)
    return manifest


class ExportedDecoder:
    """Load an :func:`export_decoder` directory and serve decode requests.

    ``decode_images(imgs)`` takes grayscale uint8/float arrays of any width
    (height anything — resized to the manifest height) and returns decoded
    strings, batching per width bucket exactly like eval. ``calls`` counts
    the programs' calls.

    On a CUDA device each bucket's program is captured as a CUDA graph on
    its first call and replayed after (:meth:`run`), so a later call costs
    the host an input copy and one graph launch, not the program's walk
    of its ~160 nodes; on the CPU the programs run eagerly. The graphs
    share static input and output buffers, so a decoder serves one caller
    at a time: :meth:`run` holds the decoder's lock from the copy in to
    the ids' copy out, and threads sharing a decoder take turns there.

    Under a ``torch.profiler`` trace (``utils/profiler.py``) a request is
    the span ``serve.request``, holding ``serve.prepare`` (resize and
    bucket padding of its images), then per chunk ``serve.pad`` (stacking
    and padding to the batch), the program call's ``serve.upload``,
    ``serve.enqueue`` (on the host: the graph's replay, or the program's
    eager run, at a capture both the warm-up and the capture) and
    ``serve.readback`` (waiting for the device), and ``serve.to_strings``;
    the counters ``serve.images`` (images asked for), ``serve.rows`` (rows
    the programs computed, padding included) and ``serve.graph_replays``
    (program calls served by a replay)."""

    def __init__(self, export_dir: str, device='cuda'):
        self.device = resolve_device(device)
        with open(os.path.join(export_dir, MANIFEST)) as f:
            self.manifest = json.load(f)
        self.manifest['buckets'] = sorted(
            int(b) for b in self.manifest['buckets'])
        if self.device.type not in self.manifest['platforms']:
            raise ValueError('{} holds programs exported for {}; they cannot '
                             'serve on {}'.format(export_dir,
                                                  self.manifest['platforms'],
                                                  self.device.type))
        self._programs = {}
        for w in self.manifest['buckets']:
            path = os.path.join(export_dir, _artifact_name(w))
            self._programs[int(w)] = torch.export.load(path).module()
        # charset comes from the MANIFEST, not the loading process's cfg —
        # the artifact decodes in a process that never loaded the config
        self._decode_maps = {0: ''}
        for i, c in enumerate(self.manifest['charset'], 1):
            self._decode_maps[i] = c
        self.calls = 0
        # the captured programs by their inputs' shapes and dtypes, the
        # captures' side stream and the memory pool the graphs share
        # (their calls never overlap: the lock)
        self._graphs: Dict[tuple, graphs.Graph] = {}
        if self.device.type == 'cuda':
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        self._lock = threading.Lock()

    def _pick_bucket(self, width: int) -> int:
        for b in self.manifest['buckets']:
            if b >= width:
                return int(b)
        raise ValueError('image width {} exceeds largest exported bucket {}'
                         .format(width, self.manifest['buckets'][-1]))

    def _prepare(self, img: np.ndarray):
        m = self.manifest
        img = np.asarray(img)
        if np.issubdtype(img.dtype, np.floating):
            # floats are 0..1 normalized by contract; 0..255-scale floats
            # are clipped (never wrapped) as a convenience
            img = np.clip(img, 0, 1) * 255 if img.max() <= 1.0 \
                else np.clip(img, 0, 255)
        img = img.astype(np.uint8)
        out, ts = preprocess_image(
            img, img_height=m['img_height'], num_features=m['num_features'],
            pool_scale=m['pool_scale'],
            offset_time_step=m['offset_time_step'], pick=self._pick_bucket)
        return out.shape[0], out, ts

    def decode_ids_array(self, ids: np.ndarray) -> str:
        return decode_ids(ids, self._decode_maps)

    def run(self, images: np.ndarray, steps: np.ndarray) -> np.ndarray:
        """One program call: images [batch, W, F] f32 at an exported bucket
        W, steps [batch] int32 -> ids [batch, T] int32 numpy.

        On a CUDA device the first call with these shapes runs the program
        on a side stream (the warm-up, whose ids are the call's), then
        captures it as a CUDA graph over the inputs' device copies
        (``engine/graphs.py:capture``); every later call copies its inputs
        into those static buffers, replays the graph and copies the ids
        out. The graph runs the eager program's kernels in the same order
        on the same inputs, so its ids are the eager program's, bit for
        bit. A capture that fails raises; nothing falls back to the eager
        program."""
        key = tuple((a.shape, a.dtype) for a in (images, steps))
        with self._lock, full_f32():
            graph = self._graphs.get(key)
            with span('serve.upload'):
                if graph is None:
                    x = torch.from_numpy(images).to(self.device)
                    lens = torch.from_numpy(steps).to(self.device)
                else:
                    x, lens = graph.inputs
                    x.copy_(torch.from_numpy(images))
                    lens.copy_(torch.from_numpy(steps))
            program = self._programs[images.shape[1]]
            with span('serve.enqueue'):
                if graph is not None:
                    graph.replay()
                    ids = graph.outputs
                    count('serve.graph_replays')
                elif self.device.type == 'cuda':
                    ids, self._graphs[key] = graphs.capture(
                        lambda: program(x, lens), (x, lens), self._stream,
                        self._pool,
                        'the served W={} program'.format(images.shape[1]))
                else:
                    ids = program(x, lens)
            self.calls += 1
            count('serve.rows', images.shape[0])
            with span('serve.readback'):
                return ids.cpu().numpy()

    def decode_images(self, imgs: List[np.ndarray]) -> List[str]:
        batch = int(self.manifest['batch'])
        count('serve.images', len(imgs))
        with span('serve.request'):
            with span('serve.prepare'):
                prepared = [self._prepare(im) for im in imgs]
            results: List[str] = [''] * len(imgs)
            by_bucket: Dict[int, List[int]] = {}
            for i, (bucket, _, _) in enumerate(prepared):
                by_bucket.setdefault(bucket, []).append(i)
            for _, idxs in sorted(by_bucket.items()):
                for start in range(0, len(idxs), batch):
                    chunk = idxs[start:start + batch]
                    pad = batch - len(chunk)
                    with span('serve.pad'):
                        images = np.stack([prepared[i][1] for i in chunk]
                                          + [prepared[chunk[-1]][1]] * pad)
                        steps = np.array([prepared[i][2] for i in chunk]
                                         + [prepared[chunk[-1]][2]] * pad,
                                         np.int32)
                    ids = self.run(images, steps)
                    with span('serve.to_strings'):
                        for i, row in zip(chunk, ids):
                            results[i] = self.decode_ids_array(row)
        return results
