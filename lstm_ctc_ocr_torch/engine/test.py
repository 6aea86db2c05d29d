"""Evaluation: decode a directory of labelled images.

Counterpart of the JAX package's ``engine/test.py``. It restores the newest
checkpoint from ``output/<EXP_DIR>/`` (falling back to the tracked release in
``checkpoints/<EXP_DIR>/``), reads every ``{idx}_{label}.png``, pads its width
to a bucket, decodes it (CRNN forward + greedy or beam CTC decode, by
``DECODER``) and scores exact matches against the label in the filename.

``TEST.BATCH_SIZE`` 1 decodes one image at a time; larger sizes group images
by width bucket and decode fixed-size batches, padding a short chunk with
copies of its last image — under ``BN_EVAL: batch`` those rows enter the
batch-norm statistics, so the padding has to match the JAX package's.

Data parallel (the JAX eval's mesh, ``engine/test.py:150-176``): under a
process group whose ranks divide ``TEST.BATCH_SIZE`` (and ``PARALLEL`` not
``off``), each rank loads and decodes its rows of every batch with the
batch-norm statistics of the whole batch, the decoded ids are all-gathered,
and rank 0 prints what a single process prints.

Run (the flags of the JAX package's ``lstm/test_net.py``, and ``test.sh``'s
line; ``--set`` takes the rest of the line, so ``--device`` comes before
it)::

    python -m lstm_ctc_ocr_torch.engine.test --network=LSTM_test \
        --cfg=./lstm/lstm.yml --restore=1 [--test_dir data/val] \
        [--device cpu] [--set TEST.BATCH_SIZE 64 ...]

The device is CUDA unless ``--device cpu`` is given; without CUDA it raises
rather than fall back. Under torchrun it runs a rank a process.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from ..config import get_encode_decode_dict, get_output_dir, load_cfg
from ..data.gen import pick_bucket
from ..data.image import load_image, png_size, preprocess_image
from ..data.records import parse_label_from_filename
from ..models.factory import get_network
from ..ops.beam import beam_decode
from ..ops.decoder import greedy_decode
from ..parallel import mesh as pmesh
from ..utils.profiler import count, span
from ..utils.timer import Timer
from . import checkpoint

_DTYPES = {'bfloat16': torch.bfloat16, 'float32': None}


@dataclasses.dataclass
class EvalResult:
    correct: int
    total: int
    p50: float                   # seconds of decode per image (amortized)
    images_per_sec: float        # all images over the whole loop's wall time
    steady_images_per_sec: float  # excluding each bucket's first decode call
    decode_calls: int
    predictions: Dict[str, str]  # file name -> decoded string

    @property
    def acc(self) -> float:
        return self.correct / max(self.total, 1)


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; raises for CUDA when CUDA is missing."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('CUDA is not available; pass device="cpu" '
                           '(--device cpu) to run on the CPU')
    return dev


@contextlib.contextmanager
def full_f32():
    """f32 convs and matmuls in full f32 (no TF32), as the JAX reference
    computes them, for the time of an entry point's run; the process's
    settings are put back afterwards. Also a decorator."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def decode_ids(nums, decode_maps, ignore=0) -> str:
    """Ids -> string; ids outside the charset (a 64-class head over 62
    chars) decode to ''."""
    return ''.join(decode_maps.get(int(i), '') for i in np.asarray(nums).ravel()
                   if int(i) != ignore)


def prepare_single(img: np.ndarray, cfg):
    """Eval preprocessing of one grayscale image, bucket-padded.

    Returns (image [1, W_pad, 32] float32, time_step [1] int32)."""
    out, ts = preprocess_image(
        img, img_height=int(cfg.IMG_HEIGHT),
        num_features=int(cfg.NUM_FEATURES), pool_scale=int(cfg.POOL_SCALE),
        offset_time_step=int(cfg.OFFSET_TIME_STEP),
        pick=lambda w: pick_bucket(w, cfg.BUCKETS))
    return out[None], np.array([ts], np.int32)


def decode_fn(model, cfg, bn_group=None):
    """The live decode as tensors: images [N, W, 32] f32 and steps [N]
    int32 on the model's device -> decoded ids [N, T] int32 — the forward
    in ``TRAIN.DTYPE`` with the ``BN_EVAL`` statistics, then greedy or beam
    decode as ``DECODER`` says. Runs in the caller's grad mode. With a
    process group, ``BN_EVAL: batch`` takes the statistics of every rank's
    rows. Under a ``torch.profiler`` trace the forward is the span
    ``eval.forward`` and the beam search ``eval.beam``; a beam call adds
    its frames (T) to the counter ``beam.frames``."""
    dtype = _DTYPES[str(cfg.TRAIN.DTYPE)]
    moving = str(cfg.BN_EVAL) == 'moving'
    beam = str(cfg.DECODER) == 'beam'
    width, merge = int(cfg.BEAM_WIDTH), bool(cfg.BEAM_MERGE_REPEATED)

    def decode(x, lens):
        with span('eval.forward'):
            logits = model(x, lens, dtype=dtype, moving_bn=moving,
                           bn_group=bn_group).transpose(0, 1)
        if beam:
            count('beam.frames', logits.shape[1])
            with span('eval.beam'):
                return beam_decode(logits, lens, beam_width=width,
                                   merge_repeated=merge)
        return greedy_decode(logits, lens)
    return decode


def make_decode_step(model, cfg, device, mesh=None):
    """images [N, W, 32] f32 numpy, steps [N] int32 -> decoded ids [N, T]
    int32 numpy; the copy back to the host waits for the device. With a
    ``mesh``: this rank's rows of a global batch, decoded with the batch
    statistics of every rank's rows. A decode runs the model in eval mode
    (a DSL net's dropout is off), and leaves its mode as it was. Under a
    ``torch.profiler`` trace the copies are the spans ``eval.upload`` and
    ``eval.readback`` (waiting for the device), around :func:`decode_fn`'s."""
    decode = decode_fn(model, cfg, mesh.group if mesh is not None else None)

    @torch.inference_mode()
    def decode_step(images, steps):
        training = model.training
        if training:
            model.eval()
        try:
            with span('eval.upload'):
                x = torch.from_numpy(images).to(device)
                lens = torch.from_numpy(steps).to(device)
            ids = decode(x, lens)
            with span('eval.readback'):
                return ids.cpu().numpy()
        finally:
            if training:
                model.train()
    return decode_step


def _eval_mesh(cfg, device, batch):
    """The DP mesh of a batched eval: every rank of the process group when
    the ranks divide the batch and ``PARALLEL`` is not ``off``, else None
    (each rank decodes every batch alone)."""
    world = pmesh.world_size()
    if batch > 1 and str(cfg.PARALLEL) != 'off' and world > 1 \
            and batch % world == 0:
        return pmesh.make_mesh(device)
    return None


@full_f32()
def test_net(cfg, test_dir: str, output_dir: str = None, device='cuda',
             echo: Callable[[str], None] = print, model=None,
             restore: bool = True) -> EvalResult:
    """Evaluate the newest checkpoint of ``cfg.EXP_DIR`` on ``test_dir``.

    ``echo`` receives the per-image and summary lines (rank 0's only, under
    a process group). ``model`` is the network to restore into (a
    ``models/crnn.py`` subclass, say); the default is the factory's
    ``LSTM_test``, initialised from ``RNG_SEED``. ``restore=False``
    evaluates that initialised network, as the JAX ``restore=0`` does."""
    dev = resolve_device(device)
    if pmesh.world_size() > 1 and torch.distributed.get_rank() != 0:
        def echo(_):
            pass
    if model is None:
        model = get_network('LSTM_test', cfg, generator=torch.Generator()
                            .manual_seed(int(cfg.RNG_SEED)))
    if restore:
        if output_dir is None:
            output_dir = get_output_dir(cfg)
        found = checkpoint.latest_eval_checkpoint(output_dir)
        if found is None:
            raise RuntimeError(
                'no checkpoint found in {} (nor released weights in {})'
                .format(output_dir, checkpoint.release_dir(output_dir)))
        path, step = found
        checkpoint.load_into(model, path, str(cfg.BN_EVAL) == 'moving')
        echo('Restored {} (step {})'.format(path, step))
    else:
        echo('Evaluating the initialised network (no restore)')
    model = model.to(dev).eval()
    _, decode_maps = get_encode_decode_dict(cfg)
    entries = sorted(os.listdir(test_dir))
    files = [f for f in entries if parse_label_from_filename(f) is not None]
    if len(files) < len(entries):
        echo('skipping {} non-dataset entries in {}'.format(
            len(entries) - len(files), test_dir))
    batch = int(cfg.TEST.BATCH_SIZE)
    mesh = _eval_mesh(cfg, dev, batch)
    if mesh is not None:
        echo('eval DP over {} ranks ({})'.format(mesh.size, mesh.backend))
    decode_step = make_decode_step(model, cfg, dev, mesh=mesh)
    if batch > 1:
        return _test_batched(cfg, decode_step, decode_maps, test_dir, files,
                             batch, echo, mesh)
    timer = Timer()
    latencies: List[float] = []
    warm: List[float] = []                  # calls at an already-seen width
    seen = set()
    predictions: Dict[str, str] = {}
    correct = 0
    t0 = time.perf_counter()
    for fname in files:
        timer.tic()
        image, time_step = prepare_single(
            load_image(os.path.join(test_dir, fname)), cfg)
        td = time.perf_counter()
        ids = decode_step(image, time_step)[0]
        latencies.append(time.perf_counter() - td)
        if image.shape[1] in seen:
            warm.append(latencies[-1])
        seen.add(image.shape[1])
        res = decode_ids(ids, decode_maps)
        predictions[fname] = res
        correct += int(parse_label_from_filename(fname) == res)
        echo('{} cost time: {:.3f},\n    res: {}'.format(
            fname, timer.toc(average=False), res))
    dt = time.perf_counter() - t0
    result = EvalResult(
        correct=correct, total=len(files),
        p50=float(np.percentile(latencies, 50)) if latencies else 0.0,
        images_per_sec=len(files) / dt if dt > 0 else 0.0,
        steady_images_per_sec=len(warm) / sum(warm) if sum(warm) > 0 else 0.0,
        decode_calls=len(files), predictions=predictions)
    _summary(result, echo, batch)
    return result


def files_by_bucket(cfg, test_dir: str, files) -> Dict[int, List[str]]:
    """Width bucket -> the ``files`` of ``test_dir`` that fall in it, in
    their order: the batched eval's grouping, from the PNG headers."""
    by_bucket: Dict[int, List[str]] = {}
    for fname in files:
        w, h = png_size(os.path.join(test_dir, fname))
        if h != cfg.IMG_HEIGHT:
            w = int(cfg.IMG_HEIGHT / h * w)
        by_bucket.setdefault(pick_bucket(w, cfg.BUCKETS), []).append(fname)
    return by_bucket


def _test_batched(cfg, decode_step, decode_maps, test_dir, files, batch, echo,
                  mesh=None):
    """Images grouped by width bucket and decoded ``batch`` at a time; the
    p50 is each batch's decode time over ``batch`` (the device computes the
    padded rows too). With a ``mesh`` each rank loads and decodes its rows
    of the padded batch, and the ids are gathered back in batch order."""
    by_bucket = files_by_bucket(cfg, test_dir, files)
    latencies: List[float] = []
    chunk_times = []                        # (n_images, seconds, is_warm)
    predictions: Dict[str, str] = {}
    correct = 0
    t0 = time.perf_counter()
    for _, names in sorted(by_bucket.items()):
        for i in range(0, len(names), batch):
            chunk = names[i:i + batch]
            # a short chunk is padded with copies of its last image
            rows = chunk + [chunk[-1]] * (batch - len(chunk))
            if mesh is not None:
                rows = rows[pmesh.batch_sharded(mesh, batch)[0]]
            loaded = {}                     # each file read once
            for f in rows:
                if f not in loaded:
                    loaded[f] = prepare_single(
                        load_image(os.path.join(test_dir, f)), cfg)
            images = np.concatenate([loaded[f][0] for f in rows])
            steps = np.concatenate([loaded[f][1] for f in rows])
            tb = time.perf_counter()
            dec = decode_step(images, steps)
            if mesh is not None:
                dec = pmesh.gather_rows(mesh, torch.from_numpy(dec)).numpy()
            secs = time.perf_counter() - tb
            chunk_times.append((len(chunk), secs, i > 0))
            latencies.extend([secs / batch] * len(chunk))
            for fname, ids in zip(chunk, dec):
                res = decode_ids(ids, decode_maps)
                predictions[fname] = res
                correct += int(parse_label_from_filename(fname) == res)
                echo('{}    res: {}'.format(fname, res))
    dt = time.perf_counter() - t0
    warm_n = sum(k for k, _, w in chunk_times if w)
    warm_s = sum(s for _, s, w in chunk_times if w)
    result = EvalResult(
        correct=correct, total=len(files),
        p50=float(np.percentile(latencies, 50)) if latencies else 0.0,
        images_per_sec=len(files) / dt if dt > 0 else 0.0,
        steady_images_per_sec=warm_n / warm_s if warm_s > 0 else 0.0,
        decode_calls=len(chunk_times), predictions=predictions)
    _summary(result, echo, batch)
    return result


def _summary(r: EvalResult, echo, batch):
    echo('total acc:{}/{}={:.4f}'.format(r.correct, r.total, r.acc))
    echo('p50 decode latency: {:.6f}s per image (batch {})'.format(r.p50, batch))
    echo('decode: {:.1f} images/sec total, {:.1f} images/sec steady-state '
         '(excl. each bucket\'s first call), {} decode calls'.format(
             r.images_per_sec, r.steady_images_per_sec, r.decode_calls))


def parse_args(argv=None):
    """The flags of the JAX package's ``lstm/test_net.py`` (``test.sh``'s
    line parses as it does there), and ``--device``."""
    parser = argparse.ArgumentParser(
        description='Evaluate a CRNN+CTC checkpoint with the PyTorch port')
    parser.add_argument('--gpu', dest='gpu_id', default=0, type=int,
                        help='CUDA device index')
    parser.add_argument('--cfg', dest='cfg_file', default=None, type=str,
                        help='YAML experiment config merged over the defaults')
    parser.add_argument('--network', dest='network_name',
                        default='LSTM_test', type=str,
                        help='model name to build (LSTM_test)')
    parser.add_argument('--set', dest='set_cfgs', default=None,
                        nargs=argparse.REMAINDER,
                        help='dotted-path config overrides: KEY VALUE ... '
                             '(takes the rest of the line: put --device and '
                             'the other flags before it)')
    parser.add_argument('--restore', dest='restore', default=1, type=int,
                        help='1: load the latest checkpoint from the output '
                             'dir (or the release); 0: evaluate the '
                             'initialised network')
    parser.add_argument('--test_dir', dest='test_dir', default='./data/val/',
                        type=str,
                        help='directory of {idx}_{label}.png test images')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu' (gloo between ranks)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = load_cfg(args.cfg_file, args.set_cfgs or [])
    owned = not torch.distributed.is_initialized()
    pmesh.init_distributed(device=args.device)
    try:
        device = args.device
        if device == 'cuda':
            device = 'cuda:{}'.format(
                torch.cuda.current_device()
                if torch.distributed.is_initialized() else args.gpu_id)
        model = get_network(args.network_name, cfg,
                            generator=torch.Generator().manual_seed(
                                int(cfg.RNG_SEED)))
        result = test_net(cfg, args.test_dir, device=device, model=model,
                          restore=bool(args.restore))
    finally:
        if owned and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    return 0 if result.total else 1


if __name__ == '__main__':
    sys.exit(main())
