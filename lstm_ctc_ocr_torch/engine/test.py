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

Run::

    python -m lstm_ctc_ocr_torch.engine.test --cfg lstm/lstm.yml \
        --test_dir data/val --set TEST.BATCH_SIZE 64 [--device cpu]

The device is CUDA unless ``--device cpu`` is given; without CUDA it raises
rather than fall back.
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


def decode_fn(model, cfg):
    """The live decode as tensors: images [N, W, 32] f32 and steps [N]
    int32 on the model's device -> decoded ids [N, T] int32 — the forward
    in ``TRAIN.DTYPE`` with the ``BN_EVAL`` statistics, then greedy or beam
    decode as ``DECODER`` says. Runs in the caller's grad mode."""
    dtype = _DTYPES[str(cfg.TRAIN.DTYPE)]
    moving = str(cfg.BN_EVAL) == 'moving'
    beam = str(cfg.DECODER) == 'beam'
    width, merge = int(cfg.BEAM_WIDTH), bool(cfg.BEAM_MERGE_REPEATED)

    def decode(x, lens):
        logits = model(x, lens, dtype=dtype, moving_bn=moving).transpose(0, 1)
        if beam:
            return beam_decode(logits, lens, beam_width=width,
                               merge_repeated=merge)
        return greedy_decode(logits, lens)
    return decode


def make_decode_step(model, cfg, device):
    """images [N, W, 32] f32 numpy, steps [N] int32 -> decoded ids [N, T]
    int32 numpy; the copy back to the host waits for the device."""
    decode = decode_fn(model, cfg)

    @torch.inference_mode()
    def decode_step(images, steps):
        return decode(torch.from_numpy(images).to(device),
                      torch.from_numpy(steps).to(device)).cpu().numpy()
    return decode_step


@full_f32()
def test_net(cfg, test_dir: str, output_dir: str = None, device='cuda',
             echo: Callable[[str], None] = print, model=None) -> EvalResult:
    """Evaluate the newest checkpoint of ``cfg.EXP_DIR`` on ``test_dir``.

    ``echo`` receives the per-image and summary lines. ``model`` is the
    network to restore into (a ``models/crnn.py`` subclass, say); the
    default is the factory's ``LSTM_test``."""
    dev = resolve_device(device)
    if output_dir is None:
        output_dir = get_output_dir(cfg)
    found = checkpoint.latest_eval_checkpoint(output_dir)
    if found is None:
        raise RuntimeError('no checkpoint found in {} (nor released weights '
                           'in {})'.format(output_dir,
                                           checkpoint.release_dir(output_dir)))
    path, step = found
    if model is None:
        model = get_network('LSTM_test', cfg)
    checkpoint.load_into(model, path, str(cfg.BN_EVAL) == 'moving')
    model = model.to(dev).eval()
    echo('Restored {} (step {})'.format(path, step))
    _, decode_maps = get_encode_decode_dict(cfg)
    entries = sorted(os.listdir(test_dir))
    files = [f for f in entries if parse_label_from_filename(f) is not None]
    if len(files) < len(entries):
        echo('skipping {} non-dataset entries in {}'.format(
            len(entries) - len(files), test_dir))
    decode_step = make_decode_step(model, cfg, dev)
    batch = int(cfg.TEST.BATCH_SIZE)
    if batch > 1:
        return _test_batched(cfg, decode_step, decode_maps, test_dir, files,
                             batch, echo)
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


def _test_batched(cfg, decode_step, decode_maps, test_dir, files, batch, echo):
    """Images grouped by width bucket and decoded ``batch`` at a time; the
    p50 is each batch's decode time over ``batch`` (the device computes the
    padded rows too)."""
    by_bucket = files_by_bucket(cfg, test_dir, files)
    latencies: List[float] = []
    chunk_times = []                        # (n_images, seconds, is_warm)
    predictions: Dict[str, str] = {}
    correct = 0
    t0 = time.perf_counter()
    for _, names in sorted(by_bucket.items()):
        for i in range(0, len(names), batch):
            chunk = names[i:i + batch]
            loaded = [prepare_single(load_image(os.path.join(test_dir, f)),
                                     cfg) for f in chunk]
            pad = batch - len(loaded)
            images = np.concatenate([x[0] for x in loaded]
                                    + [loaded[-1][0]] * pad)
            steps = np.concatenate([x[1] for x in loaded]
                                   + [loaded[-1][1]] * pad)
            tb = time.perf_counter()
            dec = decode_step(images, steps)
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


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Evaluate a CRNN+CTC checkpoint with the PyTorch port')
    parser.add_argument('--cfg', dest='cfg_file', default=None,
                        help='YAML experiment config merged over the defaults')
    parser.add_argument('--test_dir', default='./data/val/',
                        help='directory of {idx}_{label}.png test images')
    parser.add_argument('--set', dest='set_cfgs', default=[], nargs='+',
                        help='dotted-path config overrides: KEY VALUE ...')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    cfg = load_cfg(args.cfg_file, args.set_cfgs)
    result = test_net(cfg, args.test_dir, device=args.device)
    return 0 if result.total else 1


if __name__ == '__main__':
    sys.exit(main())
