"""Decode-path bench: greedy against beam, per bucket.

Counterpart of the JAX package's ``tools/bench_decode.py``, with its flags,
defaults and JSON keys. Times the FULL decode step (the evaluation's
``engine/test.py:make_decode_step``: the images to the device, the CRNN
forward with the BiLSTM kernel ``csrc/bilstm_fwd.cu``, the decoder, the ids
back to the host) and the decoder alone, for both decoders, at batch 64 on
two shapes:

* ``default_W96``: the default config's modal bucket (W=96, T=23);
* ``longline_W448``: a longline bucket (W=448, T=111) with the longline
  geometry (``MIN_LEN 20``, ``MAX_LEN 24``, ``MAX_CHAR_LEN 24``);

then the ``beam_over_greedy_full_step`` line. Each time is the median of
windows of calls, each window closed by the decoded ids' readback and timed
by CUDA events on the card. The network is the default config's
``LSTM_test`` initialised from ``RNG_SEED``.

``--frozen`` (beam, W=96) times the live decode step against the frozen
serving artifact of the same network: ``engine/serve.py``'s
``export_decoder`` writes the program, ``ExportedDecoder`` loads it, and
the BiLSTM runs there as the custom op ``lstm_ctc_ocr_torch::bilstm_fwd``.
The JAX tool also times ``live_jax_portable``, the portable ``lax.scan``
program its artifact holds; the port's artifact holds the hand kernels as
custom ops (it is not portable, ROADMAP Queue 3), so there is no such
program and no such line. Run::

    python -m lstm_ctc_ocr_torch.tools.bench_decode [--batch 64]
        [--beam_width 16] [--frozen] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

import numpy as np
import torch

from ..config import default_cfg
from ..engine.serve import ExportedDecoder, export_decoder
from ..engine.test import full_f32, make_decode_step, resolve_device
from ..engine.train import compute_dtype
from ..models.factory import get_network
from ..ops.beam import beam_decode
from ..ops.decoder import greedy_decode
from ._common import timed_ms


def _setup(cfg, width, batch, device, seed=0):
    """The seeded ``LSTM_test`` on ``device`` and one batch: random images
    [batch, width, F] f32 and full-width steps [batch] int32 (numpy)."""
    rng = np.random.RandomState(seed)
    model = get_network('LSTM_test', cfg, generator=torch.Generator()
                        .manual_seed(int(cfg.RNG_SEED))).to(device).eval()
    image = rng.rand(batch, width, int(cfg.NUM_FEATURES)).astype(np.float32)
    t_steps = np.full((batch,), width // int(cfg.POOL_SCALE) - 1, np.int32)
    return model, image, t_steps


def _row(tag, width, batch, secs, **keys):
    return dict({'shape': tag, 'width': width, 'batch': batch}, **keys,
                p50_sec_per_batch=round(secs, 6),
                p50_ms_per_image=round(secs / batch * 1e3, 4),
                images_per_sec=round(batch / secs, 1))


def bench_shape(cfg, tag, width, batch, device, timing):
    """The four rows of one shape: (greedy, beam) x (full_step,
    decoder_only)."""
    model, image, t_steps = _setup(cfg, width, batch, device)
    dtype = compute_dtype(cfg)
    lens = torch.from_numpy(t_steps).to(device)
    with torch.inference_mode():
        logits = model(torch.from_numpy(image).to(device), lens,
                       dtype=dtype).transpose(0, 1).contiguous()
    results = []
    for decoder in ('greedy', 'beam'):
        cfg.DECODER = decoder
        full = timed_ms(make_decode_step(model, cfg, device), image, t_steps,
                        **timing) / 1e3
        if decoder == 'beam':
            def dec(lg, ts):
                return beam_decode(lg, ts, beam_width=int(cfg.BEAM_WIDTH),
                                   merge_repeated=bool(
                                       cfg.BEAM_MERGE_REPEATED))
        else:
            dec = greedy_decode
        with torch.inference_mode():
            only = timed_ms(dec, logits, lens, **timing) / 1e3
        for scope, secs in (('full_step', full), ('decoder_only', only)):
            results.append(_row(tag, width, batch, secs, decoder=decoder,
                                beam_width=int(cfg.BEAM_WIDTH), scope=scope))
            print(json.dumps(results[-1]), flush=True)
    return results


def bench_frozen_vs_live(cfg, tag, width, batch, device, timing):
    """The live decode step against the frozen artifact of the same
    network at one bucket."""
    model, image, t_steps = _setup(cfg, width, batch, device)
    results = []

    def emit(variant, secs):
        results.append(_row(tag, width, batch, secs,
                            decoder=str(cfg.DECODER), variant=variant))
        print(json.dumps(results[-1]), flush=True)

    emit('live_kernels', timed_ms(make_decode_step(model, cfg, device),
                                  image, t_steps, **timing) / 1e3)
    with tempfile.TemporaryDirectory() as d:
        export_decoder(model, cfg, d, buckets=[width], batch=batch,
                       device=device)
        frozen = ExportedDecoder(d, device=device)
        emit('frozen_artifact', timed_ms(frozen.run, image, t_steps,
                                         **timing) / 1e3)
    return results


@full_f32()
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--batch', type=int, default=64)
    ap.add_argument('--beam_width', type=int, default=16)
    ap.add_argument('--frozen', action='store_true',
                    help='time the frozen serving artifact against the live '
                         'decode step')
    ap.add_argument('--windows', type=int, default=7)
    ap.add_argument('--calls', type=int, default=4)
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    timing = dict(windows=args.windows, calls=args.calls, device=dev)
    cfg = default_cfg()
    cfg.BEAM_WIDTH = args.beam_width
    if args.frozen:
        cfg.DECODER = 'beam'
        bench_frozen_vs_live(cfg, 'default_W96', 96, args.batch, dev, timing)
        return 0
    out = bench_shape(cfg, 'default_W96', 96, args.batch, dev, timing)
    # the longline bucket: time and label geometry of longline.yml
    cfg.MIN_LEN, cfg.MAX_LEN = 20, 24
    cfg.MAX_CHAR_LEN = 24
    out += bench_shape(cfg, 'longline_W448', 448, args.batch, dev, timing)
    ratios = {}
    for tag in ('default_W96', 'longline_W448'):
        g, b = (next(r for r in out if r['shape'] == tag and
                     r['decoder'] == d and r['scope'] == 'full_step')
                for d in ('greedy', 'beam'))
        ratios[tag] = round(b['p50_sec_per_batch'] / g['p50_sec_per_batch'],
                            2)
    print(json.dumps({'beam_over_greedy_full_step': ratios}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
