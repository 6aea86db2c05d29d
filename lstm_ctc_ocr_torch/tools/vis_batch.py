"""Write a labeled contact sheet of a training batch to a PNG.

Counterpart of the JAX package's ``tools/vis_batch.py``, with its command
line and sheet::

    python -m lstm_ctc_ocr_torch.tools.vis_batch [--n 32] [--cols 4] \\
        [--out batch_vis.png] [--from-store] [--device cuda] \\
        [--cfg YML] [--set KEY VALUE ...]

One tile per example, its label under it. The batch is the configured
backend's, the stream training takes (``engine/train.py:make_train_stream``:
synth, pool or records), or with ``--from-store`` the rows gathered back
from the device-resident store (``data/device_store.py``; ``DATA_BACKEND``
pool or records, on ``--device``, CUDA unless ``cpu``; the printed line
names the rows): what the gather train step sees is what lands on the
sheet.

The sheet's geometry is the JAX tool's (pad 6, caption band 14, background
32; a cell is the widest tile plus the pad by the tallest tile plus the
caption band and the pad). Captions are drawn without Pillow, from the
committed glyph atlas (``native/glyph_atlas.npz``) scaled to the caption
band, glyphs bottom-aligned, so their pixels differ from the JAX tool's
PIL text; the tiles' do not. The PNG is written by ``data/image.py``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

GLYPH_SCALE = 0.27        # the atlas's 40 px glyphs to ~9 px captions
BACKGROUND = 32


def batch_to_images(image, label, label_len, decode_maps):
    """[N, W, 32] width-major batch rows -> ([H, W] uint8 image, text)."""
    out = []
    image = np.asarray(image)
    if image.dtype != np.uint8:            # f32 wire format: already /255
        image = np.clip(image * 255.0, 0, 255).astype(np.uint8)
    for i in range(image.shape[0]):
        im = image[i].T                    # [32, W] height-major for viewing
        ids = np.asarray(label[i][:int(label_len[i])]).tolist()
        text = ''.join(decode_maps.get(int(c), '?') for c in ids)
        out.append((im, text))
    return out


def _glyphs(cfg):
    """char -> scaled uint8 alpha bitmap, from the committed atlas at its
    smallest size, margins cropped."""
    from ..config import resolve_font
    from ..data.image import resize_linear
    from ..native.synth import MARGIN, get_atlas
    atlas = get_atlas(str(cfg.CHARSET), resolve_font(cfg))
    out = {}
    for c, k in atlas.index.items():
        b = atlas.bitmap(k * atlas.variants)[MARGIN:-MARGIN, MARGIN:-MARGIN]
        h = max(1, int(round(b.shape[0] * GLYPH_SCALE)))
        w = max(1, int(round(b.shape[1] * GLYPH_SCALE)))
        out[c] = resize_linear(np.ascontiguousarray(b), w, h)
    return out


def draw_text(sheet, x, y, text, glyphs, bottom):
    """White ``text`` over ``sheet`` from column ``x``, glyphs alpha-blended
    with their bottoms on row ``bottom`` (top no higher than ``y``);
    characters without a glyph advance a space."""
    for ch in text:
        g = glyphs.get(ch)
        if g is None:
            x += 4
            continue
        h, w = g.shape
        top = max(y, bottom - h)
        rows = sheet[top:top + h, x:x + w]
        a = g[:rows.shape[0], :rows.shape[1]].astype(np.float32) / 255.0
        rows[...] = np.rint(rows + (255.0 - rows) * a).astype(np.uint8)
        x += w + 1


def contact_sheet(tiles, cols, pad=6, caption_h=14, glyphs=None):
    """Compose (image, text) tiles into one uint8 grayscale sheet [H, W]
    with captions (none without ``glyphs``)."""
    cols = max(1, min(cols, len(tiles)))
    rows = (len(tiles) + cols - 1) // cols
    cell_w = max(im.shape[1] for im, _ in tiles) + pad
    cell_h = max(im.shape[0] for im, _ in tiles) + caption_h + pad
    sheet = np.full((rows * cell_h + pad, cols * cell_w + pad), BACKGROUND,
                    np.uint8)
    for k, (im, text) in enumerate(tiles):
        r, c = divmod(k, cols)
        x, y = pad + c * cell_w, pad + r * cell_h
        sheet[y:y + im.shape[0], x:x + im.shape[1]] = im
        if glyphs:
            top = y + im.shape[0] + 1
            draw_text(sheet, x, top, text, glyphs, top + caption_h - 3)
    return sheet


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--n', type=int, default=32, help='examples on the sheet')
    ap.add_argument('--cols', type=int, default=4)
    ap.add_argument('--out', default='batch_vis.png')
    ap.add_argument('--from-store', action='store_true',
                    help='gather the rows back from the device-resident '
                         'store (DATA_BACKEND pool|records) instead of '
                         'taking a host batch')
    ap.add_argument('--device', default='cuda',
                    help="the store's device: 'cuda' (default) or 'cpu'")
    ap.add_argument('--cfg', default=None, help='experiment YAML')
    ap.add_argument('--set', dest='set_cfgs', nargs=argparse.REMAINDER,
                    default=None, help='cfg overrides')
    args = ap.parse_args(argv)

    from ..config import get_encode_decode_dict, load_cfg
    from ..data.image import save_png
    cfg = load_cfg(args.cfg, args.set_cfgs or ())
    _, decode_maps = get_encode_decode_dict(cfg)

    if args.from_store:
        from ..data.device_store import make_device_feed
        from ..engine.test import resolve_device
        if str(cfg.DATA_DEVICE) == 'off':
            cfg.DATA_DEVICE = 'auto'
        feed = make_device_feed(cfg, resolve_device(args.device))
        if feed is None:
            raise SystemExit('--from-store: the device-store gate declined '
                             '(see the message above)')
        idx = feed.step_indices(args.n)
        img, lab, lab_len, _ = (a.index_select(0, idx).cpu().numpy()
                                for a in feed.store.arrays)
        tiles = batch_to_images(img, lab, lab_len, decode_maps)
        src = 'device store ({} backend), rows {}'.format(
            cfg.DATA_BACKEND, idx.tolist())
    else:
        from ..engine.train import make_train_stream
        stream = make_train_stream(cfg, args.n)
        b = next(stream)
        if hasattr(stream, 'close'):
            stream.close()
        tiles = batch_to_images(b.image, b.label, b.label_len, decode_maps)
        src = 'host batch ({} backend)'.format(cfg.DATA_BACKEND)

    sheet = contact_sheet(tiles, args.cols, glyphs=_glyphs(cfg))
    save_png(args.out, sheet)
    print('wrote {} ({} examples, {}x{} px) from {}'.format(
        args.out, len(tiles), sheet.shape[1], sheet.shape[0], src))
    return 0


if __name__ == '__main__':
    sys.exit(main())
