"""ctypes binding of the native captcha renderer (``native/synth.cpp``), the
port's copy of the JAX package's ``native/synth.py``.

The split of labour is the JAX package's: Python holds each charset glyph
as a uint8 alpha bitmap at the PIL renderer's font sizes (the atlas);
everything per image — rotation, quad warp, overlap layout, noise,
smoothing, the resize to model height — runs in C++ (``synth_render``).
Selected with ``RENDERER: native``. The library is built with g++ at first
use into ``lstm_ctc_ocr_torch/build/`` (``ops/_build.py:host_library``); a
missing compiler or a failed build raises.

The atlas comes from the committed ``glyph_atlas.npz``: the 62 characters of
the default ``CHARSET`` at ``FONT_SIZES`` from ``fonts/DejaVuSerif.ttf``,
rasterised once with PIL by the JAX package's ``GlyphAtlas`` code path, so
that ``RENDERER: native`` needs no PIL. It was written, and is rewritten
after a change of font or charset, by::

    python -m lstm_ctc_ocr_torch.native.synth

:func:`get_atlas` takes the committed atlas when the font's sha1 matches and
it covers the charset; otherwise it rasterises with PIL where PIL imports,
and otherwise raises ``ImportError`` naming what the committed atlas lacks.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, 'synth.cpp')
ATLAS_PATH = os.path.join(_DIR, 'glyph_atlas.npz')

CANVAS_H = 60           # the renderer's working canvas height (captcha.py)
MIN_CANVAS_W = 160      # stock canvas width, auto-widens past it
FONT_SIZES = (40, 46, 52)
MARGIN = 4              # baked into the atlas (captcha.py draws at +4)

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    from ..ops._build import host_library
    lib = host_library(_SRC)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.synth_render.restype = ctypes.c_int
    lib.synth_render.argtypes = [
        u8p, i32p, i32p, i32p, ctypes.c_int32,       # atlas, off, w, h, variants
        i32p, i32p, ctypes.c_int32,                  # codes, code_off, n_images
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # min_w, canvas_h, out_h
        ctypes.c_uint64,                             # seed
        u8p, i32p, ctypes.c_int32,                   # out, out_w, max_w
    ]
    _lib = lib
    return lib


def rasterize(charset: str, font_path: str,
              sizes: Sequence[int] = FONT_SIZES) -> List[np.ndarray]:
    """Per-(char, size) alpha bitmaps drawn with PIL, in (char, size) order
    (the JAX package's ``GlyphAtlas`` drawing)."""
    try:
        from PIL import Image, ImageDraw, ImageFont
    except ImportError as e:
        raise ImportError('rasterising glyphs needs Pillow, which does not '
                          'import here') from e
    bitmaps: List[np.ndarray] = []
    for c in charset:
        for s in sizes:
            font = ImageFont.truetype(font_path, s)
            left, top, right, bottom = font.getbbox(c)
            w = max(right - left, 1)
            h = max(bottom - top, 1)
            im = Image.new('L', (w + 2 * MARGIN, h + 2 * MARGIN), 0)
            ImageDraw.Draw(im).text((MARGIN - left, MARGIN - top), c,
                                    font=font, fill=255)
            bitmaps.append(np.asarray(im, np.uint8))
    return bitmaps


class GlyphAtlas:
    """Per-(char, size) alpha bitmaps flattened for ``synth_render``:
    bitmap ``k * variants + v`` (char ``k`` of ``charset``, size ``v``) is
    ``data[off[e]:off[e] + w[e] * h[e]]``, row-major."""

    def __init__(self, charset: str, bitmaps: Sequence[np.ndarray],
                 variants: int = len(FONT_SIZES)):
        if len(bitmaps) != len(charset) * variants:
            raise ValueError('{} bitmaps for {} characters x {} sizes'.format(
                len(bitmaps), len(charset), variants))
        self.charset = charset
        self.variants = variants
        self.w = np.array([b.shape[1] for b in bitmaps], np.int32)
        self.h = np.array([b.shape[0] for b in bitmaps], np.int32)
        self.off = np.zeros((len(bitmaps),), np.int32)
        self.off[1:] = np.cumsum([b.size for b in bitmaps[:-1]],
                                 dtype=np.int64)
        self.data = np.concatenate([np.ascontiguousarray(b, np.uint8)
                                    .reshape(-1) for b in bitmaps])
        self.index = {c: i for i, c in enumerate(charset)}

    @classmethod
    def from_font(cls, charset: str, font_path: str) -> 'GlyphAtlas':
        """Rasterise ``charset`` with PIL."""
        return cls(charset, rasterize(charset, font_path))

    def bitmap(self, e: int) -> np.ndarray:
        o = int(self.off[e])
        return self.data[o:o + int(self.w[e]) * int(self.h[e])].reshape(
            int(self.h[e]), int(self.w[e]))

    def subset(self, charset: str) -> 'GlyphAtlas':
        """The atlas of ``charset``, whose characters are all in this one."""
        v = self.variants
        return GlyphAtlas(charset, [self.bitmap(self.index[c] * v + j)
                                    for c in charset for j in range(v)], v)


def font_sha1(path: str) -> str:
    with open(path, 'rb') as f:
        return hashlib.sha1(f.read()).hexdigest()


def save_atlas(atlas: GlyphAtlas, font_path: str,
               path: str = ATLAS_PATH) -> None:
    np.savez_compressed(
        path, charset=np.array(atlas.charset), data=atlas.data, w=atlas.w,
        h=atlas.h, sizes=np.array(FONT_SIZES, np.int32),
        margin=np.int32(MARGIN), font_sha1=np.array(font_sha1(font_path)))


def load_committed(path: str = ATLAS_PATH) -> Tuple[GlyphAtlas, str]:
    """The committed atlas and the sha1 of the font it was drawn from."""
    with np.load(path, allow_pickle=False) as d:
        if (tuple(int(s) for s in d['sizes']) != FONT_SIZES
                or int(d['margin']) != MARGIN):
            raise ValueError('{} was drawn at sizes {} margin {}, the '
                             'renderer uses {} margin {}'.format(
                                 path, d['sizes'].tolist(), int(d['margin']),
                                 FONT_SIZES, MARGIN))
        w, h = d['w'], d['h']
        data = d['data']
        charset, sha = str(d['charset']), str(d['font_sha1'])
    sizes = (w.astype(np.int64) * h).tolist()
    offs = np.concatenate([[0], np.cumsum(sizes)])
    bitmaps = [data[offs[e]:offs[e + 1]].reshape(int(h[e]), int(w[e]))
               for e in range(len(sizes))]
    return GlyphAtlas(charset, bitmaps), sha


_atlas_cache: Dict[Tuple[str, str], GlyphAtlas] = {}


def get_atlas(charset: str, font_path: str) -> GlyphAtlas:
    """The glyph atlas of ``charset`` in the font at ``font_path``: the
    committed one where it applies, else drawn with PIL; raises
    ``ImportError`` naming the gap where neither is possible."""
    key = (charset, font_path)
    if key in _atlas_cache:
        return _atlas_cache[key]
    committed, sha = load_committed()
    missing = sorted(set(charset) - set(committed.charset))
    got = font_sha1(font_path)
    if got == sha and not missing:
        atlas = committed.subset(charset)
    else:
        why = ('font {} has sha1 {}, the committed atlas was drawn from {}'
               .format(font_path, got, sha) if got != sha else
               'the committed atlas lacks the characters {!r}'.format(
                   ''.join(missing)))
        try:
            atlas = GlyphAtlas.from_font(charset, font_path)
        except ImportError as e:
            raise ImportError('RENDERER native: {}, and rasterising the atlas '
                              'needs Pillow, which does not import here'
                              .format(why)) from e
    _atlas_cache[key] = atlas
    return atlas


def render_batch(labels: Sequence[str], atlas: GlyphAtlas, seed: int,
                 out_h: int = 32, max_w: int = 1024
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Render ``labels`` -> (uint8 [n, out_h, max_w], widths [n]).

    Images come back already at model height (aspect-preserving resize in
    C++), so ``data.gen.bucket_batch`` skips its per-image resize.
    Deterministic in (labels, seed).
    """
    lib = _load()
    n = len(labels)
    codes = np.array([atlas.index[c] for lab in labels for c in lab], np.int32)
    code_off = np.zeros((n + 1,), np.int32)
    code_off[1:] = np.cumsum([len(lab) for lab in labels])
    out = np.zeros((n, out_h, max_w), np.uint8)
    out_w = np.zeros((n,), np.int32)

    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    ret = lib.synth_render(
        atlas.data.ctypes.data_as(u8p), atlas.off.ctypes.data_as(i32p),
        atlas.w.ctypes.data_as(i32p), atlas.h.ctypes.data_as(i32p),
        atlas.variants,
        codes.ctypes.data_as(i32p), code_off.ctypes.data_as(i32p), n,
        MIN_CANVAS_W, CANVAS_H, out_h, ctypes.c_uint64(seed & (2**64 - 1)),
        out.ctypes.data_as(u8p), out_w.ctypes.data_as(i32p), max_w)
    if ret != 0:
        raise RuntimeError('synth_render returned {}'.format(ret))
    return out, out_w


class NativeCaptcha:
    """Renderer with the ImageCaptcha call surface, backed by synth.cpp.

    ``generate_image`` returns a grayscale numpy array (height
    ``img_height``) rather than a full-size PIL image: the C++ side already
    fused the resize, so the batching skips its resize.
    """

    def __init__(self, charset: str, font_path: str, img_height: int):
        self.atlas = get_atlas(charset, font_path)
        self.img_height = int(img_height)
        self._counter = 0

    def generate_image(self, chars: str, rng=None) -> np.ndarray:
        seed = rng.getrandbits(63) if hasattr(rng, 'getrandbits') \
            else self._counter
        self._counter += 1
        imgs, widths = render_batch([chars], self.atlas, seed,
                                    out_h=self.img_height)
        return imgs[0, :, :int(widths[0])]

    def write(self, chars: str, output: str, rng=None) -> None:
        """Render and save to ``output`` as an 8-bit gray PNG (the offline
        dataset writer, ``data/gen_img.py``)."""
        from ..data.image import save_png
        save_png(output, self.generate_image(chars, rng))


def main():
    """Rewrite ``glyph_atlas.npz`` from the default charset and font."""
    from ..config import default_cfg, resolve_font
    cfg = default_cfg()
    font = resolve_font(cfg)
    atlas = GlyphAtlas.from_font(str(cfg.CHARSET), font)
    save_atlas(atlas, font)
    print('wrote {} ({} bitmaps, {} bytes raw, {} bytes on disk) from {} '
          '(sha1 {})'.format(ATLAS_PATH, len(atlas.w), atlas.data.size,
                             os.path.getsize(ATLAS_PATH), font,
                             font_sha1(font)))


if __name__ == '__main__':
    main()
