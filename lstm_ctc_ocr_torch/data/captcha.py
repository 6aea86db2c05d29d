"""Captcha image renderer (PIL), the port's copy of the JAX package's
``data/captcha.py``.

Same call surface (``ImageCaptcha(fonts=[...]).generate_image(chars, rng)``
-> PIL RGB image) and the same draws from ``rng`` in the same order, so the
same seed gives the same image in both packages: per-character random font
size / colour / rotation / perspective warp, character overlap, a noise
curve, noise dots, and a smoothing filter on a light random background. The
canvas auto-widens for long strings.

Pillow is imported when a renderer is made, not when this module is
imported: a host without Pillow raises ``ImportError`` there, naming Pillow,
and renders with ``RENDERER: native`` (``native/synth.py``) instead.
"""

from __future__ import annotations

import random as _random
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .image import save_png


def require_pil(renderer: str):
    """Import Pillow for ``RENDERER: <renderer>``, or raise by name."""
    try:
        import PIL.Image  # noqa: F401
    except ImportError as e:
        raise ImportError(
            'RENDERER {}: draws with Pillow, which does not import here; '
            'RENDERER native renders without it (native/synth.py and its '
            'committed glyph atlas)'.format(renderer)) from e


def _default_font() -> str:
    from ..config import default_cfg, resolve_font
    return resolve_font(default_cfg())


def _random_light_color(rng) -> Tuple[int, int, int]:
    return (rng.randint(220, 255), rng.randint(220, 255), rng.randint(220, 255))


def _random_dark_color(rng, opacity: int = 255) -> Tuple[int, int, int, int]:
    return (rng.randint(0, 140), rng.randint(0, 140), rng.randint(0, 140), opacity)


class ImageCaptcha:
    """Render a character string as a distorted captcha image.

    Parameters follow the third-party library's constructor so call sites
    (data generator, offline dataset writer) read identically.
    """

    def __init__(self, width: int = 160, height: int = 60,
                 fonts: Optional[Sequence[str]] = None,
                 font_sizes: Optional[Sequence[int]] = None):
        require_pil('captcha')
        self._width = width
        self._height = height
        self._fonts = list(fonts) if fonts else [_default_font()]
        self._font_sizes = tuple(font_sizes) if font_sizes else (40, 46, 52)
        self._truefonts: List['ImageFont.FreeTypeFont'] = []

    @property
    def truefonts(self) -> List['ImageFont.FreeTypeFont']:
        from PIL import ImageFont
        if not self._truefonts:
            self._truefonts = [
                ImageFont.truetype(f, s)
                for f in self._fonts for s in self._font_sizes
            ]
        return self._truefonts

    # -- noise ---------------------------------------------------------------

    def create_noise_curve(self, image: 'Image.Image', color, rng
                           ) -> 'Image.Image':
        from PIL import ImageDraw
        w, h = image.size
        x1 = rng.randint(0, max(1, w // 5))
        x2 = rng.randint(w - w // 5, w - 1)
        y1 = rng.randint(h // 5, h - h // 5)
        y2 = rng.randint(y1, h - h // 5)
        points = [x1, y1, x2, y2]
        start = rng.randint(160, 200)
        end = rng.randint(0, 20)
        ImageDraw.Draw(image).arc(points, start, end, fill=color)
        return image

    def create_noise_dots(self, image: 'Image.Image', color, rng,
                          width: int = 3, number: int = 30) -> 'Image.Image':
        from PIL import ImageDraw
        draw = ImageDraw.Draw(image)
        w, h = image.size
        for _ in range(number):
            x1 = rng.randint(0, w - 1)
            y1 = rng.randint(0, h - 1)
            draw.line(((x1, y1), (x1 - 1, y1 - 1)), fill=color, width=width)
        return image

    # -- characters ----------------------------------------------------------

    def _draw_character(self, c: str, draw_color, rng) -> 'Image.Image':
        from PIL import Image, ImageDraw
        font = rng.choice(self.truefonts)
        left, top, right, bottom = font.getbbox(c)
        w, h = max(right - left, 1), max(bottom - top, 1)

        char_img = Image.new('RGBA', (w + 8, h + 8))
        ImageDraw.Draw(char_img).text((4 - left, 4 - top), c, font=font, fill=draw_color)

        # random rotation
        char_img = char_img.rotate(rng.uniform(-30, 30), Image.Resampling.BILINEAR, expand=True)

        # random perspective-ish warp via QUAD transform
        w2, h2 = char_img.size
        dx = w2 * rng.uniform(0.05, 0.25)
        dy = h2 * rng.uniform(0.05, 0.25)
        quad = (
            rng.uniform(-dx, dx), rng.uniform(-dy, dy),
            rng.uniform(-dx, dx), h2 + rng.uniform(-dy, dy),
            w2 + rng.uniform(-dx, dx), h2 + rng.uniform(-dy, dy),
            w2 + rng.uniform(-dx, dx), rng.uniform(-dy, dy),
        )
        char_img = char_img.transform((w2, h2), Image.Transform.QUAD, quad,
                                      Image.Resampling.BILINEAR)
        # tight-crop to the inked region so glyph spacing is driven by actual
        # ink, not by rotation-expanded transparent margins
        bbox = char_img.getbbox()
        if bbox:
            char_img = char_img.crop(bbox)
        return char_img

    def create_captcha_image(self, chars: str, background, rng
                             ) -> 'Image.Image':
        from PIL import Image
        images = [self._draw_character(c, _random_dark_color(rng), rng) for c in chars]
        total_w = sum(im.size[0] for im in images)
        # random horizontal squeeze so adjacent glyphs overlap a little;
        # pick the offsets first so the canvas can be sized to the true extent
        overlap = int(0.18 * total_w / max(len(images), 1))
        offsets = [0] + [im.size[0] - rng.randint(0, max(overlap, 1))
                         for im in images[:-1]]
        xs = []
        x = 0
        for off in offsets:
            x += off
            xs.append(x)
        needed = xs[-1] + images[-1].size[0] + 12
        # Auto-widen the canvas past the stock 160px (reference behaviour for
        # 4-6 chars) so long strings (20+ chars) fit instead of overflowing.
        width = max(self._width, needed)
        image = Image.new('RGB', (width, self._height), background)

        x0 = max(2, (width - needed) // 2 + 6)
        for char_img, x in zip(images, xs):
            w, h = char_img.size
            y = rng.randint(0, max(self._height - h, 0)) if h < self._height \
                else -(h - self._height) // 2
            image.paste(char_img, (x0 + x, y), char_img)
        return image

    def generate_image(self, chars: str, rng=None) -> 'Image.Image':
        from PIL import ImageFilter
        """Render ``chars`` -> PIL RGB image (same surface as the captcha lib)."""
        if not chars:
            # the C++ twin rejects empty labels too (synth.cpp); failing
            # here beats an IndexError deep in the layout code
            raise ValueError('cannot render an empty label')
        rng = rng or _random
        background = _random_light_color(rng)
        im = self.create_captcha_image(chars, background, rng)
        self.create_noise_dots(im, _random_dark_color(rng), rng)
        self.create_noise_curve(im, _random_dark_color(rng), rng)
        im = im.filter(ImageFilter.SMOOTH)
        return im

    def write(self, chars: str, output: str, rng=None) -> None:
        """Render and save to ``output`` as a PNG (the offline dataset
        writer, ``data/gen_img.py``)."""
        save_png(output, np.asarray(self.generate_image(chars, rng=rng)))
