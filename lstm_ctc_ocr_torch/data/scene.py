"""Scene-text-style synthetic line renderer (PIL), the port's copy of the
JAX package's ``data/scene.py``.

Photo-like cropped words instead of captchas: cluttered textured
backgrounds, straight(ish) text with variable contrast, lighting gradients,
blur and sensor noise. The same draws from ``rng`` in the same order as the
JAX renderer, so the same seed gives the same image in both packages.
Selected with ``RENDERER: scene`` (``lstm/scene.yml``).

Pillow is imported when a renderer is made, not when this module is
imported: a host without Pillow raises ``ImportError`` there, naming
Pillow (``data/captcha.py:require_pil``).
"""

from __future__ import annotations

import random as _random
from typing import Optional, Sequence

import numpy as np

from .captcha import _default_font, require_pil
from .image import save_png


def _noise_texture(w: int, h: int, rng, base: int, spread: int
                   ) -> 'Image.Image':
    """Low-frequency luminance texture: tiny random grid upscaled bilinear."""
    from PIL import Image
    gw, gh = max(2, w // 24), max(2, h // 12)
    grid = np.array([[rng.randint(-spread, spread) for _ in range(gw)]
                     for _ in range(gh)], dtype=np.float32)
    tex = Image.fromarray(
        np.clip(grid + base, 0, 255).astype(np.uint8), 'L'
    ).resize((w, h), Image.BILINEAR)
    return tex


class SceneTextRenderer:
    """Render a string as a photo-like cropped text line."""

    def __init__(self, height: int = 60,
                 fonts: Optional[Sequence[str]] = None,
                 font_sizes: Optional[Sequence[int]] = None):
        require_pil('scene')
        self._height = height
        self._fonts = list(fonts) if fonts else [_default_font()]
        self._font_sizes = tuple(font_sizes) if font_sizes else (34, 40, 46)

    def generate_image(self, chars: str, rng=None) -> 'Image.Image':
        from PIL import Image, ImageDraw, ImageFilter, ImageFont
        rng = rng or _random
        font = ImageFont.truetype(rng.choice(self._fonts),
                                  rng.choice(self._font_sizes))
        l, t, r, b = font.getbbox(chars)
        tw, th = r - l, b - t
        h = self._height
        pad = rng.randint(4, 14)
        w = tw + 2 * pad

        # background: textured mid/low-frequency luminance, dark or light
        dark_bg = rng.random() < 0.5
        base = rng.randint(10, 90) if dark_bg else rng.randint(150, 240)
        img = _noise_texture(w, h, rng, base, spread=rng.randint(8, 35))
        img = img.convert('RGB')
        draw = ImageDraw.Draw(img)

        # clutter: a few low-contrast rectangles / lines behind the text
        for _ in range(rng.randint(0, 3)):
            x0, y0 = rng.randint(0, w - 1), rng.randint(0, h - 1)
            x1, y1 = rng.randint(0, w - 1), rng.randint(0, h - 1)
            c = base + rng.randint(-30, 30)
            c = int(np.clip(c, 0, 255))
            if rng.random() < 0.5:
                draw.rectangle([min(x0, x1), min(y0, y1),
                                max(x0, x1), max(y0, y1)], outline=(c, c, c))
            else:
                draw.line([x0, y0, x1, y1], fill=(c, c, c), width=1)

        # text: contrast-constrained fill, optional shadow, straight baseline
        if dark_bg:
            fill = tuple(rng.randint(170, 255) for _ in range(3))
        else:
            fill = tuple(rng.randint(0, 80) for _ in range(3))
        x = pad - l
        y = (h - th) // 2 - t + rng.randint(-3, 3)
        if rng.random() < 0.4:     # drop shadow
            sh = 0 if dark_bg else 255
            draw.text((x + 2, y + 2), chars, font=font,
                      fill=(255 - sh, 255 - sh, 255 - sh))
        draw.text((x, y), chars, font=font, fill=fill)

        # mild whole-line rotation (scene crops are nearly straight)
        angle = rng.uniform(-3.0, 3.0)
        img = img.rotate(angle, Image.BILINEAR, expand=False,
                         fillcolor=(base, base, base))

        # photo degradations: blur, brightness gradient, sensor noise
        if rng.random() < 0.7:
            img = img.filter(ImageFilter.GaussianBlur(rng.uniform(0.3, 1.3)))
        arr = np.asarray(img).astype(np.float32)
        ramp = np.linspace(rng.uniform(0.75, 1.0), rng.uniform(1.0, 1.25), w)
        arr = arr * ramp[None, :, None]
        arr = arr + np.random.RandomState(rng.randrange(2**31)).normal(
            0.0, rng.uniform(2.0, 9.0), arr.shape)
        return Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8), 'RGB')

    def write(self, chars: str, output: str, rng=None) -> None:
        save_png(output, np.asarray(self.generate_image(chars, rng=rng)))
