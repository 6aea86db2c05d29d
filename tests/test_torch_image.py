"""The port's OpenCV-free image loader against OpenCV on every tracked val
PNG: PNG decode + grayscale must equal ``cv2.imread(path, 0)`` bit for bit,
and the bilinear resize to height 32 must equal ``cv2.resize`` — measured
max |difference| 0 gray levels, so the test asserts 0."""

import os
import zlib

import numpy as np
import pytest

from lstm_ctc_ocr_torch.data import image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VAL_DIRS = sorted(d for d in os.listdir(os.path.join(REPO, 'data'))
                  if d.startswith('val'))


@pytest.mark.parametrize('val_dir', VAL_DIRS)
def test_loader_matches_opencv(val_dir):
    cv2 = pytest.importorskip('cv2')
    d = os.path.join(REPO, 'data', val_dir)
    names = sorted(f for f in os.listdir(d) if f.endswith('.png'))
    assert names
    for f in names:
        path = os.path.join(d, f)
        ref = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        gray = image.load_image(path)
        assert gray.dtype == np.uint8
        np.testing.assert_array_equal(gray, ref, err_msg=f)
        assert image.png_size(path) == (ref.shape[1], ref.shape[0])
        new_w = int(32 / ref.shape[0] * ref.shape[1])
        np.testing.assert_array_equal(image.resize_linear(ref, new_w, 32),
                                      cv2.resize(ref, (new_w, 32)),
                                      err_msg=f)


def _png(pixels, ctype, filters):
    """Encode ``pixels`` [H, W, C] with the given per-row filter types."""
    import struct
    h, w, c = pixels.shape
    bpp = c
    rows = []
    prev = np.zeros(w * c, np.int64)
    for y in range(h):
        cur = pixels[y].reshape(-1).astype(np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        f = filters[y % len(filters)]
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - ul
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, ul))
        rows.append(bytes([f]) + ((cur - pred) & 255).astype(np.uint8).tobytes())
        prev = cur

    def chunk(kind, body):
        return (struct.pack('>I', len(body)) + kind + body
                + struct.pack('>I', zlib.crc32(kind + body)))
    ihdr = struct.pack('>IIBBBBB', w, h, 8, ctype, 0, 0, 0)
    return (b'\x89PNG\r\n\x1a\n' + chunk(b'IHDR', ihdr)
            + chunk(b'IDAT', zlib.compress(b''.join(rows)))
            + chunk(b'IEND', b''))


@pytest.mark.parametrize('ctype,channels', [(0, 1), (4, 2), (2, 3), (6, 4)])
def test_decode_all_filters_and_color_types(ctype, channels):
    """All five row filters (None, Sub, Up, Average, Paeth) in each 8-bit
    color type round-trip exactly; color reduces with the libpng weights."""
    rng = np.random.RandomState(ctype)
    pixels = rng.randint(0, 256, size=(10, 7, channels)).astype(np.uint8)
    data = _png(pixels, ctype, [0, 1, 2, 3, 4])
    np.testing.assert_array_equal(image.decode_png(data), pixels)
    gray = image.to_gray(pixels)
    if channels >= 3:
        rgb = pixels[..., :3].astype(np.int64)
        want = (rgb[..., 0] * 9797 + rgb[..., 1] * 19234
                + rgb[..., 2] * 3737) >> 15
        np.testing.assert_array_equal(gray, want)
    else:
        np.testing.assert_array_equal(gray, pixels[..., 0])


def test_decode_rejects_unsupported():
    with pytest.raises(IOError):
        image.decode_png(b'not a png')
    pixels = np.zeros((2, 2, 1), np.uint8)
    data = bytearray(_png(pixels, 0, [0]))
    data[24] = 16                         # bit depth 16
    with pytest.raises(IOError, match='unsupported'):
        image.decode_png(bytes(data))
