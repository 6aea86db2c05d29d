"""The port's offline data writers against the JAX package's.

* ``data/image.py``'s PNG encoder: gray and RGB round-trip through the
  port's decoder, and where Pillow imports, Pillow reads the port's files
  and the port reads Pillow's, pixel for pixel.
* ``data/gen_img.py``: 8 images against the JAX ``gen_img`` from the same
  indices, with the native renderer (always) and the captcha renderer
  (where Pillow imports): the same file names and decoded pixels.
* ``tools/build_records.py --synth 16`` against the JAX tool run as a
  subprocess: the same records, byte for byte.
* ``tools/vis_batch.py``: the sheet's geometry and every pixel outside the
  caption bands equal the JAX tool's (Pillow) sheet; ``--from-store`` on
  the CPU puts the store's gathered rows on the sheet.
"""

import contextlib
import io
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from lstm_ctc_ocr_torch.config import default_cfg, load_cfg
from lstm_ctc_ocr_torch.data import gen_img, records
from lstm_ctc_ocr_torch.data.image import (decode_png, encode_png,
                                           load_image, save_png)
from lstm_ctc_ocr_torch.tools import build_records, vis_batch

from torch_dsl_cases import JaxCfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pixels(path):
    with open(path, 'rb') as f:
        return decode_png(f.read())


@pytest.mark.parametrize('shape', [(5, 7), (1, 1), (32, 97), (6, 9, 3),
                                   (31, 120, 3)])
def test_png_round_trip(tmp_path, shape):
    x = np.random.RandomState(sum(shape)).randint(0, 256, shape, np.uint8)
    got = decode_png(encode_png(x))
    want = x if x.ndim == 3 else x[..., None]
    np.testing.assert_array_equal(got, want)
    path = str(tmp_path / 'x.png')
    save_png(path, x)
    Image = pytest.importorskip('PIL.Image')
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im), x)
    Image.fromarray(x).save(str(tmp_path / 'pil.png'))
    np.testing.assert_array_equal(_pixels(str(tmp_path / 'pil.png')), want)


def test_png_rejects_what_it_cannot_write():
    with pytest.raises(ValueError):
        encode_png(np.zeros((2, 2), np.float32))
    with pytest.raises(ValueError):
        encode_png(np.zeros((2, 2, 4), np.uint8))


@pytest.mark.parametrize('renderer', ['native', 'captcha'])
def test_gen_img_matches_jax(tmp_path, renderer):
    if renderer == 'captcha':
        pytest.importorskip('PIL')
    from lstm_ctc_ocr_tpu.data import gen_img as jgen_img
    jdir, pdir = str(tmp_path / 'jax'), str(tmp_path / 'port')
    with JaxCfg(RENDERER=renderer):
        jgen_img.run(8, jdir, workers=0)
    cfg = default_cfg()
    cfg.RENDERER = renderer
    gen_img.run(8, pdir, workers=0, cfg=cfg)
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(pdir)) == names and len(names) == 8
    for f in names:
        np.testing.assert_array_equal(_pixels(os.path.join(pdir, f)),
                                      _pixels(os.path.join(jdir, f)))
        np.testing.assert_array_equal(load_image(os.path.join(pdir, f)),
                                      load_image(os.path.join(jdir, f)))


def test_gen_img_workers_write_the_inline_files(tmp_path):
    """Two worker processes write the inline run's files byte for byte;
    the pool runs in a fresh process through the command line (a fork from
    this multi-threaded test process could deadlock)."""
    cfg = default_cfg()
    cfg.RENDERER = 'native'
    a, b = str(tmp_path / 'inline'), str(tmp_path / 'pool')
    gen_img.run(6, a, workers=0, cfg=cfg)
    proc = subprocess.run(
        [sys.executable, '-m', 'lstm_ctc_ocr_torch.data.gen_img', '6', b,
         '--workers', '2', '--set', 'RENDERER', 'native'], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for f in os.listdir(a):
        with open(os.path.join(a, f), 'rb') as x, \
                open(os.path.join(b, f), 'rb') as y:
            assert x.read() == y.read()


def test_build_records_synth_matches_jax_tool(tmp_path):
    jout, pout = str(tmp_path / 'jax.records'), str(tmp_path / 'port.records')
    env = dict(os.environ, JAX_PLATFORMS='cpu', PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, 'tools', 'build_records.py'),
         '--synth', '16', '--seed', '3', '--out', jout, '--set', 'RENDERER',
         'native', 'MIN_LEN', '3'], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert build_records.main(['--synth', '16', '--seed', '3', '--out', pout,
                               '--set', 'RENDERER', 'native', 'MIN_LEN',
                               '3']) == 0
    with open(jout, 'rb') as a, open(pout, 'rb') as b:
        assert a.read() == b.read()
    ds = records.RecordsDataset(pout, default_cfg())
    assert len(ds) == 16
    assert all(3 <= len(ds.get(i)[0]) for i in range(16))


def test_build_records_img_dir(tmp_path):
    src = os.path.join(REPO, 'data', 'val_digit4_native')
    d = tmp_path / 'imgs'
    d.mkdir()
    for f in sorted(os.listdir(src))[:5]:
        shutil.copy(os.path.join(src, f), str(d / f))
    out = str(tmp_path / 'x.records')
    assert build_records.main(['--img_dir', str(d), '--out', out]) == 0
    ds = records.RecordsDataset(out, default_cfg())
    assert [ds.get(i)[0] for i in range(len(ds))] == \
        [records.parse_label_from_filename(f) for f in sorted(os.listdir(d))]


def _tiles(n=7, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 256, (32, int(rng.randint(40, 110))), np.uint8),
             ''.join(rng.choice(list('abcXYZ0189'), rng.randint(1, 7))))
            for _ in range(n)]


def _caption_mask(sheet_shape, tiles, cols, pad=6, caption_h=14):
    """True on the rows of each row of cells' caption band."""
    mask = np.zeros(sheet_shape, bool)
    cell_h = max(im.shape[0] for im, _ in tiles) + caption_h + pad
    for k, (im, _) in enumerate(tiles):
        r = k // max(1, min(cols, len(tiles)))
        y = pad + r * cell_h + im.shape[0]
        mask[y:y + caption_h] = True
    return mask


@pytest.mark.parametrize('cols', [1, 3, 4, 10])
def test_vis_batch_sheet_matches_jax(cols):
    pytest.importorskip('PIL')
    sys.path.insert(0, os.path.join(REPO, 'tools'))
    import vis_batch as jvis
    tiles = _tiles()
    want = np.asarray(jvis.contact_sheet(tiles, cols))
    got = vis_batch.contact_sheet(tiles, cols,
                                  glyphs=vis_batch._glyphs(default_cfg()))
    assert got.shape == want.shape and got.dtype == np.uint8
    mask = _caption_mask(got.shape, tiles, cols)
    np.testing.assert_array_equal(got[~mask], want[~mask])
    assert (got[mask] > 32).any()                  # the captions are drawn


def test_vis_batch_from_store_shows_the_gathered_rows(tmp_path):
    rec = str(tmp_path / 'v.records')
    src = os.path.join(REPO, 'data', 'val_digit4_native')
    d = tmp_path / 'imgs'
    d.mkdir()
    for f in sorted(os.listdir(src))[:12]:
        shutil.copy(os.path.join(src, f), str(d / f))
    records.write_image_annotation_pairs_to_records(str(d), rec)
    overrides = ['DATA_BACKEND', 'records', 'RECORDS_PATH', rec,
                 'DATA_DEVICE', "'on'", 'CHARSET', "'0123456789'",
                 'NCLASSES', '12']
    out = str(tmp_path / 'sheet.png')
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert vis_batch.main(['--n', '5', '--cols', '2', '--from-store',
                               '--device', 'cpu', '--out', out, '--set']
                              + overrides) == 0
    import torch
    from lstm_ctc_ocr_torch.config import get_encode_decode_dict
    from lstm_ctc_ocr_torch.data.device_store import make_device_feed
    cfg = load_cfg(None, overrides)
    feed = make_device_feed(cfg, torch.device('cpu'), verbose=False)
    idx = feed.step_indices(5)
    assert 'rows {}'.format(idx.tolist()) in buf.getvalue()
    img, lab, lab_len, _ = (a.index_select(0, idx).numpy()
                            for a in feed.store.arrays)
    tiles = vis_batch.batch_to_images(img, lab, lab_len,
                                      get_encode_decode_dict(cfg)[1])
    want = vis_batch.contact_sheet(tiles, 2)
    got = _pixels(out)[..., 0]
    mask = _caption_mask(got.shape, tiles, 2)
    np.testing.assert_array_equal(got[~mask], want[~mask])
    labels = {records.parse_label_from_filename(f) for f in os.listdir(d)}
    assert {t for _, t in tiles} <= labels
