"""The port's records feed against the JAX package's.

A records file written by one package is the other's, byte for byte: the
port writes from the tracked ``data/val`` PNGs with its own decoder, the
JAX package with OpenCV, and each reads the other's file. The same seed
gives the same shuffled, bucketed batches (images, labels, lengths, time
steps) from both readers; the port's height-32 resize is its own
(``data/image.py``), bit-exact to OpenCV's.
"""

import filecmp
import os
import shutil

import numpy as np
import pytest

from lstm_ctc_ocr_tpu.config import cfg as jcfg
from lstm_ctc_ocr_tpu.data import gen as jgen
from lstm_ctc_ocr_tpu.data import records as jrecords
from lstm_ctc_ocr_torch.config import default_cfg
from lstm_ctc_ocr_torch.data import gen, records

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VAL = os.path.join(REPO, 'data', 'val')


@pytest.fixture(scope='module')
def img_dir(tmp_path_factory):
    """24 tracked val PNGs and two files the walk must skip."""
    d = tmp_path_factory.mktemp('imgs')
    for f in sorted(os.listdir(VAL))[:24]:
        shutil.copy(os.path.join(VAL, f), str(d / f))
    (d / 'notes.txt').write_text('not an image')
    (d / 'unlabelled.png').write_bytes(b'')
    return str(d)


def test_files_written_by_either_package_are_identical(img_dir, tmp_path):
    pytest.importorskip('cv2')
    ours, theirs = str(tmp_path / 'a.records'), str(tmp_path / 'b.records')
    assert records.write_image_annotation_pairs_to_records(img_dir, ours) == 24
    assert jrecords.write_image_annotation_pairs_to_records(img_dir,
                                                            theirs) == 24
    assert filecmp.cmp(ours, theirs, shallow=False)
    assert records.main([img_dir, str(tmp_path / 'c.records')]) == 0
    assert filecmp.cmp(ours, str(tmp_path / 'c.records'), shallow=False)


def test_each_reader_reads_the_others_file(img_dir, tmp_path):
    ours, theirs = str(tmp_path / 'a.records'), str(tmp_path / 'b.records')
    pairs = list(records.iter_labeled_images(img_dir))
    assert len(pairs) == 24 and pairs[0][1].dtype == np.uint8
    with records.RecordsWriter(ours) as w:
        for label, img in pairs:
            w.add(label, img)
    with jrecords.RecordsWriter(theirs) as w:
        for label, img in pairs:
            w.add(label, img)
    cfg = default_cfg()
    for path in (ours, theirs):
        ds, jds = records.RecordsDataset(path, cfg), \
            jrecords.RecordsDataset(path)
        assert len(ds) == len(jds) == 24
        for i, (label, img) in enumerate(pairs):
            for got in (ds.get(i), jds.get(i)):
                assert got[0] == label
                np.testing.assert_array_equal(got[1], img)
        ds.close()
        jds.close()


def _same_batch(a, b):
    for field in ('image', 'label', 'label_len', 'time_step'):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and x.shape == y.shape, field
        np.testing.assert_array_equal(x, y, err_msg=field)
    np.testing.assert_array_equal(a.flat_labels, b.flat_labels)


@pytest.mark.parametrize('cache', [True, False])
def test_batch_streams_match(img_dir, tmp_path, cache):
    """Same seed, same batches: numpy's permutation drives both readers,
    and the 60 -> 32 pixel resize agrees bit for bit."""
    pytest.importorskip('cv2')
    path = str(tmp_path / 'a.records')
    records.write_image_annotation_pairs_to_records(img_dir, path)
    cfg = default_cfg()
    ds = records.RecordsDataset(path, cfg, cache_resized=cache)
    jds = jrecords.RecordsDataset(path, cache_resized=cache)
    ours = list(ds.batch_iterator(8, shuffle=True, seed=5, epochs=2))
    theirs = list(jds.batch_iterator(8, shuffle=True, seed=5, epochs=2))
    assert len(ours) == len(theirs) == 6
    for a, b in zip(ours, theirs):
        assert a.image.dtype == np.uint8 and a.image.shape[2] == 32
        _same_batch(a, b)
    _same_batch(ds.batch(range(8)),
                next(jds.batch_iterator(8, shuffle=False)))
    ds.close()
    jds.close()


def test_bucket_batch_matches_jax_in_both_wire_formats():
    pytest.importorskip('cv2')
    rng = np.random.RandomState(0)
    imgs = [rng.randint(0, 256, (h, w), dtype=np.uint8)
            for h, w in ((60, 160), (32, 90), (45, 200), (60, 121))]
    labels = ['ab12', 'Zz9', 'q0Xy7L', 'A']
    cfg = default_cfg()
    assert gen.max_label_len(cfg) == jgen.max_label_len() == 6
    _same_batch(gen.bucket_batch(imgs, labels, cfg),
                jgen.bucket_batch(imgs, labels))
    old = jcfg.TRANSFER_DTYPE
    try:
        jcfg.TRANSFER_DTYPE = cfg.TRANSFER_DTYPE = 'float32'
        a, b = gen.bucket_batch(imgs, labels, cfg), \
            jgen.bucket_batch(imgs, labels)
        assert a.image.dtype == np.float32
        _same_batch(a, b)
    finally:
        jcfg.TRANSFER_DTYPE = old
