"""The port's TF interop tools against the JAX package's, on the same
inputs (``lstm_ctc_ocr_torch/tools/{export_tfrecords, import_tfrecords,
import_tf_checkpoint}.py`` against ``tools/*.py``):

* export: the ``.tfrecords`` bytes of a records file and of an image
  directory identical (the reference schema, RGB replication and the
  ``time_step`` quirk included);
* import: reference-style TFRecords (RGB, gray + alpha and gray images, a
  label past MAX_CHAR_LEN, an id outside the charset) give byte-identical
  records files, and export then import gives the source back;
* checkpoint import: a TF1 checkpoint with the reference CRNN's variable
  names (batch-norm spellings, moving statistics and optimizer slots
  included) gives ``.npy`` dicts equal array for array, which the port's
  ``load_npy_pretrained`` loads into the CRNN.

Those need tensorflow (``pytest.importorskip``, as the JAX package's tests
do). One test needs none: with ``tensorflow`` unimportable each tool
raises ``ImportError`` naming it and the tool.
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

from lstm_ctc_ocr_torch.config import default_cfg, get_encode_decode_dict
from lstm_ctc_ocr_torch.data.records import RecordsWriter
from lstm_ctc_ocr_torch.engine import checkpoint
from lstm_ctc_ocr_torch.models.factory import get_network
from lstm_ctc_ocr_torch.tools import export_tfrecords as port_export
from lstm_ctc_ocr_torch.tools import import_tf_checkpoint as port_ckpt
from lstm_ctc_ocr_torch.tools import import_tfrecords as port_import

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'tools'))

import export_tfrecords as jax_export  # noqa: E402
import import_tf_checkpoint as jax_ckpt  # noqa: E402
import import_tfrecords as jax_import  # noqa: E402


@pytest.fixture
def tf():
    return pytest.importorskip('tensorflow')


def _read(path):
    with open(path, 'rb') as f:
        return f.read()


def _records(path, seed=0, n=4):
    rng = np.random.RandomState(seed)
    labels = ['aB3x', 'Zz90qQ', '7H1', 'mN5', 'q2']
    with RecordsWriter(path) as w:
        for i in range(n):
            w.add(labels[i % len(labels)],
                  rng.randint(0, 256, (32, 60 + 20 * i), dtype=np.uint8))
    return path


def test_export_bytes_match_jax(tf, tmp_path):
    src = _records(str(tmp_path / 'src.records'))
    img_dir = tmp_path / 'imgs'
    img_dir.mkdir()
    val = os.path.join(REPO, 'data', 'val')
    for f in sorted(os.listdir(val))[:5]:
        shutil.copy(os.path.join(val, f), str(img_dir / f))
    (img_dir / 'notes.txt').write_text('no label pattern')
    for what in (src, str(img_dir)):
        ours, theirs = str(tmp_path / 'port.tfr'), str(tmp_path / 'jax.tfr')
        n = port_export.export_tfrecords(what, ours)
        assert n == jax_export.export_tfrecords(what, theirs) > 0
        assert _read(ours) == _read(theirs), what
    # the schema's quirks, on the last file written
    raw = next(tf.data.TFRecordDataset(ours).as_numpy_iterator())
    ctx = tf.train.SequenceExample.FromString(raw).context.feature
    h, w = (ctx[k].int64_list.value[0] for k in ('height', 'width'))
    rgb = np.frombuffer(ctx['image_raw'].bytes_list.value[0],
                        np.uint8).reshape(h, w, 3)
    assert (rgb == rgb[..., :1]).all()
    assert ctx['time_step'].int64_list.value[0] == \
        default_cfg().IMG_SHAPE[0] == 32


def _reference_tfrecord(tf, path):
    """Reference-writer records: RGB, gray + alpha and gray payloads, one
    label past MAX_CHAR_LEN and one id outside the charset."""
    encode_maps, _ = get_encode_decode_dict(default_cfg())
    rng = np.random.RandomState(1)
    cases = [('aB3x', (40, 90, 3)), ('Zz90qQ', (32, 70, 2)),
             ('7H1', (32, 50)), ('abcdefgh', (32, 60, 3)), ('q2', (32, 40))]

    def i64(v):
        return tf.train.Feature(int64_list=tf.train.Int64List(value=[v]))
    with tf.io.TFRecordWriter(path) as w:
        for k, (label, shape) in enumerate(cases):
            img = rng.randint(0, 256, shape, dtype=np.uint8)
            ids = [encode_maps[c] for c in label]
            if k == len(cases) - 1:
                ids[0] = 99                       # not in the charset
            ids += [0] * max(0, 6 - len(ids))
            ex = tf.train.SequenceExample(
                context=tf.train.Features(feature={
                    'height': i64(shape[0]), 'width': i64(shape[1]),
                    'time_step': i64(32), 'label_len': i64(len(label)),
                    'image_raw': tf.train.Feature(bytes_list=tf.train
                                                  .BytesList(
                                                      value=[img.tobytes()]))}),
                feature_lists=tf.train.FeatureLists(feature_list={
                    'label': tf.train.FeatureList(
                        feature=[i64(v) for v in ids])}))
            w.write(ex.SerializeToString())


def test_import_records_match_jax(tf, tmp_path):
    tfr = str(tmp_path / 'ref.tfrecords')
    _reference_tfrecord(tf, tfr)
    ours, theirs = str(tmp_path / 'port.rec'), str(tmp_path / 'jax.rec')
    assert port_import.import_tfrecords(tfr, ours) == \
        jax_import.import_tfrecords(tfr, theirs) == 3
    assert _read(ours) == _read(theirs)
    # export then import is lossless
    src = _records(str(tmp_path / 'src.records'), seed=7)
    mid, back = str(tmp_path / 'mid.tfr'), str(tmp_path / 'back.records')
    port_export.export_tfrecords(src, mid)
    assert port_import.import_tfrecords(mid, back) == 4
    assert _read(back) == _read(src)


def test_checkpoint_import_matches_jax_and_loads(tf, tmp_path):
    from test_tf_interop import _reference_style_checkpoint
    ckpt = str(tmp_path / 'ref.ckpt')
    _reference_style_checkpoint(ckpt)
    ours, theirs = str(tmp_path / 'port.npy'), str(tmp_path / 'jax.npy')
    assert port_ckpt.main([ckpt, '--out', ours]) == 0
    jax_ckpt.convert_tf_checkpoint(ckpt, theirs)

    def flat(d, prefix=''):
        out = {}
        for k, v in d.items():
            out.update(flat(v, prefix + k + '/') if isinstance(v, dict)
                       else {prefix + k: v})
        return out
    a = flat(np.load(ours, allow_pickle=True).item())
    b = flat(np.load(theirs, allow_pickle=True).item())
    assert sorted(a) == sorted(b) and 'conv4_1/bn_gamma' in a
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], k)
    for name in ('conv4_1/conv4_1/moving_mean', 'conv1/weights/Adam'):
        assert port_ckpt.map_variable(name, (3,)) == \
            jax_ckpt.map_variable(name, (3,))

    # a checkpoint at the CRNN's own shapes feeds the port's --pre_train
    cfg = default_cfg()
    cfg.TRAIN.NUM_HID = 16
    model = get_network('LSTM_train', cfg)
    jflat = checkpoint.flat_from_params(model.state_dict())
    names = {'conv1/weights': 'params/conv1/kernel',
             'conv4_1/conv4_1/gamma': 'params/conv4_1/bn_gamma',
             'logits/bidirectional_rnn/fw/lstm_cell/kernel':
                 'params/logits/cells/fw/kernel',
             'logits/weights': 'params/logits/weights'}
    rng = np.random.RandomState(11)
    values = {n: rng.randn(*jflat[k].shape).astype(np.float32)
              for n, k in names.items()}
    g = tf.Graph()
    with g.as_default():
        tfvars = {n: tf.compat.v1.get_variable(n, initializer=v)
                  for n, v in values.items()}
        saver = tf.compat.v1.train.Saver(var_list=tfvars)
        with tf.compat.v1.Session() as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            saver.save(sess, str(tmp_path / 'crnn.ckpt'))
    out = str(tmp_path / 'crnn.npy')
    port_ckpt.convert_tf_checkpoint(str(tmp_path / 'crnn.ckpt'), out)
    before = checkpoint.flat_from_params(model.state_dict())
    checkpoint.load_npy_pretrained(model, out, ignore_missing=True)
    after = checkpoint.flat_from_params(model.state_dict())
    for n, k in names.items():
        np.testing.assert_array_equal(after[k], values[n], k)
    np.testing.assert_array_equal(after['params/conv2/kernel'],
                                  before['params/conv2/kernel'])


def test_each_tool_raises_by_name_without_tensorflow(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, 'tensorflow', None)
    src = _records(str(tmp_path / 'src.records'), n=1)
    calls = {
        'import_tf_checkpoint': lambda: port_ckpt.convert_tf_checkpoint(
            str(tmp_path / 'x.ckpt'), str(tmp_path / 'x.npy')),
        'import_tfrecords': lambda: port_import.import_tfrecords(
            str(tmp_path / 'x.tfrecords'), str(tmp_path / 'x.records')),
        'export_tfrecords': lambda: port_export.export_tfrecords(
            src, str(tmp_path / 'x.tfrecords')),
    }
    for tool, call in calls.items():
        with pytest.raises(ImportError, match='tensorflow') as e:
            call()
        assert 'lstm_ctc_ocr_torch.tools.' + tool in str(e.value)
    assert not os.path.exists(str(tmp_path / 'x.npy'))
