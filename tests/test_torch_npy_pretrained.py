"""``.npy`` pre-train dicts in the port: ``tools/convert_ckpt2npy.py`` and
``engine/checkpoint.py:load_npy_pretrained``, against the JAX package's.

* The port's converter writes the JAX converter's dict (same keys, nesting,
  dtypes and bytes) for the ``lstm_ctc`` release.
* The JAX converter's ``.npy`` of the release, loaded into the port's
  model, gives exactly the tensors a ``.ckpt.npz`` warm start gives.
* A stacked ``lstm`` head's list cells (digit keys) round-trip, and load
  into the DSL's ``.lstm`` net as into the JAX tree.
* ``ignore_missing``: unknown names are skipped and shape mismatches are
  skipped with the JAX line; without it both raise as the JAX loader does.
* The solver's ``pre_train`` takes the ``.npy`` (loaded with
  ``ignore_missing``, as the JAX solver loads it): two steps from it equal
  two steps from the ``.ckpt.npz`` it was converted from, bit for bit.
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

import jax

from lstm_ctc_ocr_tpu.engine import checkpoint as jcheckpoint
from lstm_ctc_ocr_torch.config import load_cfg
from lstm_ctc_ocr_torch.data import records
from lstm_ctc_ocr_torch.engine import checkpoint, train
from lstm_ctc_ocr_torch.models import crnn
from lstm_ctc_ocr_torch.tools import convert_ckpt2npy

from torch_dsl_cases import JaxCfg, JChain, PChain, perturbed_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RELEASE = os.path.join(REPO, 'checkpoints', 'lstm_ctc',
                       'lstm_ctc_iter_32207.ckpt.npz')
sys.path.insert(0, os.path.join(REPO, 'tools'))
import convert_ckpt2npy as jconvert  # noqa: E402  (the JAX package's tool)


def _load(path):
    return np.load(path, allow_pickle=True).item()


def _assert_same_tree(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_same_tree(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])


def test_converter_writes_the_jax_dict(tmp_path):
    want = str(tmp_path / 'jax.npy')
    got = str(tmp_path / 'port.npy')
    jconvert.convert(RELEASE, want)
    assert convert_ckpt2npy.main([RELEASE, '--out', got]) == 0
    _assert_same_tree(_load(got), _load(want))
    assert sorted(_load(got)) == ['conv1', 'conv2', 'conv3_1', 'conv3_2',
                                  'conv4_1', 'conv4_2', 'conv5', 'logits']
    # the default name: the checkpoint's path with .npy for its suffix
    ckpt = str(tmp_path / 'x_iter_1.ckpt.npz')
    shutil.copy(RELEASE, ckpt)
    convert_ckpt2npy.main([ckpt])
    assert os.path.isfile(str(tmp_path / 'x_iter_1.ckpt.npy'))


def test_jax_npy_loads_as_the_checkpoint(tmp_path):
    path = str(tmp_path / 'rel.npy')
    jconvert.convert(RELEASE, path)
    a = crnn.LSTM_train(generator=torch.Generator().manual_seed(0))
    b = crnn.LSTM_train(generator=torch.Generator().manual_seed(1))
    assert checkpoint.load_npy_pretrained(a, path) is a
    checkpoint.load_into(b, RELEASE, need_bn_state=False, params_only=True)
    sa, sb = a.state_dict(), b.state_dict()
    for k in sa:
        if k.endswith(('bn_mean', 'bn_var')):
            continue               # not in a params dict: both keep their own
        assert torch.equal(sa[k], sb[k]), k


def _stacked_steps():
    return [(('data',), 'conv_single', (3, 3, 4, 1, 1), {'name': 'conv1'}),
            (None, 'max_pool', (2, 2, 2, 2), {'padding': 'VALID',
                                              'name': 'pool1'}),
            (None, 'conv_single', (2, 8, 8, 1, 1), {'padding': 'VALID',
                                                     'name': 'conv5'}),
            (None, 'reshape_squeeze_layer', (), {'d': 8, 'name': 'r'}),
            (('r', 'time_step_len'), 'lstm', (6, 2), {'name': 'logits'})]


def test_list_cells_round_trip(tmp_path):
    """A stacked ``lstm`` head's cells, a list in the JAX tree, pass the
    converter as digit keys and load into the DSL's ``.lstm`` net and into
    the JAX tree alike."""
    shapes = {'data': (2, 16, 16), 'time_step_len': (2,)}
    names = ('data', 'time_step_len')
    with JaxCfg():
        jnet = JChain(_stacked_steps(), names)
        params = perturbed_params(jnet, shapes)
        ckpt = str(tmp_path / 'j_iter_5.ckpt.npz')
        np.savez(ckpt, **jcheckpoint.flatten_state({'params': params}))
        npy = str(tmp_path / 'j.npy')
        convert_ckpt2npy.convert(ckpt, npy)
        assert sorted(_load(npy)['logits']['cells']) == ['0', '1']
        fresh = jnet.init_params(jax.random.PRNGKey(9), shapes)
        jloaded = jcheckpoint.load_npy_pretrained(fresh, npy)
    pnet = PChain(_stacked_steps(), shapes, names)
    checkpoint.load_npy_pretrained(pnet, npy)
    got = checkpoint.flat_from_params(pnet.state_dict())
    want = jcheckpoint.flatten_state({'params': jloaded})
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def _messages(loader, model, path, ignore):
    """(printed lines, exception type and text) of one load."""
    import contextlib
    import io
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            loader(model, path, ignore_missing=ignore)
        err = None
    except (KeyError, ValueError) as e:
        err = (type(e), str(e))
    return buf.getvalue().splitlines(), err


@pytest.mark.parametrize('edit', ['unknown_layer', 'unknown_param',
                                  'unknown_cell', 'shape_mismatch'])
def test_ignore_missing_as_jax(tmp_path, edit):
    shapes = {'data': (2, 16, 16), 'time_step_len': (2,)}
    names = ('data', 'time_step_len')
    with JaxCfg():
        jnet = JChain(_stacked_steps(), names)
        params = perturbed_params(jnet, shapes)
    tree = {k: {p: np.asarray(v) for p, v in d.items() if p != 'cells'}
            for k, d in params.items()}
    tree['logits']['cells'] = {str(i): {p: np.asarray(v)
                                        for p, v in c.items()}
                               for i, c in enumerate(params['logits']['cells'])}
    if edit == 'unknown_layer':
        tree['fc9'] = {'weights': np.ones((2, 2), np.float32)}
    elif edit == 'unknown_param':
        tree['conv1']['gamma'] = np.ones((4,), np.float32)
    elif edit == 'unknown_cell':
        tree['logits']['cells']['2'] = dict(tree['logits']['cells']['1'])
    else:
        tree['logits']['weights'] = np.ones((6, 9), np.float32)
        tree['conv5']['kernel'] = np.ones((2, 16, 4, 7), np.float32)
    path = str(tmp_path / 'e.npy')
    np.save(path, tree, allow_pickle=True)
    for ignore in (True, False):
        with JaxCfg():
            jlines, jerr = _messages(
                lambda m, p, ignore_missing: jcheckpoint.load_npy_pretrained(
                    m, p, ignore_missing), params, path, ignore)
        pnet = PChain(_stacked_steps(), shapes, names)
        before = {k: v.clone() for k, v in pnet.state_dict().items()}
        plines, perr = _messages(checkpoint.load_npy_pretrained, pnet, path,
                                 ignore)
        assert plines == jlines
        assert perr == jerr
        if ignore:
            assert perr is None
            after = checkpoint.flat_from_params(pnet.state_dict())
            skipped = {'params/logits/weights', 'params/conv5/kernel'}
            for k, v in after.items():
                if edit == 'shape_mismatch' and k in skipped:
                    np.testing.assert_array_equal(
                        v, checkpoint.flat_from_params(before)[k])
                elif k.startswith('params/'):
                    leaf = jcheckpoint.flatten_state({'params': params})[k]
                    np.testing.assert_array_equal(v, np.asarray(leaf))
        else:
            assert perr is not None


@pytest.fixture(scope='module')
def tiny_records(tmp_path_factory):
    root = tmp_path_factory.mktemp('npy_records')
    img_dir = root / 'imgs'
    img_dir.mkdir()
    val = os.path.join(REPO, 'data', 'val')
    for f in sorted(os.listdir(val))[:8]:
        shutil.copy(os.path.join(val, f), str(img_dir / f))
    path = str(root / 'train.records')
    records.write_image_annotation_pairs_to_records(str(img_dir), path)
    return path


def test_solver_pre_train_npy_equals_npz(tmp_path, tiny_records):
    cfg = load_cfg(os.path.join(REPO, 'lstm', 'lstm.yml'), [
        'DATA_BACKEND', 'records', 'RECORDS_PATH', tiny_records,
        'DATA_DEVICE', "'off'", 'RENDERER', 'native', 'TRAIN.DTYPE',
        "'float32'", 'TRAIN.BATCH_SIZE', '2', 'VAL.BATCH_SIZE', '2',
        'TRAIN.NUM_HID', '16', 'TRAIN.SNAPSHOT_ITERS', '100',
        'TRAIN.LOSS_MIN_SNAPSHOT', '0.0'])
    seed_model = crnn.LSTM_train(num_hid=16,
                                 generator=torch.Generator().manual_seed(4))
    ckpt = str(tmp_path / 'w_iter_1.ckpt.npz')
    checkpoint.write_npz(ckpt, checkpoint.flat_from_params(
        seed_model.state_dict()))
    npy = str(tmp_path / 'w.npy')
    convert_ckpt2npy.convert(ckpt, npy)
    runs = []
    for pre in (npy, ckpt):
        net = crnn.LSTM_train(num_hid=16,
                              generator=torch.Generator().manual_seed(5))
        model, _, losses = train.train_net(
            net, {}, pre, str(tmp_path / 'out'), str(tmp_path / 'logs'),
            cfg, max_iters=3, device='cpu')
        runs.append((losses, model.state_dict()))
    assert len(runs[0][0]) == 2 and runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k
