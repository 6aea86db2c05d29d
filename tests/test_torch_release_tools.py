"""The port's release tools against the JAX package's, on the CPU.

``tools/calibrate_bn.py`` and ``tools/release_ckpt.py`` of the JAX package
run as subprocesses (``JAX_PLATFORMS=cpu``) on copies of the same files as
the port's ``lstm_ctc_ocr_torch.tools.calibrate_bn`` / ``release_ckpt``.
Calibration: same release, seed, 2 batches of 4 of the synthetic stream
with the native renderer, f32; the pooled statistics agree to 1e-5
(relative and absolute: the two packages' convs sum in different orders),
every other array of the file is unchanged. A release written by the port
restores in both packages' loaders with the same parameters, and is the
JAX tool's file array for array. ``export_model --check --device cpu``
exits 0.
"""

import copy
import os
import shutil
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

import jax

from lstm_ctc_ocr_tpu.config import cfg as jcfg, cfg_from_file
from lstm_ctc_ocr_tpu.engine import checkpoint as jcheckpoint
from lstm_ctc_ocr_tpu.models.factory import get_network as jget_network
from lstm_ctc_ocr_torch.config import load_cfg
from lstm_ctc_ocr_torch.engine import checkpoint
from lstm_ctc_ocr_torch.engine import test as port_test
from lstm_ctc_ocr_torch.engine.train import make_optimizer
from lstm_ctc_ocr_torch.models.factory import get_network
from lstm_ctc_ocr_torch.tools import calibrate_bn, release_ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YML = os.path.join(REPO, 'lstm', 'lstm.yml')
RELEASE = os.path.join(REPO, 'checkpoints', 'lstm_ctc',
                       'lstm_ctc_iter_32207.ckpt.npz')


def _jax_tool(name, *args):
    env = dict(os.environ, JAX_PLATFORMS='cpu', PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, os.path.join(REPO, 'tools', name)]
                          + list(args), cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return proc.stdout


def _compressed(path):
    with zipfile.ZipFile(path) as z:
        return {i.compress_type for i in z.infolist()}


def test_calibrate_bn_matches_the_jax_tool(tmp_path):
    copies = []
    for side in ('jax', 'torch'):
        d = tmp_path / side / 'checkpoints' / 'lstm_ctc'
        d.mkdir(parents=True)
        copies.append(str(d / os.path.basename(RELEASE)))
        shutil.copy(RELEASE, copies[-1])
    common = ['--batches', '2', '--batch', '4', '--seed', '11']
    # LSTM_IMPL jax keeps the JAX forward off the Pallas interpreter; the
    # statistics come from the convs before the LSTM either way. ROOT_DIR
    # keeps the tools' output/<EXP_DIR> out of the repo.
    _jax_tool('calibrate_bn.py', '--cfg', YML, '--ckpt', copies[0], *common,
              '--set', 'RENDERER', 'native', 'TRAIN.DTYPE', 'float32',
              'LSTM_IMPL', 'jax', 'ROOT_DIR', str(tmp_path / 'jax'))
    assert calibrate_bn.main(['--cfg', YML, '--ckpt', copies[1], '--device',
                              'cpu', *common, '--set', 'RENDERER', 'native',
                              'TRAIN.DTYPE', "'float32'", 'ROOT_DIR',
                              str(tmp_path / 'torch')]) == 0
    original = checkpoint.read_flat(RELEASE)
    want, got = (checkpoint.read_flat(p) for p in copies)
    assert set(got) == set(want) == set(original)
    bn_keys = sorted(k for k in got if k.startswith('bn_state/'))
    assert bn_keys == ['bn_state/{}/{}'.format(layer, s)
                       for layer in ('conv4_1', 'conv4_2')
                       for s in ('mean', 'var')]
    for k in got:
        if k in bn_keys:
            assert got[k].dtype == want[k].dtype == np.float32
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)
            assert not np.array_equal(got[k], original[k])
        else:
            assert np.array_equal(got[k], original[k]), k
            assert got[k].dtype == original[k].dtype
    assert _compressed(copies[1]) == _compressed(copies[0]) \
        == {zipfile.ZIP_DEFLATED}


def _snapshot(root, exp):
    """A training snapshot written by the port's solver checkpointing:
    seeded parameters, moving statistics away from their initial values,
    Adam state. Returns (cfg, path, state_dict)."""
    cfg = load_cfg(YML, ['ROOT_DIR', str(root), 'EXP_DIR', exp,
                         'TRAIN.DTYPE', "'float32'"])
    model = get_network('LSTM_train', cfg,
                        generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        model.conv4_1.bn_mean.uniform_(-1.0, 1.0)
        model.conv4_2.bn_var.uniform_(0.5, 2.0)
        model.conv1.kernel[0, 0, 0, 0] = 1e5       # past f16's range: f32
    path = checkpoint.save(model, make_optimizer(model, cfg),
                           str(root / 'output' / exp), 5, cfg)
    return cfg, path, {k: v.clone() for k, v in model.state_dict().items()}


def test_release_restores_in_both_packages(tmp_path):
    exp = 'release_test'
    cfg, snap, state = _snapshot(tmp_path / 'torch', exp)
    assert release_ckpt.main(['--cfg', YML, '--set', 'ROOT_DIR',
                              str(tmp_path / 'torch'), 'EXP_DIR', exp]) == 0
    rel = str(tmp_path / 'torch' / 'checkpoints' / exp /
              'lstm_ctc_iter_5.ckpt.npz')
    flat = checkpoint.read_flat(rel)
    assert not any(k.startswith('opt_state') for k in flat)
    assert flat['params/conv1/kernel'].dtype == np.float32
    assert flat['params/conv2/kernel'].dtype == np.float16
    assert flat['bn_state/conv4_1/mean'].dtype == np.float32

    # the port's loader: f16 rounding of the snapshot, moving stats exact
    port = get_network('LSTM_test', cfg)
    checkpoint.load_into(port, rel, need_bn_state=True)
    for k, v in port.state_dict().items():
        want = state[k] if '.bn_' in k or k == 'conv1.kernel' \
            else state[k].half().float()
        assert torch.equal(v, want), k

    # the JAX loader restores the same values through the bridge
    old = copy.deepcopy(dict(jcfg))
    try:
        cfg_from_file(YML)
        net = jget_network('LSTM_test')
        params = net.init_params(jax.random.PRNGKey(0),
                                 {'data': (1, 64, jcfg.NUM_FEATURES),
                                  'time_step_len': (1,)})
        restored = jcheckpoint.restore(
            {'params': params, 'bn_state': net.init_bn_state()}, rel)
    finally:
        jcfg.clear()
        for k, v in old.items():
            jcfg[k] = v
    bridged = checkpoint.params_from_flat(
        jcheckpoint.flatten_state(restored))
    assert set(bridged) == set(port.state_dict())
    for k, v in port.state_dict().items():
        assert torch.equal(bridged[k], v), k

    # and the JAX tool writes the same file from the same snapshot
    jroot = tmp_path / 'jax'
    (jroot / 'output' / exp).mkdir(parents=True)
    shutil.copy(snap, str(jroot / 'output' / exp))
    _jax_tool('release_ckpt.py', '--cfg', YML, '--set', 'ROOT_DIR',
              str(jroot), 'EXP_DIR', exp)
    jflat = checkpoint.read_flat(str(jroot / 'checkpoints' / exp /
                                     'lstm_ctc_iter_5.ckpt.npz'))
    assert set(jflat) == set(flat)
    for k in flat:
        assert flat[k].dtype == jflat[k].dtype and np.array_equal(
            flat[k], jflat[k]), k


def test_release_verify_evaluates_the_released_file(tmp_path, capsys):
    """``--verify-dir`` evaluates the file it released: an f16 release of
    the f16 ``lstm_ctc`` release decodes as the release itself does."""
    exp = 'verify_test'
    (tmp_path / 'output' / exp).mkdir(parents=True)
    shutil.copy(RELEASE, str(tmp_path / 'output' / exp))
    val = tmp_path / 'val'
    val.mkdir()
    src = os.path.join(REPO, 'data', 'val')
    for f in sorted(os.listdir(src))[:8]:
        shutil.copy(os.path.join(src, f), str(val / f))
    sets = ['--set', 'ROOT_DIR', str(tmp_path), 'EXP_DIR', exp,
            'TRAIN.DTYPE', "'float32'"]
    assert release_ckpt.main(['--cfg', YML, '--verify-dir', str(val),
                              '--batch', '4', '--device', 'cpu'] + sets) == 0
    out = capsys.readouterr().out
    cfg = load_cfg(YML, sets[1:] + ['TEST.BATCH_SIZE', '4'])
    r = port_test.test_net(cfg, str(val), os.path.dirname(RELEASE),
                           device='cpu', echo=lambda s: None)
    assert 'released-weights accuracy: {:.4f} ({}/8,'.format(
        r.acc, r.correct) in out


@pytest.mark.parametrize('bn_eval', ['batch', 'moving'])
def test_export_model_check_exits_0(tmp_path, bn_eval):
    root = tmp_path / 'root'
    (root / 'checkpoints').mkdir(parents=True)
    os.symlink(os.path.dirname(RELEASE), str(root / 'checkpoints' /
                                             'lstm_ctc'))
    out = tmp_path / 'export'
    proc = subprocess.run(
        [sys.executable, '-m', 'lstm_ctc_ocr_torch.tools.export_model',
         '--cfg', YML, '--buckets', '64', '--batch', '2', '--device', 'cpu',
         '--check', '--out', str(out), '--set', 'ROOT_DIR', str(root),
         'TRAIN.DTYPE', "'float32'", 'BN_EVAL', repr(bn_eval)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert 'bucket 64: artifact == live decode' in proc.stdout
    assert sorted(os.listdir(out)) == ['decode_w64.pt2', 'manifest.json']


def test_export_model_refuses_moving_without_bn_state(tmp_path):
    exp = 'no_bn_state'
    d = tmp_path / 'checkpoints' / exp
    d.mkdir(parents=True)
    flat = {k: v for k, v in checkpoint.read_flat(RELEASE).items()
            if not k.startswith('bn_state/')}
    checkpoint.write_npz(str(d / 'lstm_ctc_iter_1.ckpt.npz'), flat)
    from lstm_ctc_ocr_torch.tools import export_model
    with pytest.raises(RuntimeError, match='has no bn_state'):
        export_model.main(['--cfg', YML, '--device', 'cpu', '--set',
                           'ROOT_DIR', str(tmp_path), 'EXP_DIR', exp,
                           'BN_EVAL', "'moving'"])
