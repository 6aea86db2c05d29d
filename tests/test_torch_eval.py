"""The port's evaluation end to end against the JAX package's.

Both evaluations restore the tracked ``lstm_ctc`` release through the
release-directory fallback (an empty ``output/lstm_ctc``) and decode the same
64-image slice of ``data/val`` that tests/test_release_eval.py uses, on the
CPU in f32 at batch 16. Each file must decode to the same string.
"""

import copy
import os
import shutil
from collections import Counter

import pytest
import torch

from lstm_ctc_ocr_tpu.config import AttrDict, cfg as jcfg, cfg_from_file
from lstm_ctc_ocr_torch.config import load_cfg
from lstm_ctc_ocr_torch.data.gen import pick_bucket
from lstm_ctc_ocr_torch.data.image import png_size
from lstm_ctc_ocr_torch.engine import test as port_test

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def release_layout(tmp_path):
    """Fresh-clone layout: empty output/lstm_ctc, tracked checkpoints, and a
    copy of the first 64 val images."""
    out_dir = tmp_path / 'output' / 'lstm_ctc'
    out_dir.mkdir(parents=True)
    (tmp_path / 'checkpoints').mkdir()
    os.symlink(os.path.join(REPO, 'checkpoints', 'lstm_ctc'),
               str(tmp_path / 'checkpoints' / 'lstm_ctc'))
    val = os.path.join(REPO, 'data', 'val')
    sub = tmp_path / 'val'
    sub.mkdir()
    for f in sorted(f for f in os.listdir(val) if f.endswith('.png'))[:64]:
        shutil.copy(os.path.join(val, f), str(sub / f))
    return str(out_dir), str(sub)


@pytest.fixture
def _jcfg_guard():
    snapshot = copy.deepcopy(dict(jcfg))
    yield
    jcfg.clear()
    for k, v in snapshot.items():
        jcfg[k] = v


def test_eval_slice_matches_jax_eval(release_layout, _jcfg_guard, capsys):
    pytest.importorskip('cv2')
    out_dir, sub = release_layout

    cfg_from_file(os.path.join(REPO, 'lstm', 'lstm.yml'))
    jcfg.TEST.BATCH_SIZE = 16
    jcfg.TRAIN.DTYPE = 'float32'
    jcfg.DECODER = 'greedy'
    jcfg.PARALLEL = 'off'
    from lstm_ctc_ocr_tpu.engine.test import test_net as jtest_net
    from lstm_ctc_ocr_tpu.models.factory import get_network
    jacc, _ = jtest_net(get_network('LSTM_test'), AttrDict({'name': 'x'}),
                        sub, out_dir, None)
    want = {}
    for line in capsys.readouterr().out.splitlines():
        fname, sep, res = line.partition('    res: ')
        if sep and fname.endswith('.png'):
            want[fname] = res

    cfg = load_cfg(os.path.join(REPO, 'lstm', 'lstm.yml'),
                   ['TEST.BATCH_SIZE', '16', 'TRAIN.DTYPE', "'float32'"])
    lines = []
    result = port_test.test_net(cfg, sub, out_dir, device='cpu',
                                echo=lines.append)
    assert len(want) == result.total == 64
    assert result.predictions == want
    assert result.acc == pytest.approx(jacc)
    # one call per 16-image chunk of each width bucket
    per_bucket = Counter(
        pick_bucket(int(32 / h * w), cfg.BUCKETS)
        for w, h in (png_size(os.path.join(sub, f)) for f in want))
    assert result.decode_calls == sum(-(-n // 16) for n in per_bucket.values())
    assert any(line.startswith('total acc:') for line in lines)


def test_entry_points_default_to_cuda(release_layout):
    if torch.cuda.is_available():
        pytest.skip('a GPU is present: the default device works here')
    out_dir, sub = release_layout
    cfg = load_cfg(os.path.join(REPO, 'lstm', 'lstm.yml'))
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        port_test.test_net(cfg, sub, out_dir)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        port_test.main(['--cfg', os.path.join(REPO, 'lstm', 'lstm.yml'),
                        '--test_dir', sub])


def test_batch_one_path_matches_batched(release_layout):
    """TEST.BATCH_SIZE 1 under BN_EVAL moving (batch-independent BN) gives
    the batched path's strings on a few images."""
    out_dir, sub = release_layout
    for f in sorted(os.listdir(sub))[6:]:
        os.remove(os.path.join(sub, f))
    res = {}
    for bs in ('1', '4'):
        cfg = load_cfg(os.path.join(REPO, 'lstm', 'lstm.yml'),
                       ['TEST.BATCH_SIZE', bs, 'TRAIN.DTYPE', "'float32'",
                        'BN_EVAL', "'moving'"])
        res[bs] = port_test.test_net(cfg, sub, out_dir, device='cpu',
                                     echo=lambda s: None)
    assert res['1'].decode_calls == 6
    assert res['1'].predictions == res['4'].predictions
    assert res['1'].correct == res['4'].correct
