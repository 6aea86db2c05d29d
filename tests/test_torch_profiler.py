"""The port's ``StepProfiler`` (``utils/profiler.py``) against the JAX
package's, and ``PROFILE_DIR`` in the solver.

* Disabled by default: no trace, no directory. The device defaults to
  CUDA and raises without it.
* The window: the port's and the JAX ``StepProfiler`` driven through the
  same iteration sequences (one step a dispatch, and K = 3 and 8 steps a
  dispatch, where a dispatch can jump over the whole window and trace
  nothing), with the JAX ``jax.profiler.start_trace`` / ``stop_trace``
  replaced by recorders: both start and stop at the same ``it``, and print
  the same lines.
* On the CPU the port writes a Chrome trace (``*.pt.trace.json``) that
  names the traced ops; ``close()`` in the window stops and writes it.
* ``train_net(device='cpu')`` with ``PROFILE_DIR`` writes a trace and gives
  the same losses, bit for bit, as without it.
"""

import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax

from lstm_ctc_ocr_tpu.utils import profiler as jprofiler
from lstm_ctc_ocr_torch.config import default_cfg, load_cfg
from lstm_ctc_ocr_torch.data import records
from lstm_ctc_ocr_torch.engine import train
from lstm_ctc_ocr_torch.models.factory import get_network
from lstm_ctc_ocr_torch.utils.profiler import StepProfiler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _traces(d):
    return sorted(glob.glob(os.path.join(d, '*.pt.trace.json')))


def test_disabled_by_default(tmp_path):
    for prof in (StepProfiler(device='cpu'),
                 StepProfiler(cfg=default_cfg(), device='cpu')):
        assert not prof.enabled
        for it in range(50):
            prof.step(it)
        prof.close()
        assert not prof.active and not prof.done


def test_defaults_to_cuda_and_raises_without_it(monkeypatch):
    """``StepProfiler()`` with no device takes this process's CUDA device,
    as ``parallel/mesh.py:make_mesh`` does, so a trace on the card records
    its kernels; without CUDA it raises rather than land on the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        StepProfiler()
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        StepProfiler(cfg=default_cfg())
    assert StepProfiler(device='cpu').device == torch.device('cpu')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'current_device', lambda: 3)
    assert StepProfiler().device == torch.device('cuda', 3)


def _transitions(prof, its):
    """``[(it, 'start' | 'stop')]`` as the profiler's state moves."""
    out = []
    for it in its:
        was = prof.active
        prof.step(it)
        if prof.active != was:
            out.append((it, 'start' if prof.active else 'stop'))
    was = prof.active
    prof.close()
    if was:
        out.append(('close', 'stop'))
    return out


@pytest.mark.parametrize('start,num_steps,its', [
    (2, 3, list(range(0, 12))),             # K=1, the window inside the run
    (20, 10, list(range(1, 40))),           # the config's defaults
    (0, 100, list(range(0, 5))),            # the run ends in the window
    (3, 3, list(range(1, 60, 8))),          # K=8 jumps over [3, 6): nothing
    (3, 10, list(range(1, 60, 8))),         # K=8: starts at 9, stops at 17
    (4, 3, list(range(1, 30, 3))),          # K=3: starts at 4, stops at 7
    (5, 3, list(range(1, 30, 3))),          # K=3: starts at 7, stops at 10
])
def test_window_matches_jax(tmp_path, monkeypatch, capsys, start, num_steps,
                            its):
    calls = []
    monkeypatch.setattr(jax.profiler, 'start_trace',
                        lambda d: calls.append(('start', d)))
    monkeypatch.setattr(jax.profiler, 'stop_trace',
                        lambda: calls.append(('stop',)))
    jdir, pdir = str(tmp_path / 'jax'), str(tmp_path / 'port')
    want = _transitions(jprofiler.StepProfiler(jdir, start, num_steps), its)
    jax_lines = capsys.readouterr().out.replace(jdir, 'DIR')
    got = _transitions(StepProfiler(pdir, start, num_steps, device='cpu'),
                      its)
    port_lines = capsys.readouterr().out.replace(pdir, 'DIR')
    assert got == want
    assert port_lines == jax_lines
    assert [c[0] for c in calls] == [t for _, t in want]
    assert len(_traces(pdir)) == (1 if want else 0)


def test_trace_file_names_the_traced_ops(tmp_path):
    d = str(tmp_path / 'profile')
    prof = StepProfiler(trace_dir=d, start=2, num_steps=3, device='cpu')
    x = torch.ones(8, 8)
    for it in range(8):
        prof.step(it)
        x = torch.tanh(x @ x)
    assert prof.done and not prof.active
    files = _traces(d)
    assert len(files) == 1
    with open(files[0]) as f:
        trace = json.load(f)
    names = {e.get('name') for e in trace['traceEvents']}
    assert 'aten::mm' in names and 'aten::tanh' in names


def test_close_stops_open_trace(tmp_path):
    d = str(tmp_path / 'profile2')
    prof = StepProfiler(trace_dir=d, start=0, num_steps=100, device='cpu')
    prof.step(0)
    assert prof.active
    torch.ones(4, 4).sum()
    prof.close()               # an early exit in the window ends the trace
    assert not prof.active and prof.done
    assert len(_traces(d)) == 1
    prof.step(1)               # a closed window stays closed
    assert not prof.active


@pytest.fixture(scope='module')
def tiny_records(tmp_path_factory):
    root = tmp_path_factory.mktemp('records')
    img_dir = root / 'imgs'
    img_dir.mkdir()
    val = os.path.join(REPO, 'data', 'val')
    for f in sorted(os.listdir(val))[:12]:
        shutil.copy(os.path.join(val, f), str(img_dir / f))
    path = str(root / 'train.records')
    assert records.write_image_annotation_pairs_to_records(str(img_dir),
                                                           path) == 12
    return path


@pytest.mark.parametrize('k', [1, 3])
def test_train_net_traces_and_keeps_its_losses(tiny_records, tmp_path, k):
    """The solver with ``PROFILE_DIR`` (one step or three a dispatch)
    against the same run without it: a trace under the directory, the
    profiler's lines, and the same losses bit for bit."""
    def run(*overrides):
        cfg = load_cfg(os.path.join(REPO, 'lstm', 'lstm.yml'), [
            'TRAIN.DTYPE', "'float32'", 'DATA_BACKEND', 'records',
            'RECORDS_PATH', tiny_records, 'TRAIN.BATCH_SIZE', '4',
            'VAL.BATCH_SIZE', '4', 'TRAIN.NUM_HID', '16',
            'TRAIN.SNAPSHOT_ITERS', '100', 'VAL.VAL_STEP', '100',
            'TRAIN.STEPS_PER_DISPATCH', str(k)] + list(overrides))
        net = get_network('LSTM_train', cfg,
                          generator=torch.Generator().manual_seed(3))
        tag = 'p' if overrides else 'n'
        return train.train_net(net, {}, None, str(tmp_path / ('out' + tag)),
                               str(tmp_path / ('log' + tag)), cfg,
                               max_iters=8, device='cpu')[2]
    plain = run()
    d = str(tmp_path / 'trace')
    traced = run('PROFILE_DIR', d, 'PROFILE_START', '2', 'PROFILE_STEPS',
                 '3')
    assert len(plain) == 7 and np.isfinite(plain).all()
    assert traced == plain
    files = _traces(d)
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get('name') for e in json.load(f)['traceEvents']}
    assert 'aten::convolution' in names
