"""Runs of every cell with the look for a card skipped: here on the CPU at
a small size, through the program's plain versions.

* Each cell sets up, runs a short window, compares, prints a result line,
  and loads neither JAX nor the JAX package (in a fresh process).
* With the timed path broken underneath, ``correct`` comes out false: a
  training step that leaves the state unchanged, a loss over half the
  batch, a decoded token altered where it is produced.
* The control, the reference in float8 put in the program's place, fails
  a number of each cell.
* On the card (skipped elsewhere), the control at the cell's own size.
"""

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
sys.path.insert(0, REPO)

from benchmark import calibrate, common, harness  # noqa: E402

TRAIN = 'crnn_captcha.train_graphed'
SMALL = {
    'crnn_captcha.train_graphed': (
        dict(trace_units=2),
        {'TRAIN.NUM_HID': 16, 'TRAIN.DTYPE': 'float32',
         'TRAIN.BATCH_SIZE': 4, 'TRAIN.STEPS_PER_DISPATCH': 2}),
    'crnn_longline.train_graphed': (
        dict(trace_units=1),
        {'TRAIN.NUM_HID': 16, 'TRAIN.DTYPE': 'float32',
         'TRAIN.BATCH_SIZE': 3, 'TRAIN.STEPS_PER_DISPATCH': 2}),
    'crnn_longline.eval_beam': (
        dict(drawn_requests=8, check_requests=2, trace_units=1),
        {'BEAM_WIDTH': 4, 'TEST.BATCH_SIZE': 8}),
    'crnn_captcha.serve_greedy': (
        dict(request_images=16, drawn_requests=8, check_requests=2,
             trace_units=1),
        {'TEST.BATCH_SIZE': 8}),
}


def small(name):
    work, config = common.load_cell(name)
    over_w, over_c = SMALL[name]
    work = dict(work, **over_w)
    config = copy.deepcopy(config)
    for key, v in over_c.items():
        d = config['cfg']
        *path, leaf = key.split('.')
        for p in path:
            d = d[p]
        d[leaf] = v
    return work, config


def run(name, trace=False, seed=2**31 + 11):
    work, config = small(name)
    ctx = harness.Context(name, work, config, seed, 0.2, trace, 'cpu')
    out = harness.run_cell(ctx, harness.load_module('traffic', work['kind']),
                           time.time())
    with open(os.path.join(REPO, 'BENCHMARK.json')) as f:
        e2e, layer = harness.cell_metrics(json.load(f), name)
    return harness.result_line(ctx, out, e2e, layer, {'platform': 'cpu'})


def test_every_cell_runs_and_loads_no_jax():
    script = '''
import json, sys
sys.path.insert(0, {bench!r})
sys.argv = ['x']
import test_bench_runs as t
from benchmark import harness
lines = {{n: t.run(n, trace=n.endswith('serve_greedy')) for n in t.SMALL}}
print(json.dumps([lines, harness.forbidden_modules()]))
'''.format(bench=os.path.join(BENCH, 'tests'))
    res = subprocess.run([sys.executable, '-c', script], capture_output=True,
                         text=True, cwd=REPO, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    lines, bad = json.loads(res.stdout.strip().splitlines()[-1])
    assert bad == []
    for name, line in lines.items():
        assert line['correct'] is True, (name, line['checks'])
        assert list(line)[-1] == 'checks'
        assert line['attempted'] > 0 and line['failed'] == 0
    served = lines['crnn_captcha.serve_greedy']['metrics']
    assert served['serve.batch_fill']['value'] > 0


def test_a_step_that_leaves_the_state_unchanged_fails(monkeypatch):
    from lstm_ctc_ocr_torch.engine import train
    monkeypatch.setattr(train.Optimizer, 'step', lambda self: None)
    line = run(TRAIN)
    assert line['correct'] is False
    assert line['checks']['update_gap']['value'] > 0.5


def test_a_loss_over_half_the_batch_fails(monkeypatch):
    from lstm_ctc_ocr_torch.ops import ctc_cuda
    real = ctc_cuda.ctc_loss

    def half(logits, labels, label_lens, logit_lens):
        losses = real(logits, labels, label_lens, logit_lens)
        keep = torch.arange(losses.shape[0]) < losses.shape[0] // 2
        # the second half reads as infeasible: the mean is over the rest
        return torch.where(keep, losses, losses.detach() * 0 + 1e30)
    monkeypatch.setattr(ctc_cuda, 'ctc_loss', half)
    line = run(TRAIN)
    assert line['correct'] is False


def test_an_altered_beam_token_fails(monkeypatch):
    from lstm_ctc_ocr_torch.engine import test as port_test
    real = port_test.beam_decode

    def altered(*a, **k):
        ids = real(*a, **k).clone()
        ids[0, 0] = ids[0, 0] % 62 + 1
        return ids
    monkeypatch.setattr(port_test, 'beam_decode', altered)
    line = run('crnn_longline.eval_beam')
    assert line['correct'] is False


def test_an_altered_served_token_fails(monkeypatch):
    from lstm_ctc_ocr_torch.engine import serve
    real = serve.ExportedDecoder.run

    def altered(self, images, steps):
        ids = np.array(real(self, images, steps))
        ids[0, 0] = ids[0, 0] % 62 + 1
        return ids
    monkeypatch.setattr(serve.ExportedDecoder, 'run', altered)
    line = run('crnn_captcha.serve_greedy')
    assert line['correct'] is False


@pytest.mark.parametrize('name', [TRAIN, 'crnn_longline.eval_beam',
                                  'crnn_captcha.serve_greedy'])
def test_the_control_fails(name):
    """The reference in float8 in the program's place fails a number of
    the cell, here at a small size with the cell's limits."""
    work, config = small(name)
    rows = []
    calibrate.readings(name, [2**31 + 3], 1, 0.2, 'cpu', rows.append,
                       work=work, config=config)
    control = rows[0]['fp8']
    assert any(v > work['limits'][n] for n, v in control.items()), control


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the cell runs the CUDA kernels')
    return torch.device('cuda', 0)


@pytest.mark.parametrize('name', [w for w in SMALL])
def test_the_control_fails_on_the_card_at_the_cells_size(card, name):
    """On the card, at the cell's own size and one seed: the program's
    numbers within their limits, the control's past one of them."""
    work, _ = common.load_cell(name)
    rows = []
    calibrate.readings(name, [2**31 + 101], 1, 2.0, card, rows.append)
    assert all(v <= work['limits'][n] for n, v in rows[0]['program'].items())
    assert any(v > work['limits'][n] for n, v in rows[0]['fp8'].items())
