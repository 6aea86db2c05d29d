"""The readers of the program's own spans and counters
(``lstm_ctc_ocr_torch/utils/profiler.py``): each on a hand-built summary
and counters, ``None`` where what it reads is absent (as at a program
without them), and in a traced run of every cell here on the CPU at a
small size, where each cell's readers find something to read."""

import json
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
sys.path.insert(0, REPO)

from benchmark import harness  # noqa: E402

MS = 1_000_000                                  # ns

# a summary's spans (name, start ns, end ns) and device kernels (name,
# start ns, duration ns) on one clock
SUMMARY = {
    'spans': [('serve.request', 0, 30 * MS), ('serve.prepare', 0, 6 * MS),
              ('serve.enqueue', 10 * MS, 12 * MS),
              ('serve.enqueue', 20 * MS, 23 * MS),
              ('eval.beam', 100 * MS, 110 * MS),
              ('eval.beam', 200 * MS, 206 * MS),
              ('solver.upload', 300 * MS, 300 * MS + MS // 10),
              ('solver.replay', 301 * MS, 302 * MS),
              ('solver.readback_wait', 302 * MS, 340 * MS)],
    'kernels': [('k', t, 1000) for t in
                (99 * MS, 100 * MS, 105 * MS, 110 * MS, 150 * MS, 201 * MS)],
}
COUNTERS = {'serve.images': 60, 'serve.rows': 128, 'beam.frames': 40,
            'solver.dispatches': 1}
WANT = {
    'serve.prepare_ms_per_image': 6 / 60,
    'serve.enqueue_ms_per_call': (2 + 3) / 2,
    'serve.row_fill': 100.0 * 60 / 128,
    'decode.beam_ms_per_frame': (10 + 6) / 40,
    'decode.beam_launches_per_frame': 4 / 40,   # 100, 105, 110, 201 ms
    'train.enqueue_ms_per_dispatch': 1.1,
}
# what each reads: the spans (all but the row fill), the counters (all but
# the enqueue, which counts its spans)
READS_SPANS = set(WANT) - {'serve.row_fill'}
READS_COUNTERS = set(WANT) - {'serve.enqueue_ms_per_call'}


def _reader(name, monkeypatch, counters):
    """The reader ``name``, with the program's counters set to
    ``counters``."""
    from lstm_ctc_ocr_torch.utils import profiler
    monkeypatch.setattr(profiler, 'counters', counters.copy)
    return harness.load_module('metrics', name).read


@pytest.mark.parametrize('name', sorted(WANT))
def test_reader_on_a_hand_built_trace(name, monkeypatch):
    read = _reader(name, monkeypatch, COUNTERS)
    assert read(SUMMARY) == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize('name', sorted(WANT))
def test_reader_finds_nothing_to_read(name, monkeypatch):
    """No spans, or no counters (the program's parent has neither):
    ``None`` from each reader that reads them, and no exception."""
    read = _reader(name, monkeypatch, COUNTERS)
    if name in READS_SPANS:
        assert read(dict(SUMMARY, spans=[])) is None
    read = _reader(name, monkeypatch, {})
    if name in READS_COUNTERS:
        assert read(SUMMARY) is None
    assert read({'spans': [], 'kernels': []}) is None


def test_readers_take_the_programs_counters_by_default(monkeypatch):
    """A program without ``counters`` (as the parent's profiler module
    lacks it) reads as no counters."""
    from lstm_ctc_ocr_torch.utils import profiler
    monkeypatch.delattr(profiler, 'counters')
    for name in sorted(WANT):
        read = harness.load_module('metrics', name).read
        if name in READS_COUNTERS:
            assert read(SUMMARY) is None, name


def test_traced_cells_read_the_programs_spans():
    """Each cell traced once on the CPU, in a fresh process each: its new
    readers find their spans and counters (all but the launches a beam
    frame, which counts kernels on the card), and the program's row fill
    equals the benchmark's batch fill to the last digit."""
    with open(os.path.join(REPO, 'BENCHMARK.json')) as f:
        bench = json.load(f)
    new = {m['name']: m['workloads'] for m in bench['per_layer']
           if m['name'] in WANT}
    script = '''
import json, sys
sys.path.insert(0, {tests!r})
import test_bench_runs as t
print(json.dumps(t.run(sys.argv[1], trace=True)['metrics']))
'''.format(tests=os.path.join(BENCH, 'tests'))
    for cell in sorted({c for cells in new.values() for c in cells}):
        res = subprocess.run([sys.executable, '-c', script, cell],
                             capture_output=True, text=True, cwd=REPO,
                             timeout=600)
        assert res.returncode == 0, res.stderr[-3000:]
        metrics = json.loads(res.stdout.strip().splitlines()[-1])
        for name, cells in new.items():
            if cell in cells and name != 'decode.beam_launches_per_frame':
                assert metrics.get(name, {}).get('value'), (cell, name)
        if 'serve.row_fill' in metrics:
            assert metrics['serve.row_fill'] == metrics['serve.batch_fill']
