"""The readers of the beam search kernel (``csrc/beam.cu``):
``decode.beam_kernel_share`` (the program's counters ``beam.kernel_frames``
over ``beam.frames``) and ``decode.beam_kernel_us_per_frame`` (the device
time of the ``beam_kernel`` launches over ``beam.frames``). Each on a
hand-built summary and counters, ``None`` where what it reads is absent (as
at a program without the kernel), and in a traced run of the beam cell here
on the CPU, where the plain search runs and both leave their metric out."""

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
# start ns, duration ns) on one clock: two beam kernel launches, under the
# names the profiler gives a template instance, beside another kernel
SUMMARY = {
    'spans': [('eval.beam', 100 * MS, 110 * MS)],
    'kernels': [('k', 101 * MS, 1000),
                ('void (anonymous namespace)::beam_kernel<float>(float const*)',
                 250 * MS, 30_000),
                ('beam_kernel<__nv_bfloat16>', 260 * MS, 50_000)],
}
COUNTERS = {'beam.frames': 40, 'beam.kernel_frames': 30}
WANT = {
    'decode.beam_kernel_share': 100.0 * 30 / 40,
    'decode.beam_kernel_us_per_frame': (30 + 50) / 40,
}


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
@pytest.mark.parametrize('counters', [
    {}, {'beam.frames': 40}, {'beam.kernel_frames': 30}],
    ids=['none', 'frames_only', 'kernel_frames_only'])
def test_reader_finds_nothing_to_read(name, counters, monkeypatch):
    """A program without the kernel's counter, or without ``beam.frames``:
    ``None`` from the share, and from the time wherever ``beam.frames`` is
    missing or the trace holds no beam kernel; no exception."""
    read = _reader(name, monkeypatch, counters)
    if name == 'decode.beam_kernel_share' or 'beam.frames' not in counters:
        assert read(SUMMARY) is None
    assert read(dict(SUMMARY, kernels=SUMMARY['kernels'][:1])) is None
    assert read({'spans': [], 'kernels': []}) is None


@pytest.mark.parametrize('name', sorted(WANT))
def test_reader_takes_the_programs_counters_by_default(name, monkeypatch):
    """A program without ``counters`` (a profiler module that lacks it)
    reads as no counters."""
    from lstm_ctc_ocr_torch.utils import profiler
    monkeypatch.delattr(profiler, 'counters', raising=False)
    read = harness.load_module('metrics', name).read
    assert read(SUMMARY) is None


def test_readers_are_listed_for_the_beam_cell():
    with open(os.path.join(REPO, 'BENCHMARK.json')) as f:
        bench = json.load(f)
    metrics = {m['name']: m for m in bench['per_layer']}
    for name in WANT:
        read = harness.load_module('metrics', name)
        entry = metrics[name]
        assert entry['workloads'] == ['crnn_longline.eval_beam']
        assert (entry['layer'], entry['unit'], entry['moves']) == \
            (read.LAYER, read.UNIT, read.MOVES)


def test_traced_beam_cell_leaves_them_out_on_the_cpu():
    """The beam cell traced once on the CPU, in a fresh process: the plain
    search runs there, so neither the kernel's counter nor its launches
    exist, and the line leaves both metrics out without failing."""
    script = '''
import json, sys
sys.path.insert(0, {tests!r})
import test_bench_runs as t
print(json.dumps(t.run(sys.argv[1], trace=True)['metrics']))
'''.format(tests=os.path.join(BENCH, 'tests'))
    res = subprocess.run([sys.executable, '-c', script,
                          'crnn_longline.eval_beam'],
                         capture_output=True, text=True, cwd=REPO,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    metrics = json.loads(res.stdout.strip().splitlines()[-1])
    assert metrics.get('decode.beam_ms_per_frame', {}).get('value')
    for name in WANT:
        assert name not in metrics
