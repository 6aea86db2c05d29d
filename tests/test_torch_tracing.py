"""The program's spans and counters (``utils/profiler.py:span``, ``count``)
in the serving export, the eval decode and the solver's dispatch.

* With no trace running nothing is recorded: ``record_function`` is never
  entered and no counter moves, through ``ExportedDecoder.decode_images``,
  ``make_decode_step`` (beam and greedy) and a CPU ``make_train_chunk``.
* Under ``torch.profiler`` every span shows in the Kineto events, nested
  and ordered as the layers run, and the counters count the known work:
  images, rows (calls times the programs' batch), frames (T a beam call)
  and dispatches.
* The gate: under export, compile or a CUDA graph's capture a span and a
  count do nothing, also while a trace runs; a decoder exported inside an
  active profiler holds the same graph as one exported without. A
  capture's tally takes no count or wrapper launch of another thread.
* On the card (skipped without one): a replayed dispatch's upload, replay
  and readback wait, and its counters.

Small shapes: f32, NUM_HID 16, the programs' batch 2, buckets 64 and 96,
beam width 4. The file imports no JAX, so its card test runs where JAX is
missing (``tests/test_torch_device_store.py`` says how).
"""

import threading

import numpy as np
import pytest
import torch

from lstm_ctc_ocr_torch.config import load_cfg
from lstm_ctc_ocr_torch.engine import serve, train
from lstm_ctc_ocr_torch.engine import test as port_test
from lstm_ctc_ocr_torch.models.factory import get_network
from lstm_ctc_ocr_torch.utils import profiler

from test_torch_multistep import (_cfg, _model, _one_thread,  # noqa: F401
                                  _store, cuda_device)

BUCKETS, BATCH = [64, 96], 2
SERVE_SPANS = ('serve.request', 'serve.prepare', 'serve.pad', 'serve.upload',
               'serve.enqueue', 'serve.readback', 'serve.to_strings')
CHUNK_SPANS = ('serve.pad', 'serve.upload', 'serve.enqueue',
               'serve.readback', 'serve.to_strings')
PREFIXES = ('serve.', 'eval.', 'solver.')


def _decode_cfg(decoder='greedy'):
    return load_cfg(None, ['TRAIN.DTYPE', "'float32'", 'TRAIN.NUM_HID', '16',
                           'TEST.BATCH_SIZE', str(BATCH), 'DECODER',
                           repr(decoder), 'BEAM_WIDTH', '4'])


def _decode_model(cfg):
    return get_network('LSTM_test', cfg, generator=torch.Generator()
                       .manual_seed(0)).eval()


@pytest.fixture(scope='module')
def served(tmp_path_factory):
    """An exported greedy decoder at both buckets."""
    out = str(tmp_path_factory.mktemp('served'))
    cfg = _decode_cfg()
    serve.export_decoder(_decode_model(cfg), cfg, out, buckets=BUCKETS,
                         batch=BATCH, device='cpu')
    return serve.ExportedDecoder(out, device='cpu')


def _images():
    """Raw grayscale images: after the resize to height 32, three land in
    bucket 64 and two in bucket 96 (two calls and one at batch 2)."""
    rng = np.random.RandomState(0)
    return [(rng.rand(60, w) * 255).astype(np.uint8)
            for w in (90, 180, 150, 40, 100)]


def _decode_args(width, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(BATCH, width, 32).astype(np.float32),
            np.array([width // 4 - 1, width // 8], np.int32))


def _train_chunk(k=2):
    cfg = _cfg()
    model = _model(cfg)
    chunk = train.make_train_chunk(model, train.make_optimizer(model, cfg),
                                   cfg, None, k, gather=True)
    store = _store(cfg, 'cpu')
    return lambda: chunk(*store.arrays,
                         torch.from_numpy(store.next_indices(4, k)))


def _path(served, name):
    """One instrumented path, as a call."""
    if name == 'serve':
        return lambda: served.decode_images(_images())
    if name == 'train':
        return _train_chunk()
    cfg = _decode_cfg(name)
    step = port_test.make_decode_step(_decode_model(cfg), cfg, 'cpu')
    return lambda: step(*_decode_args(64))


def _spans(prof):
    """``[(name, start_ns, end_ns)]`` of the program's ranges in the trace,
    by start."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith(PREFIXES) \
                and not str(ev.device_type()).endswith('CUDA'):
            out.append((ev.name(), ev.start_ns(),
                        ev.start_ns() + ev.duration_ns()))
    return sorted(out, key=lambda s: s[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _traced(fn, cuda=False):
    """``fn()`` under a trace: its result, the program's spans and what
    the counters gained."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    before = profiler.counters()
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
    gained = {k: v - before.get(k, 0)
              for k, v in profiler.counters().items() if v != before.get(k)}
    return out, _spans(prof), gained


@pytest.mark.parametrize('path', ['serve', 'beam', 'greedy', 'train'])
def test_no_trace_records_nothing(served, path, monkeypatch):
    run = _path(served, path)

    def entered(name):
        raise AssertionError('record_function({!r}) with no trace'.format(
            name))
    monkeypatch.setattr(torch.profiler, 'record_function', entered)
    before = profiler.counters()
    run()
    run()
    assert profiler.counters() == before


def test_off_path_is_one_shared_null_context():
    assert profiler.span('serve.prepare') is profiler.span('solver.replay')
    with profiler.span('eval.beam'):
        pass


def test_served_request_spans_nest_and_rows_are_counted(served):
    calls = served.calls
    strings, spans, counts = _traced(lambda: served.decode_images(
        _images()))
    n_calls = served.calls - calls
    assert len(strings) == 5 and n_calls == 3
    assert counts == {'serve.images': 5, 'serve.rows': n_calls * BATCH}
    names = [s[0] for s in spans]
    assert set(names) == set(SERVE_SPANS)
    assert names.count('serve.request') == names.count('serve.prepare') == 1
    for name in CHUNK_SPANS:
        assert names.count(name) == n_calls, name
    request = spans[names.index('serve.request')]
    assert all(_inside(s, request) for s in spans if s is not request)
    # the images are prepared first, then each chunk runs its spans in turn
    assert names[1] == 'serve.prepare'
    assert names[2:] == list(CHUNK_SPANS) * n_calls
    for a, b in zip(spans[1:], spans[2:]):
        assert a[2] <= b[1], (a, b)


@pytest.mark.parametrize('decoder', ['beam', 'greedy'])
def test_decode_step_spans_and_frames(decoder):
    cfg = _decode_cfg(decoder)
    step = port_test.make_decode_step(_decode_model(cfg), cfg, 'cpu')

    def two_calls():
        return [step(*_decode_args(w, seed=w)) for w in BUCKETS]
    ids, spans, counts = _traced(two_calls)
    want = {}
    call = ['eval.upload', 'eval.forward', 'eval.readback']
    if decoder == 'beam':
        want['beam.frames'] = sum(i.shape[1] for i in ids)
        assert want['beam.frames'] == sum(w // 4 - 1 for w in BUCKETS)
        call.insert(2, 'eval.beam')
    assert counts == want
    assert [s[0] for s in spans] == call * 2
    for a, b in zip(spans, spans[1:]):
        assert a[2] <= b[1], (a, b)


def test_cpu_dispatch_counts_steps():
    run = _train_chunk(k=3)
    _, spans, counts = _traced(lambda: (run(), run()))
    assert counts == {'solver.dispatches': 2}
    assert [s[0] for s in spans] == ['solver.upload'] * 2


@pytest.mark.parametrize('gate', ['compiling', 'exporting', 'capturing'])
def test_no_span_or_count_inside_a_program_being_built(gate, monkeypatch):
    if gate == 'capturing':
        monkeypatch.setattr(torch.cuda, 'is_initialized', lambda: True)
        monkeypatch.setattr(torch.cuda, 'is_current_stream_capturing',
                            lambda: True)
    else:
        monkeypatch.setattr(torch.compiler, 'is_' + gate, lambda: True)

    def body():
        with profiler.span('solver.replay'):
            profiler.count('solver.dispatches')
    _, spans, counts = _traced(body)
    assert spans == [] and counts == {}


def test_a_capture_takes_no_count_or_launch_from_another_thread():
    """While a ``capture_counts`` block is open, another thread's counts
    and wrapper launches go where they go without it; the block's tally
    gets its own thread's alone."""
    def wrapper():
        pass
    wrapper.launches = 0
    opened, done = threading.Event(), threading.Event()

    def other():
        assert opened.wait(30)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]):
            profiler.count('serve.images', 5)
        profiler.launched(wrapper)
        done.set()
    before = profiler.counters()
    thread = threading.Thread(target=other)
    thread.start()
    with profiler.capture_counts() as tally:
        opened.set()
        assert done.wait(30)
        profiler.count('serve.rows', 2)
        profiler.launched(wrapper)
    thread.join(30)
    assert tally == {'serve.rows': 2} and tally.launches == {wrapper: 1}
    assert wrapper.launches == 1
    assert profiler.counters()['serve.images'] - before.get(
        'serve.images', 0) == 5
    assert profiler.counters().get('serve.rows', 0) == before.get(
        'serve.rows', 0)


@pytest.mark.parametrize('decoder', ['greedy', 'beam'])
def test_export_under_a_trace_is_the_same_program(decoder, tmp_path):
    cfg = _decode_cfg(decoder)
    model = _decode_model(cfg)

    def program(d, traced):
        def export():
            serve.export_decoder(model, cfg, str(tmp_path / d), buckets=[32],
                                 batch=BATCH, device='cpu')
        if traced:
            _, spans, counts = _traced(export)
            assert spans == [] and counts == {}
        else:
            export()
        ep = torch.export.load(str(tmp_path / d / 'decode_w32.pt2'))
        return [(n.op, str(n.target)) for n in ep.graph.nodes]
    plain = program('plain', False)
    assert program('traced', True) == plain
    assert not any('profiler' in t for _, t in plain)


def test_replayed_dispatch_spans_and_counts(cuda_device):
    """A K-step dispatch replayed under a trace: its index upload, the
    replay and the readback's wait as spans, once a dispatch, and the
    counters; the capture dispatch, before the trace, is not counted."""
    cfg = _cfg('TRAIN.NUM_HID', '64', 'TRAIN.DTYPE', "'bfloat16'")
    k, n = 4, 8
    model = _model(cfg, cuda_device)
    store = _store(cfg, cuda_device, n_rows=24)
    chunk = train.make_train_chunk(model, train.make_optimizer(model, cfg),
                                   cfg, torch.bfloat16, k, gather=True)

    def dispatch():
        return chunk(*store.arrays, torch.from_numpy(
            store.next_indices(n, k)).to(cuda_device))
    dispatch()                          # eager, then captured
    torch.cuda.synchronize()

    def three():
        losses = []
        for _ in range(3):
            pending = train._start_readback(dispatch()[0])
            losses.extend(train._finish_readback(pending))
        return losses
    losses, spans, counts = _traced(three, cuda=True)
    assert len(losses) == 3 * k and all(np.isfinite(losses))
    assert counts == {'solver.dispatches': 3}
    assert [s[0] for s in spans] == ['solver.upload', 'solver.replay',
                                     'solver.readback_wait'] * 3
    for a, b in zip(spans, spans[1:]):
        assert a[2] <= b[1], (a, b)
