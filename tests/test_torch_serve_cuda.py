"""The served programs as CUDA graphs (``engine/serve.py:ExportedDecoder``)
on the card; every test skips without one.

Two tracked releases at their real shapes (batch 64, bf16, batch-statistics
BN), exported at every bucket of their configuration: ``lstm_ctc``
(greedy) and ``lstm_records`` (beam width 16). For each:

* the graphed decoder's ids equal the eager program's
  (``ExportedDecoder._programs``, called as the CPU path calls it) bit for
  bit on every bucket: a full chunk, a short chunk padded with copies of
  its last image, each three times, and calls that alternate buckets
  (rows of ``data/val`` captchas, their columns repeated to the bucket's
  width, with ragged steps);
* a replay moves the kernel wrappers' ``launches`` and the trace counter
  ``beam.kernel_frames`` exactly as an eager call does;
* ``serve.graph_replays`` counts every call but the first of each bucket;
* two threads sharing one decoder get the strings one thread gets;
* a capture made while another thread decodes holds its own program's
  launches and counts alone: the other thread's land where they would, and
  two threads that start on a fresh decoder leave graphs that count as
  graphs captured by one thread do.

The file imports no JAX, so it runs on the GPU machine::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_serve_cuda.py
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from lstm_ctc_ocr_torch.config import load_cfg
from lstm_ctc_ocr_torch.data.image import load_image, preprocess_image
from lstm_ctc_ocr_torch.engine import checkpoint, serve
from lstm_ctc_ocr_torch.engine import test as port_test
from lstm_ctc_ocr_torch.models.factory import get_network
from lstm_ctc_ocr_torch.ops import beam_cuda, rnn_cuda
from lstm_ctc_ocr_torch.utils import profiler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 64
RELEASES = {'greedy': 'lstm.yml', 'beam': 'records.yml'}
VAL = os.path.join(REPO, 'data', 'val')


def _val_files():
    return sorted(f for f in os.listdir(VAL) if f.endswith('.png'))


@pytest.fixture(scope='module')
def exported(tmp_path_factory):
    """decoder -> (export directory, buckets), each release exported on
    the card at every bucket of its configuration."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the programs are CUDA graphs there')
    out = {}
    for decoder, yml in RELEASES.items():
        cfg = load_cfg(os.path.join(REPO, 'lstm', yml),
                       ['TEST.BATCH_SIZE', str(BATCH), 'TRAIN.DTYPE',
                        "'bfloat16'", 'BN_EVAL', "'batch'"])
        assert str(cfg.DECODER) == decoder
        model = get_network('LSTM_test', cfg)
        checkpoint.load_into(model, checkpoint.latest_eval_checkpoint(
            os.path.join(REPO, 'checkpoints', cfg.EXP_DIR))[0], False)
        d = str(tmp_path_factory.mktemp(decoder))
        buckets = sorted(int(b) for b in cfg.BUCKETS)
        serve.export_decoder(model, cfg, d, buckets=buckets, batch=BATCH,
                             device='cuda')
        out[decoder] = (d, buckets)
    return out


@pytest.fixture(scope='module')
def captchas():
    """The first 64 ``data/val`` captchas at height 32, unpadded: f32
    [W, 32] in 0..1."""
    return [preprocess_image(load_image(os.path.join(VAL, f)), img_height=32,
                             num_features=32, pool_scale=4,
                             offset_time_step=-1, pick=lambda w: w)[0]
            for f in _val_files()[:BATCH]]


def _inputs(rng, captchas, w, rows=BATCH):
    """images [BATCH, w, 32] f32 and steps [BATCH] int32 in 1..T: the
    first ``rows`` drawn captchas, each one's columns repeated to ``w``,
    and the rest copies of the last, as ``decode_images`` pads a short
    chunk."""
    t_len = w // 4 - 1
    images = np.stack([np.resize(captchas[i], (w, 32))
                       for i in rng.randint(0, len(captchas), rows)])
    steps = rng.randint(1, t_len + 1, rows).astype(np.int32)
    steps[0] = t_len
    pad = BATCH - rows
    return (np.concatenate([images, images[-1:].repeat(pad, 0)]),
            np.concatenate([steps, steps[-1:].repeat(pad)]))


def _eager(dec, images, steps):
    """The loaded program called eagerly, as ``run`` calls it on the CPU."""
    with port_test.full_f32():
        x = torch.from_numpy(images).to(dec.device)
        lens = torch.from_numpy(steps).to(dec.device)
        return dec._programs[images.shape[1]](x, lens).cpu().numpy()


def _counted(fn, n):
    """Run ``fn`` ``n`` times under a trace: the launches of the kernel
    wrappers and the profiler's counts it added."""
    wrappers = {'bilstm_fwd': rnn_cuda.bilstm_fwd,
                'beam': beam_cuda.beam_decode}
    launches = {k: w.launches for k, w in wrappers.items()}
    counts = profiler.counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(n):
            fn()
    torch.cuda.synchronize()
    return ({k: w.launches - launches[k] for k, w in wrappers.items()},
            {k: v - counts.get(k, 0) for k, v in profiler.counters().items()
             if v != counts.get(k, 0)})


@pytest.mark.parametrize('decoder', ['greedy', 'beam'])
def test_graphed_ids_equal_the_eager_programs(exported, captchas, decoder):
    d, buckets = exported[decoder]
    dec = serve.ExportedDecoder(d, device='cuda')
    rng = np.random.RandomState(len(decoder))
    for w in buckets:
        for rows in (BATCH, 5):
            images, steps = _inputs(rng, captchas, w, rows)
            want = _eager(dec, images, steps)
            assert want.shape == (BATCH, w // 4 - 1) and want.any()
            for _ in range(3):
                np.testing.assert_array_equal(dec.run(images, steps), want,
                                              err_msg='W={}'.format(w))
    assert len(dec._graphs) == len(buckets)
    # buckets in turn, new inputs every call
    calls = [(w, _inputs(rng, captchas, w, rows)) for rows in (BATCH, 17)
             for w in buckets[::-1] + buckets]
    wants = [_eager(dec, *args) for _, args in calls]
    for (w, args), want in zip(calls, wants):
        np.testing.assert_array_equal(dec.run(*args), want,
                                      err_msg='W={}'.format(w))


@pytest.mark.parametrize('decoder', ['greedy', 'beam'])
def test_replays_count_as_eager_calls(exported, captchas, decoder):
    """From the bucket's first call on, each call adds one ``bilstm_fwd``
    launch (and one beam launch and T ``beam.kernel_frames`` on a beam
    release), as an eager call does: the capture's own are put back."""
    d, buckets = exported[decoder]
    dec = serve.ExportedDecoder(d, device='cuda')
    w = buckets[len(buckets) // 2]
    images, steps = _inputs(np.random.RandomState(5), captchas, w)
    n = 4
    graphed = _counted(lambda: dec.run(images, steps), n)
    eager = _counted(lambda: _eager(dec, images, steps), n)
    beam = decoder == 'beam'
    assert graphed[0] == eager[0] == {'bilstm_fwd': n, 'beam': n * beam}
    frames = {'beam.kernel_frames': n * (w // 4 - 1)} if beam else {}
    assert eager[1] == frames
    assert graphed[1] == dict(frames, **{'serve.rows': n * BATCH,
                                         'serve.graph_replays': n - 1})


def test_graph_replays_count_the_calls_after_each_buckets_first(exported,
                                                                captchas):
    d, buckets = exported['greedy']
    dec = serve.ExportedDecoder(d, device='cuda')
    rng = np.random.RandomState(7)
    order = [buckets[1], buckets[2], buckets[1], buckets[0], buckets[1],
             buckets[2], buckets[0]]
    inputs = [_inputs(rng, captchas, w) for w in order]
    _, counts = _counted(lambda: [dec.run(*a) for a in inputs], 1)
    assert counts['serve.graph_replays'] == len(order) - len(set(order))
    assert dec.calls == len(order) and len(dec._graphs) == len(set(order))
    _, counts = _counted(lambda: [dec.run(*a) for a in inputs], 1)
    assert counts['serve.graph_replays'] == len(order)


def test_two_threads_share_a_decoder(exported):
    """Each thread's requests come back as one thread decodes them, while
    the other thread's calls fill the same buckets' static buffers."""
    d, _ = exported['greedy']
    dec = serve.ExportedDecoder(d, device='cuda')
    requests = [[load_image(os.path.join(VAL, f))
                 for f in _val_files()[i::2][:90]] for i in range(2)]
    want = [dec.decode_images(r) for r in requests]
    assert all(any(s) for s in want)
    got = [[], []]

    def serve_requests(i):
        for _ in range(4):
            got[i].append(dec.decode_images(requests[i]))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=serve_requests, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert got == [[want[0]] * 4, [want[1]] * 4]


def _tallies(dec):
    """Each bucket graph's launches and counts, by bucket."""
    return {key[0][0][1]: (dict(g.launches), g.counts)
            for key, g in dec._graphs.items()}


def test_a_capture_beside_another_threads_work_holds_only_its_own(
        exported, captchas):
    """Decoder A captures a bucket while another thread, under a trace of
    its own, replays decoder B's graph and calls B's program eagerly: A's
    graph holds one launch of each of its kernels and its own
    ``beam.kernel_frames``; B's launches reach the wrappers and B's counts
    its trace."""
    d, buckets = exported['beam']
    w = buckets[0]
    t_len = w // 4 - 1
    rng = np.random.RandomState(11)
    a_in, b_in = _inputs(rng, captchas, w), _inputs(rng, captchas, w)
    dec_a = serve.ExportedDecoder(d, device='cuda')
    dec_b = serve.ExportedDecoder(d, device='cuda')
    want_a, want_b = _eager(dec_a, *a_in), dec_b.run(*b_in)
    program = dec_a._programs[w]
    tracing, capturing, done, captured = (
        threading.Event(), threading.Event(), threading.Event(),
        threading.Event())

    def held(x, lens):
        # the capture waits inside the graph until the other thread's work
        # is done
        if torch.cuda.is_current_stream_capturing():
            capturing.set()
            assert done.wait(120)
        return program(x, lens)
    dec_a._programs = {**dec_a._programs, w: held}
    got_b, counted = [], {}

    def other():
        before = profiler.counters()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            tracing.set()
            assert capturing.wait(120)
            got_b.append(dec_b.run(*b_in))
            got_b.append(_eager(dec_b, *b_in))
            done.set()
            assert captured.wait(120)     # the trace outlasts the capture
        counted.update({k: v - before.get(k, 0)
                        for k, v in profiler.counters().items()
                        if v != before.get(k, 0)})
    launches = (rnn_cuda.bilstm_fwd.launches, beam_cuda.beam_decode.launches)
    thread = threading.Thread(target=other)
    thread.start()
    assert tracing.wait(120)
    got_a = dec_a.run(*a_in)            # the warm-up, then the capture
    captured.set()
    thread.join(120)
    assert not thread.is_alive()
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got_a, want_a)
    np.testing.assert_array_equal(dec_a.run(*a_in), want_a)
    assert len(got_b) == 2
    for ids in got_b:
        np.testing.assert_array_equal(ids, want_b)
    assert _tallies(dec_a) == {w: (
        {rnn_cuda.bilstm_fwd: 1, beam_cuda.beam_decode: 1},
        {'beam.kernel_frames': t_len})}
    # A's warm-up and replay, B's replay and eager call
    assert (rnn_cuda.bilstm_fwd.launches - launches[0],
            beam_cuda.beam_decode.launches - launches[1]) == (4, 4)
    assert counted == {'serve.rows': BATCH, 'serve.graph_replays': 1,
                       'beam.kernel_frames': 2 * t_len}


def test_two_threads_start_on_a_fresh_decoder(exported):
    """Two threads share a decoder from its first call, so its captures
    run beside the other thread's requests: the strings are one thread's,
    each bucket's graph counts what a graph captured by one thread counts,
    and a traced pass after counts the requests' images and rows."""
    d, _ = exported['beam']
    requests = [[load_image(os.path.join(VAL, f))
                 for f in _val_files()[i::2][:90]] for i in range(2)]
    one = serve.ExportedDecoder(d, device='cuda')
    want = [one.decode_images(r) for r in requests]
    assert all(any(s) for s in want)
    dec = serve.ExportedDecoder(d, device='cuda')
    got = [[], []]

    def serve_requests(i):
        for _ in range(3):
            got[i].append(dec.decode_images(requests[i]))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=serve_requests, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert got == [[want[0]] * 3, [want[1]] * 3]
    assert _tallies(dec) == _tallies(one)
    calls = dec.calls
    wrappers = (rnn_cuda.bilstm_fwd, beam_cuda.beam_decode)
    launches = [wr.launches for wr in wrappers]
    counts = profiler.counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for r in requests:
            dec.decode_images(r)
    calls = dec.calls - calls
    gained = {k: v - counts.get(k, 0) for k, v in profiler.counters().items()
              if v != counts.get(k, 0)}
    assert gained.pop('beam.kernel_frames') > 0
    assert gained == {'serve.images': sum(map(len, requests)),
                      'serve.rows': calls * BATCH,
                      'serve.graph_replays': calls}
    assert [wr.launches - n for wr, n in zip(wrappers, launches)] == [
        calls, calls]
