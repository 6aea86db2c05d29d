"""The traced run: a ``torch.profiler`` window over a fixed number of the
window's units (dispatches or requests), read into one summary that the
per-layer metrics' readers take their numbers from.

The summary holds the device's activity (every kernel, copy and fill the
profiler saw on the card, with its start and duration), the benchmark's
host spans as the profiler recorded them, the traced window's length and
the device's busy time within it (the union of those intervals), and the
drivers' counts of the traced units' work. ``breakdown`` gives the device
operations that took most time and the longest gaps with no device
activity, each named by the innermost of the benchmark's spans open at its
middle.
"""

from __future__ import annotations

import time

import torch

# the benchmark's host spans; any other user range is the program's
SPAN_PREFIXES = ('solver.', 'eval.', 'serve.')
WINDOW = 'bench.traced_window'
# a CUTLASS kernel's mangled name runs to thousands of characters
NAME_CHARS = 96


class Window:
    """``with Window(device) as w: ...`` profiles the block, synchronised at
    both ends; ``w.summary(counts)`` reads it."""

    def __init__(self, device):
        self.device = device
        self.prof = None

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(self.device).type == 'cuda':
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self._sync()
        # the window's own range marks its ends on the profiler's clock
        self._range = torch.profiler.record_function(WINDOW)
        self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def _sync(self):
        if torch.device(self.device).type == 'cuda':
            torch.cuda.synchronize(self.device)

    def __exit__(self, *exc):
        self._sync()
        self.window_s = time.perf_counter() - self.t0
        self._range.__exit__(*exc)
        self.prof.__exit__(*exc)
        return False

    def summary(self, counts):
        return summarize(self.prof.profiler.kineto_results.events(),
                         self.window_s, counts)


def _dur(ev):
    if hasattr(ev, 'duration_ns'):
        return int(ev.duration_ns())
    return int(ev.duration_us() * 1000)


def _ns(ev, which):
    if hasattr(ev, which + '_ns'):
        return int(getattr(ev, which + '_ns')())
    return int(getattr(ev, which + '_us')() * 1000)


def summarize(events, window_s, counts):
    """The summary of a traced window from the profiler's raw events; the
    window's ends are those of its own range."""
    events = list(events)
    marks = [ev for ev in events if ev.name() == WINDOW
             and not str(ev.device_type()).endswith('CUDA')]
    t0_ns = _ns(marks[0], 'start')
    t1_ns = t0_ns + _dur(marks[0])
    device, spans = [], []
    for ev in events:
        kind = str(ev.device_type())
        start = _ns(ev, 'start')
        dur = _dur(ev)
        name = ev.name()
        annotation = getattr(ev, 'is_user_annotation', lambda: False)()
        if kind.endswith('CUDA'):
            if annotation or name.startswith(SPAN_PREFIXES + (WINDOW,)) \
                    or start + dur < t0_ns or start > t1_ns:
                continue
            device.append((name, start, dur))
        elif name.startswith(SPAN_PREFIXES):
            spans.append((name, start, start + dur))
    device.sort(key=lambda e: e[1])
    busy_ns, gaps = 0, []
    cur_s = cur_e = None
    last_end = t0_ns
    for _, s, d in device:
        s, e = max(s, t0_ns), min(s + d, t1_ns)
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_ns += cur_e - cur_s
            if s > last_end:
                gaps.append((last_end, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        last_end = max(last_end, cur_e)
    if cur_e is not None:
        busy_ns += cur_e - cur_s
    if t1_ns > last_end:
        gaps.append((last_end, t1_ns))
    return {
        'window_s': window_s,
        'busy_s': busy_ns / 1e9,
        'kernels': [e for e in device if not _is_copy(e[0])],
        'device': device,
        'spans': spans,
        'gaps': gaps,
        'counts': counts,
    }


def _is_copy(name):
    return name.startswith(('Memcpy', 'Memset', 'memcpy', 'memset'))


def kernel_base(name):
    """A kernel's bare name: ``void (anonymous namespace)::ctc_fwd_warp_
    kernel<1>(float const*, ...)`` -> ``ctc_fwd_warp_kernel``."""
    name = name.replace('(anonymous namespace)::', '')
    if name.startswith('void '):
        name = name[5:]
    return name.split('(')[0].split('<')[0].split('::')[-1].strip()


def kernel_seconds(summary, prefixes):
    """Device seconds of the kernels whose bare names start with one of
    ``prefixes``, and how many there were."""
    prefixes = tuple(prefixes)
    hits = [d for n, _, d in summary['kernels']
            if kernel_base(n).startswith(prefixes)]
    return sum(hits) / 1e9, len(hits)


def breakdown(summary, top=10):
    """``{"device_ops": [[name, s]...], "idle_gaps": [[span, s]...]}``."""
    by_name = {}
    for name, _, d in summary['device']:
        name = (kernel_base(name) or name)[:NAME_CHARS]
        by_name[name] = by_name.get(name, 0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(summary['gaps'], key=lambda g: g[0] - g[1])[:top]
    out = []
    for s, e in gaps:
        mid = (s + e) // 2
        open_ = [sp for sp in summary['spans'] if sp[1] <= mid <= sp[2]]
        label = min(open_, key=lambda sp: sp[2] - sp[1])[0] if open_ \
            else 'outside_spans'
        out.append([label, (e - s) / 1e9])
    return {'device_ops': [[n, d / 1e9] for n, d in ops], 'idle_gaps': out}
