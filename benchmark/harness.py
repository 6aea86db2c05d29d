"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the result line.

A cell is found by name: ``benchmark/workloads/<cell>.json`` names its
configuration (``benchmark/configs/<config>.json``), its driver
(``benchmark/traffic/<kind>.py``), the driver's parameters and the
comparison's limits. The metrics a run prints are those ``BENCHMARK.json``
gives the cell: with ``--trace 0`` its end-to-end metrics, with ``--trace
1`` its per-layer metrics, each read by ``benchmark/metrics/<metric>.py``
from the traced window's summary. Adding a cell, a configuration, a driver
or a metric is adding files and entries; nothing here names one.

A driver module has three functions:

* ``setup(ctx)`` builds the program's objects, warms up every shape the
  cell's traffic uses, and returns its state;
* ``window(ctx, state, loop)`` drives the program through ``loop`` (see
  :func:`closed_loop`) and returns ``(end-to-end values, counts of the
  traced units)``;
* ``check(ctx, state)`` compares what the window produced with the
  reference, after the program's state is freed, and returns
  ``[(name, value, limit)]``.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import time

from . import common, trace

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'lstm_ctc_ocr_tpu')


class Context:
    """What a driver is given: the cell's files, the run's arguments, the
    device and the host spans. ``produce`` names what stands in the
    program's place in the comparison: ``None`` (the program), ``'fp8'``
    (the control) or a planted fault, for the benchmark's own tests."""

    def __init__(self, name, work, config, seed, seconds, trace_on, device,
                 produce=None):
        self.name, self.work, self.config = name, work, config
        self.seed, self.seconds, self.trace = int(seed), seconds, trace_on
        self.device = device
        self.produce = produce
        self.spans = common.Spans(annotate=trace_on)
        self.records = {}


def load_module(kind, name):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(common.BENCH_DIR, kind, name + '.py')
    spec = importlib.util.spec_from_file_location(
        'benchmark_{}_{}'.format(kind, name.replace('.', '_')), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench, cell):
    """The cell's end-to-end and per-layer metric entries."""
    e2e = [m for m in bench['end_to_end']
           if 'workloads' not in m or cell in m['workloads']]
    names = {m['name'] for m in e2e}
    layer = [m for m in bench['per_layer']
             if (cell in m['workloads'] if 'workloads' in m
                 else m['moves'] in names)]
    return e2e, layer


def closed_loop(ctx, step, drain, trace_units=0):
    """Run ``step(i)`` for i = 0, 1, ... until ``ctx.seconds`` have passed,
    then ``drain()`` (which waits for the device). With ``trace_units``
    the first that many units run under the profiler, which is stopped and
    read before the loop goes on. Returns ``(units, seconds, summary)``."""
    window = None
    summary = None
    if trace_units:
        window = trace.Window(ctx.device).__enter__()
    t0 = time.perf_counter()
    i = 0
    while True:
        step(i)
        i += 1
        if window is not None and i == trace_units:
            drain()
            window.__exit__(None, None, None)
            summary = window.summary(dict(ctx.records.get('trace_counts',
                                                          {})))
            summary['host_spans'] = [list(r) for r in ctx.spans.rows]
            window = None
        if time.perf_counter() - t0 >= ctx.seconds and window is None:
            break
    drain()
    return i, time.perf_counter() - t0, summary


def run_cell(ctx, driver, t_proc):
    """Set-up, window, memory peak, comparison. Returns a dict with the
    end-to-end values (``setup_s`` among them), ``attempted``, ``failed``,
    ``memory_peak_bytes``, ``checks``, the driver's ``state`` less the
    program, and, when traced, ``summary``."""
    import torch
    cuda = torch.device(ctx.device).type == 'cuda'
    if cuda:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(ctx.device)
    t_driver = time.time()
    state = driver.setup(ctx)
    if cuda:
        torch.cuda.synchronize(ctx.device)
    setup_s = time.time() - t_proc
    ctx.records['setup_phases'] = dict(
        ctx.records.get('setup_phases', {}), to_driver_s=t_driver - t_proc,
        driver_s=setup_s - (t_driver - t_proc))
    values, summary = driver.window(ctx, state)
    values['setup_s'] = setup_s
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    state.pop('program', None)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = driver.check(ctx, state)
    return {'values': values, 'summary': summary, 'state': state,
            'attempted': ctx.records['attempted'],
            'failed': ctx.records['failed'],
            'memory_peak_bytes': peak, 'checks': checks}


def forbidden_modules():
    """Top-level names in ``sys.modules`` that no run may hold."""
    tops = {m.split('.')[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def result_line(ctx, out, e2e, layer, device_info):
    """The contract's last line as a dict, the comparison's numbers last."""
    metrics = {}
    if ctx.trace:
        s = out['summary']
        for m in layer:
            v = load_module('metrics', m['name']).read(s)
            if v is not None:
                metrics[m['name']] = {'value': v, 'unit': m['unit']}
    else:
        for m in e2e:
            v = out['values'].get(m['name'])
            if v is not None:
                metrics[m['name']] = {'value': v, 'unit': m['unit']}
    correct = (out['attempted'] > 0 and out['failed'] == 0
               and all(v <= lim for _, v, lim in out['checks']))
    line = {'correct': correct, 'attempted': out['attempted'],
            'failed': out['failed'], 'metrics': metrics,
            'device': dict(device_info,
                           memory_peak_bytes=out['memory_peak_bytes'])}
    if ctx.trace:
        s = out['summary']
        line['device']['busy_s'] = s['busy_s']
        line['device']['window_s'] = s['window_s']
        line['breakdown'] = trace.breakdown(s)
    line['checks'] = {n: {'value': v, 'limit': lim}
                      for n, v, lim in out['checks']}
    return line


def set_cache_dirs():
    """Every kernel and build cache at a fixed path inside the checkout
    (the program builds its own kernels into ``lstm_ctc_ocr_torch/build``,
    also inside it)."""
    for var, sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                     ('TRITON_CACHE_DIR', 'triton')):
        os.environ[var] = os.path.join(common.CACHE_DIR, sub)


def main(argv=None):
    t_proc = common.process_start()
    p = argparse.ArgumentParser(description='Run one benchmark cell once')
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_cache_dirs()
    work, config = common.load_cell(args.workload)
    with open(os.path.join(common.REPO, 'BENCHMARK.json')) as f:
        bench = json.load(f)
    e2e, layer = cell_metrics(bench, args.workload)

    import torch
    chips = int(work.get('chips', 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print('no CUDA device (or fewer than {}): this benchmark measures '
              'the card and never falls back to the CPU'.format(chips),
              file=sys.stderr)
        return 2
    device = torch.device('cuda', 0)
    name, limit = common.card()
    print('card: {}, power limit {}'.format(name, limit), file=sys.stderr)
    device_info = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                   'count': chips}
    driver = load_module('traffic', work['kind'])
    ctx = Context(args.workload, work, config, args.seed, args.seconds,
                  bool(args.trace), device)
    out = run_cell(ctx, driver, t_proc)
    # where set-up went: process start to the driver (imports, CUDA init,
    # the card's query), then the driver's own set-up
    print('set-up phases: {}'.format(json.dumps(ctx.records['setup_phases'])),
          file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print('the run loaded {}: the benchmark measures the PyTorch port '
              'alone'.format(', '.join(bad)), file=sys.stderr)
        return 3
    line = result_line(ctx, out, e2e, layer, device_info)
    if ctx.trace:
        ctx.spans.write(os.path.join(common.CACHE_DIR, 'spans',
                                     '{}.json'.format(args.workload)))
    for n, v in line['checks'].items():
        print('check {}: {} (limit {})'.format(n, v['value'], v['limit']),
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0
