"""The benchmark's files against its contract: every cell resolves to its
configuration, driver and metrics by name, names and units keep to their
characters, every cell reports what its per-layer metrics move, and a cell
or a metric is added with data files and entries alone."""

import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.\-]{1,16}$')


def bench():
    with open(os.path.join(REPO, 'BENCHMARK.json')) as f:
        return json.load(f)


def module(kind, name):
    spec = importlib.util.spec_from_file_location(
        'm_' + name.replace('.', '_'), os.path.join(BENCH, kind, name + '.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_top_level_keys_and_limits():
    b = bench()
    assert set(b) == {'command', 'paths', 'run_seconds', 'configs',
                      'workloads', 'end_to_end', 'per_layer'}
    assert b['paths'] == ['benchmark']
    assert b['command'][1] == 'benchmark/run.py'
    assert 1 <= b['run_seconds'] <= 51
    assert os.path.getsize(os.path.join(REPO, 'BENCHMARK.json')) < 64 * 1024
    # the check's whole budget at the full 24 cells
    assert (2 + 14 * 24) * (b['run_seconds'] + 60) + 24 * 180 + 1200 \
        <= 43200


def test_names_units_and_text_fields():
    b = bench()
    names = [x['name'] for k in ('configs', 'workloads', 'end_to_end',
                                 'per_layer') for x in b[k]]
    assert all(NAME.match(n) for n in names), names
    for k in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        assert len({x['name'] for x in b[k]}) == len(b[k])
    for m in b['end_to_end'] + b['per_layer']:
        assert UNIT.match(m['unit']), m['unit']
        assert m['better'] in ('lower', 'higher')
    for c in b['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert all(NAME.match(k) for k in c['reduced'])
    for w in b['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['chips'] == 1
        for field in ('why', 'traffic', 'config'):
            assert 1 <= len(w[field]) <= 200 and '\n' not in w[field]
    for m in b['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    for m in b['per_layer']:
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}
        assert m['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')


@pytest.mark.parametrize('cell', [w['name'] for w in bench()['workloads']])
def test_every_cell_resolves(cell):
    b = bench()
    entry = next(w for w in b['workloads'] if w['name'] == cell)
    with open(os.path.join(BENCH, 'workloads', cell + '.json')) as f:
        work = json.load(f)
    assert work['config'] == entry['config']
    assert work['traffic'] == entry['traffic']
    config = next(c for c in b['configs'] if c['name'] == entry['config'])
    with open(os.path.join(REPO, config['file'])) as f:
        assert json.load(f)['name'] == config['name']
    driver = module('traffic', work['kind'])
    assert all(callable(getattr(driver, f)) for f in ('setup', 'window',
                                                      'check'))
    assert set(work['limits']) and all(v > 0 for v in
                                       work['limits'].values())
    sys.path.insert(0, REPO)
    from benchmark import harness
    e2e, layer = harness.cell_metrics(b, cell)
    names = {m['name'] for m in e2e}
    assert 'setup_s' in names and len(names) >= 2
    assert layer, 'a cell reports at least one per-layer metric'
    for m in layer:
        assert m['moves'] in names, (cell, m['name'])
        mod = module('metrics', m['name'])
        assert (mod.LAYER, mod.UNIT, mod.MOVES) == (m['layer'], m['unit'],
                                                    m['moves'])


def test_every_config_is_used_and_every_metric_has_a_reader():
    b = bench()
    assert {c['name'] for c in b['configs']} == {w['config']
                                                 for w in b['workloads']}
    for m in b['per_layer']:
        assert os.path.isfile(os.path.join(BENCH, 'metrics',
                                           m['name'] + '.py'))
        for cell in m.get('workloads', []):
            assert cell in {w['name'] for w in b['workloads']}


def test_nothing_imports_the_jax_package():
    """The benchmark's sources name neither JAX nor the JAX package, and
    the reference names nothing of the program either."""
    bad = re.compile(r'^\s*(import|from)\s+(jax|jaxlib|flax|'
                     r'lstm_ctc_ocr_tpu)\b', re.M)
    prog = re.compile(r'lstm_ctc_ocr_torch')
    for root, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith('.py') and 'tests' not in root:
                src = open(os.path.join(root, f)).read()
                assert not bad.search(src), f
                if os.path.basename(root) == 'reference':
                    assert not prog.search(src), f


def test_a_cell_and_a_metric_are_added_as_files(tmp_path):
    """A copy of the benchmark gains a cell (the eval driver greedy on the
    captchas) and a metric by new files and entries alone, and the copy's
    harness finds and runs them, here on the CPU at a small size."""
    root = tmp_path / 'checkout'
    shutil.copytree(BENCH, root / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    for d in ('lstm_ctc_ocr_torch', 'data', 'checkpoints'):
        os.symlink(os.path.join(REPO, d), root / d)
    b = bench()
    b['workloads'].append({'name': 'crnn_captcha.eval_greedy',
                           'config': 'crnn_captcha', 'traffic': 'eval_greedy',
                           'chips': 1, 'why': 'added as data'})
    b['per_layer'].append({'name': 'decode.kernels_seen', 'unit': 'launches',
                           'better': 'higher', 'source': 'device_trace',
                           'layer': 'device', 'moves': 'decode_images_per_s'})
    for m in b['end_to_end']:
        if 'workloads' in m and 'crnn_captcha.serve_greedy' in m['workloads']:
            m['workloads'].append('crnn_captcha.eval_greedy')
    (root / 'BENCHMARK.json').write_text(json.dumps(b))
    (root / 'benchmark' / 'workloads' / 'crnn_captcha.eval_greedy.json') \
        .write_text(json.dumps({
            'config': 'crnn_captcha', 'traffic': 'eval_greedy',
            'kind': 'decode_live', 'chips': 1, 'data_dir': 'data/val',
            'release': 'checkpoints/lstm_ctc/lstm_ctc_iter_32207.ckpt.npz',
            'drawn_requests': 64, 'check_requests': 4,
            'trace_units': 2, 'limits': {'decode_gap': 1.0}}))
    (root / 'benchmark' / 'metrics' / 'decode.kernels_seen.py').write_text(
        '"""Kernels seen."""\n\nLAYER = "device"\nUNIT = "launches"\n'
        'MOVES = "decode_images_per_s"\n\n\ndef read(summary):\n'
        '    return len(summary["kernels"]) or None\n')
    script = '''
import json, sys, time
sys.path.insert(0, {root!r})
from benchmark import common, harness
work, config = common.load_cell('crnn_captcha.eval_greedy')
config['cfg']['TEST']['BATCH_SIZE'] = 3
b = json.load(open({root!r} + '/BENCHMARK.json'))
e2e, layer = harness.cell_metrics(b, 'crnn_captcha.eval_greedy')
ctx = harness.Context('crnn_captcha.eval_greedy', work, config, 2**31 + 5,
                      0.2, True, 'cpu')
out = harness.run_cell(ctx, harness.load_module('traffic', work['kind']),
                       time.time())
line = harness.result_line(ctx, out, e2e, layer, {{'platform': 'cpu'}})
print(json.dumps([sorted(m['name'] for m in e2e),
                  sorted(m['name'] for m in layer), line['correct'],
                  harness.forbidden_modules()]))
'''.format(root=str(root))
    env = dict(os.environ, PYTHONPATH=str(root))
    res = subprocess.run([sys.executable, '-c', script], capture_output=True,
                         text=True, env=env, cwd=str(root), timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    e2e, layer, correct, bad = json.loads(res.stdout.strip().splitlines()[-1])
    assert e2e == ['decode_images_per_s', 'decode_p95_ms', 'setup_s']
    assert 'decode.kernels_seen' in layer and 'decode_mfu' not in layer
    assert correct is True
    assert bad == []


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    """In a directory that holds only ``BENCHMARK.json`` and the benchmark,
    a run ends with an error and prints no result line."""
    shutil.copytree(BENCH, tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(os.path.join(REPO, 'BENCHMARK.json'), tmp_path)
    script = '''
import sys, time
sys.path.insert(0, {root!r})
from benchmark import common, harness
name = 'crnn_captcha.train_graphed'
work, config = common.load_cell(name)
ctx = harness.Context(name, work, config, 1, 0.1, False, 'cpu')
harness.run_cell(ctx, harness.load_module('traffic', work['kind']),
                 time.time())
print('{{"correct": true}}')
'''.format(root=str(tmp_path))
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    res = subprocess.run([sys.executable, '-c', script], capture_output=True,
                         text=True, cwd=str(tmp_path), env=env, timeout=300)
    assert res.returncode != 0
    assert 'correct' not in res.stdout
