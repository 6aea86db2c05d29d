"""Import hygiene of the port: ``lstm_ctc_ocr_torch`` imports no JAX and
nothing of ``lstm_ctc_ocr_tpu``, and neither does chip_smoke.py."""

import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, 'lstm_ctc_ocr_torch')
FORBIDDEN = ('jax', 'jaxlib', 'lstm_ctc_ocr_tpu')


def _modules():
    out = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith('.py'):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                out.append(rel.replace(os.sep, '.').replace('.__init__', ''))
    return sorted(out)


def test_importing_every_module_loads_no_jax():
    code = ('import importlib, sys\n'
            'for m in {!r}:\n'
            '    importlib.import_module(m)\n'
            'bad = sorted(k for k in sys.modules\n'
            '             if k.split(".")[0] in {!r})\n'
            'assert not bad, bad\n'
            'print("ok", len({!r}))\n').format(_modules(), FORBIDDEN,
                                              _modules())
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith('ok')


def test_sources_name_no_jax_imports():
    paths = [os.path.join(REPO, 'chip_smoke.py')]
    for root, _, files in os.walk(PKG):
        paths += [os.path.join(root, f) for f in files if f.endswith('.py')]
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or '']
            for name in names:
                assert name.split('.')[0] not in FORBIDDEN, (path, name)
