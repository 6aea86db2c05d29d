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


# every module of the port; a new module must be listed here
EXPECTED = [
    'lstm_ctc_ocr_torch', 'lstm_ctc_ocr_torch.config',
    'lstm_ctc_ocr_torch.data', 'lstm_ctc_ocr_torch.data.captcha',
    'lstm_ctc_ocr_torch.data.device_store',
    'lstm_ctc_ocr_torch.data.enqueuer', 'lstm_ctc_ocr_torch.data.gen',
    'lstm_ctc_ocr_torch.data.gen_img',
    'lstm_ctc_ocr_torch.data.image', 'lstm_ctc_ocr_torch.data.pool',
    'lstm_ctc_ocr_torch.data.records', 'lstm_ctc_ocr_torch.data.scene',
    'lstm_ctc_ocr_torch.engine', 'lstm_ctc_ocr_torch.engine.checkpoint',
    'lstm_ctc_ocr_torch.engine.graphs', 'lstm_ctc_ocr_torch.engine.serve',
    'lstm_ctc_ocr_torch.engine.summary', 'lstm_ctc_ocr_torch.engine.test',
    'lstm_ctc_ocr_torch.engine.train', 'lstm_ctc_ocr_torch.models',
    'lstm_ctc_ocr_torch.models.crnn', 'lstm_ctc_ocr_torch.models.factory',
    'lstm_ctc_ocr_torch.models.htr', 'lstm_ctc_ocr_torch.models.layers',
    'lstm_ctc_ocr_torch.models.layers_legacy',
    'lstm_ctc_ocr_torch.models.network', 'lstm_ctc_ocr_torch.native',
    'lstm_ctc_ocr_torch.native.ctc_ref',
    'lstm_ctc_ocr_torch.native.synth', 'lstm_ctc_ocr_torch.ops',
    'lstm_ctc_ocr_torch.ops._build', 'lstm_ctc_ocr_torch.ops.beam',
    'lstm_ctc_ocr_torch.ops.beam_cuda',
    'lstm_ctc_ocr_torch.ops.conv', 'lstm_ctc_ocr_torch.ops.conv_bn_cuda',
    'lstm_ctc_ocr_torch.ops.ctc',
    'lstm_ctc_ocr_torch.ops.ctc_cuda', 'lstm_ctc_ocr_torch.ops.custom_ops',
    'lstm_ctc_ocr_torch.ops.decoder',
    'lstm_ctc_ocr_torch.ops.rnn', 'lstm_ctc_ocr_torch.ops.rnn_cuda',
    'lstm_ctc_ocr_torch.parallel', 'lstm_ctc_ocr_torch.parallel.dryrun',
    'lstm_ctc_ocr_torch.parallel.mesh',
    'lstm_ctc_ocr_torch.tools', 'lstm_ctc_ocr_torch.tools._common',
    'lstm_ctc_ocr_torch.tools.ablate_ctc_fwd',
    'lstm_ctc_ocr_torch.tools.ablate_lstm_bwd',
    'lstm_ctc_ocr_torch.tools.ablate_lstm_fwd',
    'lstm_ctc_ocr_torch.tools.attrib_step',
    'lstm_ctc_ocr_torch.tools.bench_conv_bn',
    'lstm_ctc_ocr_torch.tools.build_records',
    'lstm_ctc_ocr_torch.tools.bench_ctc',
    'lstm_ctc_ocr_torch.tools.bench_data',
    'lstm_ctc_ocr_torch.tools.bench_decode',
    'lstm_ctc_ocr_torch.tools.bench_fold_h',
    'lstm_ctc_ocr_torch.tools.bench_rnn',
    'lstm_ctc_ocr_torch.tools.calibrate_bn',
    'lstm_ctc_ocr_torch.tools.convert_ckpt2npy',
    'lstm_ctc_ocr_torch.tools.export_model',
    'lstm_ctc_ocr_torch.tools.export_tfrecords',
    'lstm_ctc_ocr_torch.tools.import_tf_checkpoint',
    'lstm_ctc_ocr_torch.tools.import_tfrecords',
    'lstm_ctc_ocr_torch.tools.profile_step',
    'lstm_ctc_ocr_torch.tools.release_ckpt',
    'lstm_ctc_ocr_torch.tools.vis_batch',
    'lstm_ctc_ocr_torch.utils', 'lstm_ctc_ocr_torch.utils.metrics',
    'lstm_ctc_ocr_torch.utils.profiler',
    'lstm_ctc_ocr_torch.utils.segmentation',
    'lstm_ctc_ocr_torch.utils.timer',
]


def test_every_module_is_covered():
    assert _modules() == sorted(EXPECTED)


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


def test_data_path_imports_neither_torch_nor_pil():
    """The synthetic stream's modules import no torch (worker processes
    forked from a process that holds a CUDA context must never touch it)
    and no Pillow (the native renderer runs without it)."""
    mods = ['lstm_ctc_ocr_torch.data.' + m for m in (
        'captcha', 'enqueuer', 'gen', 'gen_img', 'image', 'pool', 'records',
        'scene')]
    mods.append('lstm_ctc_ocr_torch.native.synth')
    code = ('import importlib, sys\n'
            'for m in {!r}:\n'
            '    importlib.import_module(m)\n'
            'bad = sorted(k for k in sys.modules\n'
            '             if k.split(".")[0] in ("torch", "PIL"))\n'
            'assert not bad, bad\n'
            'print("ok")\n').format(mods)
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
