"""The port's eval CLI takes the JAX package's flags: ``test.sh``'s line
(``--network=LSTM_test --cfg=./lstm/lstm.yml --restore=1``) parses to the
JAX parser's namespace (``lstm/test_net.py``), ``--set`` takes the rest of
the line as there, and the line runs; ``--restore 0`` evaluates the
initialised network, as the JAX ``restore=0`` does."""

import importlib.util
import os
import shutil
import sys

import pytest
import torch

from lstm_ctc_ocr_torch.config import load_cfg
from lstm_ctc_ocr_torch.engine import test as port_test
from lstm_ctc_ocr_torch.models.factory import get_network

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_SH = ['--network=LSTM_test', '--cfg=./lstm/lstm.yml', '--restore=1']


def _jax_args(argv, monkeypatch):
    """``lstm/test_net.py``'s ``parse_args`` on ``argv``."""
    spec = importlib.util.spec_from_file_location(
        'jax_test_net', os.path.join(REPO, 'lstm', 'test_net.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, 'argv', ['test_net.py'] + argv)
    return vars(mod.parse_args())


@pytest.mark.parametrize('argv', [
    TEST_SH,
    TEST_SH + ['--gpu', '1', '--test_dir', 'data/val_digit4'],
    ['--cfg', 'lstm/digit4.yml', '--set', 'TEST.BATCH_SIZE', '8',
     '--restore', '0'],
    [],
])
def test_flags_parse_as_the_jax_cli(argv, monkeypatch):
    want = _jax_args(argv, monkeypatch)
    got = vars(port_test.parse_args(argv + ['--device', 'cpu']
                                    if '--set' not in argv else
                                    ['--device', 'cpu'] + argv))
    assert got.pop('device') == 'cpu'
    if not any(a.startswith('--network') for a in argv):
        # the JAX CLI has no default network (and fails without one)
        assert want['network_name'] is None
        want['network_name'] = 'LSTM_test'
    assert got == want


@pytest.fixture
def layout(tmp_path):
    """A root whose output/lstm_ctc is empty (eval falls back to the tracked
    release) and 8 images of data/val."""
    (tmp_path / 'output' / 'lstm_ctc').mkdir(parents=True)
    (tmp_path / 'checkpoints').mkdir()
    os.symlink(os.path.join(REPO, 'checkpoints', 'lstm_ctc'),
               str(tmp_path / 'checkpoints' / 'lstm_ctc'))
    val = os.path.join(REPO, 'data', 'val')
    sub = tmp_path / 'val'
    sub.mkdir()
    for f in sorted(os.listdir(val))[:8]:
        shutil.copy(os.path.join(val, f), str(sub / f))
    return tmp_path, str(sub)


def test_the_test_sh_line_runs(layout, monkeypatch, capsys):
    root, sub = layout
    monkeypatch.chdir(REPO)              # test.sh's relative --cfg
    rc = port_test.main(TEST_SH + [
        '--device', 'cpu', '--test_dir', sub, '--set', 'TEST.BATCH_SIZE',
        '4', 'TRAIN.DTYPE', "'float32'", 'ROOT_DIR', str(root)])
    assert rc == 0
    text = capsys.readouterr().out
    assert 'Restored {}'.format(os.path.join(
        str(root), 'checkpoints', 'lstm_ctc')) in text
    assert 'total acc:' in text
    assert text.count('    res: ') == 8


def test_restore_zero_evaluates_the_initialised_network(layout, capsys):
    root, sub = layout
    argv = ['--cfg', os.path.join(REPO, 'lstm', 'lstm.yml'), '--restore',
            '0', '--device', 'cpu', '--test_dir', sub, '--set',
            'TEST.BATCH_SIZE', '4', 'TRAIN.DTYPE', "'float32'", 'ROOT_DIR',
            str(root)]
    assert port_test.main(argv) == 0
    text = capsys.readouterr().out
    assert 'Evaluating the initialised network (no restore)' in text
    assert 'Restored' not in text
    cfg = load_cfg(os.path.join(REPO, 'lstm', 'lstm.yml'),
                   ['TEST.BATCH_SIZE', '4', 'TRAIN.DTYPE', "'float32'"])
    fresh = port_test.test_net(
        cfg, sub, device='cpu', echo=lambda s: None, restore=False,
        model=get_network('LSTM_test', cfg, generator=torch.Generator()
                          .manual_seed(int(cfg.RNG_SEED))))
    restored = port_test.test_net(cfg, sub, str(root / 'output' / 'lstm_ctc'),
                                  device='cpu', echo=lambda s: None)
    served = {line.partition('    res: ')[0]: line.partition('    res: ')[2]
              for line in text.splitlines() if '    res: ' in line}
    assert served == fresh.predictions != restored.predictions
    assert restored.correct > fresh.correct
