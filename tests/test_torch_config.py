"""The port's config: its YAML-subset reader against ``yaml.safe_load`` on
every tracked config, and the JAX package's merge and override rules."""

import glob
import os

import pytest

from lstm_ctc_ocr_tpu import config as jconfig
from lstm_ctc_ocr_torch import config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YMLS = sorted(glob.glob(os.path.join(REPO, 'lstm', '*.yml')))


@pytest.mark.parametrize('path', YMLS, ids=os.path.basename)
def test_yaml_subset_matches_safe_load(path):
    yaml = pytest.importorskip('yaml')
    with open(path) as f:
        text = f.read()
    assert config.load_yaml(text) == yaml.safe_load(text)
    cfg = config.load_cfg(path)          # every tracked config merges
    assert cfg.EXP_DIR == yaml.safe_load(text)['EXP_DIR']


def test_yaml_subset_scalars_and_errors():
    yaml = pytest.importorskip('yaml')
    text = ("A: 'it''s'  # comment\nB: \"x#y\"\nC: [1, 2.5, 'a', b]\n"
            "D:\n  E: 1.0e-5\n  F:\n    G: true\n  H: -3\nI:\nJ: .5\n")
    assert config.load_yaml(text) == yaml.safe_load(text)
    for bad in ('A:\n  - 1\n', 'A: 1\n   B: 2\n', 'A 1\n', 'A: &x 1\n'):
        with pytest.raises(ValueError):
            config.load_yaml(bad)


def test_defaults_match_jax_package():
    cfg = config.default_cfg()
    ref = jconfig.cfg

    def keys(d, prefix=''):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out.update(keys(v, prefix + k + '.'))
            else:
                out[prefix + k] = v
        return out
    mine, theirs = keys(cfg), keys(ref)
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        if k != 'ROOT_DIR':
            assert mine[k] == theirs[k], k


def test_merge_and_overrides():
    cfg = config.load_cfg(os.path.join(REPO, 'lstm', 'digit4.yml'),
                          ['TEST.BATCH_SIZE', '64', 'BN_EVAL', "'moving'",
                           'TRAIN.LEARNING_RATE', '1'])
    assert cfg.CHARSET == '0123456789' and cfg.NCLASSES == 12
    assert cfg.TEST.BATCH_SIZE == 64 and cfg.BN_EVAL == 'moving'
    assert cfg.TRAIN.LEARNING_RATE == 1.0
    assert config.default_cfg().TEST.BATCH_SIZE == 1    # no shared state
    with pytest.raises(KeyError):
        config.merge_a_into_b({'NOPE': 1}, cfg)
    with pytest.raises(ValueError):
        config.merge_a_into_b({'TRAIN': {'NUM_HID': 'wide'}}, cfg)
    with pytest.raises(KeyError):
        config.cfg_from_list(['TEST.NOPE', '1'], cfg)
    with pytest.raises(ValueError):
        config.cfg_from_list(['TEST.BATCH_SIZE', "'x'"], cfg)
    enc, dec = config.get_encode_decode_dict(cfg)
    assert enc['0'] == 1 and dec[10] == '9' and dec[0] == ''
