"""The port's pool sampler (``data/pool.py``) against the JAX package's:
the same fill, the same sampled and refreshed batches for the same seed,
and one cache file that either package writes and the other loads (same
name, same layout), with the same reseed after a load."""

import copy
import os
import shutil

import numpy as np
import pytest

from lstm_ctc_ocr_tpu.config import cfg as jcfg
from lstm_ctc_ocr_tpu.data import gen as jgen
from lstm_ctc_ocr_tpu.data import pool as jpool
from lstm_ctc_ocr_torch.config import default_cfg
from lstm_ctc_ocr_torch.data import pool


@pytest.fixture
def cfgs(monkeypatch):
    """(port config, JAX config) with the native renderer; the JAX config and
    its renderer cache are restored."""
    old = copy.deepcopy(dict(jcfg))
    monkeypatch.setattr(jgen, '_renderer_cache', {})
    cfg = default_cfg()
    for c in (cfg, jcfg):
        c.RENDERER = 'native'
        c.POOL_REFRESH = 2
    yield cfg, jcfg
    jcfg.clear()
    for k, v in old.items():
        jcfg[k] = v


def _same_pool(a, b):
    assert a.labels == b.labels
    assert len(a.images) == len(b.images)
    for x, y in zip(a.images, b.images):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def _same_batches(a, b, n=3):
    ia, ib = a.batch_iterator(4), b.batch_iterator(4)
    for _ in range(n):
        x, y = next(ia), next(ib)
        for k in ('image', 'label', 'label_len', 'time_step'):
            assert np.array_equal(getattr(x, k), getattr(y, k)), k


@pytest.mark.parametrize('seed', [0, 3])
def test_pool_sampler_matches_jax(cfgs, tmp_path, monkeypatch, seed):
    cfg, _ = cfgs
    (tmp_path / 'jax').mkdir()
    (tmp_path / 'port').mkdir()
    monkeypatch.chdir(tmp_path / 'jax')
    want = jpool.PoolSampler(16, seed=seed, verbose=False)
    monkeypatch.chdir(tmp_path / 'port')
    got = pool.PoolSampler(cfg, 16, seed=seed, verbose=False)
    _same_pool(got, want)
    _same_batches(got, want)        # sampling, then refresh, in turn


def test_pool_cache_loads_across_packages(cfgs, tmp_path, monkeypatch):
    """A cache written by the JAX package loads in the port and the reverse;
    after a load both reseed the same way."""
    cfg, _ = cfgs
    for d in ('jax', 'port', 'cross'):
        (tmp_path / d).mkdir()
    monkeypatch.chdir(tmp_path / 'jax')
    jpool.PoolSampler(16, seed=2, verbose=False)
    name = jpool._cache_path(16, 2)
    assert pool.cache_path(cfg, 16, 2) == name and os.path.isfile(name)

    monkeypatch.chdir(tmp_path / 'port')
    os.makedirs(os.path.dirname(name))
    shutil.copy(str(tmp_path / 'jax' / name), name)
    got = pool.PoolSampler(cfg, 16, seed=2)       # loads the JAX file
    monkeypatch.chdir(tmp_path / 'jax')
    want = jpool.PoolSampler(16, seed=2)          # loads its own
    _same_pool(got, want)
    _same_batches(got, want)

    monkeypatch.chdir(tmp_path / 'cross')
    pool.PoolSampler(cfg, 16, seed=4, verbose=False)   # the port writes
    again = pool.PoolSampler(cfg, 16, seed=4)
    theirs = jpool.PoolSampler(16, seed=4)             # the JAX package loads
    _same_pool(again, theirs)
    _same_batches(again, theirs)
