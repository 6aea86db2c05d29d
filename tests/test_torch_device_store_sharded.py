"""The port's sharded device store (``data/device_store.py``:
``ShardedDeviceStore``, ``PoolShardedFeed``, ``RecordsShardedFeed``,
``make_sharded_device_feed``) at world 2 over gloo on the CPU, against the
JAX package's ``ShardedDeviceStore`` and feeds on a 2-device mesh
(mirroring ``tests/test_device_store_sharded.py``).

One spawn of two ranks (``torch_parallel_worker.sharded_store``) serves the
file; each test reads its part:

* each rank's block equals ``bucket_batch`` of its rows at the one bucket
  the ranks agree on (the widest of the ranks'), and the JAX store's block
  of the same device; the samplers draw the JAX store's indices;
* an epoch covers every row of every block once;
* the block gather at world 2 gives what host batches of the same rows
  give, bit for bit;
* a refresh flush writes the rank's own block, and nothing else;
* a batch shard larger than a block, and a refresh row wider than the
  bucket, raise; the feed gate under ``DATA_DEVICE on`` raises too;
* the pool and records feeds build the JAX feeds' blocks and refresh rows
  from the same seeds.
"""

import copy
import os

import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from lstm_ctc_ocr_torch.data import records


@pytest.fixture(scope='module')
def jcfg():
    from lstm_ctc_ocr_tpu.config import cfg, cfg_from_file, cfg_from_list
    old = copy.deepcopy(dict(cfg))
    cfg_from_file(worker.YML)
    cfg_from_list(['TRAIN.DTYPE', "'float32'", 'TRAIN.NUM_HID', '16',
                   'RENDERER', "'native'", 'POOL_SIZE', '8',
                   'POOL_REFRESH', '3', 'DATA_DEVICE', "'on'"])
    yield cfg
    cfg.clear()
    for k, v in old.items():
        cfg[k] = v


def _partitions():
    """Two blocks of 8 rows; rank 1's rows are wider, so the bucket the
    ranks agree on is rank 1's."""
    rng = np.random.RandomState(0)
    chars = list('abc049')
    images, labels = [], []
    for lo, hi in ((40, 80), (60, 120)):
        images.append([rng.randint(0, 256, (32, int(w)), np.uint8)
                       for w in rng.randint(lo, hi, 8)])
        labels.append([''.join(rng.choice(chars, 4)) for _ in range(8)])
    return images, labels


@pytest.fixture(scope='module')
def ranks(tmp_path_factory, jcfg):
    tmp = tmp_path_factory.mktemp('sharded')
    path = str(tmp / 'rows.records')
    rng = np.random.RandomState(3)
    with records.RecordsWriter(path) as w:
        for width in (60, 88, 120, 71, 95, 64, 100):        # 7 rows: 1 left
            w.add(''.join(rng.choice(list('abc049'), 4)),
                  rng.randint(0, 256, (32, width), np.uint8))
    images, labels = _partitions()
    out = worker.run_ranks(tmp, 'sharded_store', tmp=str(tmp), images=images,
                           labels=labels, records_path=path)
    return images, labels, path, out


@pytest.fixture(scope='module')
def jmesh(jcfg):
    from lstm_ctc_ocr_tpu.parallel import mesh
    return mesh.make_mesh(2)


def test_blocks_match_bucket_batch_and_jax(ranks, jmesh):
    from lstm_ctc_ocr_tpu.data.device_store import ShardedDeviceStore
    images, labels, _, out = ranks
    jstore = ShardedDeviceStore(images, labels, 'uniform', seed=1,
                                mesh=jmesh, verbose=False)
    assert [o['w_bucket'] for o in out] == [jstore.w_bucket] * 2 == [128] * 2
    jplan = [jstore.next_indices(8, 1)[0] for _ in range(3)]
    for r, o in enumerate(out):
        ref = o['bucket_batch']
        for got, want, jax_block in zip(
                o['block'], (ref.image, ref.label, ref.label_len,
                             ref.time_step), jstore.arrays):
            np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(jax_block)[r])
        for got, want in zip(o['uniform'], jplan):
            assert got.shape == (4,)
            np.testing.assert_array_equal(got, want[r])


def test_epoch_covers_every_row_once(ranks):
    _, _, _, out = ranks
    for o in out:
        seen = np.concatenate(o['epoch'])            # 4 shards of 4 rows
        assert sorted(seen[:8].tolist()) == list(range(8))
        assert sorted(seen[8:].tolist()) == list(range(8))


def test_block_gather_equals_host_batches(ranks):
    _, _, _, out = ranks
    for o in out:
        (g_losses, g_state), (h_losses, h_state) = \
            o['train']['gather'], o['train']['host']
        assert g_losses == h_losses and np.isfinite(g_losses).all()
        assert all(torch.equal(g_state[k], h_state[k]) for k in h_state)
    assert out[0]['train']['gather'][0] == out[1]['train']['gather'][0]


def test_refresh_flush_updates_the_owning_block(ranks):
    _, _, _, out = ranks
    for r, o in enumerate(out):
        before, after, lab_len = o['refresh']
        np.testing.assert_array_equal(after[2, :60].numpy(),
                                      np.full((60, 32), 7 + r, np.uint8))
        np.testing.assert_array_equal(after[2, 60:].numpy(), 0)
        keep = [i for i in range(8) if i != 2]
        assert torch.equal(after[keep], before[keep])
        assert int(lab_len[2]) == 2


def test_partition_size_and_bucket_checks_raise(ranks):
    _, _, _, out = ranks
    for o in out:
        errors = o['errors']
        assert 'a batch shard of 9 rows does not fit the 8-row partition' \
            in errors['shard']
        assert 'wider than the store bucket (129 > 128)' in errors['wide']
        assert errors['feed'] == ("DATA_DEVICE 'on': a batch shard of 4 rows "
                                  'does not fit a 2-row partition (2 ranks)')


def test_pool_and_records_feeds_match_jax(ranks, jmesh, monkeypatch):
    from lstm_ctc_ocr_tpu.data import gen as jgen
    from lstm_ctc_ocr_tpu.data.device_store import (PoolShardedFeed,
                                                    RecordsShardedFeed)
    from lstm_ctc_ocr_tpu.data.records import RecordsDataset
    monkeypatch.setattr(jgen, '_renderer_cache', {})
    _, _, path, out = ranks
    jpool = PoolShardedFeed(jmesh, verbose=False)
    jidx = jpool.store.next_indices(4, 2)
    jpool.tick(2)
    ds = RecordsDataset(path)
    jrec = RecordsShardedFeed(ds, jmesh, verbose=False)
    ds.close()
    jrec_idx = jrec.store.next_indices(4, 3)
    for r, o in enumerate(out):
        for got, want in zip(o['pool_block'], jpool.store.arrays):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want)[r])
        np.testing.assert_array_equal(o['pool_indices'], jidx[:, r])
        pending = jpool.store._pending[r]
        assert len(o['pool_pending']) == len(pending) == 6
        for (row, im, s), (jrow, jim, js) in zip(o['pool_pending'], pending):
            assert (row, s) == (jrow, js)
            np.testing.assert_array_equal(im, jim)
        assert o['records_block'][0].shape[0] == 3       # rows r, r+2, r+4
        for got, want in zip(o['records_block'], jrec.store.arrays):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want)[r])
        np.testing.assert_array_equal(o['records_indices'], jrec_idx[:, r])
        assert o['layouts'] == ('sharded', 'sharded', (2,), (3, 2))


def test_replicated_feed_gives_each_rank_its_rows(ranks):
    """Under a mesh the replicated feed's indices are the rank's columns of
    the mesh-less feed's global ones, from the same seed."""
    _, _, _, out = ranks
    for r, o in enumerate(out):
        chunk_all, chunk_rank, step_all, step_rank = o['replicated']
        assert chunk_all.shape == (3, 4) and step_all.shape == (4,)
        assert torch.equal(chunk_rank, chunk_all[:, 2 * r:2 * (r + 1)])
        assert torch.equal(step_rank, step_all[2 * r:2 * (r + 1)])
