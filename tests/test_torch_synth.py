"""The port's synthetic captcha stream against the JAX package's.

* ``gen_rand``: the same labels for the same seed (default, ``digit4`` and
  ``longline`` lengths).
* The native renderer: the committed glyph atlas equals the JAX
  ``GlyphAtlas`` as whole arrays, ``render_batch`` is bit-identical to the
  JAX ``render_batch``, and the renderer regenerates the tracked
  ``data/val_digit4_native`` PNGs bit for bit; without Pillow it still
  renders, and ``captcha``/``scene`` raise naming Pillow.
* The PIL renderers: ``generate_img`` equals the JAX function for
  ``captcha`` and ``scene``, and the captcha path regenerates the tracked
  ``data/val`` PNGs.
* Batches: the first batches of inline ``get_batch`` and ``group_batch``'s
  4-tuple equal the JAX package's; the enqueuer's workers under fork and
  spawn, and its failure detection.
* The solver: ``make_train_stream`` for synth and pool, the validation batch
  equal to the JAX solver's, and the train CLI with no ``DATA_BACKEND``
  override.

Exact equality throughout: both packages make the same draws from the same
RNG streams, and ``data/image.py:resize_linear`` is bit-exact to
``cv2.resize``.
"""

import copy
import os
import random
import shutil
import sys

import numpy as np
import pytest
import torch

from lstm_ctc_ocr_tpu.config import cfg as jcfg
from lstm_ctc_ocr_tpu.config import resolve_font as jresolve_font
from lstm_ctc_ocr_tpu.data import gen as jgen
from lstm_ctc_ocr_tpu.native import synth as jsynth
from lstm_ctc_ocr_torch.config import default_cfg, resolve_font
from lstm_ctc_ocr_torch.data import enqueuer, gen, image
from lstm_ctc_ocr_torch.engine import train
from lstm_ctc_ocr_torch.native import synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRESETS = {
    'default': {},
    'digit4': {'CHARSET': '0123456789', 'MIN_LEN': 4, 'MAX_LEN': 4,
               'MAX_CHAR_LEN': 4},
    'longline': {'MIN_LEN': 20, 'MAX_LEN': 24, 'MAX_CHAR_LEN': 24,
                 'BUCKETS': [256, 320, 384, 448, 512, 576, 640, 704, 768]},
}


@pytest.fixture
def both(monkeypatch):
    """``both(**settings)`` -> a port config with ``settings``, the same
    settings applied to the JAX package's global config; the JAX config and
    its renderer cache (keyed on renderer and font only) are restored."""
    old = copy.deepcopy(dict(jcfg))
    monkeypatch.setattr(jgen, '_renderer_cache', {})

    def make(**settings):
        cfg = default_cfg()
        for k, v in settings.items():
            cfg[k] = v
            jcfg[k] = v
        jgen._renderer_cache.clear()
        return cfg
    yield make
    jcfg.clear()
    for k, v in old.items():
        jcfg[k] = v


def _same_batch(a, b):
    for k in ('image', 'label', 'label_len', 'time_step'):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and np.array_equal(x, y), k


@pytest.mark.parametrize('preset', sorted(PRESETS))
def test_gen_rand_matches_jax(both, preset):
    cfg = both(**PRESETS[preset])
    for seed in range(5):
        r1, r2 = random.Random(seed), random.Random(seed)
        got = [gen.gen_rand(cfg, r1) for _ in range(20)]
        assert got == [jgen.gen_rand(r2) for _ in range(20)]
        lo, hi = PRESETS[preset].get('MIN_LEN', 4), PRESETS[preset].get(
            'MAX_LEN', 6)
        assert all(lo <= len(s) <= hi for s in got)


def test_resolve_font_matches_jax(both, capsys):
    cfg = both()
    assert resolve_font(cfg) == jresolve_font()
    assert resolve_font(cfg, 'missing/Font.ttf') == jresolve_font(
        'missing/Font.ttf')
    assert capsys.readouterr().out.count('WARNING: configured FONT') == 2


def test_committed_atlas_equals_jax_glyph_atlas(both):
    """The committed atlas is the JAX ``GlyphAtlas`` of the default charset,
    and its digits subset the JAX atlas of ``"0123456789"``."""
    cfg = both()
    font = resolve_font(cfg)
    committed, sha = synth.load_committed()
    assert sha == synth.font_sha1(font)
    assert committed.charset == cfg.CHARSET
    for charset in (str(cfg.CHARSET), '0123456789'):
        want = jsynth.GlyphAtlas(charset, font)
        got = committed.subset(charset)
        for k in ('data', 'off', 'w', 'h'):
            assert getattr(got, k).dtype == getattr(want, k).dtype
            assert np.array_equal(getattr(got, k), getattr(want, k)), k
        assert got.index == want.index and got.variants == want.variants


@pytest.mark.parametrize('labels,seed', [
    (['ab12', 'XYZ9', 'q'], 1),
    (['q'], 0),
    (['0123456789abcdefghijKLMN'], 7),
    (['Zz', '9' * 6, 'longerLINE24charsXYZabcd'], 2 ** 62 + 5),
])
def test_render_batch_matches_jax(both, labels, seed):
    cfg = both()
    font = resolve_font(cfg)
    got = synth.render_batch(labels, synth.get_atlas(cfg.CHARSET, font), seed)
    want = jsynth.render_batch(labels, jsynth.get_atlas(cfg.CHARSET, font),
                               seed)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


def test_native_regenerates_val_digit4_native(both):
    """The tracked PNGs were written by the JAX package's offline writer:
    image ``i`` from ``random.Random(i * 9176 + 11)``, label by
    ``gen_rand``, then the native renderer."""
    cfg = both(RENDERER='native', **PRESETS['digit4'])
    val = os.path.join(REPO, 'data', 'val_digit4_native')
    for f in sorted(os.listdir(val))[:50]:
        idx, label = f[:-4].split('_')
        rng = random.Random(int(idx) * 9176 + 11)
        chars = gen.gen_rand(cfg, rng)
        got = gen._renderer(cfg).generate_image(chars, rng=rng)
        assert chars == label
        assert np.array_equal(got, image.load_image(os.path.join(val, f))), f


@pytest.mark.parametrize('case', ['native', 'captcha', 'scene', 'atlas_gap',
                                  'font_mismatch'])
def test_without_pil(both, monkeypatch, tmp_path, case):
    """With Pillow blocked, ``native`` renders from the committed atlas;
    ``captcha`` and ``scene``, an atlas that lacks a character of the
    charset, and a font other than the atlas's raise ImportError by name."""
    monkeypatch.setattr(gen, '_renderer_cache', {})
    monkeypatch.setattr(synth, '_atlas_cache', {})
    monkeypatch.setitem(sys.modules, 'PIL', None)
    cfg = both(RENDERER=case if case in ('captcha', 'scene') else 'native')
    if case == 'native':
        img, label = gen.generate_img(cfg, random.Random(3))
        assert img.dtype == np.uint8 and img.shape[0] == 32
        assert 4 <= len(label) <= 6
        return
    if case == 'atlas_gap':
        cfg.CHARSET = '0123456789-'
        match = r"lacks the characters '-'.*Pillow"
    elif case == 'font_mismatch':
        font = tmp_path / 'Other.ttf'
        font.write_bytes(open(resolve_font(cfg), 'rb').read() + b'\0')
        cfg.FONT = str(font)
        match = 'sha1.*Pillow'
    else:
        match = 'RENDERER {}.*Pillow.*RENDERER native'.format(case)
    with pytest.raises(ImportError, match=match):
        gen._renderer(cfg)


@pytest.mark.parametrize('renderer', ['captcha', 'scene'])
def test_generate_img_matches_jax(both, renderer):
    cfg = both(RENDERER=renderer)
    for seed in range(4):
        got_img, got_label = gen.generate_img(cfg, random.Random(seed))
        want_img, want_label = jgen.generate_img(random.Random(seed))
        assert got_label == want_label
        assert got_img.dtype == want_img.dtype
        assert np.array_equal(got_img, want_img)


def test_captcha_regenerates_val(both):
    """The tracked ``data/val`` PNGs (RGB, 60 high) come from the captcha
    renderer with the offline writer's seeds."""
    cfg = both()
    val = os.path.join(REPO, 'data', 'val')
    for f in sorted(os.listdir(val))[:10]:
        idx, label = f[:-4].split('_')
        rng = random.Random(int(idx) * 9176 + 11)
        chars = gen.gen_rand(cfg, rng)
        got = np.asarray(gen._renderer(cfg).generate_image(chars, rng=rng))
        with open(os.path.join(val, f), 'rb') as fh:
            want = image.decode_png(fh.read())
        assert chars == label
        assert np.array_equal(got, want), f


@pytest.mark.parametrize('renderer', ['native', 'captcha', 'scene'])
def test_get_batch_matches_jax(both, renderer):
    cfg = both(RENDERER=renderer)
    got = gen.get_batch(cfg, num_workers=0, seed=5, batch_size=4)
    want = jgen.get_batch(num_workers=0, seed=5, batch_size=4)
    try:
        for _ in range(3):
            _same_batch(next(got), next(want))
    finally:
        got.close()
        want.close()


@pytest.mark.parametrize('renderer', ['native', 'captcha'])
def test_group_batch_matches_jax(both, renderer):
    cfg = both(RENDERER=renderer)
    got = next(gen.generator(cfg, batch_size=5, bucketed=False,
                             rng=random.Random(11)))
    want = next(jgen.generator(batch_size=5, bucketed=False,
                               rng=random.Random(11)))
    assert len(got) == len(want) == 4
    assert len(got[0]) == len(want[0]) == 5
    for a, b in zip(got[0], want[0]):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    assert list(got[1]) == list(want[1])
    assert list(got[2]) == list(want[2]) and list(got[3]) == list(want[3])


@pytest.mark.parametrize('start', ['fork', 'spawn'])
def test_enqueuer_workers_deliver_batches(both, start):
    """Two worker processes under each start method deliver bucketed
    batches; the per-worker seeds decorrelate their streams (the factory is
    picklable for spawn)."""
    cfg = both(RENDERER='native', MP_START=start)
    stream = gen.get_batch(cfg, num_workers=2, seed=5, batch_size=4)
    try:
        batches = [next(stream) for _ in range(4)]
    finally:
        stream.close()
    for b in batches:
        assert isinstance(b, gen.DeviceBatch)
        assert b.image.shape[0] == 4 and b.image.shape[1] in cfg.BUCKETS
    assert len({b.label.tobytes() for b in batches}) == 4


def test_enqueuer_worker_failure_detected():
    def bad_factory():
        raise RuntimeError('boom')
        yield  # pragma: no cover

    enq = enqueuer.GeneratorEnqueuer(bad_factory, seed=0)
    enq.start(workers=1, max_queue_size=2)
    try:
        with pytest.raises((RuntimeError, TimeoutError)):
            enq.get(timeout=20.0)
    finally:
        enq.stop()
    assert not enq.is_running()


@pytest.mark.parametrize('backend', ['synth', 'pool'])
def test_make_train_stream_yields(both, monkeypatch, tmp_path, backend):
    monkeypatch.chdir(tmp_path)               # the pool's cache directory
    cfg = both(RENDERER='native', DATA_BACKEND=backend, POOL_SIZE=8)
    cfg.TRAIN.NUM_WORKERS = 2
    stream = train.make_train_stream(cfg, 4)
    try:
        for _ in range(2):
            b = next(stream)
            assert b.image.shape[0] == 4 and b.image.dtype == np.uint8
            assert (b.label_len >= 4).all() and (b.time_step > 0).all()
    finally:
        stream.close()


def test_effective_workers_scale_to_the_host(monkeypatch):
    for cores, requested, want in ((1, 12, 0), (2, 12, 1), (8, 12, 7),
                                   (8, 4, 4), (8, 0, 0)):
        monkeypatch.setattr(os, 'cpu_count', lambda: cores)
        assert train.effective_workers(requested) == want


def test_unknown_backend_raises(both):
    cfg = both(DATA_BACKEND='tfrecords')
    with pytest.raises(ValueError, match='DATA_BACKEND'):
        train.make_train_stream(cfg, 4)


def test_solver_validation_batch_matches_jax(both, monkeypatch, tmp_path):
    """The solver validates on the first batch of an inline stream seeded
    RNG_SEED + 7, the JAX solver's ``val_gen`` (JAX engine/train.py)."""
    from lstm_ctc_ocr_torch.models.factory import get_network
    cfg = both(RENDERER='native')
    for k, v in (('BATCH_SIZE', 4), ('NUM_HID', 16), ('NUM_WORKERS', 0),
                 ('DTYPE', 'float32'), ('DISPLAY', 1)):
        cfg.TRAIN[k] = v
    cfg.VAL.BATCH_SIZE, cfg.VAL.VAL_STEP = 6, 2
    seen = []
    real = train.get_batch

    def spy(cfg_, num_workers, seed=0, **kwargs):
        stream = real(cfg_, num_workers, seed=seed, **kwargs)

        def recorded():
            try:
                for b in stream:
                    seen.append((num_workers, seed, b))
                    yield b
            finally:
                stream.close()
        return recorded()
    monkeypatch.setattr(train, 'get_batch', spy)
    net = get_network('LSTM_train', cfg,
                      generator=torch.Generator().manual_seed(3))
    train.train_net(net, {}, None, str(tmp_path / 'out'),
                    str(tmp_path / 'log'), cfg, max_iters=4, device='cpu')
    val = [b for w, s, b in seen if s == int(cfg.RNG_SEED) + 7]
    assert len(val) == 1 and val[0].image.shape[0] == 6
    want = jgen.get_batch(num_workers=0, seed=jcfg.RNG_SEED + 7,
                          batch_size=6, bucketed=True)
    _same_batch(val[0], next(want))
    want.close()
    train_batches = [b for w, s, b in seen if s == int(cfg.RNG_SEED)]
    assert len(train_batches) == 3


@pytest.mark.parametrize('backend', [None, 'pool'])
def test_train_cli_trains_on_the_synthetic_stream(monkeypatch, tmp_path,
                                                  capsys, backend):
    """The train CLI on ``lstm/lstm.yml`` with no ``DATA_BACKEND`` override
    (the default synth) and with ``DATA_BACKEND pool``: three steps, a
    validation accuracy from the synthetic stream, a snapshot."""
    monkeypatch.chdir(tmp_path)               # the pool's cache directory
    exp = 'test_torch_synth_{}_{}'.format(backend or 'synth', os.getpid())
    out = os.path.join(REPO, 'output', exp)
    logs = os.path.join(REPO, 'logs', exp)
    extra = ['DATA_BACKEND', 'pool', 'POOL_SIZE', '16'] if backend else []
    try:
        rc = train.main([
            '--cfg', os.path.join(REPO, 'lstm', 'lstm.yml'), '--iters', '4',
            '--device', 'cpu', '--set', 'RENDERER', 'native',
            'TRAIN.BATCH_SIZE', '8', 'VAL.BATCH_SIZE', '8', 'TRAIN.DTYPE',
            "'float32'", 'TRAIN.NUM_WORKERS', '2', 'TRAIN.DISPLAY', '1',
            'VAL.VAL_STEP', '3', 'TRAIN.SNAPSHOT_ITERS', '3', 'EXP_DIR', exp,
            'LOG_DIR', exp] + extra)
        assert rc == 0
        text = capsys.readouterr().out
        assert "'DATA_BACKEND': '{}'".format(backend or 'synth') in text
        assert text.count('accuracy: ') == 1 and 'iter: 3 / 4' in text
        losses = [float(line.split('total loss: ')[1].split(',')[0])
                  for line in text.splitlines() if 'total loss: ' in line]
        assert len(losses) == 3 and np.isfinite(losses).all()
        assert os.listdir(out) == ['lstm_ctc_iter_3.ckpt.npz']
    finally:
        shutil.rmtree(out, ignore_errors=True)
        shutil.rmtree(logs, ignore_errors=True)
