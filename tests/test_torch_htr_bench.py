"""The benchmark's pieces for Puigcerver's handwriting model, on the CPU:
the FLOP count (``benchmark/flops_htr.py``) against ``FlopCounterMode`` on
the plain reference, the four ``htr.*`` readers on hand-built traces, and
the new cell run at a small size through the program's plain versions,
where a sound run is ``correct`` and a step that leaves the state
unchanged, a loss over half the batch and the float8 control are not.
"""

import copy
import json
import os
import sys
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from benchmark import common, flops, flops_htr, harness  # noqa: E402
from benchmark.reference import htr as ref_htr  # noqa: E402
from lstm_ctc_ocr_torch.utils import profiler  # noqa: E402

HTR = 'htr_puigcerver.train_graphed'


# --- operations -------------------------------------------------------------

@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('dims,width,n', [
    (dict(num_hid=512, num_layers=5, nclasses=80, height=128), 64, 1),
    (dict(num_hid=16, num_layers=2, nclasses=80, height=16), 93, 3)])
def test_flops_equal_flop_counter_mode_on_the_reference(dims, width, n,
                                                        train):
    params = ref_htr.make_params(0, 'cpu', **dims)
    if train:
        params = {k: v.requires_grad_(not ref_htr.is_buffer(k))
                  for k, v in params.items()}
    x = torch.rand(n, width, dims['height'])
    lens = torch.full((n,), width // 8, dtype=torch.int32)
    counter = FlopCounterMode(display=False)
    with counter:
        out = ref_htr.forward(params, x, lens, step=1 if train else None)
        if train:
            out.sum().backward()
    want = n * flops_htr.model_flops(width, train=train, **dims)
    assert counter.get_total_flops() == want


def test_conv_flops_and_frames():
    c = flops_htr.conv_flops(1792)
    assert c['conv1'] == 2 * 16 * 9 * 1792 * 128
    assert c['conv5'] == 2 * 64 * 80 * 9 * 224 * 16
    assert flops_htr.frames(1780) == 222 and flops_htr.features(128) == 1280
    assert flops_htr.dims({'num_hid': 16}) == dict(
        num_hid=16, num_layers=5, nclasses=80, height=128)
    one = flops_htr.bilstm_bound([200, 150], 256, 1)
    assert flops_htr.bilstm_bound([200, 150], 256, 5) == pytest.approx(5 * one)
    assert one == pytest.approx(flops.bilstm_fwd_bound([200, 150], 256,
                                                       residuals=True)[0]
                                + flops.bilstm_bwd_bound([200, 150], 256)[0])


# --- readers on hand-built traces -------------------------------------------

def _summary(kernels, counts, window_s=0.5):
    return {'window_s': window_s, 'busy_s': 0.4,
            'kernels': [(name, 0, int(ns)) for name, ns in kernels],
            'device': [], 'spans': [], 'gaps': [], 'counts': counts}


COUNTS = {'steps': 16, 'batch': 16, 'widths': [1600] * 32,
          'label_lens': [22] * 32, 'store_width': 1792, 'num_hid': 512,
          'nclasses': 80, 'dtype': 'bfloat16', 'num_layers': 5,
          'height': 128}
KERNELS = [('void bilstm_fwd_cluster_kernel<1>(float const*)', 4e6),
           ('bilstm_bwd_cluster_kernel', 5e6),
           ('bilstm_bwd_du_kernel', 1e6), ('elementwise_kernel', 3e6)]
CTC_KERNELS = [('void ctc_fwd_warp_kernel<2>(float const*)', 3e5),
               ('void ctc_bwd_warp_kernel<2>(float const*)', 5e5),
               ('elementwise_kernel', 3e6)]


def reader(name):
    return harness.load_module('metrics', name).read


def test_htr_train_mfu_reads_the_models_flops():
    got = reader('htr.train_mfu')(_summary(KERNELS, COUNTS))
    want = 100 * 32 * flops_htr.model_flops(1600, train=True) / (0.5 * 989e12)
    assert got == pytest.approx(want)
    assert reader('htr.train_mfu')(_summary(KERNELS, {})) is None


def test_htr_bilstm_roofline_reads_every_layers_bound():
    got = reader('htr.bilstm_roofline')(_summary(KERNELS, COUNTS))
    bound = 2 * flops_htr.bilstm_bound([200] * 16, 256, 5)
    assert got == pytest.approx(100 * bound / 10e-3)
    assert reader('htr.bilstm_roofline')(
        _summary(KERNELS[3:], COUNTS)) is None
    assert reader('htr.bilstm_roofline')(_summary(KERNELS, {})) is None


def test_htr_ctc_roofline_reads_each_rows_own_frames():
    got = reader('htr.ctc_roofline')(_summary(CTC_KERNELS, COUNTS))
    # 1600 px at height 128 is 200 frames (W // 8), not W // 4 - 1
    bound = 2 * sum(flops.ctc_bound([200] * 16, [22] * 16, bwd)[0]
                    for bwd in (False, True))
    assert got == pytest.approx(100 * bound / 0.8e-3)
    assert got < reader('train.ctc_roofline')(_summary(CTC_KERNELS, COUNTS))


@pytest.mark.parametrize('kernels,counts', [
    (CTC_KERNELS[2:], COUNTS), (CTC_KERNELS, {}),
    (CTC_KERNELS, dict(COUNTS, widths=[]))],
    ids=['no_ctc_kernel', 'no_counts', 'no_widths'])
def test_htr_ctc_roofline_is_none_with_nothing_to_read(kernels, counts):
    assert reader('htr.ctc_roofline')(_summary(kernels, counts)) is None


def test_htr_bilstm_us_per_kframe_reads_the_programs_counter(monkeypatch):
    read = reader('htr.bilstm_us_per_kframe')
    monkeypatch.setattr(profiler, 'counters',
                        lambda: {'rnn.layer_frames': 5 * 16 * 224 * 16})
    assert read(_summary(KERNELS, COUNTS)) == pytest.approx(
        10e-3 * 1e6 / (5 * 16 * 224 * 16 / 1000))
    assert read(_summary(KERNELS[3:], COUNTS)) is None
    monkeypatch.setattr(profiler, 'counters', lambda: {})
    assert read(_summary(KERNELS, COUNTS)) is None


def test_the_new_entries_resolve():
    with open(os.path.join(REPO, 'BENCHMARK.json')) as f:
        b = json.load(f)
    e2e, layer = harness.cell_metrics(b, HTR)
    assert {m['name'] for m in e2e} == {'train_images_per_s', 'setup_s'}
    assert {m['name'] for m in layer} == {
        'htr.train_mfu', 'htr.bilstm_roofline', 'htr.bilstm_us_per_kframe',
        'htr.ctc_roofline', 'train.launches_per_step', 'train.frame_fill',
        'train.device_idle_share'}
    for m in layer:
        mod = harness.load_module('metrics', m['name'])
        assert (mod.LAYER, mod.UNIT, mod.MOVES) == (m['layer'], m['unit'],
                                                    m['moves'])
    work, config = common.load_cell(HTR)
    assert config['reduced'] == [] and config['cfg']['NET_NAME'] == 'htr'
    assert len(config['cfg']['CHARSET']) == 78 \
        and config['cfg']['NCLASSES'] == 80


# --- the cells at a small size ----------------------------------------------

SMALL = {
    HTR: (dict(data_dir='data/val', trace_units=1),
          {'IMG_HEIGHT': 32, 'NUM_FEATURES': 32, 'BUCKETS': [160],
           'MAX_CHAR_LEN': 6, 'TRAIN.NUM_HID': 16, 'TRAIN.NUM_LAYERS': 2,
           'TRAIN.DTYPE': 'float32', 'TRAIN.BATCH_SIZE': 4,
           'TRAIN.STEPS_PER_DISPATCH': 2}),
}


def run(name, trace=False):
    work, config = common.load_cell(name)
    over_w, over_c = SMALL[name]
    work = dict(work, **over_w)
    config = copy.deepcopy(config)
    for key, v in over_c.items():
        d = config['cfg']
        *path, leaf = key.split('.')
        for p in path:
            d = d[p]
        d[leaf] = v
    ctx = harness.Context(name, work, config, 2**31 + 11, 0.2, trace, 'cpu')
    driver = harness.load_module('traffic', work['kind'])
    out = harness.run_cell(ctx, driver, time.time())
    with open(os.path.join(REPO, 'BENCHMARK.json')) as f:
        e2e, layer = harness.cell_metrics(json.load(f), name)
    return (harness.result_line(ctx, out, e2e, layer, {'platform': 'cpu'}),
            ctx, driver, out['state'])


@pytest.mark.parametrize('name', [HTR])
def test_a_sound_run_is_correct_and_the_control_is_not(name):
    line, ctx, driver, state = run(name, trace=True)
    assert line['correct'] is True, line['checks']
    assert line['attempted'] > 0 and line['failed'] == 0
    assert 'train_images_per_s' not in line['metrics']
    assert line['metrics']['train.frame_fill']['value'] > 0
    assert line['metrics']['htr.train_mfu']['value'] > 0
    ctx.produce = 'fp8'
    assert any(v > lim for _, v, lim in driver.check(ctx, state))


@pytest.mark.parametrize('name', [HTR])
def test_a_step_that_leaves_the_state_unchanged_fails(monkeypatch, name):
    from lstm_ctc_ocr_torch.engine import train
    monkeypatch.setattr(train.Optimizer, 'step', lambda self: None)
    line = run(name)[0]
    assert line['correct'] is False
    assert line['checks']['update_gap']['value'] > 0.5


def test_a_loss_over_half_the_batch_fails_the_htr_cell(monkeypatch):
    from lstm_ctc_ocr_torch.ops import ctc_cuda
    real = ctc_cuda.ctc_loss

    def half(logits, labels, label_lens, logit_lens):
        losses = real(logits, labels, label_lens, logit_lens)
        keep = torch.arange(losses.shape[0]) < losses.shape[0] // 2
        # the second half reads as infeasible: the mean is over the rest
        return torch.where(keep, losses, losses.detach() * 0 + 1e30)
    monkeypatch.setattr(ctc_cuda, 'ctc_loss', half)
    assert run(HTR)[0]['correct'] is False
