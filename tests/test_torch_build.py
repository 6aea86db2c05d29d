"""The port's kernel build (``ops/_build.py``) without nvcc: which sources
it finds and when a library's name, and so its build, changes; and the
host library build (g++) that the native captcha renderer uses."""

import ctypes

import pytest

from lstm_ctc_ocr_torch.ops import _build


def test_header_change_rebuilds_every_library(tmp_path, monkeypatch):
    """A library's name hashes its source, every shared header and the
    flags: editing a header renames (rebuilds) every library, editing one
    source only its own."""
    src = tmp_path / 'csrc'
    src.mkdir()
    for name in ('a', 'b'):
        (src / (name + '.cu')).write_text('#include "common.cuh"\n')
    (src / 'common.cuh').write_text('// first\n')
    monkeypatch.setattr(_build, 'SRC_DIR', str(src))
    monkeypatch.setattr(_build, 'BUILD_DIR', str(tmp_path / 'build'))
    assert _build.kernel_sources() == ['a', 'b']

    def targets():
        return {n: _build._target(n) for n in ('a', 'b')}
    first = targets()
    assert first['a'] != first['b']
    assert targets() == first
    (src / 'common.cuh').write_text('// second\n')
    second = targets()
    assert all(second[n] != first[n] for n in first)
    (src / 'a.cu').write_text('#include "common.cuh"\n// edited\n')
    third = targets()
    assert third['a'] != second['a'] and third['b'] == second['b']


def test_repo_kernels_share_the_common_header():
    """Every kernel source that the redesign touches includes the shared
    header, so a change there rebuilds all of them."""
    names = _build.kernel_sources()
    for name in ('bilstm_bwd', 'bilstm_fwd', 'conv_bn', 'ctc', 'lstm_bwd',
                 'lstm_fwd'):
        assert name in names
        with open('{}/{}.cu'.format(_build.SRC_DIR, name)) as f:
            assert '#include "lstm_common.cuh"' in f.read()


def test_forward_kernels_share_the_cluster_header(tmp_path, monkeypatch):
    """Both LSTM forward kernels run the recurrence of
    ``lstm_fwd_cluster.cuh``, and a change to that header renames both of
    their libraries."""
    for name in ('bilstm_fwd', 'lstm_fwd'):
        with open('{}/{}.cu'.format(_build.SRC_DIR, name)) as f:
            text = f.read()
        assert '#include "lstm_fwd_cluster.cuh"' in text
        assert 'lstm_fwd_cluster::recurrence(' in text
    src = tmp_path / 'csrc'
    src.mkdir()
    for fname in ('bilstm_fwd.cu', 'lstm_fwd.cu', 'lstm_common.cuh',
                  'lstm_fwd_cluster.cuh'):
        with open('{}/{}'.format(_build.SRC_DIR, fname)) as f:
            (src / fname).write_text(f.read())
    monkeypatch.setattr(_build, 'SRC_DIR', str(src))
    before = {n: _build._target(n) for n in ('bilstm_fwd', 'lstm_fwd')}
    with open(src / 'lstm_fwd_cluster.cuh', 'a') as f:
        f.write('// edited\n')
    assert all(_build._target(n) != t for n, t in before.items())


def test_backward_kernels_share_the_cluster_header(tmp_path, monkeypatch):
    """Both LSTM backward kernels run the recurrence of
    ``lstm_bwd_cluster.cuh`` (``bilstm_bwd`` for its two directions), and a
    change to that header renames both of their libraries and neither
    forward's."""
    for name in ('bilstm_bwd', 'lstm_bwd'):
        with open('{}/{}.cu'.format(_build.SRC_DIR, name)) as f:
            text = f.read()
        assert '#include "lstm_bwd_cluster.cuh"' in text
        assert 'lstm_bwd_cluster::recurrence(' in text
        assert '#include "lstm_fwd_cluster.cuh"' not in text
    src = tmp_path / 'csrc'
    src.mkdir()
    for fname in ('bilstm_bwd.cu', 'lstm_bwd.cu', 'lstm_common.cuh',
                  'lstm_bwd_cluster.cuh'):
        with open('{}/{}'.format(_build.SRC_DIR, fname)) as f:
            (src / fname).write_text(f.read())
    monkeypatch.setattr(_build, 'SRC_DIR', str(src))
    before = {n: _build._target(n) for n in ('bilstm_bwd', 'lstm_bwd')}
    with open(src / 'lstm_bwd_cluster.cuh', 'a') as f:
        f.write('// edited\n')
    assert all(_build._target(n) != t for n, t in before.items())


def test_ablation_tool_matches_the_kernel_source():
    """``tools/ablate_lstm_bwd`` edits the backward recurrence by text: each
    edit's anchor is in ``csrc/lstm_bwd_cluster.cuh`` exactly once, the
    combined ablation applies cleanly, both backward kernels are timed,
    and the tool refuses to run without a card."""
    import torch
    from lstm_ctc_ocr_torch.tools import ablate_lstm_bwd
    assert ablate_lstm_bwd.HEADER == 'lstm_bwd_cluster.cuh'
    with open('{}/{}'.format(_build.SRC_DIR, ablate_lstm_bwd.HEADER)) as f:
        source = f.read()
    for name, edits in ablate_lstm_bwd.ABLATIONS.items():
        text = source
        for old, new in edits:
            assert text.count(old) == 1, (name, old)
            text = text.replace(old, new)
        assert (text == source) == (name == 'full'), name
    assert len(ablate_lstm_bwd.ABLATIONS['dg_only']) == 3
    assert ablate_lstm_bwd.KERNELS == {
        'lstm_bwd': (512, 'lstm_bwd_cluster_kernel'),
        'bilstm_bwd': (256, 'bilstm_bwd_cluster_kernel')}
    for name, (_, kernel) in ablate_lstm_bwd.KERNELS.items():
        with open('{}/{}.cu'.format(_build.SRC_DIR, name)) as f:
            assert kernel + '(' in f.read()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            ablate_lstm_bwd.main()


def test_forward_ablation_tool_matches_the_cluster_header():
    """``tools/ablate_lstm_fwd`` edits the forward recurrence by text: each
    edit's anchor is in ``csrc/lstm_fwd_cluster.cuh`` exactly once, the
    combined ablation applies cleanly, and the tool refuses to run without
    a card."""
    import torch
    from lstm_ctc_ocr_torch.tools import ablate_lstm_fwd
    with open('{}/{}'.format(_build.SRC_DIR, ablate_lstm_fwd.HEADER)) as f:
        source = f.read()
    for name, edits in ablate_lstm_fwd.ABLATIONS.items():
        text = source
        for old, new in edits:
            assert text.count(old) == 1, (name, old)
            text = text.replace(old, new)
        assert (text == source) == (name == 'full'), name
    assert len(ablate_lstm_fwd.ABLATIONS['gates_only']) == 5
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            ablate_lstm_fwd.main()


def test_ctc_forward_ablation_tool_matches_the_kernel_source():
    """``tools/ablate_ctc_fwd`` edits the CTC forward's warp step by text:
    each edit's anchor is in ``csrc/ctc.cu`` exactly once, the combined
    ablation applies cleanly, the timed kernel is the warp forward, and the
    tool refuses to run without a card."""
    import torch
    from lstm_ctc_ocr_torch.tools import ablate_ctc_fwd
    with open('{}/ctc.cu'.format(_build.SRC_DIR)) as f:
        source = f.read()
    for name, edits in ablate_ctc_fwd.ABLATIONS.items():
        text = source
        for old, new in edits:
            assert text.count(old) == 1, (name, old)
            text = text.replace(old, new)
        assert (text == source) == (name == 'full'), name
    assert len(ablate_ctc_fwd.ABLATIONS['skeleton']) == 4
    assert 'ctc_fwd_warp_kernel(' in source
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            ablate_ctc_fwd.main()


def test_host_library_name_hashes_source_and_flags(tmp_path, monkeypatch):
    """A host library is ``build/lib<stem>-<hash>.so`` with the hash over
    its source and ``HOST_FLAGS`` (``-ffp-contract=off`` among them):
    editing either renames it."""
    monkeypatch.setattr(_build, 'BUILD_DIR', str(tmp_path / 'build'))
    src = tmp_path / 'synth.cpp'
    src.write_text('int f() { return 1; }\n')
    first = _build.host_target(str(src))
    assert first.startswith(str(tmp_path / 'build' / 'libsynth-'))
    assert first.endswith('.so') and _build.host_target(str(src)) == first
    assert '-ffp-contract=off' in _build.HOST_FLAGS
    src.write_text('int f() { return 2; }\n')
    second = _build.host_target(str(src))
    assert second != first
    monkeypatch.setattr(_build, 'HOST_FLAGS', _build.HOST_FLAGS + ['-g'])
    assert _build.host_target(str(src)) not in (first, second)


def test_host_library_builds_loads_and_raises(tmp_path, monkeypatch):
    """g++ builds the library at first use and it loads; a failed build and
    a missing compiler raise by name, nothing falls back."""
    import shutil
    if shutil.which('g++') is None:
        pytest.skip('needs g++')
    monkeypatch.setattr(_build, 'BUILD_DIR', str(tmp_path / 'build'))
    src = tmp_path / 'answer.cpp'
    src.write_text('extern "C" int answer() { return 42; }\n')
    lib = _build.host_library(str(src))
    lib.answer.restype = ctypes.c_int
    assert lib.answer() == 42
    assert _build.host_library(str(src)) is lib
    assert sorted(p.name for p in (tmp_path / 'build').iterdir()) == [
        _build.host_target(str(src)).rsplit('/', 1)[1]]
    bad = tmp_path / 'bad.cpp'
    bad.write_text('this is not C++\n')
    with pytest.raises(RuntimeError, match='g[+][+] failed for'):
        _build.host_library(str(bad))
    other = tmp_path / 'other.cpp'
    other.write_text('extern "C" int other() { return 1; }\n')
    monkeypatch.setattr(_build.shutil, 'which', lambda name: None)
    with pytest.raises(RuntimeError, match='g[+][+] not found'):
        _build.host_library(str(other))
