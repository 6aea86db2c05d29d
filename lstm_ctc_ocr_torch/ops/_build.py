"""Build the port's CUDA kernels with nvcc at first use and load them.

Each ``csrc/<name>.cu`` compiles, on its own, into a shared library with a
plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>-<hash>.so csrc/<name>.cu

and is loaded with ``ctypes``. ``<hash>`` covers the source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source builds anew and
an unchanged one is loaded from ``build/`` (listed in ``.gitignore``). The
ptxas report (registers, shared memory, spills) is kept beside the library
as ``lib<name>-<hash>.log``.
:func:`build_all` starts one nvcc per source at once and waits for all.

Host code (the captcha renderer, ``native/synth.cpp``) builds the same way
with g++ (:func:`host_library`)::

    g++ -O3 -shared -fPIC -ffp-contract=off -o build/lib<name>-<hash>.so <src>

``-ffp-contract=off`` keeps ``a*b+c`` from becoming a fused multiply-add on
hosts whose compiler contracts by default (GCC on aarch64), so the float
path gives the same bits on every host.

Nothing here runs when the module is imported, and nothing falls back: a
missing compiler or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, List

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(PKG_DIR, 'build')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

HOST_FLAGS = ['-O3', '-shared', '-fPIC', '-ffp-contract=off']

_loaded: Dict[str, ctypes.CDLL] = {}


def kernel_sources() -> List[str]:
    """Names of the kernels under ``csrc/`` (``<name>.cu``)."""
    return sorted(f[:-3] for f in os.listdir(SRC_DIR) if f.endswith('.cu'))


def _nvcc() -> str:
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.isfile(path):
        raise RuntimeError('nvcc not found (PATH or /usr/local/cuda/bin): the '
                           'CUDA kernels are built from source at first use')
    return path


def _target(name: str) -> str:
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(SRC_DIR) if f.endswith('.cuh'))
    for fname in [name + '.cu'] + headers:
        with open(os.path.join(SRC_DIR, fname), 'rb') as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, 'lib{}-{}.so'.format(
        name, digest.hexdigest()[:16]))


def build_all(names=None) -> Dict[str, str]:
    """Compile every named kernel (default: all) that is not built yet, one
    nvcc process per source, all started together. Returns name -> .so."""
    names = list(names) if names is not None else kernel_sources()
    os.makedirs(BUILD_DIR, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    for name, so in targets.items():
        if os.path.isfile(so):
            continue
        cmd = [_nvcc()] + NVCC_FLAGS + [
            '-o', so + '.tmp', os.path.join(SRC_DIR, name + '.cu')]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT)
    failed = []
    for name, proc in procs.items():
        log, _ = proc.communicate()
        so = targets[name]
        with open(so[:-3] + '.log', 'wb') as f:
            f.write(log)
        if proc.returncode != 0:
            failed.append('{} (exit {}):\n{}'.format(
                name, proc.returncode, log.decode(errors='replace')))
            continue
        os.replace(so + '.tmp', so)
    if failed:
        raise RuntimeError('nvcc failed for ' + '\n'.join(failed))
    return targets


def build_log(name: str) -> str:
    """The nvcc/ptxas output of the current build of ``name``."""
    path = _target(name)[:-3] + '.log'
    if not os.path.isfile(path):
        return ''
    with open(path, 'r', errors='replace') as f:
        return f.read()


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(build_all([name])[name])
        _loaded[name] = lib
    return lib


def host_target(src: str) -> str:
    """``build/lib<name>-<hash>.so`` of a host C++ source; ``<hash>`` covers
    the source and :data:`HOST_FLAGS`."""
    digest = hashlib.sha256(' '.join(HOST_FLAGS).encode())
    with open(src, 'rb') as f:
        digest.update(f.read())
    name = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, 'lib{}-{}.so'.format(
        name, digest.hexdigest()[:16]))


def host_library(src: str) -> ctypes.CDLL:
    """The loaded shared library of the host C++ source ``src``, built with
    g++ at first use. Processes that build at once each write their own
    temporary file and rename it into place."""
    so = host_target(src)
    lib = _loaded.get(so)
    if lib is not None:
        return lib
    if not os.path.isfile(so):
        cxx = shutil.which('g++')
        if cxx is None:
            raise RuntimeError('g++ not found on PATH: {} is built from source '
                               'at first use'.format(os.path.basename(src)))
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = '{}.tmp.{}'.format(so, os.getpid())
        proc = subprocess.run([cxx] + HOST_FLAGS + ['-o', tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError('g++ failed for {} (exit {}):\n{}'.format(
                src, proc.returncode, proc.stdout + proc.stderr))
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    _loaded[so] = lib
    return lib
