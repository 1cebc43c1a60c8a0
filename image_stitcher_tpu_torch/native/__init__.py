"""Build and load the hand-written native code (nvcc or cc, + ctypes).

The counterpart of the JAX package's ``native/`` loader, which builds
``hostops.c`` with the system C compiler: each ``csrc/<name>.cu`` has a
plain C interface and is compiled at first use with ``nvcc`` into a
shared library, then loaded with :mod:`ctypes`; each host source
``csrc/<name>.c`` (the blosc-lz4 codec, the tile decoders) is compiled
the same way with the system C compiler (``$CC``, else ``cc``, ``gcc``,
``clang``). The library lands in ``build/torch_kernels/<hash>/`` at the root of the
checkout, where the hash covers the source and the compiler flags (and
for host code the CPU's instruction set, since it is built for the host
it runs on), so an edited source is rebuilt and an unchanged one is
loaded as it is.

There is no fallback: a missing compiler or a failed build raises, and
the caller (a wrapper about to launch on a CUDA tensor, a zarr writer
asked for blosc-lz4 chunks, a reader given a compressed tile) raises
with it. Nothing here runs when a
module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), 'build', 'torch_kernels')

#: Hopper only (``sm_90a``); no --use_fast_math, so f32 arithmetic is IEEE.
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

#: host C sources: optimized for the CPU they are built on
CC_FLAGS = ('-O3', '-march=native', '-std=c99', '-shared', '-fPIC')

_LOCK = threading.Lock()
_NAME_LOCKS: Dict[str, threading.Lock] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
#: name -> {'path', 'seconds', 'cached', 'log'} of the build that loaded it
BUILDS: Dict[str, Dict] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    candidates = []
    for var in ('CUDA_HOME', 'CUDA_PATH'):
        if os.environ.get(var):
            candidates.append(os.path.join(os.environ[var], 'bin', 'nvcc'))
    found = shutil.which('nvcc')
    if found:
        candidates.append(found)
    candidates.append('/usr/local/cuda/bin/nvcc')
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels of image_stitcher_tpu_torch "
        "are built from source at first use and need the CUDA toolkit")


def find_cc() -> str:
    """Path of the system C compiler: $CC, then cc, gcc, clang on PATH."""
    for cc in (os.environ.get('CC'), 'cc', 'gcc', 'clang'):
        found = shutil.which(cc) if cc else None
        if found:
            return found
    raise RuntimeError(
        "no C compiler found ($CC, cc, gcc, clang): the host C code of "
        "image_stitcher_tpu_torch (the blosc-lz4 codec, the tile decoders) "
        "is built from source at first use")


def _cpu_tag() -> bytes:
    """The machine and the CPU's feature flags: a host library built with
    -march=native must not be loaded on another CPU."""
    ident = platform.machine()
    try:
        with open('/proc/cpuinfo') as f:
            for line in f:
                if line.startswith(('flags', 'Features')):
                    ident += line
                    break
    except OSError:
        ident += platform.processor()
    return ident.encode()


def _build(name: str) -> Dict:
    host = os.path.exists(os.path.join(CSRC, f'{name}.c'))
    src = os.path.join(CSRC, f'{name}.c' if host else f'{name}.cu')
    with open(src, 'rb') as f:
        source = f.read()
    flags = CC_FLAGS if host else NVCC_FLAGS
    key = source + ' '.join(flags).encode() + (_cpu_tag() if host else b'')
    tag = hashlib.sha1(key).hexdigest()[:16]
    out_dir = os.path.join(BUILD_ROOT, tag)
    so_path = os.path.join(out_dir, f'lib{name}.so')
    if os.path.exists(so_path):
        return {'path': so_path, 'seconds': 0.0, 'cached': True, 'log': ''}
    os.makedirs(out_dir, exist_ok=True)
    # unique temp name + atomic rename: concurrent processes may race
    tmp = f'{so_path}.{os.getpid()}.{threading.get_ident()}.tmp'
    compiler = find_cc() if host else find_nvcc()
    cmd = [compiler, *flags, '-o', tmp, src]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(compiler)} failed to build "
                           f"{src} (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so_path)
    return {'path': so_path, 'seconds': seconds, 'cached': False,
            'log': proc.stderr + proc.stdout}


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu`` (nvcc) or
    ``csrc/<name>.c`` (the system C compiler), built on first use.
    Two sources can build at once from two threads (one lock per name)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        name_lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with name_lock:
        if name not in _LIBS:
            info = _build(name)
            _LIBS[name] = ctypes.CDLL(info['path'])
            BUILDS[name] = info
        return _LIBS[name]
