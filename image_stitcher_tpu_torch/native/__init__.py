"""Build and load the hand-written CUDA kernels (nvcc + ctypes).

The counterpart of the JAX package's ``native/`` loader, which builds
``hostops.c`` with the system C compiler: each ``csrc/<name>.cu`` has a
plain C interface and is compiled at first use with ``nvcc`` into a
shared library, then loaded with :mod:`ctypes`. The library lands in
``build/torch_kernels/<hash>/`` at the root of the checkout, where the
hash covers the source and the compiler flags, so an edited kernel is
rebuilt and an unchanged one is loaded as it is.

There is no fallback: a missing ``nvcc`` or a failed build raises, and
the caller (a wrapper about to launch on a CUDA tensor) raises with it.
Nothing here runs when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
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


def _build(name: str) -> Dict:
    src = os.path.join(CSRC, f'{name}.cu')
    with open(src, 'rb') as f:
        source = f.read()
    tag = hashlib.sha1(source + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = os.path.join(BUILD_ROOT, tag)
    so_path = os.path.join(out_dir, f'lib{name}.so')
    if os.path.exists(so_path):
        return {'path': so_path, 'seconds': 0.0, 'cached': True, 'log': ''}
    os.makedirs(out_dir, exist_ok=True)
    # unique temp name + atomic rename: concurrent processes may race
    tmp = f'{so_path}.{os.getpid()}.tmp'
    cmd = [find_nvcc(), *NVCC_FLAGS, '-o', tmp, src]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {src} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so_path)
    return {'path': so_path, 'seconds': seconds, 'cached': False,
            'log': proc.stderr + proc.stdout}


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, built on first use.
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
