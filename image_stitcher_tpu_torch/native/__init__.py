"""Build and load the hand-written native code (nvcc or cc, + ctypes).

The counterpart of the JAX package's ``native/`` loader, which builds
``hostops.c`` with the system C compiler: each ``csrc/<name>.cu`` has a
plain C interface and is compiled at first use with ``nvcc`` into a
shared library, then loaded with :mod:`ctypes`; each host source
``csrc/<name>.c`` (the blosc codecs, the tile decoders, the JPEG
codec, the host fuser's ``hostops.c``) is compiled the same way with the
system C compiler (``$CC``, else ``cc``, ``gcc``,
``clang``). The library lands in ``build/torch_kernels/<hash>/`` at the root of the
checkout, where the hash covers the source, the ``csrc/`` files it
``#include``s, and the compiler flags (and
for host code the CPU's instruction set, since it is built for the host
it runs on), so an edited source is rebuilt and an unchanged one is
loaded as it is.

There is no fallback: a missing compiler or a failed build raises, and
the caller (a wrapper about to launch on a CUDA tensor, a zarr writer
asked for blosc chunks, a reader given a compressed tile, a JPEG
OME-TIFF writer) raises
with it. Nothing here runs when a
module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import re
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

#: sources built with flags of their own: ``hostops.c`` with the JAX
#: package's (``image_stitcher_tpu/native/__init__.py``): GNU C, so the
#: compiler contracts the feather sums ``acc += w * v`` into fused
#: multiply-adds where the CPU has them, exactly as the JAX build does
#: (ISO C, ``-std=c99``, turns contraction off and changes the last bit)
SOURCE_CC_FLAGS = {'hostops': ('-O3', '-march=native', '-shared', '-fPIC')}

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
        "image_stitcher_tpu_torch (the blosc codecs, the tile decoders) "
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


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def _source_text(path: str, seen=None) -> bytes:
    """The source at ``path`` and, recursively, every ``#include "..."``
    file of csrc/ it names: what the build hash must cover, so an edited
    included file rebuilds the library too."""
    seen = set() if seen is None else seen
    seen.add(path)
    with open(path, 'rb') as f:
        text = f.read()
    for inc in _INCLUDE.findall(text):
        dep = os.path.join(os.path.dirname(path), inc.decode())
        if dep not in seen and os.path.isfile(dep):
            text += b'\0' + inc + b'\0' + _source_text(dep, seen)
    return text


def _build(name: str) -> Dict:
    host = os.path.exists(os.path.join(CSRC, f'{name}.c'))
    src = os.path.join(CSRC, f'{name}.c' if host else f'{name}.cu')
    source = _source_text(src)
    flags = SOURCE_CC_FLAGS.get(name, CC_FLAGS) if host else NVCC_FLAGS
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


def hostops() -> ctypes.CDLL:
    """``csrc/hostops.c`` (the host fuser's placement, feather and
    finalize loops, the 2x pyramid folds and the row writer), built on
    first use, with its ctypes signatures declared as the JAX package
    declares them."""
    lib = load('hostops')
    if getattr(lib, '_declared', False):
        return lib
    pd, ci, vp = ctypes.c_ssize_t, ctypes.c_int, ctypes.c_void_p
    place = [vp, pd, vp, pd, vp, pd, ci, ci, ci, ci, pd, pd]
    feather = [vp, vp, pd, vp, pd, vp, pd, ci, ci, ci, ci,
               ci, ci, ci, ci, pd, pd, ctypes.c_float]
    fold = [vp, pd, vp, pd, pd, pd]
    finalize = [vp, vp, pd, vp, pd, pd, pd]
    for suffix in ('u16', 'u8'):
        for fn, argtypes in (
                (f'place_{suffix}', place), (f'feather_{suffix}', feather),
                (f'downsample2x_{suffix}', fold),
                (f'downsample2x2_mean_{suffix}', fold),
                (f'finalize_feather_{suffix}', finalize)):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = None
    c64 = ctypes.c_longlong
    lib.write_rows_contig.argtypes = [ci, vp, c64, c64, c64, vp, c64, c64]
    lib.write_rows_contig.restype = c64
    lib._declared = True
    return lib
