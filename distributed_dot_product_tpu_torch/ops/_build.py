# -*- coding: utf-8 -*-
"""
Build and load the port's hand-written CUDA kernels (no JAX counterpart:
the TPU kernels were traced by Pallas at call time).

Each library of :data:`LIBRARIES` is one ``csrc/<source>.cu`` compiled by
``nvcc`` for Hopper (``-gencode arch=compute_90a,code=sm_90a``) with its
own ``-D`` flags into a shared library with a plain C interface, under
``build/kernels/`` at the repository root, named by a hash of the source
and the flags — an edited source builds afresh, an unchanged one is
reused. The flash sources build in parts that ``nvcc`` compiles side by
side: their base instantiations (the serving and training paths), and
with ``-DFLASH_EXT`` the instantiations that take segments, a window,
dropout and int8 scoring (K3's and K4's apart). The library is opened
with ``ctypes``; the wrappers pass device pointers and the CUDA stream as
``c_void_p``.

The build runs at a kernel's first use, so running any entry point on
the card builds what it needs. :func:`build_all` starts one ``nvcc`` per
library at once and waits for them all. A failed build raises: there is
no fallback to another implementation.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ['load', 'build_all', 'LIBRARIES', 'SOURCES']

_CSRC = Path(__file__).resolve().parent.parent / 'csrc'
_BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'kernels'
# library name: (source under csrc/, its -D flags)
LIBRARIES = {
    'flash_fwd': ('flash_fwd', ()),
    'flash_fwd_ext': ('flash_fwd', ('-DFLASH_EXT',)),
    'flash_bwd': ('flash_bwd', ()),
    'flash_bwd_dq_ext': ('flash_bwd', ('-DFLASH_EXT=1',)),
    'flash_bwd_dkv_ext': ('flash_bwd', ('-DFLASH_EXT=2',)),
    'flash_decode': ('flash_decode', ()),
}
SOURCES = tuple(LIBRARIES)
_NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
               '-O3', '-shared', '-Xcompiler', '-fPIC')

_LOCK = threading.Lock()
_LIBS = {}


def _nvcc():
    for cand in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if cand and (Path(cand) / 'bin' / 'nvcc').is_file():
            return str(Path(cand) / 'bin' / 'nvcc')
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError(
            'nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin '
            'and PATH): the CUDA kernels are built from source at first use')
    return found


def _flags(name):
    return (*_NVCC_FLAGS, *LIBRARIES[name][1])


def _target(name):
    src = (_CSRC / f'{LIBRARIES[name][0]}.cu').read_bytes()
    digest = hashlib.sha256(src + ' '.join(_flags(name)).encode()
                            ).hexdigest()[:16]
    return _BUILD_DIR / f'{name}-{digest}.so'


def _start(name):
    """Start ``nvcc`` for one library into a temporary name; returns
    ``(process, tmp_path, final_path)``, or None when already built."""
    out = _target(name)
    if out.is_file():
        return None
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    cmd = [_nvcc(), *_flags(name), '-o', str(tmp),
           str(_CSRC / f'{LIBRARIES[name][0]}.cu')]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name, job):
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'nvcc failed on csrc/{LIBRARIES[name][0]}.cu '
                           f'for {name} (exit {proc.returncode}):\n{log}')
    os.replace(tmp, out)


def build_all():
    """Compile every library that is not built yet, one ``nvcc`` per
    library, all started together; raises if any build fails."""
    with _LOCK:
        jobs = {name: _start(name) for name in SOURCES}
        errors = []
        for name, job in jobs.items():
            try:
                _finish(name, job)
            except RuntimeError as exc:
                errors.append(str(exc))
        if errors:
            raise RuntimeError('\n'.join(errors))


def load(name):
    """The ``ctypes`` library ``name`` of :data:`LIBRARIES` (built at
    first use)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = _LIBS[name] = ctypes.CDLL(str(_target(name)))
        return lib
