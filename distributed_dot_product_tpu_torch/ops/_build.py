# -*- coding: utf-8 -*-
"""
Build and load the port's hand-written CUDA kernels (no JAX counterpart:
the TPU kernels were traced by Pallas at call time).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into its own shared library
with a plain C interface, under ``build/kernels/`` at the repository root,
named by a hash of the source — an edited source builds afresh, an
unchanged one is reused. The library is opened with ``ctypes``; the
wrappers pass device pointers and the CUDA stream as ``c_void_p``.

The build runs at a kernel's first use, so running any entry point on
the card builds what it needs. :func:`build_all` starts one ``nvcc`` per
source at once and waits for them all. A failed build raises: there is
no fallback to another implementation.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ['load', 'build_all', 'SOURCES']

_CSRC = Path(__file__).resolve().parent.parent / 'csrc'
_BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'kernels'
SOURCES = ('flash_fwd', 'flash_bwd', 'flash_decode')
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


def _target(name):
    src = (_CSRC / f'{name}.cu').read_bytes()
    digest = hashlib.sha256(src + ' '.join(_NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    return _BUILD_DIR / f'{name}-{digest}.so'


def _start(name):
    """Start ``nvcc`` for one source into a temporary name; returns
    ``(process, tmp_path, final_path)``, or None when already built."""
    out = _target(name)
    if out.is_file():
        return None
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    cmd = [_nvcc(), *_NVCC_FLAGS, '-o', str(tmp), str(_CSRC / f'{name}.cu')]
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
        raise RuntimeError(f'nvcc failed on csrc/{name}.cu '
                           f'(exit {proc.returncode}):\n{log}')
    os.replace(tmp, out)


def build_all():
    """Compile every kernel source that is not built yet, one ``nvcc``
    per source, all started together; raises if any build fails."""
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
    """The ``ctypes`` library built from ``csrc/<name>.cu`` (built at
    first use)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = _LIBS[name] = ctypes.CDLL(str(_target(name)))
        return lib
