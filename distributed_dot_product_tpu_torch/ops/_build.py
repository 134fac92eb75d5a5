# -*- coding: utf-8 -*-
"""
Build and load the port's hand-written CUDA kernels (no JAX counterpart:
the TPU kernels were traced by Pallas at call time).

Each library of :data:`LIBRARIES` is one ``csrc/<source>.cu`` compiled by
``nvcc`` for Hopper (``-gencode arch=compute_90a,code=sm_90a``) with its
own ``-D`` flags into a shared library with a plain C interface, under
``build/kernels/`` at the repository root, named by a hash of the source,
the ``csrc/`` headers it includes (``#include "hopper.cuh"``) and the
flags — an edited source or header builds afresh, an unchanged one is
reused. The flash sources build in parts that ``nvcc`` compiles side by
side: their base instantiations (the serving and training paths), and
with ``-DFLASH_EXT`` the instantiations that take segments, a window,
dropout and int8 scoring (K3's and K4's apart). The float32 kernels are
libraries of their own, so that the bf16 ones build from unchanged code:
``csrc/flash_f32.cu`` (K1/K2, its Ext part apart),
``csrc/flash_bwd_f32.cu`` (K3/K4, the Ext parts of K3 and K4 apart) and
``csrc/flash_decode.cu`` again with ``-DDECODE_F32`` (K5/K5p). The
library is opened with ``ctypes``; the wrappers pass device pointers and
the CUDA stream as ``c_void_p``.

``nvcc`` runs with ``-Xptxas -v``; each library's build log is kept
beside it (``.log``), and :func:`resources` reads each kernel's
registers and spill bytes from it. The build runs at a kernel's first
use, so running any entry point on the card builds what it needs.
:func:`build_all` starts one ``nvcc`` per library at once and waits for
them all. A failed build raises: there is no fallback to another
implementation.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ['load', 'build_all', 'resources', 'LIBRARIES', 'SOURCES']

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
    'flash_f32': ('flash_f32', ()),
    'flash_f32_fwd_ext': ('flash_f32', ('-DFLASH_EXT=1',)),
    'flash_f32_bwd': ('flash_bwd_f32', ()),
    'flash_f32_dq_ext': ('flash_bwd_f32', ('-DFLASH_EXT=2',)),
    'flash_f32_dkv_ext': ('flash_bwd_f32', ('-DFLASH_EXT=3',)),
    'flash_decode_f32': ('flash_decode', ('-DDECODE_F32',)),
}
SOURCES = tuple(LIBRARIES)
_NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
               '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

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


def _headers(text, seen):
    """The ``csrc/`` headers that ``text`` includes (``#include "x"``),
    and theirs, each once, in the order first met."""
    for name in re.findall(r'^\s*#\s*include\s+"([^"]+)"', text, re.M):
        path = _CSRC / name
        if name not in seen and path.is_file():
            seen.append(name)
            _headers(path.read_text(), seen)
    return seen


def _target(name):
    """The library's path: its name and a hash of its source, the headers
    the source includes, and its flags."""
    src = (_CSRC / f'{LIBRARIES[name][0]}.cu').read_bytes()
    parts = [src]
    for header in _headers(src.decode(), []):
        parts += [header.encode(), (_CSRC / header).read_bytes()]
    parts.append(' '.join(_flags(name)).encode())
    digest = hashlib.sha256(b'\0'.join(parts)).hexdigest()[:16]
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
    out.with_suffix('.log').write_text(log)
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


def resources(name):
    """Each kernel of library ``name`` as ``ptxas -v`` reported it at its
    build: ``{mangled name: (registers, spill bytes stored + loaded)}``
    (empty when the build log is gone)."""
    path = _target(name).with_suffix('.log')
    return _parse_ptxas(path.read_text()) if path.is_file() else {}


def _parse_ptxas(log):
    found, kernel, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel, spill = m.group(1), 0
            continue
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
            continue
        m = re.search(r'Used (\d+) registers', line)
        if m and kernel is not None:
            found[kernel] = (int(m.group(1)), spill)
            kernel = None
    return found


def load(name):
    """The ``ctypes`` library ``name`` of :data:`LIBRARIES` (built at
    first use)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = _LIBS[name] = ctypes.CDLL(str(_target(name)))
        return lib
