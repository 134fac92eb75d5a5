# -*- coding: utf-8 -*-
"""
The kernel build's bookkeeping that runs without ``nvcc``: the
``ptxas -v`` report it keeps beside each library, read back as each
kernel's registers and spill bytes (``chip_smoke.py`` prints them).
"""

from distributed_dot_product_tpu_torch.ops import _build

LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z8kernel_av' for 'sm_90a'
ptxas info    : Function properties for _Z8kernel_av
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 155 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z8kernel_bv' for 'sm_90a'
ptxas info    : Function properties for _Z8kernel_bv
    96 bytes stack frame, 52 bytes spill stores, 44 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 4096 bytes smem
"""


def test_ptxas_report_parsed_per_kernel():
    assert _build._parse_ptxas(LOG) == {'_Z8kernel_av': (155, 0),
                                        '_Z8kernel_bv': (255, 96)}


def test_no_report_reads_empty():
    assert _build._parse_ptxas('') == {}
    assert _build._parse_ptxas('nvcc warning : something\n') == {}


def _csrc(tmp_path, monkeypatch, header=b'// v1\n'):
    """A csrc/ of its own: one flash_fwd.cu that includes hopper.cuh, and
    an unrelated file."""
    (tmp_path / 'flash_fwd.cu').write_text(
        '#include <cuda_runtime.h>\n#include "hopper.cuh"\nint x;\n')
    (tmp_path / 'hopper.cuh').write_bytes(header)
    (tmp_path / 'notes.txt').write_text('unrelated\n')
    monkeypatch.setattr(_build, '_CSRC', tmp_path)


def test_target_hashes_the_included_header(tmp_path, monkeypatch):
    """An edited header gives a new library path (a fresh build); an
    unrelated file in csrc/ does not."""
    _csrc(tmp_path, monkeypatch)
    first = _build._target('flash_fwd')
    assert _build._target('flash_fwd') == first
    (tmp_path / 'notes.txt').write_text('edited\n')
    assert _build._target('flash_fwd') == first
    (tmp_path / 'hopper.cuh').write_bytes(b'// v2\n')
    assert _build._target('flash_fwd') != first
    (tmp_path / 'hopper.cuh').write_bytes(b'// v1\n')
    assert _build._target('flash_fwd') == first


def test_included_headers_are_followed(tmp_path, monkeypatch):
    """Headers a header includes count too; system includes and missing
    files do not."""
    _csrc(tmp_path, monkeypatch, b'#include "inner.cuh"\n')
    (tmp_path / 'inner.cuh').write_text('// inner v1\n')
    assert _build._headers(
        (tmp_path / 'flash_fwd.cu').read_text(), []) == ['hopper.cuh',
                                                          'inner.cuh']
    first = _build._target('flash_fwd')
    (tmp_path / 'inner.cuh').write_text('// inner v2\n')
    assert _build._target('flash_fwd') != first
