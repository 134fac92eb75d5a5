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
