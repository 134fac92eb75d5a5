# -*- coding: utf-8 -*-
"""
The kernel build's bookkeeping that runs without ``nvcc``: the
``ptxas -v`` report it keeps beside each library, read back as each
kernel's registers and spill bytes (``chip_smoke.py`` prints them); the
float32 kernels' libraries, built from ``csrc/flash_bwd_f32.cu`` and
``csrc/flash_f32.cu``, and the symbols their wrappers bind (a text check
of the sources); the TF32 wgmma shapes the float32 forward runs; the
anchors that ``scripts/torch_bwd_f32_sections.py``,
``scripts/torch_fwd_f32_sections.py`` and the float32 planted faults of
``scripts/torch_planted_faults.py`` plant at.
"""

import importlib
import re
import sys
from pathlib import Path

import pytest

from distributed_dot_product_tpu_torch.ops import _build

fa = importlib.import_module(
    'distributed_dot_product_tpu_torch.ops.flash_attention')
REPO = Path(__file__).resolve().parent.parent

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


# The float32 backward (K3 f32, K4 f32) builds from csrc/flash_bwd_f32.cu:
# its base library and the Ext parts of K3 and of K4, each with its flags;
# K1/K2 f32 keep csrc/flash_f32.cu.
F32_BWD = {'flash_f32_bwd': ('flash_bwd_f32', ()),
           'flash_f32_dq_ext': ('flash_bwd_f32', ('-DFLASH_EXT=2',)),
           'flash_f32_dkv_ext': ('flash_bwd_f32', ('-DFLASH_EXT=3',))}


def test_float32_backward_libraries_build_from_their_source():
    for name, entry in F32_BWD.items():
        assert _build.LIBRARIES[name] == entry, name
    assert _build.LIBRARIES['flash_f32'] == ('flash_f32', ())
    assert _build.LIBRARIES['flash_f32_fwd_ext'] == ('flash_f32',
                                                     ('-DFLASH_EXT=1',))
    assert (_build._CSRC / 'flash_bwd_f32.cu').is_file()
    # The float32 forward's source no longer defines the backward.
    fwd = (_build._CSRC / 'flash_f32.cu').read_text()
    assert 'flash_bwd_dq_f32' not in fwd and 'flash_bwd_dkv_f32' not in fwd


def _active(body, flags):
    """The lines of ``body`` that the preprocessor keeps under ``flags``
    (``-DFLASH_EXT=n`` or none) in its ``#if !defined(FLASH_EXT)`` /
    ``#elif FLASH_EXT == n`` / ``#endif`` chain."""
    value = next((int(f.split('=')[1]) for f in flags
                  if f.startswith('-DFLASH_EXT=')), None)
    kept, state = [], None
    for line in body.splitlines():
        st = line.strip()
        m = re.match(r'#elif FLASH_EXT == (\d+)', st)
        if st.startswith('#if !defined(FLASH_EXT)'):
            state = value is None
        elif m:
            state = value == int(m.group(1))
        elif st.startswith('#endif'):
            state = None
        elif state is not False:
            kept.append(line)
    return '\n'.join(kept)


@pytest.mark.parametrize('ext', [None, 'ext'], ids=['base', 'ext'])
@pytest.mark.parametrize('kind', ['dq', 'dkv'])
def test_float32_backward_symbol_defined_where_built(kind, ext):
    """Each ``extern "C"`` symbol the float32 K3/K4 wrappers bind is defined
    once in the source of the library they load, and the branch that
    library's flags keep launches a kernel on the grid."""
    lib, symbol = fa._library(kind, True, ext)
    source, flags = _build.LIBRARIES[lib]
    assert (lib, source) == ((f'flash_f32_{kind}_ext' if ext else
                              'flash_f32_bwd'), 'flash_bwd_f32')
    text = (_build._CSRC / f'{source}.cu').read_text()
    head = f'extern "C" int {symbol}('
    assert text.count(head) == 1
    start = text.index(head)
    end = text.index('\n}\n', start)
    kept = _active(text[start:end], flags)
    assert 'FLASH_GRID(' in kept and '_LAUNCH(' in kept
    launches = re.findall(r'LAUNCH\(D, DV, (true|false), (true|false)\)',
                          kept)
    assert launches and all((e == 'true') == bool(ext)
                            for e, _ in launches), launches


def test_bwd_sections_script_plants_every_anchor():
    """scripts/torch_bwd_f32_sections.py knows the package's float32
    backward: every section anchor of K3 and K4 is there once."""
    sys.path.insert(0, str(REPO / 'scripts'))
    try:
        sections = importlib.import_module('torch_bwd_f32_sections')
    finally:
        sys.path.remove(str(REPO / 'scripts'))
    text = (_build._CSRC / 'flash_bwd_f32.cu').read_text()
    recipe, planted = sections.plant(text)
    assert recipe == 'split_once'
    assert planted.count('SEC_FLUSH(0)') == 2
    assert planted.count('SEC_FLUSH(8)') == 2
    assert planted.count('SEC_T0 // [section]') == 2
    # Nine marks a kernel, and the macro's definition.
    assert planted.count('SEC_MARK(') == 2 * 9 + 1


@pytest.mark.parametrize('fault', [
    'f32_single_tf32_product', 'f32_pv_reduction_order',
    'f32_bwd_pv_reduction_order', 'f32_bwd_do_small_part_zero',
    'k5_f32_v_rows_swapped', 'f32_k_small_plane_zero',
    'k5_f32_butterfly_drops_lane', 'k5p_f32_reads_unheld_column'])
def test_float32_planted_fault_anchors_once(fault):
    """Each float32 planted fault's text is there once in its source (the
    script refuses a fault whose anchor moved)."""
    sys.path.insert(0, str(REPO / 'scripts'))
    try:
        faults = importlib.import_module('torch_planted_faults').FAULTS
    finally:
        sys.path.remove(str(REPO / 'scripts'))
    source, old, new, phases = faults[fault]
    assert (_build._CSRC / source).read_text().count(old) == 1
    assert new != old and phases == ('float32_path',)


# The float32 forward (K1 f32, K2 f32) builds from csrc/flash_f32.cu: its
# base library and its Ext part, each with its flags.
F32_FWD = {'flash_f32': ('flash_f32', ()),
           'flash_f32_fwd_ext': ('flash_f32', ('-DFLASH_EXT=1',))}


@pytest.mark.parametrize('ext', [None, 'ext'], ids=['base', 'ext'])
def test_float32_forward_symbol_defined_where_built(ext):
    """``flash_fwd_f32`` is defined once in csrc/flash_f32.cu, the source of
    both of the float32 forward's libraries, and the branch each library's
    flags keep launches the base or the Ext kernel on the grid."""
    lib, symbol = fa._library('fwd', True, ext)
    assert symbol == 'flash_fwd_f32'
    assert lib == ('flash_f32_fwd_ext' if ext else 'flash_f32')
    assert _build.LIBRARIES[lib] == F32_FWD[lib]
    source, flags = _build.LIBRARIES[lib]
    text = (_build._CSRC / f'{source}.cu').read_text()
    head = f'extern "C" int {symbol}('
    assert text.count(head) == 1
    start = text.index(head)
    kept = _active(text[start:text.index('\n}\n', start)], flags)
    assert 'FLASH_GRID(' in kept and '_LAUNCH(' in kept
    launches = re.findall(r'LAUNCH\(D, DV, (true|false), (true|false)\)',
                          kept)
    assert launches and all((e == 'true') == bool(ext)
                            for e, _ in launches), launches
    # Each library also answers for its own kernels' occupancy.
    occ = 'extern "C" int flash_fwd_f32_occupancy('
    assert text.count(occ) == 1


@pytest.mark.parametrize('n', [16, 32, 64, 96])
def test_tf32_wgmma_shapes_in_the_sources(n):
    """The TF32 wgmma products (A from registers) the float32 forward's
    plans use are in csrc/hopper.cuh, and csrc/flash_f32.cu runs S and P.V
    on them, each three products in tf32x3_terms' order."""
    hopper = (_build._CSRC / 'hopper.cuh').read_text()
    assert f'struct WgmmaTf32<{n}> {{' in hopper
    assert f'wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32 ' in hopper
    fwd = (_build._CSRC / 'flash_f32.cu').read_text()
    assert fwd.count('WgmmaTf32<') == 2 and fwd.count('tf32x3_terms(') == 2
    # No product loop splits a K or V element: only the producer's stores
    # and the A fragments split.
    assert 'mma3(' not in fwd and 'mma_tf32(' not in fwd


def test_fwd_sections_script_plants_every_anchor():
    """scripts/torch_fwd_f32_sections.py knows the package's float32
    forward: every section anchor of K1/K2 is there once."""
    sys.path.insert(0, str(REPO / 'scripts'))
    try:
        sections = importlib.import_module('torch_fwd_f32_sections')
    finally:
        sys.path.remove(str(REPO / 'scripts'))
    text = (_build._CSRC / 'flash_f32.cu').read_text()
    recipe, planted = sections.plant(text)
    assert recipe == 'wgmma_split_once'
    assert planted.count('SEC_FLUSH(mvec != nullptr ? 8 : 0)') == 2
    assert planted.count('SEC_T0 // [section]') == 1
    # Ten marks, and the macro's definition.
    assert planted.count('SEC_MARK(') == 10 + 1
    assert 'extern "C" int fwd_sections(' in planted


def _variants(name='torch_bwd_f32_variants'):
    sys.path.insert(0, str(REPO / 'scripts'))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(str(REPO / 'scripts'))


@pytest.mark.parametrize('name', sorted(_variants().VARIANTS))
def test_bwd_variant_edits_apply(name):
    """Each named variant of scripts/torch_bwd_f32_variants.py edits the
    package's float32 backward at anchors that are there once."""
    variants = _variants()
    text = (_build._CSRC / 'flash_bwd_f32.cu').read_text()
    edits, _ = variants.VARIANTS[name]
    out = variants.edited(text, edits)
    assert (out == text) == (name == 'as_is')


@pytest.mark.parametrize(
    'name', sorted(_variants('torch_fwd_f32_variants').VARIANTS))
def test_fwd_variant_edits_apply(name):
    """Each named variant of scripts/torch_fwd_f32_variants.py edits the
    package's float32 forward at anchors that are there once."""
    variants = _variants('torch_fwd_f32_variants')
    text = (_build._CSRC / 'flash_f32.cu').read_text()
    edits, _ = variants.VARIANTS[name]
    out = variants.edited(text, edits)
    assert (out == text) == (name == 'as_is')


def _decode_branches(text, f32):
    """The lines of csrc/flash_decode.cu that the preprocessor keeps in
    the float32 build (``f32``) or the bf16 one: its ``#ifdef DECODE_F32``
    / ``#ifndef DECODE_F32`` ... ``#else`` ... ``#endif`` blocks (not
    nested) resolved."""
    kept, state = [], None
    for line in text.splitlines():
        st = line.strip()
        if st == '#ifdef DECODE_F32':
            state = f32
        elif st == '#ifndef DECODE_F32':
            state = not f32
        elif st == '#else' and state is not None:
            state = not state
        elif st == '#endif' and state is not None:
            state = None
        elif state is not False:
            kept.append(line)
    return '\n'.join(kept)


DECODE = _build._CSRC / 'flash_decode.cu'


def test_float32_decode_library_builds_from_its_source():
    """The float32 K5/K5p library is csrc/flash_decode.cu with
    -DDECODE_F32 (the bf16 one the same source without it)."""
    assert _build.LIBRARIES['flash_decode_f32'] == ('flash_decode',
                                                    ('-DDECODE_F32',))
    assert _build.LIBRARIES['flash_decode'] == ('flash_decode', ())
    assert DECODE.is_file()


@pytest.mark.parametrize('f32', [True, False], ids=['float32', 'bf16'])
def test_decode_entry_points_defined_in_each_build(f32):
    """Each build of csrc/flash_decode.cu defines the two C entry points
    ops/flash_decode.py binds (``flash_decode_<suffix>`` and
    ``flash_decode_paged_<suffix>``) once, its exports, and launches its own
    kernel: the float32 build the FFMA kernel, with no 3xTF32 product and
    no bf16 kernel; the bf16 build the mma.sync kernel."""
    kept = _decode_branches(DECODE.read_text(), f32)
    suffix = 'f32' if f32 else 'bf16'
    assert kept.count(f'#define DECODE_SYMBOL(name) name##_{suffix}') == 1
    for symbol in ('DECODE_SYMBOL(flash_decode)(',
                   'DECODE_SYMBOL(flash_decode_paged)(',
                   'flash_decode_chunk()', 'flash_decode_smem(',
                   'flash_decode_max_clusters(', 'flash_decode_stages('):
        assert kept.count(f'extern "C" int {symbol}') == 1, symbol
    mine, other = (('flash_decode_f32_kernel', 'flash_decode_kernel') if f32
                   else ('flash_decode_kernel', 'flash_decode_f32_kernel'))
    assert f'  return {mine}<D, DV, PAGED, QUANT>;' in kept
    assert f'{other}(const Args a)' not in kept
    assert f'{mine}(const Args a)' in kept
    # No 3xTF32 product anywhere in the decode source.
    assert 'mma3(' not in kept and '#include "tf32x3.cuh"' not in kept
    if f32:
        assert 'cp.async.bulk.shared::cluster.global' in kept
        assert 'fmaf(' in kept


def _script(name):
    sys.path.insert(0, str(REPO / 'scripts'))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(str(REPO / 'scripts'))


def test_decode_sections_script_plants_every_anchor():
    """scripts/torch_decode_sections.py knows the package's decode source:
    every section anchor of the bf16 kernel, of the float32 one and of the
    merge is there once, and each plan of ``--plans`` edits lines that are
    there once."""
    sections = _script('torch_decode_sections')
    text = DECODE.read_text()
    recipe, planted = sections.plant(text)
    assert recipe == 'section_comments'
    for kern in ('bf16', 'f32'):
        assert planted.count(f'SEC_T0 // [section] decode {kern} start') == 1
        assert planted.count(
            f'SEC_MARK(7) SEC_STAMP(7) SEC_FLUSH // [section] decode {kern} '
            f'done') == 1
        # Each build keeps its own kernel's marks: eight, and the macro's
        # definition.
        kept = _decode_branches(planted, kern == 'f32')
        assert kept.count('SEC_MARK(') == 8 + 1
        assert kept.count('SEC_STAMP(') == 3 + 4 + 2
    for k in (3, 4, 5, 6):
        assert planted.count(f'SEC_STAMP({k}) // [section] decode merge') == 1
    assert 'extern "C" int decode_sections(' in planted
    for steps, blocks in sections.PLANS.values():
        edited = sections.with_plan(text, steps, blocks)
        assert f'constexpr int kF32MaxSteps = {steps};' in edited
        assert f'constexpr int kF32Blocks = {blocks};' in edited
        assert sections.plant(edited)[0] == 'section_comments'


DECODE_FAULTS = ('k5_merge_arrival_order', 'k5_fresh_rows_not_substituted',
                 'k5p_unallocated_page_scored',
                 'k5_merge_before_peers_landed', 'k5p_unheld_column_scored',
                 'k5_f32_v_rows_swapped', 'k5_f32_butterfly_drops_lane',
                 'k5p_f32_reads_unheld_column')


@pytest.mark.parametrize('fault', DECODE_FAULTS)
def test_decode_planted_fault_anchors_once(fault):
    """Each decode planted fault's text is there once in
    csrc/flash_decode.cu, in code its own build compiles: a float32
    fault in the float32 build alone, a bf16 one in the bf16 build."""
    source, old, new, _ = _script('torch_planted_faults').FAULTS[fault]
    assert source == 'flash_decode.cu'
    text = DECODE.read_text()
    assert text.count(old) == 1 and new != old
    f32 = '_f32_' in fault
    assert _decode_branches(text, f32).count(old) == 1
    if f32:
        assert old not in _decode_branches(text, False)
