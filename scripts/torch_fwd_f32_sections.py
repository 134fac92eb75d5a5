#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""
Where the float32 forward's time goes inside K1 and K2, on one CUDA card:
clock64 section timers planted in a temporary copy of the float32 forward
source (the forward twin of ``scripts/torch_bwd_f32_sections.py``, whose
helpers it uses).

    python3 scripts/torch_fwd_f32_sections.py [--source PATH]

By default it times the package's own ``csrc/flash_f32.cu``. ``--source``
names another file that defines the float32 K1/K2 (an older checkout's
``csrc/flash_f32.cu``, built with the headers beside it); it is timed
beside the package's own in turns (that source, own, own, that source).
Each body is built twice into a temporary directory, every build started
at once: as it is, timed with CUDA events (cold L2, as
``chip_smoke.time_ms``), and with timers planted at the body's section
boundaries (a body whose anchors no recipe below knows is timed without
sections). Every warp sums the clock64 cycles its lane 0 spends in each
section and adds them to a device counter (K1 at 0-7, K2 at 8-15, told
apart by the row-bound pointer); a section's share of the summed cycles
of the warps that compute, times the uninstrumented kernel time, is its
time. A producer warp's own sections (its wait for a free stage; its
loads, splits and stores) are shares of the producer warps' cycles.

The case is the float32 LM's (4 x 8 heads, 4096 rows, head dim 96,
causal), q, k and v float32 from a seed; K2 runs on the row bounds of the
same q and k. SDPA's float32 forward is timed in the same run. Run from
the repository root. Prints one JSON line: the card's name and power
limit, the times, each body's sections, its ``ptxas`` registers and
spills at (96, 96) (and the ``ptxas`` warnings that name wgmma), and,
where the body exports it, its shared memory, threads a block, blocks an
SM and computing warps an SM at (96, 96).
"""

import argparse
import ctypes
import importlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'scripts'))
import torch_bwd_f32_sections as bwd  # noqa: E402

OWN = os.path.join(bwd.CSRC, 'flash_f32.cu')
LIB = 'flash_f32'   # the base K1/K2 library, built from OWN's name
TIMERS = bwd.TIMERS.replace('bwd_sections', 'fwd_sections')

SECTIONS = ('loads_or_wait', 's_product', 'scores_softmax', 'pv_product',
            'prologue_epilogue', 'producer_wait_free_stage',
            'producer_load_split_store')
# K2 is the same kernel with the row bounds (mvec) set.
_BASE = 'mvec != nullptr ? 8 : 0'

# Per kernel body: a text that identifies it and the (anchor, replacement)
# pairs that plant the timers; every anchor must occur once.
RECIPES = {
    # PR 22's body: one warpgroup a block, cp.async stages issued by every
    # thread, each B operand split in the product loop (mma.sync); the
    # stage's two barriers count as waiting.
    'split_in_loop': (
        'mma3(part + 4 * nt, fa, bk[8 * nt], bk[pb + 8 * nt]);',
        (('  using S = FwdSmem<D, DV, Quant>;\n',
          '  using S = FwdSmem<D, DV, Quant>;\n  SEC_T0\n'),
         ('  const bool rows_full = qb0 + kB <= tq;\n',
          '  SEC_MARK(4)\n  const bool rows_full = qb0 + kB <= tq;\n'),
         ('    __syncthreads();   // stage `stage` landed for every thread\n',
          '    __syncthreads();   // stage `stage` landed for every thread\n'
          '    SEC_MARK(0)\n'),
         ("    // Masked scores to -inf; ALiBi's bias.",
          "    SEC_MARK(1)\n    // Masked scores to -inf; ALiBi's bias."),
         ('    // O += P V.\n', '    SEC_MARK(2)\n    // O += P V.\n'),
         ('    mma_pb<NKT, DV / 8>(o, s, sV, kPf<DV>);\n',
          '    mma_pb<NKT, DV / 8>(o, s, sV, kPf<DV>);\n    SEC_MARK(3)\n'),
         ('        kLn2 * (m_run[h] + log2f(l[h] == 0.f ? 1.f : l[h]));\n'
          '  }\n}\n',
          '        kLn2 * (m_run[h] + log2f(l[h] == 0.f ? 1.f : l[h]));\n'
          f'  }}\n  SEC_MARK(4)\n  SEC_FLUSH({_BASE})\n}}\n'))),
    # The wgmma body: consumer warpgroups computing from split stages that
    # a producer warpgroup fills. The anchors are the "// [section] ..."
    # comments that end each section.
    'wgmma_split_once': (
        '// [section] fwd producer: free stage',
        tuple((f'// [section] fwd {mark}\n',
               f'{plant.format(base=_BASE)}// [section] fwd {mark}\n')
              for mark, plant in (
                  ('start', 'SEC_T0 '),
                  ('producer: free stage', 'SEC_MARK(5) '),
                  ('producer: stage stored', 'SEC_MARK(6) '),
                  ('producer: done', 'SEC_MARK(6) SEC_FLUSH({base}) '),
                  ('consumer: prologue done', 'SEC_MARK(4) '),
                  ('consumer: stage landed', 'SEC_MARK(0) '),
                  ('consumer: S done', 'SEC_MARK(1) '),
                  ('consumer: softmax done', 'SEC_MARK(2) '),
                  ('consumer: V landed', 'SEC_MARK(0) '),
                  ('consumer: P.V done', 'SEC_MARK(3) '),
                  ('consumer: done', 'SEC_MARK(4) SEC_FLUSH({base}) ')))),
}

B, H, T, D = 4, 8, 4096, 96


def plant(text):
    """``(recipe name, planted text)`` of a float32 forward body, or
    ``(None, None)``."""
    return bwd.plant(text, RECIPES, TIMERS)


def occupancy(build):
    """``{smem_bytes, threads, blocks_per_sm, computing_warps_per_sm}``
    of the base K1/K2 at (96, 96) from the loaded body's
    ``flash_fwd_f32_occupancy``, or None where the body has none (every
    thread of a body without it computes)."""
    fn = getattr(build.load(LIB), 'flash_fwd_f32_occupancy', None)
    if fn is None:
        return None
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    vals = [ctypes.c_int() for _ in range(4)]
    err = fn(96, 96, 0, *(ctypes.addressof(v) for v in vals))
    if err:
        return {'error': err}
    smem, threads, blocks, computing = (v.value for v in vals)
    return {'smem_bytes': smem, 'threads': threads, 'blocks_per_sm': blocks,
            'computing_warps_per_sm': blocks * computing // 32}


def registers_at_96(report, label):
    """The (96, 96) K1/K2 kernels' ptxas registers and spill bytes."""
    return {label(name): list(rs) for name, rs in report.items()
            if 'flash_fwd_f32' in name and 'Li96ELi96E' in name}


def wgmma_warnings(build):
    """The lines of the loaded library's build log that name wgmma (ptxas
    says so where it serializes the products)."""
    log = build._target(LIB).with_suffix('.log')
    if not log.is_file():
        return None
    return [ln.strip() for ln in log.read_text().splitlines()
            if 'wgmma' in ln.lower()]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--source', default=None,
                    help='another file defining the float32 K1/K2, timed '
                         'beside the package\'s own')
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('torch_fwd_f32_sections: no CUDA card', file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from distributed_dot_product_tpu_torch.ops import _build
    fa = importlib.import_module(
        'distributed_dot_product_tpu_torch.ops.flash_attention')

    bodies = {}
    for tag, path in (('source', args.source), ('own', OWN)):
        if path is not None and os.path.isfile(path):
            with open(path) as f:
                bodies[tag] = (os.path.abspath(path), f.read())
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    gen = torch.Generator().manual_seed(0)
    dev = torch.device('cuda')
    q, k, v = (torch.randn((B, H, T, D), generator=gen).to(dev)
               for _ in range(3))
    scale = 1.0 / math.sqrt(D)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)
    result = {'script': 'scripts/torch_fwd_f32_sections.py', 'card': smi,
              'case': {'q': [B, H, T, D], 'dtype': 'float32',
                       'causal': True}, 'bodies': {}}

    home = (str(_build._CSRC), str(_build._BUILD_DIR))
    with tempfile.TemporaryDirectory() as tmp:
        places, recipes = {}, {}
        for tag, (path, text) in bodies.items():
            src = bwd.headers_of(path)
            places[tag] = bwd.csrc_copy(tmp, tag, text, 'flash_f32.cu', src)
            recipe, planted = plant(text)
            recipes[tag] = recipe
            if planted is not None:
                places[tag + '_timed'] = bwd.csrc_copy(
                    tmp, tag + '_timed', planted, 'flash_f32.cu', src)
        reports = bwd.build_together(_build, places, LIB, ())
        mvec = fa.bounded_shift(q * (scale * math.log2(math.e)), k)

        def k1():
            return fa.flash_attention(q, k, v, causal=True, scale=scale)

        def k2():
            return fa.flash_attention_bounded(q, k, v, causal=True,
                                              scale=scale, mvec=mvec)

        outs, first = {}, None
        for tag in bodies:
            bwd.point(_build, places[tag], LIB)
            outs[tag] = (k1(), k2())
            torch.cuda.synchronize()
            first = first or tag
        diff = {tag: {n: (a - b).abs().max().item() for n, a, b in zip(
            ('k1', 'k2'), outs[tag], outs[first])}
            for tag in bodies if tag != first}
        plain = fa.flash_attention_plain(q, k, v, causal=True, scale=scale)
        errs = {tag: chip_smoke.rel_errs(torch, o[0], plain)[0]
                for tag, o in outs.items()}
        del outs, plain
        order = (['source', 'own', 'own', 'source'] if len(bodies) == 2
                 else list(bodies))
        times = {tag: {'k1': [], 'k2': []} for tag in bodies}
        for tag in order:
            bwd.point(_build, places[tag], LIB)
            times[tag]['k1'].append(chip_smoke.time_ms(torch, k1, flush))
            times[tag]['k2'].append(chip_smoke.time_ms(torch, k2, flush))
        for tag, (path, _) in bodies.items():
            bwd.point(_build, places[tag], LIB)
            ms = {n: statistics.mean(x) for n, x in times[tag].items()}
            row = {'source': os.path.relpath(path, ROOT),
                   'body': recipes[tag], 'k1_ms': ms['k1'],
                   'k2_ms': ms['k2'], 'k1_ms_each': times[tag]['k1'],
                   'k2_ms_each': times[tag]['k2'],
                   'k1_max_row_rel_err_vs_plain': errs[tag],
                   'max_abs_diff_vs_' + first: diff.get(tag),
                   'ptxas_96': registers_at_96(reports[tag],
                                               chip_smoke.kernel_label),
                   'ptxas_wgmma_warnings': wgmma_warnings(_build),
                   'occupancy_96': occupancy(_build)}
            if tag + '_timed' in places:
                bwd.point(_build, places[tag + '_timed'], LIB)
                read = _build.load(LIB).fwd_sections
                read.argtypes = [ctypes.c_void_p, ctypes.c_int]
                counts = (ctypes.c_ulonglong * 16)()
                row['sections'] = {}
                for base, (name, fn) in ((0, ('k1', k1)), (8, ('k2', k2))):
                    row[name + '_ms_with_timers'] = chip_smoke.time_ms(
                        torch, fn, flush, reps=5)
                    torch.cuda.synchronize()
                    if read(None, 1):
                        raise SystemExit('could not clear the counters')
                    fn()
                    torch.cuda.synchronize()
                    if read(ctypes.addressof(counts), 0):
                        raise SystemExit('could not read the counters')
                    c = [counts[base + i] for i in range(7)]
                    work, prod = sum(c[:5]), sum(c[5:])
                    sec = {}
                    for i, n in enumerate(SECTIONS):
                        total = work if i < 5 else prod
                        if total:
                            sec[n] = {'share': c[i] / total,
                                      'warp_cycles': c[i]}
                            if i < 5:
                                sec[n]['ms'] = ms[name] * c[i] / total
                    row['sections'][name] = sec
            result['bodies'][tag] = row
        bwd.point(_build, home, LIB)

    # SDPA's float32 forward in the same run.
    F = torch.nn.functional

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)
    result['sdpa_float32_fwd_ms'] = chip_smoke.time_ms(torch, sdpa, flush)
    result['sdpa_backend'] = chip_smoke.sdpa_backend(torch, sdpa)[0]
    for row in result['bodies'].values():
        for name in ('k1', 'k2'):
            row[name + '_over_sdpa'] = (row[name + '_ms']
                                        / result['sdpa_float32_fwd_ms'])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
