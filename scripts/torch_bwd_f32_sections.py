#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""
Where the float32 backward's time goes inside K3 (dq) and K4 (dk, dv), on
one CUDA card: clock64 section timers planted in a temporary copy of the
float32 backward source.

    python3 scripts/torch_bwd_f32_sections.py [--source PATH]

By default it times the package's own ``csrc/flash_bwd_f32.cu``.
``--source`` names another file that defines the float32 K3 and K4 (an
older checkout's ``csrc/flash_f32.cu`` or ``flash_bwd_f32.cu``, built
with the headers beside it); it is timed beside the package's own in
turns (that source, own, own, that source). Each body is built twice
through the port's builder into a temporary directory, every build
started at once: as it is, timed with CUDA events (cold L2, as
``chip_smoke.time_ms``), and with timers planted at the body's section
boundaries (a body whose anchors no recipe below knows is timed without
sections). Every warp sums the clock64 cycles its
lane 0 spends in each section and adds them to a device counter; a
section's share of the summed cycles of the warps that compute, times the
uninstrumented kernel time, is its time. A producer warp's own sections
(its wait for a free stage; its loads, splits and stores) are shares of
the producer warps' cycles.

The case is the float32 LM's (4 x 8 heads, 4096 rows, head dim 96,
causal), q, k, v and dO float32 from a seed, out and lse from the float32
K1; SDPA's float32 backward (dq, dk, dv together) is timed in the same
run. Run from the repository root. Prints one JSON line: the card, the
times, each body's sections, its ``ptxas`` registers and spills, and
(where the body exports it) its shared memory, threads a block and
blocks an SM at (96, 96).
"""

import argparse
import ctypes
import importlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, 'distributed_dot_product_tpu_torch', 'csrc')
OWN = os.path.join(CSRC, 'flash_bwd_f32.cu')
LIB = 'flash_f32_bwd'   # the base K3/K4 library, built from OWN's name

# Planted after the source's last #include: device counters (K3 at 0-7,
# K4 at 8-15), the timer macros and a host function that reads (and
# clears) them. Sections 0-4 are a computing warp's, 5-6 a producer's.
TIMERS = r'''
__device__ unsigned long long g_sections[16];
#define SEC_T0 long long sec_t_ = clock64(); \
  long long sec_acc_[7] = {0, 0, 0, 0, 0, 0, 0};
#define SEC_MARK(n) { const long long n_ = clock64(); \
  sec_acc_[n] += n_ - sec_t_; sec_t_ = n_; }
#define SEC_FLUSH(base) if (threadIdx.x % 32 == 0) { \
  for (int i_ = 0; i_ < 7; ++i_) \
    atomicAdd(&g_sections[(base) + i_], \
              static_cast<unsigned long long>(sec_acc_[i_])); }
extern "C" int bwd_sections(unsigned long long* host, int reset) {
  if (reset) {
    unsigned long long zero[16] = {};
    return static_cast<int>(cudaMemcpyToSymbol(g_sections, zero,
                                               sizeof(zero)));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_sections,
                                               16 * sizeof(*host)));
}
'''

SECTIONS = {
    'k3': ('loads_or_wait', 's_and_dp', 'scores', 'dq_product',
           'prologue_epilogue', 'producer_wait_free_stage',
           'producer_load_split_store'),
    'k4': ('loads_or_wait', 's_and_dp', 'scores', 'dv_and_dk_products',
           'prologue_epilogue', 'producer_wait_free_stage',
           'producer_load_split_store')}

# Per kernel body: a text that identifies it and the (anchor, replacement)
# pairs that plant the timers; every anchor must occur once.
RECIPES = {
    # The first float32 body (in csrc/flash_f32.cu beside K1/K2): one
    # warpgroup a block, cp.async stages issued by every thread, each B
    # operand split in the product loop; the stage's barriers count as
    # waiting.
    'split_in_loop': (
        'mma3(part + 4 * nt, fa, bp[0], bp[4]);',
        (('  using S = DqSmem<D, DV, Quant>;\n',
          '  using S = DqSmem<D, DV, Quant>;\n  SEC_T0\n'),
         ('  int t = next_tile(t_lo);\n  int fetch = t;\n',
          '  SEC_MARK(4)\n  int t = next_tile(t_lo);\n  int fetch = t;\n'),
         ('    __syncthreads();   // stage `stage` (and the resident rows) '
          'landed\n\n    const int k0 = t * kN;\n',
          '    __syncthreads();   // stage `stage` (and the resident rows) '
          'landed\n    SEC_MARK(0)\n\n    const int k0 = t * kN;\n'),
         ('    mma_abt<DV, NKT>(dp, sG + 16 * warp * kPf<DV>, kPf<DV>, sV, '
          'kPf<DV>);\n',
          '    mma_abt<DV, NKT>(dp, sG + 16 * warp * kPf<DV>, kPf<DV>, sV, '
          'kPf<DV>);\n    SEC_MARK(1)\n'),
         ('    // dQ += dS . K (k~).\n',
          '    SEC_MARK(2)\n    // dQ += dS . K (k~).\n'),
         ('    mma_pb<NKT, D / 8>(acc, dp, sK, kPf<D>);\n\n'
          '    __syncthreads();\n',
          '    mma_pb<NKT, D / 8>(acc, dp, sK, kPf<D>);\n    SEC_MARK(3)\n\n'
          '    __syncthreads();\n'),
         ('          make_float2(acc[i] * scale, acc[i + 1] * scale);\n'
          '  }\n}\n',
          '          make_float2(acc[i] * scale, acc[i + 1] * scale);\n  }\n'
          '  SEC_MARK(4)\n  SEC_FLUSH(0)\n}\n'),
         ('  using S = DkvSmem<D, DV, Quant>;\n',
          '  using S = DkvSmem<D, DV, Quant>;\n  SEC_T0\n'),
         ('  int h = 0, qt = qt_lo;\n  next_item(h, qt);\n',
          '  SEC_MARK(4)\n  int h = 0, qt = qt_lo;\n  next_item(h, qt);\n'),
         ('    __syncthreads();   // stage `stage` (and the resident rows) '
          'landed\n\n    const int q0 = qt * kN;\n',
          '    __syncthreads();   // stage `stage` (and the resident rows) '
          'landed\n    SEC_MARK(0)\n\n    const int q0 = qt * kN;\n'),
         ('    if (do_dk)\n      mma_abt<DV, NKT>(dp, sV + 16 * warp * '
          'kPf<DV>, kPf<DV>, sG, kPf<DV>);\n',
          '    if (do_dk)\n      mma_abt<DV, NKT>(dp, sV + 16 * warp * '
          'kPf<DV>, kPf<DV>, sG, kPf<DV>);\n    SEC_MARK(1)\n'),
         ('    // dV += P^T . dO and dK += dS^T . q2 (q~).\n',
          '    SEC_MARK(2)\n'
          '    // dV += P^T . dO and dK += dS^T . q2 (q~).\n'),
         ('    __syncthreads();   // every thread done with `stage` before '
          'its refill\n    ++qt;\n',
          '    SEC_MARK(3)\n    __syncthreads();   // every thread done with '
          '`stage` before its refill\n    ++qt;\n'),
         ('            make_float2(av[i], av[i + 1]);\n    }\n  }\n}\n',
          '            make_float2(av[i], av[i + 1]);\n    }\n  }\n'
          '  SEC_MARK(4)\n  SEC_FLUSH(8)\n}\n'))),
    # The split-once body (csrc/flash_bwd_f32.cu): consumer warpgroups
    # computing from split stages that a producer warpgroup fills. The
    # anchors are the "// [section] ..." comments that end each section.
    'split_once': (
        '// [section] dq producer: free stage',
        tuple((f'// [section] {kern} {mark}\n',
               f'{plant.format(base=base)}// [section] {kern} {mark}\n')
              for kern, base in (('dq', 0), ('dkv', 8))
              for mark, plant in (
                  ('start', 'SEC_T0 '),
                  ('producer: free stage', 'SEC_MARK(5) '),
                  ('producer: stage stored', 'SEC_MARK(6) '),
                  ('producer: done', 'SEC_MARK(6) SEC_FLUSH({base}) '),
                  ('consumer: prologue done', 'SEC_MARK(4) '),
                  ('consumer: stage landed', 'SEC_MARK(0) '),
                  ('consumer: S and dP done', 'SEC_MARK(1) '),
                  ('consumer: scores done', 'SEC_MARK(2) '),
                  ('consumer: gradient products done', 'SEC_MARK(3) '),
                  ('consumer: done', 'SEC_MARK(4) SEC_FLUSH({base}) ')))),
}

B, H, T, D = 4, 8, 4096, 96


def plant(text, recipes=None, timers=TIMERS):
    """``(recipe name, planted text)``, or ``(None, None)`` when no recipe
    of ``recipes`` (this script's by default) knows the body or one of its
    anchors is not there once."""
    recipes = RECIPES if recipes is None else recipes
    recipe = next((name for name, (mark, _) in recipes.items()
                   if mark in text), None)
    if recipe is None:
        return None, None
    for old, new in recipes[recipe][1]:
        if text.count(old) != 1:
            return None, None
        text = text.replace(old, new)
    at = text.rfind('#include')
    at = text.index('\n', at) + 1
    return recipe, text[:at] + timers + text[at:]


def headers_of(path):
    """The csrc/ directory a body at ``path`` builds with: the directory
    it lies in when that holds the kernels' headers (another checkout's
    csrc/, so that its body builds with its own headers), else the
    package's."""
    here = os.path.dirname(os.path.abspath(path))
    return here if os.path.isfile(os.path.join(here, 'hopper.cuh')) else CSRC


def csrc_copy(tmp, tag, text, name='flash_bwd_f32.cu', csrc=CSRC):
    """A copy of ``csrc`` under ``tmp/tag`` whose ``name`` is ``text``;
    returns (csrc, build dir)."""
    src = os.path.join(tmp, tag, 'csrc')
    shutil.copytree(csrc, src)
    with open(os.path.join(src, name), 'w') as f:
        f.write(text)
    return src, os.path.join(tmp, tag, 'build')


def point(build, where, lib=LIB):
    """Points the port's builder at ``where`` = (csrc, build dir); the next
    call of a kernel of ``lib`` loads (and if need be builds) that
    library."""
    build._CSRC = type(build._CSRC)(where[0])
    build._BUILD_DIR = type(build._BUILD_DIR)(where[1])
    build._LIBS.pop(lib, None)


def build_together(build, places, lib=LIB, beside=('flash_f32',)):
    """Builds ``lib`` in every place of ``places`` at once, and the
    package's own libraries ``beside``; returns each place's ptxas report
    ``{kernel: (registers, spill bytes)}``."""
    saved = build._CSRC, build._BUILD_DIR
    jobs = {}
    try:
        own = {name: build._start(name) for name in beside}
        for tag, where in places.items():
            point(build, where, lib)
            jobs[tag] = (where, build._start(lib))
        for name, job in own.items():
            build._finish(name, job)
        reports = {}
        for tag, (where, job) in jobs.items():
            build._finish(lib, job)
            point(build, where, lib)
            reports[tag] = build.resources(lib)
        return reports
    finally:
        build._CSRC, build._BUILD_DIR = saved


def occupancy(build):
    """``{kernel: {smem_bytes, threads, blocks_per_sm}}`` at (96, 96) from
    the loaded body's ``flash_bwd_f32_occupancy``, or None where the body
    has none."""
    lib = build.load(LIB)
    fn = getattr(lib, 'flash_bwd_f32_occupancy', None)
    if fn is None:
        return None
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    out = {}
    for kind, name in ((0, 'k3'), (1, 'k4')):
        vals = [ctypes.c_int() for _ in range(3)]
        err = fn(kind, 96, 96, 0, *(ctypes.addressof(v) for v in vals))
        out[name] = ({'error': err} if err else dict(zip(
            ('smem_bytes', 'threads', 'blocks_per_sm'),
            (v.value for v in vals))))
    return out


def registers_at_96(report, label):
    """The (96, 96) K3 / K4 kernels' ptxas registers and spill bytes."""
    return {label(name): list(rs) for name, rs in report.items()
            if ('flash_dq' in name or 'flash_dkv' in name)
            and 'Li96ELi96E' in name}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--source', default=None,
                    help='another file defining the float32 K3 and K4, '
                         'timed beside the package\'s own')
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('torch_bwd_f32_sections: no CUDA card', file=sys.stderr)
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
                bodies[tag] = (os.path.relpath(path, ROOT), f.read())
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    gen = torch.Generator().manual_seed(0)
    dev = torch.device('cuda')
    q, k, v, g = (torch.randn((B, H, T, D), generator=gen).to(dev)
                  for _ in range(4))
    scale = 1.0 / math.sqrt(D)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)
    result = {'script': 'scripts/torch_bwd_f32_sections.py', 'card': smi,
              'case': {'q': [B, H, T, D], 'dtype': 'float32',
                       'causal': True}, 'bodies': {}}

    home = (str(_build._CSRC), str(_build._BUILD_DIR))
    with tempfile.TemporaryDirectory() as tmp:
        places, recipes = {}, {}
        for tag, (_, text) in bodies.items():
            src = headers_of(os.path.join(ROOT, bodies[tag][0]))
            places[tag] = csrc_copy(tmp, tag, text, csrc=src)
            recipe, planted = plant(text)
            recipes[tag] = recipe
            if planted is not None:
                places[tag + '_timed'] = csrc_copy(tmp, tag + '_timed',
                                                   planted, csrc=src)
        # The package's own float32 K1 (the forward's lse) beside them.
        reports = build_together(_build, places)
        # The forward (the package's own float32 K1) and the backward's
        # operands.
        out, lse = fa.flash_attention_with_lse(q, k, v, causal=True,
                                               scale=scale)
        q2, lse2, delta = fa.flash_attention_bwd_operands(q, out, lse, g,
                                                          scale)

        def k3():
            return fa.flash_attention_dq(q2, k, v, g, lse2, delta,
                                         causal=True, scale=scale)

        def k4():
            return fa.flash_attention_dkv(q2, k, v, g, lse2, delta,
                                          causal=True)

        grads, first = {}, None
        for tag in bodies:
            point(_build, places[tag])
            grads[tag] = (k3(), *k4())
            torch.cuda.synchronize()
            first = first or tag
        diff = {tag: {n: (a - b).abs().max().item() for n, a, b in zip(
            ('dq', 'dk', 'dv'), grads[tag], grads[first])}
            for tag in bodies if tag != first}
        del grads
        order = (['source', 'own', 'own', 'source'] if len(bodies) == 2
                 else list(bodies))
        times = {tag: {'k3': [], 'k4': []} for tag in bodies}
        for tag in order:
            point(_build, places[tag])
            times[tag]['k3'].append(chip_smoke.time_ms(torch, k3, flush))
            times[tag]['k4'].append(chip_smoke.time_ms(torch, k4, flush))
        for tag, (path, _) in bodies.items():
            point(_build, places[tag])
            ms = {n: statistics.mean(x) for n, x in times[tag].items()}
            row = {'source': path, 'body': recipes[tag],
                   'k3_ms': ms['k3'], 'k4_ms': ms['k4'],
                   'pair_ms': ms['k3'] + ms['k4'],
                   'k3_ms_each': times[tag]['k3'],
                   'k4_ms_each': times[tag]['k4'],
                   'max_abs_diff_vs_' + first: diff.get(tag),
                   'ptxas_96': registers_at_96(reports[tag],
                                               chip_smoke.kernel_label),
                   'occupancy_96': occupancy(_build)}
            if tag + '_timed' in places:
                point(_build, places[tag + '_timed'])
                read = _build.load(LIB).bwd_sections
                read.argtypes = [ctypes.c_void_p, ctypes.c_int]
                counts = (ctypes.c_ulonglong * 16)()
                row['sections'] = {}
                for base, (name, fn) in ((0, ('k3', k3)), (8, ('k4', k4))):
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
                    for i, n in enumerate(SECTIONS[name]):
                        total = work if i < 5 else prod
                        if total:
                            sec[n] = {'share': c[i] / total,
                                      'warp_cycles': c[i]}
                            if i < 5:
                                sec[n]['ms'] = ms[name] * c[i] / total
                    row['sections'][name] = sec
            result['bodies'][tag] = row
        point(_build, home)

    # SDPA's float32 backward (dq, dk, dv together) in the same run.
    F = torch.nn.functional
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    y = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    result['sdpa_float32_bwd_ms'] = chip_smoke.time_ms(
        torch, lambda: torch.autograd.grad(y, (qs, ks, vs), g,
                                           retain_graph=True), flush)
    result['sdpa_backend'] = chip_smoke.sdpa_backend(
        torch, lambda: F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=True))[0]
    for row in result['bodies'].values():
        row['pair_over_sdpa'] = row['pair_ms'] / result['sdpa_float32_bwd_ms']
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
