#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""
Where K5's and K5p's time goes inside the decode kernel, on one CUDA card:
clock64 section timers planted in a temporary copy of
``csrc/flash_decode.cu``.

    python3 scripts/torch_decode_sections.py [--f32] [--source PATH]
                                             [--plans]

By default it times the bf16 kernels (the ``flash_decode`` library);
``--f32`` times the float32 ones (the same source built with
``-DDECODE_F32``, the ``flash_decode_f32`` library) on float32 operands.
``--source`` names another ``flash_decode.cu`` (an older checkout's,
built with the headers beside it), timed beside the package's own in
turns (that source, own, own, that source); the outputs of every body are
compared with the first's bit for bit. ``--plans`` (with ``--f32``) also
times the package's float32 body under each plan of ``PLANS`` (the steps
a warp keeps in flight and the blocks an SM they leave room for), in the
same turns. Each body is built twice through the port's builder into a
temporary directory, every build started at once: as it is, timed with
CUDA events (cold L2, as ``chip_smoke.time_ms``), and with timers at the
body's section boundaries (``RECIPES``; a body no recipe knows is timed
without sections). Every warp sums the clock64 cycles its lane 0 spends
in each section and adds them to a device counter; each section's share
of the summed cycles, times the uninstrumented kernel time, is its time.
A section that waits (a stage's loads, the block barrier after a pass,
the cluster barriers) shows as waiting in every warp that waits.

Sections: the prologue (the slot's vectors, the first loads issued, q
loaded, the appends), waiting for a stage, the S product, the softmax
(mask, ALiBi, running max, weights), the P V product, issuing the next
stage, a pass's epilogue (the warps' states combined), and the cluster
merge (the barrier that all blocks run, the stores into the peers' shared
memory, the wait for the peers' stores, the local merge). Each block also
stamps the card's global timer at its start, at the end of its prologue,
after its steps and pass epilogue, at four points of the merge and at its
end: the timeline gives the launch's span, the spread of the blocks'
starts and each part's median and longest wall time.

Cases: K5 at the greedy decode shape (batch 4, 8 heads of 96, t_max 2048,
1033 columns attended) and K5p at the serving shape (chip_smoke's
``paged_case``: 8 slots, page 16, scrambled, mixed fill), the shapes of
``chip_smoke._f32_timing``. For the package's own body, with the same
timing: each case at cluster sizes 1, 2, 4 and 8 (the wrapper's geometry
overridden) with the clusters the card holds at once
(``flash_decode_max_clusters``), the greedy case with no column attended
and nothing appended (the kernel's fixed cost), and a one-element PyTorch
``add_`` (a launch's floor). Run from the repository root. Prints one
JSON line: the card's name and power limit, per body both cases' times
(each turn's and their mean), the sections and the timeline, ``ptxas``'s
registers and spill bytes and the blocks an SM at (96, 96) and (256,
256) (and, where the body exports them, its shared memory and steps a
warp keeps in flight), and the sweep.
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

OWN = os.path.join(bwd.CSRC, 'flash_decode.cu')
NAME = 'flash_decode.cu'

SECTIONS = ('prologue', 'stage_wait', 's_product', 'softmax', 'pv_product',
            'issue_next', 'pass_epilogue', 'cluster_merge')

# Planted after the source's last #include: a device counter per section,
# the timer macros and a host function that reads (and clears) them.
TIMERS = r'''
__device__ unsigned long long g_sections[8];
__device__ unsigned long long g_stamps[8 * 4096];
__device__ __forceinline__ unsigned long long sec_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
#define SEC_STAMP(k) if (threadIdx.x == 0 && \
  blockIdx.y * gridDim.x + blockIdx.x < 4096) \
  g_stamps[8 * (blockIdx.y * gridDim.x + blockIdx.x) + k] = sec_now();
#define SEC_T0 long long sec_t_ = clock64(); \
  long long sec_acc_[8] = {0, 0, 0, 0, 0, 0, 0, 0}; SEC_STAMP(0)
#define SEC_MARK(n) { const long long n_ = clock64(); \
  sec_acc_[n] += n_ - sec_t_; sec_t_ = n_; }
#define SEC_FLUSH if (threadIdx.x % 32 == 0) { \
  for (int i_ = 0; i_ < 8; ++i_) \
    atomicAdd(&g_sections[i_], \
              static_cast<unsigned long long>(sec_acc_[i_])); }
extern "C" int decode_stamps(unsigned long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_stamps,
                                               sizeof(g_stamps)));
}
extern "C" int decode_sections(unsigned long long* host, int reset) {
  if (reset) {
    unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    return static_cast<int>(cudaMemcpyToSymbol(g_sections, zero,
                                               sizeof(zero)));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_sections,
                                               8 * sizeof(*host)));
}
'''

# The merge's timeline stamps (3-6), in the first mma.sync body's merge
# text.
_MERGE_STAMPS = (
    ('  cluster_wait();\n  __syncthreads();\n  if ((active >> rank) & 1) {\n',
     '  cluster_wait();\n  __syncthreads();\n  SEC_STAMP(3)\n'
     '  if ((active >> rank) & 1) {\n'),
    ('  if (tid == 0)\n    mbar_expect_tx(',
     '  SEC_STAMP(4)\n  if (tid == 0)\n    mbar_expect_tx('),
    ('  mbar_wait(bar, 0);\n', '  mbar_wait(bar, 0);\n  SEC_STAMP(5)\n'),
    ('  __syncthreads();\n  for (int e = e0 + tid; e < e1; e += kThreads) {\n',
     '  __syncthreads();\n  SEC_STAMP(6)\n'
     '  for (int e = e0 + tid; e < e1; e += kThreads) {\n'))

# Per kernel body: a text that identifies it and the (anchor, replacement)
# pairs that plant the timers; every anchor must occur once.
RECIPES = {
    # The first mma.sync body (any width, with float32 3xTF32 branches),
    # the merge inline at the kernel's end: one recipe for the bf16 and
    # the float32 build.
    'mma_sync_inline_merge': (
        '  // The merge. Rank j merges',
        (('  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, '
          'its row\n',
          '  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, '
          'its row\n  SEC_T0\n'),
         ('    int st = 0;\n    for (int step = first; step <= s_last;\n',
          '    SEC_MARK(0)\n    SEC_STAMP(1)\n    int st = 0;\n'
          '    for (int step = first; step <= s_last;\n'),
         ("      // S = q K^T over the warp's 16 columns (two n-tiles).\n",
          '      SEC_MARK(1)\n'
          "      // S = q K^T over the warp's 16 columns (two n-tiles).\n"),
         ("      // ALiBi, the row's span and the held columns;",
          "      SEC_MARK(2)\n      // ALiBi, the row's span and the held "
          "columns;"),
         ('      // O = O * corr + P V',
          '      SEC_MARK(3)\n      // O = O * corr + P V'),
         ('      __syncwarp();\n      if (s_issue <= s_last) {\n'
          '        issue_warp',
          '      SEC_MARK(4)\n      __syncwarp();\n'
          '      if (s_issue <= s_last) {\n        issue_warp'),
         ('      cp_async_commit();\n'
          '      st = kStages == 1 ? 0 : st ^ 1;\n',
          '      cp_async_commit();\n      SEC_MARK(5)\n'
          '      st = kStages == 1 ? 0 : st ^ 1;\n'),
         ('    __syncthreads();\n  }\n\n  // The merge. Rank j merges',
          '    __syncthreads();\n    SEC_MARK(6)\n    SEC_STAMP(2)\n  }\n\n'
          '  // The merge. Rank j merges'),
         ('      store_elem(a.out + qrow * a.dv + dd,\n'
          '                 w_l[rl] == 0.f ? 0.f : acc / w_l[rl]);\n'
          '    }\n  }\n}\n',
          '      store_elem(a.out + qrow * a.dv + dd,\n'
          '                 w_l[rl] == 0.f ? 0.f : acc / w_l[rl]);\n'
          '    }\n  }\n  SEC_MARK(7)\n  SEC_STAMP(7)\n  SEC_FLUSH\n}\n'),
         *_MERGE_STAMPS)),
    # The bodies marked by "// [section] decode ..." comments: the bf16
    # kernel and the float32 one (each compiled in its own build), and
    # the cluster merge both call. Each comment ends its section.
    'section_comments': (
        '// [section] decode bf16 start',
        tuple((f'// [section] decode {kern} {mark}\n',
               f'{plant}// [section] decode {kern} {mark}\n')
              for kern in ('bf16', 'f32')
              for mark, plant in (
                  ('start', 'SEC_T0 '),
                  ('prologue done', 'SEC_MARK(0) SEC_STAMP(1) '),
                  ('stage landed', 'SEC_MARK(1) '),
                  ('S done', 'SEC_MARK(2) '),
                  ('softmax done', 'SEC_MARK(3) '),
                  ('P.V done', 'SEC_MARK(4) '),
                  ('next step issued', 'SEC_MARK(5) '),
                  ('pass epilogue done', 'SEC_MARK(6) SEC_STAMP(2) '),
                  ('done', 'SEC_MARK(7) SEC_STAMP(7) SEC_FLUSH ')))
        + tuple((f'// [section] decode merge: {mark}\n',
                 f'SEC_STAMP({k}) // [section] decode merge: {mark}\n')
                for k, mark in ((3, 'cluster barrier passed'),
                                (4, 'partials stored'),
                                (5, 'peers landed'),
                                (6, 'weights done')))),
}

# The float32 body's other plans (--plans; the package's own runs two
# steps a warp, two blocks an SM): the steps a warp keeps in flight at most
# and the blocks an SM the plan leaves room for, set by editing the two
# lines of the package's source that start with these.
_PLAN_LINES = ('constexpr int kF32MaxSteps = ', 'constexpr int kF32Blocks = ')
PLANS = {'3_steps_1_block': (3, 1), '1_step_3_blocks': (1, 3)}


def with_plan(text, steps, blocks):
    """The source with its float32 plan set; raises when a plan line is
    not there once."""
    lines = text.split('\n')
    for prefix, value in zip(_PLAN_LINES, (steps, blocks)):
        hits = [i for i, ln in enumerate(lines) if ln.startswith(prefix)]
        if len(hits) != 1:
            raise SystemExit(f'{NAME}: plan line {prefix!r} not there once')
        lines[hits[0]] = f'{prefix}{value};'
    return '\n'.join(lines)


def plant(text):
    """``(recipe name, planted text)`` of a decode body, or ``(None,
    None)``."""
    return bwd.plant(text, RECIPES, TIMERS)


def occupancy(build, lib, report, label, sms, t_max):
    """At (96, 96) and (256, 256), one row, slab, no int8: the blocks an SM
    (``flash_decode_max_clusters`` at clusters of one block, over the
    SMs), the block's shared memory, the steps a warp keeps in flight
    (where the body exports ``flash_decode_stages``) and every
    instantiation's ``ptxas`` registers and spill bytes."""
    loaded = build.load(lib)
    clusters = loaded.flash_decode_max_clusters
    clusters.argtypes, clusters.restype = [ctypes.c_int] * 7, ctypes.c_int
    smem = loaded.flash_decode_smem
    smem.argtypes, smem.restype = [ctypes.c_int] * 8, ctypes.c_int
    stages = getattr(loaded, 'flash_decode_stages', None)
    if stages is not None:
        stages.argtypes, stages.restype = [ctypes.c_int] * 3, ctypes.c_int
    out = {}
    for d, dv in ((96, 96), (256, 256)):
        resident = clusters(1, 1, d, dv, 0, 0, 1)
        out[f'{d}_{dv}'] = {
            'blocks_per_sm': resident / sms if resident > 0 else resident,
            'smem_bytes': smem(1, 1, d, dv, 0, t_max, 0, 1),
            'steps_in_flight': (stages(d, dv, 0) if stages is not None
                                else None),
            'ptxas': {label(name): list(rs) for name, rs in report.items()
                      if f'ILi{d}ELi{dv}E' in name}}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--f32', action='store_true',
                    help='time the float32 kernels (flash_decode_f32)')
    ap.add_argument('--source', default=None,
                    help='another flash_decode.cu, timed beside the '
                         'package\'s own')
    ap.add_argument('--plans', action='store_true',
                    help='with --f32: also time the own float32 body under '
                         'each plan of PLANS')
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('torch_decode_sections: no CUDA card', file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from distributed_dot_product_tpu_torch.ops import _build
    fd = importlib.import_module(
        'distributed_dot_product_tpu_torch.ops.flash_decode')
    lib = 'flash_decode_f32' if args.f32 else 'flash_decode'

    bodies = {}
    for tag, path in (('source', args.source), ('own', OWN)):
        if path is not None:
            with open(path) as f:
                bodies[tag] = (os.path.abspath(path), f.read())
    if args.plans and args.f32:
        own_path, own_text = bodies['own']
        for plan, (steps, blocks) in PLANS.items():
            bodies[f'own_{plan}'] = (own_path,
                                     with_plan(own_text, steps, blocks))
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    gen = torch.Generator().manual_seed(0)
    dev = torch.device('cuda')
    dt = torch.float32 if args.f32 else torch.bfloat16
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)
    scale = 1.0 / math.sqrt(cs.HEAD_DIM)
    fill = cs.PROMPT + cs.STEPS // 2
    shape = (cs.BATCH, cs.HEADS, 1, cs.HEAD_DIM)
    q, kn, vn = (cs.randn(torch, shape, gen, dev, dt) for _ in range(3))
    ck, cv = (cs.randn(torch, (cs.BATCH, cs.HEADS, cs.T_MAX, cs.HEAD_DIM),
                       gen, dev, dt) for _ in range(2))
    vt = torch.full((cs.BATCH,), fill, dtype=torch.int32, device=dev)
    pq, pkn, pvn, kp, vp, pvt, pap, table, _ = cs.paged_case(torch, gen,
                                                             dev)
    pq, pkn, pvn, kp, vp = (x.to(dt) for x in (pq, pkn, pvn, kp, vp))
    cases = {
        'k5_greedy': lambda: fd.flash_decode(q, kn, vn, ck, cv, vt, vt,
                                             scale=scale),
        'k5p_serving': lambda: fd.flash_decode(pq, pkn, pvn, kp, vp, pvt,
                                               pap, page_table=table,
                                               scale=scale)}
    shapes = {'k5_greedy': (cs.BATCH, cs.HEADS, cs.T_MAX, False),
              'k5p_serving': (cs.SERVE_SLOTS, cs.HEADS, cs.SERVE_T_MAX,
                              True)}
    sms = fd._sm_count(dev.index)
    geometry = fd._launch_geometry
    result = {'script': 'scripts/torch_decode_sections.py', 'card': smi,
              'library': lib, 'dtype': str(dt).replace('torch.', ''),
              'bodies': {}}

    home = (str(_build._CSRC), str(_build._BUILD_DIR))
    with tempfile.TemporaryDirectory() as tmp:
        places, recipes = {}, {}
        for tag, (path, text) in bodies.items():
            src = bwd.headers_of(path)
            places[tag] = bwd.csrc_copy(tmp, tag, text, NAME, src)
            recipe, planted = plant(text)
            recipes[tag] = recipe
            if planted is not None:
                places[tag + '_timed'] = bwd.csrc_copy(
                    tmp, tag + '_timed', planted, NAME, src)
        reports = bwd.build_together(_build, places, lib, ())

        # Each body's outputs on fresh copies of the caches, against the
        # first body's bit for bit.
        outs, first = {}, None
        for tag in bodies:
            bwd.point(_build, places[tag], lib)
            c5 = (ck.clone(), cv.clone())
            cp = (kp.clone(), vp.clone())
            outs[tag] = (
                fd.flash_decode(q, kn, vn, *c5, vt, vt, scale=scale)[0],
                fd.flash_decode(pq, pkn, pvn, *cp, pvt, pap,
                                page_table=table, scale=scale)[0],
                *c5, *cp)
            torch.cuda.synchronize()
            first = first or tag
        equal = {tag: all(torch.equal(a, b) for a, b in zip(outs[tag],
                                                            outs[first]))
                 for tag in bodies if tag != first}
        del outs

        order = (['source', 'own', 'own', 'source'] if 'source' in bodies
                 else ['own', 'own'])
        plan_tags = [t for t in bodies if t.startswith('own_')]
        order = order[:2] + plan_tags + plan_tags[::-1] + order[2:]
        times = {tag: {n: [] for n in cases} for tag in bodies}
        for tag in order:
            bwd.point(_build, places[tag], lib)
            for name, fn in cases.items():
                times[tag][name].append(cs.time_ms(torch, fn, flush))

        for tag, (path, _) in bodies.items():
            bwd.point(_build, places[tag], lib)
            ms = {n: statistics.mean(x) for n, x in times[tag].items()}
            row = {'source': os.path.relpath(path, ROOT),
                   'body': recipes[tag],
                   'ms': ms, 'ms_each': times[tag],
                   'outputs_bit_equal_to_' + first: equal.get(tag),
                   'occupancy': occupancy(_build, lib, reports[tag],
                                          cs.kernel_label, sms,
                                          cs.SERVE_T_MAX)}
            if tag == 'own':
                row['cluster_sweep'] = sweep(torch, cs, fd, _build, lib,
                                             cases, shapes, flush)
                none = torch.full((cs.BATCH,), -1, dtype=torch.int32,
                                  device=dev)
                one = torch.zeros(1, device=dev)
                row['floors'] = {
                    'add_one_element_ms': cs.time_ms(
                        torch, lambda: one.add_(1), flush),
                    'k5_greedy_nothing_attended_ms': cs.time_ms(
                        torch, lambda: fd.flash_decode(
                            q, kn, vn, ck, cv, none, none, scale=scale),
                        flush)}
            if tag + '_timed' in places:
                bwd.point(_build, places[tag + '_timed'], lib)
                row['sections'] = {
                    name: sections(torch, cs, _build, lib, fn, ms[name],
                                   geometry(*shapes[name][:3], sms)[0]
                                   * shapes[name][0] * shapes[name][1],
                                   flush)
                    for name, fn in cases.items()}
            result['bodies'][tag] = row
        bwd.point(_build, home, lib)
    print(json.dumps(result), flush=True)
    return 0


def sweep(torch, cs, fd, build, lib, cases, shapes, flush):
    """Each case at clusters of 1, 2, 4 and 8 blocks (the wrapper's
    geometry overridden), with the clusters the card holds at once."""
    loaded = build.load(lib)
    loaded.flash_decode_max_clusters.argtypes = [ctypes.c_int] * 7
    loaded.flash_decode_max_clusters.restype = ctypes.c_int
    geometry = fd._launch_geometry
    sms = fd._sm_count(torch.cuda.current_device())
    out = {}
    try:
        for name, fn in cases.items():
            b, h_kv, t, paged = shapes[name]
            out[name] = {'geometry': geometry(b, h_kv, t, sms)[0],
                         'clusters': b * h_kv}
            for c in (1, 2, 4, 8):
                fd._launch_geometry = (
                    lambda *_a, c=c, b=b, h_kv=h_kv: (c, (c, b * h_kv)))
                out[name][f'cluster_{c}'] = {
                    'ms': cs.time_ms(torch, fn, flush),
                    'max_active_clusters':
                        loaded.flash_decode_max_clusters(
                            1, 1, cs.HEAD_DIM, cs.HEAD_DIM, int(paged), 0,
                            c)}
    finally:
        fd._launch_geometry = geometry
    return out


def sections(torch, cs, build, lib, fn, ms, blocks_launched, flush):
    """One case on the body with timers: its time with them, each
    section's share of the warps' cycles (and that share of ``ms``, the
    uninstrumented time), and the blocks' timeline."""
    loaded = build.load(lib)
    read = loaded.decode_sections
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    counts = (ctypes.c_ulonglong * 8)()
    timed = cs.time_ms(torch, fn, flush, reps=5)
    torch.cuda.synchronize()
    if read(None, 1):
        raise SystemExit('could not clear the section counters')
    fn()
    torch.cuda.synchronize()
    if read(ctypes.addressof(counts), 0):
        raise SystemExit('could not read the section counters')
    total = sum(counts) or 1
    stamps = (ctypes.c_ulonglong * (8 * 4096))()
    if loaded.decode_stamps(ctypes.addressof(stamps)):
        raise SystemExit('could not read the block stamps')
    blocks = [stamps[8 * i:8 * i + 8]
              for i in range(min(blocks_launched, 4096))]
    t0 = min(x[0] for x in blocks)
    parts = ('prologue', 'steps_and_epilogue', 'cluster_barrier',
             'stores_to_peers', 'wait_for_peers', 'merge_weights',
             'merge_and_output')
    timeline = {
        'blocks': len(blocks),
        'span_us': (max(x[7] for x in blocks) - t0) / 1e3,
        'start_spread_us': (max(x[0] for x in blocks) - t0) / 1e3,
        'median_us': {k: statistics.median((x[j + 1] - x[j]) / 1e3
                                           for x in blocks)
                      for j, k in enumerate(parts)},
        'max_us': {k: max((x[j + 1] - x[j]) / 1e3 for x in blocks)
                   for j, k in enumerate(parts)},
        # Each stamp's latest time over the blocks, from the earliest
        # start: when the last block got there.
        'last_at_us': {k: (max(x[j + 1] for x in blocks) - t0) / 1e3
                       for j, k in enumerate(parts)}}
    return {'ms_with_timers': timed, 'timeline': timeline,
            'sections': {n: {'share': counts[i] / total,
                             'ms': ms * counts[i] / total,
                             'warp_cycles': counts[i]}
                         for i, n in enumerate(SECTIONS)}}


if __name__ == '__main__':
    sys.exit(main())
