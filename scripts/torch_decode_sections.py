#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""
Where K5's and K5p's time goes inside the decode kernel, on one CUDA card:
clock64 section timers planted in a temporary copy of
``csrc/flash_decode.cu``.

    python3 scripts/torch_decode_sections.py

The script builds the source twice into a temporary directory through the
port's builder: as it is, timed with CUDA events (cold L2, as
``chip_smoke.time_ms``), and with timers at the kernel's section
boundaries. Every warp sums the clock64 cycles its lane 0 spends in each
section and adds them to a device counter; each section's share of the
summed cycles, times the uninstrumented kernel time, is its time. A
section that waits (a stage's loads, the block barrier after a pass, the
cluster barriers) shows as waiting in every warp that waits.

Sections: the prologue (the slot's vectors, the first loads issued, q
loaded, the appends, q's fragments), waiting for a stage, the S product,
the softmax (mask, ALiBi, running max, weights), the P V product, issuing
the next stage, a pass's epilogue (the warps' states combined), and the
cluster merge (the barrier that all blocks run, the stores into the
peers' shared memory, the wait for the peers' stores, the local merge). Each block also stamps the card's
global timer at its start, at the end of its prologue, after its steps
and pass epilogue, and at its end: the timeline gives the launch's span,
the spread of the blocks' starts and each part's median and longest wall
time.

Cases: K5 at the greedy decode shape (batch 4, 8 heads of 96, t_max 2048,
1033 columns attended) and K5p at the serving shape (chip_smoke's
``paged_case``: 8 slots, page 16, scrambled, mixed fill). Beside the
sections, with the same timing: each case at cluster sizes 1, 2, 4 and
8 (the wrapper's geometry overridden) with the clusters the card holds
at once (``flash_decode_max_clusters``), the greedy case with no
column attended and nothing appended (the kernel's fixed cost), and a
one-element PyTorch ``add_`` (a launch's floor). Run from the repository
root. Prints one JSON line: the card, and per case both times, the
sections and the sweep.
"""

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

# (anchor, replacement): every anchor must occur once.
MARKS = (
    ('  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, its '
     'row\n',
     '  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, its '
     'row\n  SEC_T0\n'),
    ('    int st = 0;\n    for (int step = first; step <= s_last; ',
     '    SEC_MARK(0)\n    SEC_STAMP(1)\n    int st = 0;\n'
     '    for (int step = first; step <= s_last; '),
    ('      // S = q K^T over the warp\'s 16 columns (two n-tiles).\n',
     '      SEC_MARK(1)\n'
     '      // S = q K^T over the warp\'s 16 columns (two n-tiles).\n'),
    ('      // ALiBi, the row\'s span and the held columns;',
     '      SEC_MARK(2)\n      // ALiBi, the row\'s span and the held '
     'columns;'),
    ('      // O = O * corr + P V', '      SEC_MARK(3)\n'
                                   '      // O = O * corr + P V'),
    ('      __syncwarp();\n      if (s_issue <= s_last) {\n'
     '        issue_warp',
     '      SEC_MARK(4)\n      __syncwarp();\n'
     '      if (s_issue <= s_last) {\n        issue_warp'),
    ('      cp_async_commit();\n      st ^= 1;\n',
     '      cp_async_commit();\n      SEC_MARK(5)\n      st ^= 1;\n'),
    ('    __syncthreads();\n  }\n\n  // The merge. Rank j merges',
     '    __syncthreads();\n    SEC_MARK(6)\n    SEC_STAMP(2)\n  }\n\n'
     '  // The merge. Rank j merges'),
    ('          __float2bfloat16(w_l[rl] == 0.f ? 0.f : acc / w_l[rl]);\n'
     '    }\n  }\n}\n',
     '          __float2bfloat16(w_l[rl] == 0.f ? 0.f : acc / w_l[rl]);\n'
     '    }\n  }\n  SEC_MARK(7)\n  SEC_STAMP(7)\n  SEC_FLUSH\n}\n'),
    ('  cluster_wait();\n  __syncthreads();\n  if ((active >> rank) & 1) {\n',
     '  cluster_wait();\n  __syncthreads();\n  SEC_STAMP(3)\n'
     '  if ((active >> rank) & 1) {\n'),
    ('  if (tid == 0)\n    mbar_expect_tx(',
     '  SEC_STAMP(4)\n  if (tid == 0)\n    mbar_expect_tx('),
    ('  mbar_wait(bar, 0);\n', '  mbar_wait(bar, 0);\n  SEC_STAMP(5)\n'),
    ('  __syncthreads();\n  for (int e = e0 + tid; e < e1; e += kThreads) {\n',
     '  __syncthreads();\n  SEC_STAMP(6)\n'
     '  for (int e = e0 + tid; e < e1; e += kThreads) {\n'),
)


def plant(text):
    """The source with the timers planted; raises when an anchor is not
    there once."""
    for old, new in MARKS:
        if text.count(old) != 1:
            raise SystemExit(f'flash_decode.cu: anchor not there once: '
                             f'{old!r}')
        text = text.replace(old, new)
    at = text.rfind('#include')
    at = text.index('\n', at) + 1
    return text[:at] + TIMERS + text[at:]


def use_source(build, text, tmp, tag):
    """Points the port's builder at a copy of csrc/ whose flash_decode.cu
    is ``text``; the next decode call builds and loads it."""
    src = os.path.join(tmp, tag, 'csrc')
    shutil.copytree(CSRC, src)
    with open(os.path.join(src, 'flash_decode.cu'), 'w') as f:
        f.write(text)
    build._CSRC = type(build._CSRC)(src)
    build._BUILD_DIR = type(build._BUILD_DIR)(os.path.join(tmp, tag,
                                                           'build'))
    build._LIBS.pop('flash_decode', None)


def main():
    import torch
    if not torch.cuda.is_available():
        print('torch_decode_sections: no CUDA card', file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from distributed_dot_product_tpu_torch.ops import _build
    fd = importlib.import_module(
        'distributed_dot_product_tpu_torch.ops.flash_decode')

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    gen = torch.Generator().manual_seed(0)
    dev, bf16 = torch.device('cuda'), torch.bfloat16
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)
    scale = 1.0 / math.sqrt(cs.HEAD_DIM)
    fill = cs.PROMPT + cs.STEPS // 2
    shape = (cs.BATCH, cs.HEADS, 1, cs.HEAD_DIM)
    q, kn, vn = (cs.randn(torch, shape, gen, dev, bf16) for _ in range(3))
    ck, cv = (cs.randn(torch, (cs.BATCH, cs.HEADS, cs.T_MAX, cs.HEAD_DIM),
                       gen, dev, bf16) for _ in range(2))
    vt = torch.full((cs.BATCH,), fill, dtype=torch.int32, device=dev)
    pq, pkn, pvn, kp, vp, pvt, pap, table, _ = cs.paged_case(torch, gen,
                                                             dev)
    cases = {
        'k5_greedy': lambda: fd.flash_decode(q, kn, vn, ck, cv, vt, vt,
                                             scale=scale),
        'k5p_serving': lambda: fd.flash_decode(pq, pkn, pvn, kp, vp, pvt,
                                               pap, page_table=table,
                                               scale=scale)}
    none = torch.full((cs.BATCH,), -1, dtype=torch.int32, device=dev)
    one = torch.zeros(1, device=dev)
    shapes = {'k5_greedy': (cs.BATCH, cs.HEADS, cs.T_MAX, False),
              'k5p_serving': (cs.SERVE_SLOTS, cs.HEADS, cs.SERVE_T_MAX,
                              True)}
    with open(os.path.join(CSRC, 'flash_decode.cu')) as f:
        text = f.read()
    out = {}
    floors = {}
    with tempfile.TemporaryDirectory() as tmp:
        use_source(_build, text, tmp, 'plain')
        times = {n: cs.time_ms(torch, fn, flush) for n, fn in cases.items()}
        floors['add_one_element_ms'] = cs.time_ms(torch, lambda: one.add_(1),
                                                  flush)
        floors['k5_greedy_nothing_attended_ms'] = cs.time_ms(
            torch, lambda: fd.flash_decode(q, kn, vn, ck, cv, none, none,
                                           scale=scale), flush)
        lib = fd._kernel_lib(False)[0]
        lib.flash_decode_max_clusters.argtypes = [ctypes.c_int] * 7
        lib.flash_decode_max_clusters.restype = ctypes.c_int
        geometry = fd._launch_geometry
        sms = fd._sm_count(dev.index)
        sweep = {}
        for name, fn in cases.items():
            b, h_kv, t, paged = shapes[name]
            sweep[name] = {'geometry': geometry(b, h_kv, t, sms)[0],
                           'clusters': b * h_kv}
            for c in (1, 2, 4, 8):
                fd._launch_geometry = (
                    lambda *_a, c=c, b=b, h_kv=h_kv: (c, (c, b * h_kv)))
                sweep[name][f'cluster_{c}'] = {
                    'ms': cs.time_ms(torch, fn, flush),
                    'max_active_clusters': lib.flash_decode_max_clusters(
                        1, 1, cs.HEAD_DIM, cs.HEAD_DIM, int(paged), 0, c)}
            fd._launch_geometry = geometry
        use_source(_build, plant(text), tmp, 'timed')
        read = _build.load('flash_decode').decode_sections
        read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        counts = (ctypes.c_ulonglong * 8)()
        for name, fn in cases.items():
            timed = cs.time_ms(torch, fn, flush, reps=5)
            torch.cuda.synchronize()
            if read(None, 1):
                raise SystemExit('could not clear the section counters')
            fn()
            torch.cuda.synchronize()
            if read(ctypes.addressof(counts), 0):
                raise SystemExit('could not read the section counters')
            total = sum(counts)
            ms = times[name]
            stamps = (ctypes.c_ulonglong * (8 * 4096))()
            if _build.load('flash_decode').decode_stamps(
                    ctypes.addressof(stamps)):
                raise SystemExit('could not read the block stamps')
            b, h_kv, t, _ = shapes[name]
            c0 = geometry(b, h_kv, t, sms)[0]
            blocks = [stamps[8 * i:8 * i + 8] for i in range(c0 * b * h_kv)]
            t0 = min(x[0] for x in blocks)
            parts = ('prologue', 'steps_and_epilogue', 'cluster_barrier',
                     'stores_to_peers', 'wait_for_peers', 'merge_weights',
                     'merge_and_output')
            timeline = {
                'blocks': len(blocks),
                'span_us': (max(x[7] for x in blocks) - t0) / 1e3,
                'start_spread_us': (max(x[0] for x in blocks) - t0) / 1e3,
                'median_us': {
                    k: statistics.median((x[j + 1] - x[j]) / 1e3
                                         for x in blocks)
                    for j, k in enumerate(parts)},
                'max_us': {
                    k: max((x[j + 1] - x[j]) / 1e3 for x in blocks)
                    for j, k in enumerate(parts)},
                # Each stamp's latest time over the blocks, from the
                # earliest start: when the last block got there.
                'last_at_us': {
                    k: (max(x[j + 1] for x in blocks) - t0) / 1e3
                    for j, k in enumerate(parts)}}
            out[name] = {'ms': ms, 'ms_with_timers': timed,
                         'timeline': timeline,
                         'sections': {
                             n: {'share': counts[i] / total,
                                 'ms': ms * counts[i] / total,
                                 'warp_cycles': counts[i]}
                             for i, n in enumerate(SECTIONS)}}
    for name in out:
        out[name]['cluster_sweep'] = sweep[name]
    print(json.dumps({'script': 'scripts/torch_decode_sections.py',
                      'card': smi, 'cases': out, 'floors': floors}),
          flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
