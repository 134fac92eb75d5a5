#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""
Where K1's time goes inside the kernel, on one CUDA card: clock64 section
timers planted in a temporary copy of ``csrc/flash_fwd.cu``.

    python3 scripts/torch_k1_sections.py [--source PATH] [--alibi]

``--source`` names another ``flash_fwd.cu`` (an older checkout's) whose
body to time; by default the package's own. The script builds that source
twice into a temporary directory through the port's builder: as it is,
timed with CUDA events (cold L2, as ``chip_smoke.time_ms``), and with
timers planted at the body's section boundaries (a body whose anchors
no recipe below knows is timed without sections). Every warp sums the
clock64 cycles its lane 0 spends in each section and adds them to a
device counter; each section's share of the summed cycles, times the
uninstrumented kernel time, is its time. The timers run in every warp, so
a section that waits on another warp (a barrier, a tile load) shows as
waiting in all of them.

The case is K1 with its row logsumexp at the LM's training shape (4 x 8
heads, 4096 rows, head dim 96, causal), bf16 from a seed; with
``--alibi``, the ALiBi LM's (the slopes 2^(-8i/8): the Ext
instantiation). Run from the repository root. Prints one JSON line: the
card, both times and the sections.
"""

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, 'distributed_dot_product_tpu_torch', 'csrc')

# Planted after the source's last #include: a device counter per section,
# the timer macros and a host function that reads (and clears) them.
TIMERS = r'''
__device__ unsigned long long g_sections[8];
#define SEC_T0 long long sec_t_ = clock64(); \
  long long sec_acc_[5] = {0, 0, 0, 0, 0};
#define SEC_MARK(n) { const long long n_ = clock64(); \
  sec_acc_[n] += n_ - sec_t_; sec_t_ = n_; }
#define SEC_FLUSH if (threadIdx.x % 32 == 0) { \
  for (int i_ = 0; i_ < 5; ++i_) \
    atomicAdd(&g_sections[i_], \
              static_cast<unsigned long long>(sec_acc_[i_])); }
extern "C" int fwd_sections(unsigned long long* host, int reset) {
  if (reset) {
    unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    return static_cast<int>(cudaMemcpyToSymbol(g_sections, zero,
                                               sizeof(zero)));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_sections,
                                               8 * sizeof(*host)));
}
'''

# Per kernel body: a text that identifies it, its section names (index 4
# is the prologue and epilogue) and the (anchor, replacement) pairs that
# plant the timers; every anchor must occur once.
RECIPES = {
    # The first version (wmma 16x16x16, S, P and O through shared memory,
    # synchronous K/V loads, one warpgroup a block).
    'wmma': (
        'wmma::store_matrix_sync(sS + warp * 16 * kBK',
        ('kv_load_wait', 's_product_and_store', 'softmax_and_rescale_sO',
         'pv_product_sO_round_trip', 'prologue_epilogue'),
        (('  const int lane = threadIdx.x % 32;\n\n  const bf16* qb',
          '  const int lane = threadIdx.x % 32;\n  SEC_T0\n\n'
          '  const bf16* qb'),
         ('  for (int t = t_begin; t < n_ktiles; ++t) {\n',
          '  SEC_MARK(4)\n  for (int t = t_begin; t < n_ktiles; ++t) {\n'),
         ("    // S = Q K^T for this warp's 16 rows",
          "    SEC_MARK(0)\n    // S = Q K^T for this warp's 16 rows"),
         ("    // Online softmax over this tile's 64 columns of my_row.\n",
          "    SEC_MARK(1)\n"
          "    // Online softmax over this tile's 64 columns of my_row.\n"),
         ("    // O += P V for this warp's 16 rows.\n",
          "    SEC_MARK(2)\n    // O += P V for this warp's 16 rows.\n"),
         ('    __syncwarp();\n  }\n\n  // l == 0',
          '    __syncwarp();\n    SEC_MARK(3)\n  }\n\n  // l == 0'),
         ('          kLn2 * (m_run + log2f(l_run == 0.f ? 1.f : l_run));\n'
          '  }\n}\n',
          '          kLn2 * (m_run + log2f(l_run == 0.f ? 1.f : l_run));\n'
          '  }\n  SEC_MARK(4)\n  SEC_FLUSH\n}\n'))),
    # The wgmma body (two warpgroups a block, TMA stages, S, P and O in
    # registers); the barriers of a tile (its landing and the release of
    # its stage) count as waiting.
    'wgmma': (
        'Wgmma<64>::ss(s, desc_kmajor(tQ, kk)',
        ('barriers_and_kv_wait', 's_wgmma', 'softmax_in_registers',
         'pv_wgmma', 'prologue_epilogue'),
        (('  extern __shared__ __align__(1024) unsigned char smem[];\n',
          '  extern __shared__ __align__(1024) unsigned char smem[];\n'
          '  SEC_T0\n'),
         ('  const uint32_t tQ = smem_u32(sQ + wg * kB * D);\n',
          '  SEC_MARK(4)\n  const uint32_t tQ = smem_u32(sQ + wg * kB * D);\n'),
         ('    __syncthreads();   // stage `stage` landed for every thread\n',
          '    __syncthreads();   // stage `stage` landed for every thread\n'
          '    SEC_MARK(0)\n'),
         ('      wgmma_wait<0>();\n      fence_regs(s);\n',
          '      wgmma_wait<0>();\n      fence_regs(s);\n      SEC_MARK(1)\n'),
         ('      // O += P V, P from registers, V read MN-major.\n',
          '      SEC_MARK(2)\n'
          '      // O += P V, P from registers, V read MN-major.\n'),
         ('      fence_regs(o);\n', '      fence_regs(o);\n      SEC_MARK(3)\n'),
         ('  cp_async_wait<0>();\n\n  // l over the quad',
          '  cp_async_wait<0>();\n  SEC_MARK(0)\n\n  // l over the quad'),
         ('            kLn2 * (m_run[h] + log2f(l[h] == 0.f ? 1.f : l[h]));\n'
          '  }\n}\n',
          '            kLn2 * (m_run[h] + log2f(l[h] == 0.f ? 1.f : l[h]));\n'
          '  }\n  SEC_MARK(4)\n  SEC_FLUSH\n}\n'))),
}

B, H, T, D = 4, 8, 4096, 96


def plant(text):
    """``(recipe name, planted text)``, or ``(None, None)`` when no recipe
    knows the body or one of its anchors is not there once."""
    recipe = next((name for name, (mark, _, _) in RECIPES.items()
                   if mark in text), None)
    if recipe is None:
        return None, None
    for old, new in RECIPES[recipe][2]:
        if text.count(old) != 1:
            return None, None
        text = text.replace(old, new)
    at = text.rfind('#include')
    at = text.index('\n', at) + 1
    return recipe, text[:at] + TIMERS + text[at:]


def use_source(build, text, tmp, tag):
    """Points the port's builder at a copy of csrc/ whose flash_fwd.cu is
    ``text``; the next K1 call builds and loads it."""
    src = os.path.join(tmp, tag, 'csrc')
    shutil.copytree(CSRC, src)
    with open(os.path.join(src, 'flash_fwd.cu'), 'w') as f:
        f.write(text)
    build._CSRC = type(build._CSRC)(src)
    build._BUILD_DIR = type(build._BUILD_DIR)(os.path.join(tmp, tag,
                                                           'build'))
    build._LIBS.pop('flash_fwd', None)
    build._LIBS.pop('flash_fwd_ext', None)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--source', default=os.path.join(CSRC, 'flash_fwd.cu'))
    ap.add_argument('--alibi', action='store_true',
                    help="the ALiBi LM's K1 (the Ext instantiation)")
    args = ap.parse_args()
    import ctypes
    import importlib

    import torch
    if not torch.cuda.is_available():
        print('torch_k1_sections: no CUDA card', file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from distributed_dot_product_tpu_torch.ops import _build
    fa = importlib.import_module(
        'distributed_dot_product_tpu_torch.ops.flash_attention')

    with open(args.source) as f:
        text = f.read()
    recipe, planted = plant(text)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    gen = torch.Generator().manual_seed(0)
    dev, bf16 = torch.device('cuda'), torch.bfloat16
    q, k, v = (chip_smoke.randn(torch, (B, H, T, D), gen, dev, bf16)
               for _ in range(3))
    scale = 1.0 / math.sqrt(D)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)

    feat = {'alibi_slopes': chip_smoke.ALIBI_SLOPES} if args.alibi else {}

    def k1():
        return fa.flash_attention_with_lse(q, k, v, causal=True, scale=scale,
                                           **feat)

    with tempfile.TemporaryDirectory() as tmp:
        use_source(_build, text, tmp, 'plain')
        ms = chip_smoke.time_ms(torch, k1, flush)
        ms_timed, sections = None, None
        if planted is not None:
            use_source(_build, planted, tmp, 'timed')
            ms_timed = chip_smoke.time_ms(torch, k1, flush, reps=5)
            lib = 'flash_fwd_ext' if args.alibi else 'flash_fwd'
            read = _build.load(lib).fwd_sections
            read.argtypes = [ctypes.c_void_p, ctypes.c_int]
            counts = (ctypes.c_ulonglong * 8)()
            torch.cuda.synchronize()
            if read(None, 1):
                raise SystemExit('could not clear the section counters')
            k1()
            torch.cuda.synchronize()
            if read(ctypes.addressof(counts), 0):
                raise SystemExit('could not read the section counters')
            names = RECIPES[recipe][1]
            total = sum(counts[i] for i in range(len(names)))
            sections = {n: {'share': counts[i] / total,
                            'ms': ms * counts[i] / total,
                            'warp_cycles': counts[i]}
                        for i, n in enumerate(names)}
    print(json.dumps({'script': 'scripts/torch_k1_sections.py',
                      'source': os.path.relpath(args.source, ROOT),
                      'body': recipe, 'card': smi,
                      'case': {'q': [B, H, T, D], 'causal': True,
                               'lse': True, 'alibi': args.alibi},
                      'ms': ms, 'ms_with_timers': ms_timed,
                      'sections': sections}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
