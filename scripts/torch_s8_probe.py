#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""
Probe of the s8 ``wgmma`` operand layout on one CUDA card: which no-swizzle
descriptor pair reads an int8 tile K-major.

    python3 scripts/torch_s8_probe.py      # from the repository root

The int8 K1/K4 kernels (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``) keep
an int8 64 x d tile in the bf16 tiles' byte geometry (d/16 panels of 64
rows x 16 bytes, filled by TMA through an int8 tensor map) and read it
with ``desc_kmajor`` of ``csrc/hopper.cuh`` (leading byte offset one
panel, 1024 bytes; stride byte offset one 8-row group, 128 bytes), one
k32 step spanning two panels. This script builds a one-block kernel on
``csrc/hopper.cuh`` that loads two random int8 tiles A, B (64 x d) that
way and computes A·Bᵀ with ``wgmma m64n64k32 s32.s8.s8``, once with the
kernels' descriptors and once with the two offsets swapped, and compares
each with the exact integer product; d = 32, 64, 96, 128. Prints one
JSON line (the card, and per d and pair whether the product is exact);
exits non-zero unless the kernels' pair is exact at every d.
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, 'distributed_dot_product_tpu_torch', 'csrc')

PROBE = r'''
#include "hopper.cuh"

// A (64 x D int8) . B^T (64 x D int8) -> out (64 x 64 int32), both tiles
// by TMA; lbo < 0: the kernels' desc_kmajor, else make_desc(lbo, sbo).
template <int D>
__global__ void probe(const __grid_constant__ CUtensorMap ma,
                      const __grid_constant__ CUtensorMap mb, int* out,
                      int lbo, int sbo) {
  __shared__ __align__(1024) signed char sA[kB * D];
  __shared__ __align__(1024) signed char sB[kB * D];
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&bar, 2 * kB * D);
    tma_tile<D>(sA, &ma, 0, 0, &bar);
    tma_tile<D>(sB, &mb, 0, 0, &bar);
  }
  mbar_wait(&bar, 0);
  const uint32_t a = smem_u32(sA), b = smem_u32(sB);
  int d[32];
  for (int i = 0; i < 32; ++i) d[i] = 0;
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk) {
    const uint32_t step = 2 * kk * kPanelBytes;
    const uint64_t da = lbo < 0 ? desc_kmajor(a, kk)
                                : make_desc(a + step, lbo, sbo);
    const uint64_t db = lbo < 0 ? desc_kmajor(b, kk)
                                : make_desc(b + step, lbo, sbo);
    Wgmma<64>::ss(d, da, db, kk);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  for (int i = 0; i < 32; ++i) out[acc_row(i) * kB + acc_col(i)] = d[i];
}

extern "C" int probe_s8(const void* a, const void* b, void* out, int d,
                        int lbo, int sbo) {
  CUtensorMap ma, mb;
  if (!tile_map(&ma, a, 1, kB, d, true) || !tile_map(&mb, b, 1, kB, d, true))
    return -1;
  int* o = static_cast<int*>(out);
  switch (d) {
    case 32: probe<32><<<1, kThreads>>>(ma, mb, o, lbo, sbo); break;
    case 64: probe<64><<<1, kThreads>>>(ma, mb, o, lbo, sbo); break;
    case 96: probe<96><<<1, kThreads>>>(ma, mb, o, lbo, sbo); break;
    case 128: probe<128><<<1, kThreads>>>(ma, mb, o, lbo, sbo); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
'''

# (name, lbo, sbo): the kernels' descriptors first (a wrong pair may fault
# and end the process's CUDA context), then the swapped offsets.
PAIRS = (('desc_kmajor', -1, -1), ('swapped', 128, 1024))


def main():
    import torch
    if not torch.cuda.is_available():
        print('torch_s8_probe: no CUDA card', file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from distributed_dot_product_tpu_torch.ops import _build
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    gen = torch.Generator().manual_seed(0)
    result, ok = {}, True
    with tempfile.TemporaryDirectory() as tmp:
        src, lib = os.path.join(tmp, 'probe.cu'), os.path.join(tmp, 'p.so')
        with open(src, 'w') as f:
            f.write(PROBE)
        subprocess.run([_build._nvcc(), '-gencode',
                        'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
                        '-shared', '-Xcompiler', '-fPIC', '-I', CSRC, '-o',
                        lib, src], check=True)
        fn = ctypes.CDLL(lib).probe_s8
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
        for name, lbo, sbo in PAIRS:
            for d in (32, 64, 96, 128):
                a, b = (torch.randint(-128, 128, (64, d), generator=gen,
                                      dtype=torch.int8) for _ in range(2))
                want = a.long() @ b.long().T
                try:
                    a, b = a.cuda(), b.cuda()
                    out = torch.zeros((64, 64), dtype=torch.int32,
                                      device='cuda')
                    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), d,
                             lbo, sbo)
                    torch.cuda.synchronize()
                    exact = err == 0 and torch.equal(out.cpu().long(), want)
                except RuntimeError as exc:   # a fault ends the context
                    err, exact = str(exc).splitlines()[0], False
                result[f'{name}/d{d}'] = {'launch_error': err,
                                          'exact': exact}
                ok = ok and (exact or name != 'desc_kmajor')
    print(json.dumps({'script': 'scripts/torch_s8_probe.py', 'card': smi,
                      'kernels_pair_exact': ok, 'cases': result}),
          flush=True)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
