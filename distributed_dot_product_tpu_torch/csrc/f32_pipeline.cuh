// The producer / consumer pipeline of the float32 kernels, shared by
// csrc/flash_f32.cu (K1/K2) and csrc/flash_bwd_f32.cu (K3/K4): a block is
// one or two consumer warpgroups and a producer warpgroup that fills a
// ring of shared-memory stages, handed over by full / empty mbarriers
// whose waits trap after 4 s; the copies a producer makes, the consumers'
// resident rows by cp.async, the key tiles a block of query rows sees,
// and the launch and occupancy of a kernel. Each source that includes it
// gets its own copy (an anonymous namespace).

#pragma once

#include <stdint.h>

#include "hopper.cuh"      // kB, cp.async, mbar_init, kSmemLimit
#include "flash_ext.cuh"   // MaskArgs, ExtArgs, vec_row
#include "f32_tiles.cuh"   // kPf, kP8

namespace {

constexpr int kWgThreads = 128;   // a warpgroup
constexpr int kProducer = kWgThreads;   // the producer: one warpgroup

// Rows [row0, row0 + N) of a (rows, W) int8 matrix into `dst` (kP8<W>
// bytes a row) as they are, rows at or past `limit` as zeros.
template <int W, int N>
__device__ __forceinline__ void copy_rows8(signed char* dst,
                                           const signed char* src, int row0,
                                           int limit, int tid) {
  constexpr int kPieces = W / 16;
  for (int idx = tid; idx < N * kPieces; idx += kProducer) {
    const int r = idx / kPieces, c = idx % kPieces;
    *reinterpret_cast<int4*>(dst + r * kP8<W> + 16 * c) =
        row0 + r < limit
            ? __ldg(reinterpret_cast<const int4*>(
                  src + static_cast<size_t>(row0 + r) * W + 16 * c))
            : make_int4(0, 0, 0, 0);
  }
}

// N 32-bit values [i0, i0 + N) of a vector into `dst`, zeros at or past
// `limit`.
template <int N>
__device__ __forceinline__ void copy_vec(void* dst, const void* src, int i0,
                                         int limit, int tid) {
  for (int i = tid; i < N; i += kProducer)
    static_cast<uint32_t*>(dst)[i] =
        i0 + i < limit ? static_cast<const uint32_t*>(src)[i0 + i] : 0u;
}

// The resident rows [row0, row0 + 64) of a (rows, W) float32 (int8)
// matrix into `dst`, kPf<W> floats (kP8<W> bytes) a row, by cp.async from
// a consumer warpgroup's thread `tid`; rows at or past `limit` as zeros.
template <int W>
__device__ __forceinline__ void load_rows_wg(float* dst, const float* src,
                                             int row0, int limit, int tid) {
  constexpr int kPieces = W / 4;
  for (int idx = tid; idx < kB * kPieces; idx += kWgThreads) {
    const int r = idx / kPieces, c = idx % kPieces;
    const bool ok = row0 + r < limit;
    cp_async16(smem_u32(dst + r * kPf<W> + 4 * c),
               src + (ok ? static_cast<size_t>(row0 + r) * W + 4 * c : 0),
               ok);
  }
}

template <int W>
__device__ __forceinline__ void load_rows8_wg(signed char* dst,
                                              const signed char* src,
                                              int row0, int limit, int tid) {
  constexpr int kPieces = W / 16;
  for (int idx = tid; idx < kB * kPieces; idx += kWgThreads) {
    const int r = idx / kPieces, c = idx % kPieces;
    const bool ok = row0 + r < limit;
    cp_async16(smem_u32(dst + r * kP8<W> + 16 * c),
               src + (ok ? static_cast<size_t>(row0 + r) * W + 16 * c : 0),
               ok);
  }
}

// ---------------------------------------------------------------------------
// The pipeline: mbarriers and named barriers.

// Waits for phase `parity` of a stage's barrier. No stage takes seconds:
// a wait past 4 s of the global timer traps (a launch error) instead of
// holding the card.
__device__ __forceinline__ void stage_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  unsigned long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    unsigned long long now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (t0 == 0)
      t0 = now;
    else if (now - t0 > 4000000000ull)
      __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// One consumer warpgroup's 128 threads (barrier 1 + wg; 0 is the block's).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + wg), "n"(kWgThreads)
               : "memory");
}

// Does a plan of `wg` consumer warpgroups and `stages` stages of `n`
// streamed rows fit with its mbarriers? (Sm::res(wg): the resident rows
// of wg consumer warpgroups; Sm::stage(n): a stage of n streamed rows.)
template <typename Sm>
__host__ __device__ constexpr bool fits(int wg, int n, int stages) {
  return Sm::res(wg) + stages * (Sm::stage(n) + 16) <= kSmemLimit;
}

// The block's barriers: full[s] (the producer's 128 threads arrive when
// stage s is stored) and empty[s] (every consumer thread arrives when it is
// done with it).
template <int S>
__device__ __forceinline__ void init_bars(uint64_t* full, uint64_t* empty,
                                          int consumers) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, kProducer);
      mbar_init(empty + s, consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The thread's warpgroup as a value the compiler knows is the same across
// the warp (a shuffle from lane 0): it stays in a uniform register, and
// the role branch on it is warp-uniform (dividing threadIdx.x instead
// costs K3 and K4 registers and spills at (96, 96)).
__device__ __forceinline__ int warpgroup_of_thread() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / kWgThreads,
                     0);
}

// ---------------------------------------------------------------------------
// The key tiles a block sees.

// The key tiles of kN columns that query rows [row0, row0 + rows) see:
// [lo, hi) (their causal extent and window) and, with positions, the
// rows' [qmin, qmax] (from the per-64-row tables).
struct KeySpan {
  int lo, hi, qmin, qmax;
};

template <bool Ext>
__device__ __forceinline__ KeySpan key_span(int row0, int rows, int tq,
                                            int tk, int kn, int causal,
                                            long long rel,
                                            const ExtArgs& ext, int bh,
                                            bool pos) {
  KeySpan sp{0, 0, 0, 0};
  const int row_end = row0 + rows < tq ? row0 + rows : tq;
  int kv_end = tk;
  if (causal) {
    const long long extent = rel + row_end;
    kv_end = extent <= 0 ? 0 : (extent < tk ? static_cast<int>(extent) : tk);
  }
  sp.hi = (kv_end + kn - 1) / kn;
  if constexpr (Ext) {
    if (causal && ext.window > 0) {
      const long long first = rel + row0 - ext.window + 1;
      sp.lo = first <= 0 ? 0
            : (first >= kv_end ? sp.hi : static_cast<int>(first) / kn);
    }
    if (pos) {
      const int* mm = vec_row(ext.posq_mm, bh);
      sp.qmin = mm[2 * (row0 / kB)];
      sp.qmax = mm[2 * (row0 / kB) + 1];
      for (int m = row0 / kB + 1; m * kB < row_end; ++m) {
        sp.qmin = min(sp.qmin, mm[2 * m]);
        sp.qmax = max(sp.qmax, mm[2 * m + 1]);
      }
    }
  }
  return sp;
}

// Does a span see key tile t? Positions skip a tile wholly in the rows'
// future or a window or more in their past (the tables are per 64
// columns; a kN-column tile reads its 64-column tile's range).
template <bool Ext>
__device__ __forceinline__ bool span_sees(const KeySpan& sp, int t, int kn,
                                          const int* posk_mm,
                                          const ExtArgs& ext) {
  bool yes = t >= sp.lo && t < sp.hi;
  if constexpr (Ext) {
    const int mt = t * kn / kB;
    yes = yes && !(posk_mm != nullptr &&
                   (posk_mm[2 * mt] > sp.qmax ||
                    (ext.window > 0 &&
                     static_cast<long long>(sp.qmin) - posk_mm[2 * mt + 1] >=
                         ext.window)));
  }
  return yes;
}

// ---------------------------------------------------------------------------
// Launches.

// Sets the kernel's dynamic shared memory and launches it; returns a
// cudaError_t code (0 = launched).
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), dim3 grid, int threads, size_t smem,
           cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// A kernel's shared memory, threads a block and resident blocks an SM.
template <typename Kernel>
int occupancy(Kernel kernel, int threads, size_t smem, int* smem_out,
              int* threads_out, int* blocks_out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_out, kernel,
                                                        threads, smem);
  *smem_out = static_cast<int>(smem);
  *threads_out = threads;
  return static_cast<int>(err);
}

MaskArgs mask_args(const void* mask, int inner, long long so, long long si,
                   long long sr) {
  return MaskArgs{static_cast<const unsigned char*>(mask),
                  inner > 0 ? inner : 1, so, si, sr};
}

}  // namespace
