// Flash-attention backward for Hopper (sm_90a), bf16 in, f32 accumulation:
// the dq kernel and the dk/dv kernel.
//
// Replace the TPU kernels `_make_dq_kernel` (dq) and `_make_dkv_kernel`
// (dk, dv) in distributed_dot_product_tpu/ops/pallas_attention.py, driven
// there by `_flash_bwd_impl`: causal masking with host-int global offsets of
// query row 0 and key column 0, a dense boolean mask (addressed through
// strides as in csrc/flash_fwd.cu), GQA, and gradients written in bf16 or,
// for the ring path that sums W fold partials, in float32 (`grad_dtype`);
// no segments, positions, window, ALiBi, dropout or int8 scoring. The
// gradient of K2, the bounded forward, is these kernels from its lse.
//
// Both recompute the softmax weights from the forward's row logsumexp
// instead of storing them: with q2 = q*scale*log2(e) (rounded to bf16),
// lse2 = max(lse*log2(e), NEG_BIG) and delta = rowsum(dO*O), all three made
// by the wrapper as the TPU path makes them outside its kernels,
//   p  = exp2(q2.k^T - lse2)        (masked, causal future, ragged edge: 0)
//   ds = p * (dO.v^T - delta)       (rounded to bf16 for the products)
//   dq = scale * ds.k,  dk = ds^T.q2 / log2(e),  dv = p^T.dO (p in bf16).
//
// What bounds them on the H100: at the training shape (4 x 8 heads,
// T = 4096, head dim 96, causal: 268 M attended pairs) dq does 6*d flops a
// pair (155 GFLOP, 0.16 ms at 989 TFLOP/s) and dk/dv 8*d (206 GFLOP,
// 0.21 ms) against ~126 MB of operands (0.04 ms at 3.35 TB/s): both are
// bound by tensor-core operations. The design keeps every score block out
// of device memory and never loads a tile in the causal future:
//  - dq: one block owns a 64-row query tile of one (batch, head) row and
//    loops over 64-column key tiles up to the tile's causal extent, the
//    TPU's sequential K grid axis turned into an in-block loop; the dq
//    accumulator stays in registers (wmma fragments) across the loop.
//  - dk/dv: one block owns a 64-row key tile of one kv head and loops over
//    the query heads of its GQA group and, for each, over the query tiles
//    from the first one whose last row can see the tile to the last; the
//    dk and dv accumulators stay in registers, so the group's sum happens
//    in float32 inside the block (the TPU path wrote per-query-head
//    partials and summed them afterwards).
// Products run on the tensor cores through nvcuda::wmma 16x16x16 bf16
// fragments; each warp owns 16 rows of every score block, so the
// elementwise passes need only warp-level synchronisation. This is the
// simple first version (no cp.async/TMA pipelining, no wgmma), well below
// the bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

constexpr int kB = 64;             // rows of a query tile and of a key tile
constexpr int kWarps = 4;          // 4 warps x 16 rows
constexpr int kThreads = kWarps * 32;
constexpr float kInvLog2e = 0.693147180559945309f;   // 1 / log2(e)

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                             wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                                wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                                wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// A dense boolean mask: byte (b, h, row, col) at
// ptr + (bh / inner) * so + (bh % inner) * si + row * sr + col.
struct MaskArgs {
  const unsigned char* ptr;
  int inner;
  long long so, si, sr;
};

__device__ __forceinline__ const unsigned char* mask_base(const MaskArgs& m,
                                                          int bh) {
  return m.ptr + (bh / m.inner) * m.so + (bh % m.inner) * m.si;
}

__device__ __forceinline__ void store_pair(bf16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store_pair(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

// Rows [row0, row0 + 64) of a (rows, D) bf16 matrix into shared memory,
// 16 bytes a thread; rows at or past `limit` load as zeros.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int row0, int limit) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < kB * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit)
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(row0 + r) * D + c * 8);
    *reinterpret_cast<uint4*>(dst + r * D + c * 8) = val;
  }
}

// One warp: c (16 x 64 f32, ld 64) = a (16 x D, ld D) . b^T, b 64 x D.
template <int D>
__device__ __forceinline__ void warp_abt(const bf16* a, const bf16* b,
                                         float* c) {
#pragma unroll
  for (int j = 0; j < kB / 16; ++j) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragA fa;
      FragBCol fb;
      wmma::load_matrix_sync(fa, a + kk * 16, D);
      wmma::load_matrix_sync(fb, b + j * 16 * D + kk * 16, D);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(c + j * 16, acc, kB, wmma::mem_row_major);
  }
}

// One warp: acc[j] (16 x 16 columns j of a 16 x D block) += a . b with
// a 16 x 64 (bf16, ld 64) and b 64 x D (bf16, ld D).
template <int D>
__device__ __forceinline__ void warp_ab_acc(FragC (&acc)[D / 16],
                                            const bf16* a, const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < kB / 16; ++kk) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk * 16, kB);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      FragBRow fb;
      wmma::load_matrix_sync(fb, b + kk * 16 * D + j * 16, D);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
}

// Writes one warp's 16 x D accumulator as OutT rows times `mul`: staged
// through the warp's own 16 x D float region of shared memory; lanes
// (2r, 2r+1) write half a row each, rows at or past `limit` are skipped.
template <int D, typename OutT>
__device__ __forceinline__ void store_rows(FragC (&acc)[D / 16], float* stage,
                                           OutT* dst, int row0, int limit,
                                           float mul) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* ws = stage + warp * 16 * D;
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wmma::store_matrix_sync(ws + j * 16, acc[j], D, wmma::mem_row_major);
  __syncwarp();
  const int r = lane >> 1, half = lane & 1;
  const int row = row0 + warp * 16 + r;
  if (row < limit) {
    const float* src = ws + r * D + half * (D / 2);
    OutT* out = dst + static_cast<size_t>(row) * D + half * (D / 2);
#pragma unroll
    for (int c = 0; c < D / 2; c += 2)
      store_pair(out + c, src[c] * mul, src[c + 1] * mul);
  }
  __syncwarp();
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(bf16) * (4 * kB * D     // sQ, sG, sK, sV
                         + kB * kB)     // sDS
         + sizeof(float) * 2 * kB * kB; // sS, sDP (the epilogue's stage)
}

template <int D, bool HasMask, typename OutT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q2, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ g,
                    const float* __restrict__ lse2,
                    const float* __restrict__ delta, OutT* __restrict__ dq,
                    MaskArgs mask, int tq, int tk, int group, int causal,
                    int causal_offset, int kv_offset, float scale,
                    int n_qtiles) {
  static_assert(D % 16 == 0 && D <= 128, "head dim must be 16*n <= 128");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sG = sQ + kB * D;
  bf16* sK = sG + kB * D;
  bf16* sV = sK + kB * D;
  bf16* sDS = sV + kB * D;
  float* sS = reinterpret_cast<float*>(sDS + kB * kB);
  float* sDP = sS + kB * kB;

  // Late query tiles see the most keys under causal masking: first.
  const int tile = n_qtiles - 1 - static_cast<int>(blockIdx.x);
  const int bh = blockIdx.y;
  const int bkv = bh / group;
  const int q0 = tile * kB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const size_t qoff = static_cast<size_t>(bh) * tq;
  const bf16* kb = k + static_cast<size_t>(bkv) * tk * D;
  const bf16* vb = v + static_cast<size_t>(bkv) * tk * D;

  // Row i may attend local key column j when rel + i >= j.
  const long long rel = static_cast<long long>(causal_offset) - kv_offset;
  int kv_end = tk;
  if (causal) {
    const int rows = (q0 + kB < tq ? q0 + kB : tq);
    const long long extent = rel + rows;
    kv_end = extent <= 0 ? 0 : (extent < tk ? static_cast<int>(extent) : tk);
  }
  const int n_ktiles = (kv_end + kB - 1) / kB;

  load_tile<D>(sQ, q2 + qoff * D, q0, tq);
  load_tile<D>(sG, g + qoff * D, q0, tq);

  // Elementwise ownership: lanes (2r, 2r+1) of warp w hold query row
  // w*16 + r, 32 key columns each.
  const int my_row = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const bool row_ok = q0 + my_row < tq;
  const long long row_pos = rel + q0 + my_row;
  const unsigned char* mrow =
      (HasMask && row_ok)
          ? mask_base(mask, bh) + static_cast<long long>(q0 + my_row) * mask.sr
          : nullptr;
  const float lse_r = row_ok ? lse2[qoff + q0 + my_row] : 0.f;
  const float delta_r = row_ok ? delta[qoff + q0 + my_row] : 0.f;

  FragC acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int t = 0; t < n_ktiles; ++t) {
    const int k0 = t * kB;
    __syncthreads();   // all warps done with the previous sK/sV
    load_tile<D>(sK, kb, k0, tk);
    load_tile<D>(sV, vb, k0, tk);
    __syncthreads();

    warp_abt<D>(sQ + warp * 16 * D, sK, sS + warp * 16 * kB);
    warp_abt<D>(sG + warp * 16 * D, sV, sDP + warp * 16 * kB);
    __syncwarp();

    const float* srow = sS + my_row * kB + half * 32;
    const float* dprow = sDP + my_row * kB + half * 32;
    bf16* dsrow = sDS + my_row * kB + half * 32;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = k0 + half * 32 + c;
      bool valid = row_ok && col < tk && (!causal || col <= row_pos);
      if constexpr (HasMask) valid = valid && !mrow[col];
      const float p = valid ? exp2f(srow[c] - lse_r) : 0.f;
      dsrow[c] = __float2bfloat16(p * (dprow[c] - delta_r));
    }
    __syncwarp();

    warp_ab_acc<D>(acc, sDS + warp * 16 * kB, sK);
  }

  __syncthreads();   // the stage overlays other warps' score rows
  store_rows<D, OutT>(acc, sS, dq + qoff * D, q0, tq, scale);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(bf16) * (4 * kB * D     // sK, sV, sQ, sG
                         + 2 * kB * kB) // sPT, sDST
         + sizeof(float) * (2 * kB * kB // sST, sDPT (the epilogue's stage)
                            + 2 * kB);  // sLse, sDelta
}

template <int D, bool HasMask, typename OutT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q2, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ g,
                     const float* __restrict__ lse2,
                     const float* __restrict__ delta, OutT* __restrict__ dk,
                     OutT* __restrict__ dv, MaskArgs mask, int tq, int tk,
                     int group, int causal, int causal_offset, int kv_offset,
                     int n_qtiles) {
  static_assert(D % 16 == 0 && D <= 128, "head dim must be 16*n <= 128");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kB * D;
  bf16* sQ = sV + kB * D;
  bf16* sG = sQ + kB * D;
  bf16* sPT = sG + kB * D;
  bf16* sDST = sPT + kB * kB;
  float* sST = reinterpret_cast<float*>(sDST + kB * kB);
  float* sDPT = sST + kB * kB;
  float* sLse = sDPT + kB * kB;
  float* sDelta = sLse + kB;

  // Early key tiles are seen by the most query rows under causal masking.
  const int k0 = static_cast<int>(blockIdx.x) * kB;
  const int bkv = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const size_t kvoff = static_cast<size_t>(bkv) * tk * D;
  load_tile<D>(sK, k + kvoff, k0, tk);
  load_tile<D>(sV, v + kvoff, k0, tk);

  // First query tile whose rows can see key column k0: row r sees it when
  // rel + r >= k0.
  const long long rel = static_cast<long long>(causal_offset) - kv_offset;
  int qt_begin = 0;
  if (causal) {
    const long long r_min = static_cast<long long>(k0) - rel;
    qt_begin = r_min <= 0 ? 0
             : (r_min >= tq ? n_qtiles : static_cast<int>(r_min / kB));
  }

  // Elementwise ownership: lanes (2r, 2r+1) of warp w hold key row
  // w*16 + r, 32 query columns each.
  const int my_row = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const bool krow_ok = k0 + my_row < tk;
  const long long kpos = static_cast<long long>(k0) + my_row;

  FragC acc_dk[D / 16], acc_dv[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::fill_fragment(acc_dk[j], 0.f);
    wmma::fill_fragment(acc_dv[j], 0.f);
  }

  for (int h = 0; h < group; ++h) {
    const size_t qoff = static_cast<size_t>(bkv) * group * tq +
                        static_cast<size_t>(h) * tq;
    const unsigned char* mbase =
        HasMask ? mask_base(mask, bkv * group + h) : nullptr;
    for (int qt = qt_begin; qt < n_qtiles; ++qt) {
      const int q0 = qt * kB;
      __syncthreads();   // all warps done with the previous query tile
      load_tile<D>(sQ, q2 + qoff * D, q0, tq);
      load_tile<D>(sG, g + qoff * D, q0, tq);
      for (int i = threadIdx.x; i < kB; i += kThreads) {
        const bool ok = q0 + i < tq;
        sLse[i] = ok ? lse2[qoff + q0 + i] : 0.f;
        sDelta[i] = ok ? delta[qoff + q0 + i] : 0.f;
      }
      __syncthreads();

      // Transposed blocks: rows are this warp's key rows, columns queries.
      warp_abt<D>(sK + warp * 16 * D, sQ, sST + warp * 16 * kB);
      warp_abt<D>(sV + warp * 16 * D, sG, sDPT + warp * 16 * kB);
      __syncwarp();

      const float* strow = sST + my_row * kB + half * 32;
      const float* dptrow = sDPT + my_row * kB + half * 32;
      bf16* prow = sPT + my_row * kB + half * 32;
      bf16* dsrow = sDST + my_row * kB + half * 32;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const int qc = half * 32 + c;
        bool valid = krow_ok && q0 + qc < tq &&
            (!causal || kpos <= rel + q0 + qc);
        if constexpr (HasMask)
          valid = valid &&
                  !mbase[static_cast<long long>(q0 + qc) * mask.sr + kpos];
        const float p = valid ? exp2f(strow[c] - sLse[qc]) : 0.f;
        prow[c] = __float2bfloat16(p);
        dsrow[c] = __float2bfloat16(p * (dptrow[c] - sDelta[qc]));
      }
      __syncwarp();

      warp_ab_acc<D>(acc_dv, sPT + warp * 16 * kB, sG);
      warp_ab_acc<D>(acc_dk, sDST + warp * 16 * kB, sQ);
    }
  }

  __syncthreads();   // the stage overlays other warps' score rows
  store_rows<D, OutT>(acc_dk, sST, dk + kvoff, k0, tk, kInvLog2e);
  store_rows<D, OutT>(acc_dv, sST, dv + kvoff, k0, tk, 1.f);
}

template <int D, bool HasMask, typename OutT>
int launch_dq(const void* q2, const void* k, const void* v, const void* g,
              const void* lse2, const void* delta, void* dq,
              const MaskArgs& mask, int batch_heads, int group, int tq,
              int tk, int causal, int causal_offset, int kv_offset,
              float scale, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<D>();
  auto kernel = flash_bwd_dq_kernel<D, HasMask, OutT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qtiles = (tq + kB - 1) / kB;
  if (n_qtiles == 0 || batch_heads == 0) return 0;
  dim3 grid(n_qtiles, batch_heads);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q2), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(g),
      static_cast<const float*>(lse2), static_cast<const float*>(delta),
      static_cast<OutT*>(dq), mask, tq, tk, group, causal, causal_offset,
      kv_offset, scale, n_qtiles);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool HasMask, typename OutT>
int launch_dkv(const void* q2, const void* k, const void* v, const void* g,
               const void* lse2, const void* delta, void* dk, void* dv,
               const MaskArgs& mask, int batch_heads, int group, int tq,
               int tk, int causal, int causal_offset, int kv_offset,
               cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<D>();
  auto kernel = flash_bwd_dkv_kernel<D, HasMask, OutT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_ktiles = (tk + kB - 1) / kB;
  const int n_qtiles = (tq + kB - 1) / kB;
  if (n_ktiles == 0 || batch_heads == 0) return 0;
  dim3 grid(n_ktiles, batch_heads / group);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q2), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(g),
      static_cast<const float*>(lse2), static_cast<const float*>(delta),
      static_cast<OutT*>(dk), static_cast<OutT*>(dv), mask, tq, tk, group,
      causal, causal_offset, kv_offset, n_qtiles);
  return static_cast<int>(cudaGetLastError());
}

MaskArgs mask_args(const void* mask, int inner, long long so, long long si,
                   long long sr) {
  return MaskArgs{static_cast<const unsigned char*>(mask),
                  inner > 0 ? inner : 1, so, si, sr};
}

}  // namespace

// q2, g (batch_heads, tq, d); k, v (batch_heads / group, tk, d); lse2,
// delta (batch_heads, tq) float32; dq like q2, in float32 when out_f32 and
// in bf16 otherwise. mask: null, or bytes addressed as MaskArgs (inner =
// heads; strides in bytes). All contiguous, bf16 unless stated. Returns a
// cudaError_t code (0 = launched).
extern "C" int flash_bwd_dq_bf16(const void* q2, const void* k,
                                 const void* v, const void* g,
                                 const void* lse2, const void* delta,
                                 void* dq, const void* mask, int mask_inner,
                                 long long mask_so, long long mask_si,
                                 long long mask_sr, int batch_heads,
                                 int group, int tq, int tk, int d,
                                 int causal, int causal_offset,
                                 int kv_offset, float scale, int out_f32,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const MaskArgs m = mask_args(mask, mask_inner, mask_so, mask_si, mask_sr);
#define DQ_LAUNCH(D, M, T)                                                  \
  return launch_dq<D, M, T>(q2, k, v, g, lse2, delta, dq, m, batch_heads,  \
                            group, tq, tk, causal, causal_offset,          \
                            kv_offset, scale, s)
#define DQ_CASE(D)                                                          \
    case D:                                                                 \
      if (mask == nullptr) {                                                \
        if (out_f32) DQ_LAUNCH(D, false, float);                            \
        DQ_LAUNCH(D, false, bf16);                                          \
      }                                                                     \
      if (out_f32) DQ_LAUNCH(D, true, float);                               \
      DQ_LAUNCH(D, true, bf16);
  switch (d) {
    DQ_CASE(32) DQ_CASE(64) DQ_CASE(96) DQ_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DQ_CASE
#undef DQ_LAUNCH
}

// As above; dk, dv like k, v (each GQA group's query heads summed), in
// float32 when out_f32 and in bf16 otherwise.
extern "C" int flash_bwd_dkv_bf16(const void* q2, const void* k,
                                  const void* v, const void* g,
                                  const void* lse2, const void* delta,
                                  void* dk, void* dv, const void* mask,
                                  int mask_inner, long long mask_so,
                                  long long mask_si, long long mask_sr,
                                  int batch_heads, int group, int tq, int tk,
                                  int d, int causal, int causal_offset,
                                  int kv_offset, int out_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const MaskArgs m = mask_args(mask, mask_inner, mask_so, mask_si, mask_sr);
#define DKV_LAUNCH(D, M, T)                                                  \
  return launch_dkv<D, M, T>(q2, k, v, g, lse2, delta, dk, dv, m,           \
                             batch_heads, group, tq, tk, causal,            \
                             causal_offset, kv_offset, s)
#define DKV_CASE(D)                                                          \
    case D:                                                                  \
      if (mask == nullptr) {                                                 \
        if (out_f32) DKV_LAUNCH(D, false, float);                            \
        DKV_LAUNCH(D, false, bf16);                                          \
      }                                                                      \
      if (out_f32) DKV_LAUNCH(D, true, float);                               \
      DKV_LAUNCH(D, true, bf16);
  switch (d) {
    DKV_CASE(32) DKV_CASE(64) DKV_CASE(96) DKV_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DKV_CASE
#undef DKV_LAUNCH
}
