// Flash-attention backward for Hopper (sm_90a), bf16 in, f32 accumulation:
// the dq kernel and the dk/dv kernel.
//
// Replace the TPU kernels `_make_dq_kernel` (dq) and `_make_dkv_kernel`
// (dk, dv) in distributed_dot_product_tpu/ops/pallas_attention.py, driven
// there by `_flash_bwd_impl` (exact softmax mode, causal with a host-int row
// offset, GQA; no mask, segments, positions, window, ALiBi, dropout or int8
// scoring, no float32 partials).
//
// Both recompute the softmax weights from the forward's row logsumexp
// instead of storing them: with q2 = q*scale*log2(e) (rounded to bf16),
// lse2 = max(lse*log2(e), NEG_BIG) and delta = rowsum(dO*O), all three made
// by the wrapper as the TPU path makes them outside its kernels,
//   p  = exp2(q2.k^T - lse2)        (causal future and ragged edge: 0)
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

// Writes one warp's 16 x D accumulator as bf16 rows times `mul`: staged
// through the warp's own 16 x D float region of shared memory; lanes
// (2r, 2r+1) write half a row each, rows at or past `limit` are skipped.
template <int D>
__device__ __forceinline__ void store_rows(FragC (&acc)[D / 16], float* stage,
                                           bf16* dst, int row0, int limit,
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
    __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(
        dst + static_cast<size_t>(row) * D + half * (D / 2));
#pragma unroll
    for (int c = 0; c < D / 2; c += 2)
      out[c / 2] = __floats2bfloat162_rn(src[c] * mul, src[c + 1] * mul);
  }
  __syncwarp();
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(bf16) * (4 * kB * D     // sQ, sG, sK, sV
                         + kB * kB)     // sDS
         + sizeof(float) * 2 * kB * kB; // sS, sDP (the epilogue's stage)
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q2, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ g,
                    const float* __restrict__ lse2,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int tq, int tk, int group, int causal, int causal_offset,
                    float scale, int n_qtiles) {
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

  int kv_end = tk;
  if (causal) {
    const int rows = (q0 + kB < tq ? q0 + kB : tq);
    const long long extent = static_cast<long long>(causal_offset) + rows;
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
  const long long row_pos = static_cast<long long>(causal_offset) + q0 +
                            my_row;
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
      const bool valid = row_ok && col < tk && (!causal || col <= row_pos);
      const float p = valid ? exp2f(srow[c] - lse_r) : 0.f;
      dsrow[c] = __float2bfloat16(p * (dprow[c] - delta_r));
    }
    __syncwarp();

    warp_ab_acc<D>(acc, sDS + warp * 16 * kB, sK);
  }

  __syncthreads();   // the stage overlays other warps' score rows
  store_rows<D>(acc, sS, dq + qoff * D, q0, tq, scale);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(bf16) * (4 * kB * D     // sK, sV, sQ, sG
                         + 2 * kB * kB) // sPT, sDST
         + sizeof(float) * (2 * kB * kB // sST, sDPT (the epilogue's stage)
                            + 2 * kB);  // sLse, sDelta
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q2, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ g,
                     const float* __restrict__ lse2,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int tq, int tk, int group,
                     int causal, int causal_offset, int n_qtiles) {
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
  // causal_offset + r >= k0.
  int qt_begin = 0;
  if (causal) {
    const long long r_min = static_cast<long long>(k0) - causal_offset;
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
        const bool valid = krow_ok && q0 + qc < tq &&
            (!causal || kpos <= static_cast<long long>(causal_offset) +
                                    q0 + qc);
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
  store_rows<D>(acc_dk, sST, dk + kvoff, k0, tk, kInvLog2e);
  store_rows<D>(acc_dv, sST, dv + kvoff, k0, tk, 1.f);
}

template <int D>
int launch_dq(const void* q2, const void* k, const void* v, const void* g,
              const void* lse2, const void* delta, void* dq, int batch_heads,
              int group, int tq, int tk, int causal, int causal_offset,
              float scale, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qtiles = (tq + kB - 1) / kB;
  if (n_qtiles == 0 || batch_heads == 0) return 0;
  dim3 grid(n_qtiles, batch_heads);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q2), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(g),
      static_cast<const float*>(lse2), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), tq, tk, group, causal, causal_offset, scale,
      n_qtiles);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q2, const void* k, const void* v, const void* g,
               const void* lse2, const void* delta, void* dk, void* dv,
               int batch_heads, int group, int tq, int tk, int causal,
               int causal_offset, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_ktiles = (tk + kB - 1) / kB;
  const int n_qtiles = (tq + kB - 1) / kB;
  if (n_ktiles == 0 || batch_heads == 0) return 0;
  dim3 grid(n_ktiles, batch_heads / group);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q2), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(g),
      static_cast<const float*>(lse2), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), tq, tk, group, causal,
      causal_offset, n_qtiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q2, g (batch_heads, tq, d); k, v (batch_heads / group, tk, d); lse2,
// delta (batch_heads, tq) float32; dq like q2. All contiguous, bf16 unless
// stated. Returns a cudaError_t code (0 = launched).
extern "C" int flash_bwd_dq_bf16(const void* q2, const void* k,
                                 const void* v, const void* g,
                                 const void* lse2, const void* delta,
                                 void* dq, int batch_heads, int group,
                                 int tq, int tk, int d, int causal,
                                 int causal_offset, float scale,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
#define DQ_CASE(D)                                                          \
    case D:                                                                 \
      return launch_dq<D>(q2, k, v, g, lse2, delta, dq, batch_heads, group, \
                          tq, tk, causal, causal_offset, scale, s);
    DQ_CASE(32) DQ_CASE(64) DQ_CASE(96) DQ_CASE(128)
#undef DQ_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// As above; dk, dv like k, v (each GQA group's query heads summed).
extern "C" int flash_bwd_dkv_bf16(const void* q2, const void* k,
                                  const void* v, const void* g,
                                  const void* lse2, const void* delta,
                                  void* dk, void* dv, int batch_heads,
                                  int group, int tq, int tk, int d,
                                  int causal, int causal_offset,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
#define DKV_CASE(D)                                                          \
    case D:                                                                  \
      return launch_dkv<D>(q2, k, v, g, lse2, delta, dk, dv, batch_heads,    \
                           group, tq, tk, causal, causal_offset, s);
    DKV_CASE(32) DKV_CASE(64) DKV_CASE(96) DKV_CASE(128)
#undef DKV_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
