// Flash-attention backward for Hopper (sm_90a), bf16 in, f32 accumulation:
// the dq kernel and the dk/dv kernel.
//
// Replace the TPU kernels `_make_dq_kernel` (dq) and `_make_dkv_kernel`
// (dk, dv) in distributed_dot_product_tpu/ops/pallas_attention.py, driven
// there by `_flash_bwd_impl`: causal masking with host-int global offsets of
// query row 0 and key column 0, a dense boolean mask (addressed through
// strides as in csrc/flash_fwd.cu), GQA, and gradients written in bf16 or,
// for the ring path that sums W fold partials, in float32 (`grad_dtype`);
// and (the Ext instantiations) segment ids, a sliding window, the
// coordinate-hash dropout and int8 scoring with its straight-through
// backward, applied as K1 applies them (see csrc/flash_fwd.cu); no
// explicit positions and no ALiBi. The gradient of K2, the bounded
// forward, is these kernels from its lse.
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
//
// Ext: dropout masks and scales dp (both passes) and, for dv, p, with the
// forward's bits (the hash of global coordinates and the query-side flat
// (batch, head) index); Δ = rowsum(dO*O) already equals the dropped
// rowsum. The window bounds the key tiles of a query tile (dq) and the
// query tiles of a key tile (dk/dv). Quant: the scores are recomputed from
// the same int8 operands (s8 x s8 -> s32 wmma, chunk-major tiles as in
// K1), so p matches the saved lse; the products that take q or k use them
// dequantized with their raw row scales and rounded to bf16 (dq = scale *
// ds.k~, dk = scale * ds^T.q~), the straight-through gradient.

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

// An int32 vector per flat (batch, head) row (see csrc/flash_fwd.cu).
struct VecArgs {
  const int* ptr;
  int inner;
  long long so, si;
};

// The Ext instantiations' run-time arguments, as in csrc/flash_fwd.cu.
struct ExtArgs {
  VecArgs segq, segk;
  int window;
  int dropout;
  unsigned int drop_threshold;
  float drop_inv;
  unsigned int seed;
  const signed char* q8;
  const signed char* k8;
  const float* sqf;
  const float* skr;
  const float* sqc;
  const float* skc;
};

__device__ __forceinline__ const int* vec_row(const VecArgs& a, int bh) {
  return a.ptr + (bh / a.inner) * a.so + (bh % a.inner) * a.si;
}

// The reference's _dropout_keep before the threshold (csrc/flash_fwd.cu).
__device__ __forceinline__ unsigned int drop_hash(unsigned int rh,
                                                  unsigned int ch,
                                                  unsigned int bs) {
  unsigned int x = rh ^ ch ^ bs;
  x ^= x >> 16;
  x *= 2246822507u;
  x ^= x >> 13;
  x *= 3266489909u;
  x ^= x >> 16;
  return x;
}

using FragAi = wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                              wmma::row_major>;
using FragBi = wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                              wmma::col_major>;
using FragCi = wmma::fragment<wmma::accumulator, 16, 16, 16, int>;

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

// Rows [row0, row0 + 64) of a (rows, D) int8 matrix into shared memory
// chunk-major ([D/16][64][16] bytes, every wmma fragment 256-bit aligned);
// with `deq`, also dequantized with the row scales `scale` and rounded to
// bf16 into `deq` (64 x D, row-major). Rows at or past `limit` load as
// zeros.
template <int D>
__device__ __forceinline__ void load_i8_tile(signed char* dst,
                                             const signed char* src,
                                             int row0, int limit,
                                             bf16* deq = nullptr,
                                             const float* scale = nullptr) {
  constexpr int kChunks = D / 16;
  for (int idx = threadIdx.x; idx < kB * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    float sc = 0.f;
    if (row0 + r < limit) {
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(row0 + r) * D + c * 16);
      if (deq != nullptr) sc = scale[row0 + r];
    }
    *reinterpret_cast<uint4*>(dst + (c * kB + r) * 16) = val;
    if (deq != nullptr) {
      const signed char* e = reinterpret_cast<const signed char*>(&val);
      __align__(16) bf16 w[16];
#pragma unroll
      for (int i = 0; i < 16; ++i)
        w[i] = __float2bfloat16(static_cast<float>(e[i]) * sc);
      uint4* o = reinterpret_cast<uint4*>(deq + r * D + c * 16);
      o[0] = reinterpret_cast<const uint4*>(w)[0];
      o[1] = reinterpret_cast<const uint4*>(w)[1];
    }
  }
}

// One warp: c (16 x 64 int32, ld 64) = a . b^T over chunk-major int8
// tiles: rows [a_row0, a_row0 + 16) of a against the 64 rows of b.
template <int D>
__device__ __forceinline__ void warp_abt_i8(const signed char* a, int a_row0,
                                            const signed char* b, int* c) {
#pragma unroll
  for (int j = 0; j < kB / 16; ++j) {
    FragCi acc;
    wmma::fill_fragment(acc, 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragAi fa;
      FragBi fb;
      wmma::load_matrix_sync(fa, a + (kk * kB + a_row0) * 16, 16);
      wmma::load_matrix_sync(fb, b + (kk * kB + j * 16) * 16, 16);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(c + j * 16, acc, kB, wmma::mem_row_major);
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

template <int D, bool Ext = false, bool Quant = false>
constexpr size_t dq_smem_bytes() {
  return sizeof(bf16) * (4 * kB * D     // sQ, sG, sK, sV
                         + kB * kB)     // sDS
         + sizeof(float) * 2 * kB * kB  // sS, sDP (the epilogue's stage)
         + (Quant ? kB * D : 0)         // sK8
         + (Ext ? kB * (sizeof(int) + sizeof(float)) : 0);  // sSegK, sSkr
}

template <int D, bool HasMask, typename OutT, bool Ext, bool Quant>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q2, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ g,
                    const float* __restrict__ lse2,
                    const float* __restrict__ delta, OutT* __restrict__ dq,
                    MaskArgs mask, int tq, int tk, int group, int causal,
                    int causal_offset, int kv_offset, float scale,
                    int n_qtiles, ExtArgs ext) {
  static_assert(D % 16 == 0 && D <= 128, "head dim must be 16*n <= 128");
  static_assert(!Quant || Ext, "int8 scoring is an Ext instantiation");
  static_assert(!(HasMask && Ext), "Ext reads the mask at run time");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sG = sQ + kB * D;
  bf16* sK = sG + kB * D;
  bf16* sV = sK + kB * D;
  bf16* sDS = sV + kB * D;
  float* sS = reinterpret_cast<float*>(sDS + kB * kB);
  float* sDP = sS + kB * kB;
  // Quant: the int8 q tile in the sQ region, the int8 k tile in sK8 and
  // its dequantized bf16 copy (the ds.k operand) in sK.
  signed char* sQ8 = reinterpret_cast<signed char*>(sQ);
  signed char* sK8 = reinterpret_cast<signed char*>(sDP + kB * kB);
  int* sSegK = reinterpret_cast<int*>(sK8 + (Quant ? kB * D : 0));
  float* sSkr = reinterpret_cast<float*>(sSegK + kB);

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
  int t_begin = 0;
  if constexpr (Ext) {
    if (causal && ext.window > 0) {
      const long long first = rel + q0 - ext.window + 1;
      t_begin = first <= 0 ? 0
              : (first >= kv_end ? n_ktiles : static_cast<int>(first) / kB);
    }
  }

  if constexpr (Quant)
    load_i8_tile<D>(sQ8, ext.q8 + qoff * D, q0, tq);
  else
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
  int seg_r = 0;
  const int* segk_row = nullptr;
  unsigned int drop_rh = 0u, drop_bs = 0u;
  float sqf_r = 0.f;
  if constexpr (Ext) {
    if (row_ok && mask.ptr != nullptr)
      mrow = mask_base(mask, bh) +
             static_cast<long long>(q0 + my_row) * mask.sr;
    if (ext.segk.ptr != nullptr) {
      segk_row = vec_row(ext.segk, bh);
      seg_r = row_ok ? vec_row(ext.segq, bh)[q0 + my_row] : 0;
    }
    drop_rh = static_cast<unsigned int>(causal_offset + q0 + my_row) *
              2654435761u;
    drop_bs = ext.seed + static_cast<unsigned int>(bh) * 668265263u;
    if constexpr (Quant) sqf_r = row_ok ? ext.sqf[qoff + q0 + my_row] : 0.f;
  }

  FragC acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int t = t_begin; t < n_ktiles; ++t) {
    const int k0 = t * kB;
    __syncthreads();   // all warps done with the previous sK/sV
    if constexpr (Quant)
      load_i8_tile<D>(sK8, ext.k8 + static_cast<size_t>(bkv) * tk * D, k0,
                      tk, sK, ext.skc + static_cast<size_t>(bkv) * tk);
    else
      load_tile<D>(sK, kb, k0, tk);
    load_tile<D>(sV, vb, k0, tk);
    if constexpr (Ext) {
      for (int i = threadIdx.x; i < kB; i += kThreads) {
        const bool ok = k0 + i < tk;
        sSegK[i] = (segk_row != nullptr && ok) ? segk_row[k0 + i] : 0;
        if constexpr (Quant)
          sSkr[i] = ok ? ext.skr[static_cast<size_t>(bkv) * tk + k0 + i]
                       : 0.f;
      }
    }
    __syncthreads();

    if constexpr (Quant)
      warp_abt_i8<D>(sQ8, warp * 16, sK8,
                     reinterpret_cast<int*>(sS) + warp * 16 * kB);
    else
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
      float sc = srow[c];
      float dpv = dprow[c];
      if constexpr (Ext) {
        if (mrow != nullptr) valid = valid && !mrow[col];
        if (ext.window > 0) valid = valid && row_pos - col < ext.window;
        if (segk_row != nullptr)
          valid = valid && seg_r == sSegK[half * 32 + c];
        if constexpr (Quant)
          sc = static_cast<float>(reinterpret_cast<const int*>(srow)[c]) *
               sqf_r * sSkr[half * 32 + c];
        if (ext.dropout) {
          const unsigned int ch =
              static_cast<unsigned int>(kv_offset + col) * 2246822519u;
          dpv = drop_hash(drop_rh, ch, drop_bs) >= ext.drop_threshold
                    ? dpv * ext.drop_inv : 0.f;
        }
      }
      const float p = valid ? exp2f(sc - lse_r) : 0.f;
      dsrow[c] = __float2bfloat16(p * (dpv - delta_r));
    }
    __syncwarp();

    warp_ab_acc<D>(acc, sDS + warp * 16 * kB, sK);
  }

  __syncthreads();   // the stage overlays other warps' score rows
  store_rows<D, OutT>(acc, sS, dq + qoff * D, q0, tq, scale);
}

template <int D, bool Ext = false, bool Quant = false>
constexpr size_t dkv_smem_bytes() {
  return sizeof(bf16) * (4 * kB * D     // sK, sV, sQ, sG
                         + 2 * kB * kB) // sPT, sDST
         + sizeof(float) * (2 * kB * kB // sST, sDPT (the epilogue's stage)
                            + 2 * kB)   // sLse, sDelta
         + (Quant ? kB * D : 0)         // sQ8
         + (Ext ? kB * (sizeof(int) + sizeof(float)) : 0);  // sSegQ, sSqf
}

template <int D, bool HasMask, typename OutT, bool Ext, bool Quant>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q2, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ g,
                     const float* __restrict__ lse2,
                     const float* __restrict__ delta, OutT* __restrict__ dk,
                     OutT* __restrict__ dv, MaskArgs mask, int tq, int tk,
                     int group, int causal, int causal_offset, int kv_offset,
                     float scale, int n_qtiles, ExtArgs ext) {
  static_assert(D % 16 == 0 && D <= 128, "head dim must be 16*n <= 128");
  static_assert(!Quant || Ext, "int8 scoring is an Ext instantiation");
  static_assert(!(HasMask && Ext), "Ext reads the mask at run time");
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
  // Quant: the int8 k tile in the sK region, the query tile's int8 copy
  // in sQ8 and its dequantized bf16 copy (the ds^T.q operand) in sQ.
  signed char* sK8 = reinterpret_cast<signed char*>(sK);
  signed char* sQ8 = reinterpret_cast<signed char*>(sDelta + kB);
  int* sSegQ = reinterpret_cast<int*>(sQ8 + (Quant ? kB * D : 0));
  float* sSqf = reinterpret_cast<float*>(sSegQ + kB);

  // Early key tiles are seen by the most query rows under causal masking.
  const int k0 = static_cast<int>(blockIdx.x) * kB;
  const int bkv = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const size_t kvoff = static_cast<size_t>(bkv) * tk * D;
  if constexpr (Quant)
    load_i8_tile<D>(sK8, ext.k8 + kvoff, k0, tk);
  else
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
  // Ext window: query rows r < window + (k0 + 63) - rel can still see the
  // tile's newest key.
  int qt_end = n_qtiles;
  if constexpr (Ext) {
    if (causal && ext.window > 0) {
      const long long r_end = ext.window + k0 + kB - 1 - rel;
      qt_end = r_end <= 0 ? 0
             : (r_end >= tq ? n_qtiles
                            : static_cast<int>((r_end + kB - 1) / kB));
    }
  }

  // Elementwise ownership: lanes (2r, 2r+1) of warp w hold key row
  // w*16 + r, 32 query columns each.
  const int my_row = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const bool krow_ok = k0 + my_row < tk;
  const long long kpos = static_cast<long long>(k0) + my_row;
  unsigned int drop_ch = 0u;
  float skr_r = 0.f;
  if constexpr (Ext) {
    drop_ch = static_cast<unsigned int>(kv_offset + kpos) * 2246822519u;
    if constexpr (Quant)
      skr_r = krow_ok ? ext.skr[static_cast<size_t>(bkv) * tk + kpos] : 0.f;
  }

  FragC acc_dk[D / 16], acc_dv[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::fill_fragment(acc_dk[j], 0.f);
    wmma::fill_fragment(acc_dv[j], 0.f);
  }

  for (int h = 0; h < group; ++h) {
    const int bh = bkv * group + h;
    const size_t qoff = static_cast<size_t>(bkv) * group * tq +
                        static_cast<size_t>(h) * tq;
    const unsigned char* mbase =
        HasMask ? mask_base(mask, bkv * group + h) : nullptr;
    int segk_r = 0;
    const int* segq_row = nullptr;
    unsigned int drop_bs = 0u;
    if constexpr (Ext) {
      if (mask.ptr != nullptr) mbase = mask_base(mask, bh);
      if (ext.segq.ptr != nullptr) {
        segq_row = vec_row(ext.segq, bh);
        segk_r = krow_ok ? vec_row(ext.segk, bh)[kpos] : 0;
      }
      drop_bs = ext.seed + static_cast<unsigned int>(bh) * 668265263u;
    }
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * kB;
      __syncthreads();   // all warps done with the previous query tile
      if constexpr (Quant)
        load_i8_tile<D>(sQ8, ext.q8 + qoff * D, q0, tq, sQ, ext.sqc + qoff);
      else
        load_tile<D>(sQ, q2 + qoff * D, q0, tq);
      load_tile<D>(sG, g + qoff * D, q0, tq);
      for (int i = threadIdx.x; i < kB; i += kThreads) {
        const bool ok = q0 + i < tq;
        sLse[i] = ok ? lse2[qoff + q0 + i] : 0.f;
        sDelta[i] = ok ? delta[qoff + q0 + i] : 0.f;
        if constexpr (Ext) {
          sSegQ[i] = (segq_row != nullptr && ok) ? segq_row[q0 + i] : 0;
          if constexpr (Quant) sSqf[i] = ok ? ext.sqf[qoff + q0 + i] : 0.f;
        }
      }
      __syncthreads();

      // Transposed blocks: rows are this warp's key rows, columns queries.
      if constexpr (Quant)
        warp_abt_i8<D>(sK8, warp * 16, sQ8,
                       reinterpret_cast<int*>(sST) + warp * 16 * kB);
      else
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
        float sc = strow[c];
        float dpv = dptrow[c];
        float keep_mul = 1.f;
        if constexpr (Ext) {
          if (mbase != nullptr)
            valid = valid &&
                    !mbase[static_cast<long long>(q0 + qc) * mask.sr + kpos];
          if (ext.window > 0)
            valid = valid && rel + q0 + qc - kpos < ext.window;
          if (segq_row != nullptr) valid = valid && sSegQ[qc] == segk_r;
          if constexpr (Quant)
            sc = static_cast<float>(reinterpret_cast<const int*>(strow)[c]) *
                 sSqf[qc] * skr_r;
          if (ext.dropout) {
            const unsigned int rh =
                static_cast<unsigned int>(causal_offset + q0 + qc) *
                2654435761u;
            keep_mul = drop_hash(rh, drop_ch, drop_bs) >= ext.drop_threshold
                           ? ext.drop_inv : 0.f;
            dpv = keep_mul == 0.f ? 0.f : dpv * keep_mul;
          }
        }
        const float p = valid ? exp2f(sc - sLse[qc]) : 0.f;
        float pn = p;
        if constexpr (Ext) {
          if (ext.dropout) pn = keep_mul == 0.f ? 0.f : p * keep_mul;
        }
        prow[c] = __float2bfloat16(pn);
        dsrow[c] = __float2bfloat16(p * (dpv - sDelta[qc]));
      }
      __syncwarp();

      warp_ab_acc<D>(acc_dv, sPT + warp * 16 * kB, sG);
      warp_ab_acc<D>(acc_dk, sDST + warp * 16 * kB, sQ);
    }
  }

  __syncthreads();   // the stage overlays other warps' score rows
  // dk: the folded q2 carries scale*log2(e), so 1/log2(e) restores the
  // scale; under Quant sQ holds the dequantized raw q, so the scale itself.
  store_rows<D, OutT>(acc_dk, sST, dk + kvoff, k0, tk,
                      Quant ? scale : kInvLog2e);
  store_rows<D, OutT>(acc_dv, sST, dv + kvoff, k0, tk, 1.f);
}

template <int D, bool HasMask, typename OutT, bool Ext, bool Quant>
int launch_dq(const void* q2, const void* k, const void* v, const void* g,
              const void* lse2, const void* delta, void* dq,
              const MaskArgs& mask, int batch_heads, int group, int tq,
              int tk, int causal, int causal_offset, int kv_offset,
              float scale, const ExtArgs& ext, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<D, Ext, Quant>();
  auto kernel = flash_bwd_dq_kernel<D, HasMask, OutT, Ext, Quant>;
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
      kv_offset, scale, n_qtiles, ext);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool HasMask, typename OutT, bool Ext, bool Quant>
int launch_dkv(const void* q2, const void* k, const void* v, const void* g,
               const void* lse2, const void* delta, void* dk, void* dv,
               const MaskArgs& mask, int batch_heads, int group, int tq,
               int tk, int causal, int causal_offset, int kv_offset,
               float scale, const ExtArgs& ext, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<D, Ext, Quant>();
  auto kernel = flash_bwd_dkv_kernel<D, HasMask, OutT, Ext, Quant>;
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
      causal, causal_offset, kv_offset, scale, n_qtiles, ext);
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
// heads; strides in bytes). ext: null (the base instantiations), or the
// segments, window, dropout and int8 operands of ExtArgs (the Ext
// instantiations; with int8 operands q2 is unused and k is read only for
// its shape). All contiguous, bf16 unless stated. Returns a cudaError_t
// code (0 = launched).
extern "C" int flash_bwd_dq_bf16(const void* q2, const void* k,
                                 const void* v, const void* g,
                                 const void* lse2, const void* delta,
                                 void* dq, const void* mask, int mask_inner,
                                 long long mask_so, long long mask_si,
                                 long long mask_sr, int batch_heads,
                                 int group, int tq, int tk, int d,
                                 int causal, int causal_offset,
                                 int kv_offset, float scale, int out_f32,
                                 const void* ext, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const MaskArgs m = mask_args(mask, mask_inner, mask_so, mask_si, mask_sr);
  const ExtArgs* e = static_cast<const ExtArgs*>(ext);
  const ExtArgs none{};
#define DQ_LAUNCH(D, M, T, E, Q)                                             \
  return launch_dq<D, M, T, E, Q>(q2, k, v, g, lse2, delta, dq, m,          \
                                  batch_heads, group, tq, tk, causal,       \
                                  causal_offset, kv_offset, scale,          \
                                  E ? *e : none, s)
  // Built three times (ops/_build.py): the base instantiations of both
  // passes, and with FLASH_EXT=1 / =2 the Ext ones of dq / dk,dv, each
  // refusing the others' calls.
#if !defined(FLASH_EXT)
  if (e != nullptr) return static_cast<int>(cudaErrorInvalidValue);
#define DQ_CASE(D)                                                           \
    case D:                                                                  \
      if (mask == nullptr) {                                                 \
        if (out_f32) DQ_LAUNCH(D, false, float, false, false);               \
        DQ_LAUNCH(D, false, bf16, false, false);                             \
      }                                                                      \
      if (out_f32) DQ_LAUNCH(D, true, float, false, false);                  \
      DQ_LAUNCH(D, true, bf16, false, false);
#elif FLASH_EXT == 1
  if (e == nullptr) return static_cast<int>(cudaErrorInvalidValue);
#define DQ_CASE(D)                                                           \
    case D:                                                                  \
      if (e->q8 != nullptr) {                                                \
        if (out_f32) DQ_LAUNCH(D, false, float, true, true);                 \
        DQ_LAUNCH(D, false, bf16, true, true);                               \
      }                                                                      \
      if (out_f32) DQ_LAUNCH(D, false, float, true, false);                  \
      DQ_LAUNCH(D, false, bf16, true, false);
#else
#define DQ_CASE(D)                                                           \
    case D:                                                                  \
      return static_cast<int>(cudaErrorInvalidValue);
#endif
  switch (d) {
    DQ_CASE(32) DQ_CASE(64) DQ_CASE(96) DQ_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DQ_CASE
#undef DQ_LAUNCH
}

// As above; dk, dv like k, v (each GQA group's query heads summed), in
// float32 when out_f32 and in bf16 otherwise. scale: the softmax scale,
// which only int8 scoring's dk uses (the folded q2 carries it otherwise).
extern "C" int flash_bwd_dkv_bf16(const void* q2, const void* k,
                                  const void* v, const void* g,
                                  const void* lse2, const void* delta,
                                  void* dk, void* dv, const void* mask,
                                  int mask_inner, long long mask_so,
                                  long long mask_si, long long mask_sr,
                                  int batch_heads, int group, int tq, int tk,
                                  int d, int causal, int causal_offset,
                                  int kv_offset, float scale, int out_f32,
                                  const void* ext, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const MaskArgs m = mask_args(mask, mask_inner, mask_so, mask_si, mask_sr);
  const ExtArgs* e = static_cast<const ExtArgs*>(ext);
  const ExtArgs none{};
#define DKV_LAUNCH(D, M, T, E, Q)                                             \
  return launch_dkv<D, M, T, E, Q>(q2, k, v, g, lse2, delta, dk, dv, m,      \
                                   batch_heads, group, tq, tk, causal,       \
                                   causal_offset, kv_offset, scale,          \
                                   E ? *e : none, s)
#if !defined(FLASH_EXT)
  if (e != nullptr) return static_cast<int>(cudaErrorInvalidValue);
#define DKV_CASE(D)                                                           \
    case D:                                                                   \
      if (mask == nullptr) {                                                  \
        if (out_f32) DKV_LAUNCH(D, false, float, false, false);               \
        DKV_LAUNCH(D, false, bf16, false, false);                             \
      }                                                                       \
      if (out_f32) DKV_LAUNCH(D, true, float, false, false);                  \
      DKV_LAUNCH(D, true, bf16, false, false);
#elif FLASH_EXT == 2
  if (e == nullptr) return static_cast<int>(cudaErrorInvalidValue);
#define DKV_CASE(D)                                                           \
    case D:                                                                   \
      if (e->q8 != nullptr) {                                                 \
        if (out_f32) DKV_LAUNCH(D, false, float, true, true);                 \
        DKV_LAUNCH(D, false, bf16, true, true);                               \
      }                                                                       \
      if (out_f32) DKV_LAUNCH(D, false, float, true, false);                  \
      DKV_LAUNCH(D, false, bf16, true, false);
#else
#define DKV_CASE(D)                                                           \
    case D:                                                                   \
      return static_cast<int>(cudaErrorInvalidValue);
#endif
  switch (d) {
    DKV_CASE(32) DKV_CASE(64) DKV_CASE(96) DKV_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DKV_CASE
#undef DKV_LAUNCH
}
