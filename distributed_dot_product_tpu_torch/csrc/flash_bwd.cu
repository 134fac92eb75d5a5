// Flash-attention backward for Hopper (sm_90a), bf16 in, f32 accumulation:
// the dq kernel (K3) and the dk/dv kernel (K4).
//
// Replace the TPU kernels `_make_dq_kernel` (dq, :1228) and
// `_make_dkv_kernel` (dk, dv, :1319) in
// distributed_dot_product_tpu/ops/pallas_attention.py, driven there by
// `_flash_bwd_impl`: causal masking with host-int global offsets of query
// row 0 and key column 0, a dense boolean mask (addressed through strides
// as in csrc/flash_fwd.cu), GQA, and gradients written in bf16 or, for the
// ring path that sums W fold partials, in float32 (`grad_dtype`); and (the
// Ext instantiations) segment ids, a sliding window, the coordinate-hash
// dropout, int8 scoring with its straight-through backward, ALiBi and
// explicit global positions, applied as K1 applies them (see
// csrc/flash_fwd.cu). The gradient of K2, the bounded forward, is these
// kernels from its lse.
//
// Both recompute the softmax weights from the forward's row logsumexp
// instead of storing them: with q2 = q*scale*log2(e) (rounded to bf16),
// lse2 = max(lse*log2(e), NEG_BIG) and delta = rowsum(dO*O), all three made
// by the wrapper as the TPU path makes them outside its kernels,
//   p  = exp2(q2.k^T - lse2)        (masked, causal future, ragged edge: 0)
//   ds = p * (dO.v^T - delta)       (rounded to bf16 for the products)
//   dq = scale * ds.k,  dk = ds^T.q2 / log2(e),  dv = p^T.dO (p in bf16).
//
// What bounds them on the H100: tensor-core operations. An attended
// (query, key) pair costs dq 6*d flops (S, dP, dQ) and dk/dv 8*d (S^T, dP^T,
// dV, dK); at the LM's training shape (4 x 8 heads, T = 4096, head dim 96,
// causal: 268 M pairs) that is 155 and 206 GFLOP, 0.16 and 0.21 ms at 989
// TFLOP/s, against ~127 and ~152 MB of operands (0.04 ms at 3.35 TB/s).
//
// The design: a block is two warpgroups (256 threads), each owning one
// 64-row tile of the block's 128 query rows (dq) or key rows (dk/dv).
//  - Every product is a wgmma (m64nNk16, f32 accumulators in registers).
//    dq: S = q2.K^T and dP = dO.V^T take both operands from shared memory
//    (K-major); dQ += dS.K takes dS from registers and K MN-major (the
//    transpose bit). dk/dv: S^T = K.q2^T and dP^T = V.dO^T, then
//    dV += P^T.dO and dK += dS^T.q2 with P^T and dS^T from registers.
//  - Scores never leave registers. The elementwise pass (exp2 against lse2;
//    the causal, mask, segment, window and positions tests; the ALiBi bias;
//    the dropout keep; dS) runs on the accumulator fragments, whose (row,
//    column) follow from the m64nN layout, and a 64-column accumulator is,
//    element for element, the four m64k16 bf16 A fragments of the next
//    product. A tile wholly inside the rows, columns, causal extent and
//    window, with no mask or segments, skips the per-element tests.
//  - Shared memory holds every tile in the no-swizzle core-matrix layout
//    the wgmma descriptors name (8 x 8 blocks of 128 contiguous bytes, so
//    d = 96 needs no 128-byte swizzle row); one tile serves K-major and
//    MN-major reads. TMA fills it, one 64-row x 8-column box a panel, rows
//    past a head's end as zeros: the resident tiles once (dq: q2, dO;
//    dk/dv: K, V), the streamed ones (dq: K, V; dk/dv: q2, dO) through
//    three stages with an mbarrier each, two tiles ahead of the one in use;
//    the small per-row vectors (lse2, delta, segment ids, positions) by
//    cp.async beside them. Both warpgroups use every streamed tile, which
//    halves the load per product against one warpgroup a block: the loads,
//    not the tensor cores, set the pace at the LM's shape.
//  - Order: dq's grid launches every (batch, head) row's longest causal
//    extents first; dk/dv's its early key blocks (seen by the most query
//    rows). A warpgroup skips the tiles its own rows do not see. dk/dv
//    loops over the GQA group's heads inside the block (the TPU path wrote
//    per-query-head partials and summed them afterwards), so the group's
//    sum stays in float32 registers.
//  - The epilogue writes the accumulators from registers straight to device
//    memory (bf16, or float32), masking the ragged edge.
// Two kernels and no atomics: a fused backward, one pass over the pairs
// with dq summed across key-tile blocks by float32 atomics, would do 10*d
// flops a pair against 14*d, but its dq would change from run to run with
// the atomics' order, and the checkpoint's resumed step (equal bit for bit)
// and the ring's fold sums need repeatable gradients.
//
// int8 scoring (Quant): dk/dv is the wgmma kernel's Quant instantiation.
// The block's int8 k rows stay resident (by TMA through an int8 tensor map,
// in the bf16 tiles' byte geometry) and every stage carries the query
// tile's int8 q rows beside the dequantized q~ (made once per call by the
// wrapper, (q8 * sq) rounded to bf16 as the reference dequantizes in
// block) and dO; S^T = k8.q8^T is an m64n64k32 s8 wgmma (both operands
// K-major as stored) and each score (float(dot) * sqf_q) * skr_k, the
// forward's arithmetic with the rows and columns swapped, bit for bit; dK
// += dS^T.q~ then carries the plain softmax scale. dq keeps the first
// version's body (flash_bwd_dq_i8_kernel): nvcuda::wmma 16x16x16
// fragments (s8 x s8 -> s32 scores), score blocks through shared memory,
// synchronous tile loads.
//
// Ext: dropout masks and scales dp (both passes) and, for dv, p, with the
// forward's bits (the hash of global coordinates and the query-side flat
// (batch, head) index); delta = rowsum(dO*O) already equals the dropped
// rowsum. The window bounds the key tiles of a query tile (dq) and the
// query tiles of a key tile (dk/dv). Quant: the scores are recomputed from
// the same int8 operands (chunk-major tiles as in K1), so p matches the
// saved lse; the products that take q or k use them dequantized with their
// raw row scales and rounded to bf16 (dq = scale * ds.k~, dk = scale *
// ds^T.q~), the straight-through gradient. ALiBi adds K1's bias to the
// recomputed scores (the slopes are constants: no slope gradient).
// Positions mask, window and key the dropout hash as in K1, and skip the
// tiles K1 skips: dq the key tiles of its query tile, dk/dv the query tiles
// of its key tile, from the same per-tile [min, max] tables (read per query
// (batch, head) row, as the positions are).

#include <mma.h>
#include <math.h>

#include <type_traits>

#include "hopper.cuh"   // kB, kWarps, kThreads and the Hopper helpers

using namespace nvcuda;

namespace {

// The wgmma kernels: two warpgroups a block, one 64-row tile each, and
// three stages for the streamed tiles.
constexpr int kWgs = 2;
constexpr int kRows = kWgs * kB;
constexpr int kBlockThreads = kWgs * kThreads;
constexpr int kStages = 3;
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
  const float* alibi;
  VecArgs posq, posk;
  VecArgs posq_mm, posk_mm;
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

// ---------------------------------------------------------------------------
// The wgmma kernels (every instantiation but int8 scoring): two warpgroups
// a block, each owning one 64-row tile of the block's 128 rows, so a tile
// streamed through the kStages stages serves 128 rows.

template <int D, bool Ext>
constexpr size_t dq_smem_bytes() {
  return sizeof(bf16) * (2 * kRows + 2 * kStages * kB) * D  // sQ, sG; sK, sV
         + (Ext ? kStages * 2 * kB * sizeof(int) : 0)       // segk, posk
         + kStages * sizeof(uint64_t);                      // the barriers
}

// dq for one 128-row query block of one (batch, head) row: q2 and dO stay
// in shared memory, key and value tiles stream through the stages (TMA,
// one barrier a stage); each warpgroup's S, dP and dS live in its
// registers. The tensor maps: q2 and dO (batch_heads, tq, D), k and v
// (batch_heads / group, tk, D), 64 x 8 boxes.
template <int D, bool HasMask, typename OutT, bool Ext>
__global__ void __launch_bounds__(kBlockThreads)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_g,
                    const float* __restrict__ lse2,
                    const float* __restrict__ delta, OutT* __restrict__ dq,
                    MaskArgs mask, int tq, int tk, int group, int causal,
                    int causal_offset, int kv_offset, float scale,
                    int n_qblocks, ExtArgs ext) {
  static_assert(D % 32 == 0 && D <= 128, "head dim must be 32*n <= 128");
  static_assert(!(HasMask && Ext), "Ext reads the mask at run time");
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);   // warpgroup w's rows at w*kB*D
  bf16* sG = sQ + kRows * D;
  bf16* sKV = sG + kRows * D;   // stage s: K at sKV + 2s*kB*D, V after it
  int* sVec = reinterpret_cast<int*>(sKV + 2 * kStages * kB * D);   // stage
                                             // s: segk at 2s*kB, posk after
  uint64_t* bars = reinterpret_cast<uint64_t*>(sVec +
                                               (Ext ? kStages * 2 * kB : 0));
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(&bars[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The longest causal extents (late query blocks) launch first.
  const int qb0 = (n_qblocks - 1 - static_cast<int>(blockIdx.y)) * kRows;
  const int bh = blockIdx.x;
  const int bkv = bh / group;
  const int wg = threadIdx.x / kThreads;
  const int q0 = qb0 + wg * kB;   // this warpgroup's first row
  const size_t qoff = static_cast<size_t>(bh) * tq;
  const int* segk_row = nullptr;
  const int* posk_row = nullptr;
  const int* posk_mm = nullptr;
  if constexpr (Ext) {
    if (ext.segk.ptr != nullptr) segk_row = vec_row(ext.segk, bh);
    if (ext.posk.ptr != nullptr) {
      posk_row = vec_row(ext.posk, bh);
      posk_mm = vec_row(ext.posk_mm, bh);
    }
  }

  // Row i may attend local key column j when rel + i >= j. Warpgroup w
  // sees key tiles [t_lo[w], t_hi[w]) (its causal extent and window) and,
  // with positions, its 64-row tile's [qmin, qmax] (the same values in
  // every thread).
  const long long rel = static_cast<long long>(causal_offset) - kv_offset;
  int t_lo[kWgs], t_hi[kWgs], qmin[kWgs], qmax[kWgs];
#pragma unroll
  for (int w = 0; w < kWgs; ++w) {
    const int r0 = qb0 + w * kB;
    t_lo[w] = t_hi[w] = qmin[w] = qmax[w] = 0;
    if (r0 >= tq) continue;
    int kv_end = tk;
    if (causal) {
      const long long extent = rel + (r0 + kB < tq ? r0 + kB : tq);
      kv_end = extent <= 0 ? 0 : (extent < tk ? static_cast<int>(extent) : tk);
    }
    t_hi[w] = (kv_end + kB - 1) / kB;
    if constexpr (Ext) {
      if (causal && ext.window > 0) {
        const long long first = rel + r0 - ext.window + 1;
        t_lo[w] = first <= 0 ? 0
                : (first >= kv_end ? t_hi[w] : static_cast<int>(first) / kB);
      }
      if (posk_mm != nullptr) {
        qmin[w] = vec_row(ext.posq_mm, bh)[2 * (r0 / kB)];
        qmax[w] = vec_row(ext.posq_mm, bh)[2 * (r0 / kB) + 1];
      }
    }
  }
  // Does warpgroup w see key tile t? Positions skip K1's tiles.
  auto sees = [&](int w, int t) {
    const int lo = w ? t_lo[1] : t_lo[0], hi = w ? t_hi[1] : t_hi[0];
    bool yes = t >= lo && t < hi;
    if constexpr (Ext) {
      const int mn = w ? qmin[1] : qmin[0], mx = w ? qmax[1] : qmax[0];
      yes = yes && !(posk_mm != nullptr &&
                     (posk_mm[2 * t] > mx ||
                      (ext.window > 0 &&
                       static_cast<long long>(mn) - posk_mm[2 * t + 1] >=
                           ext.window)));
    }
    return yes;
  };
  const int t_end = t_hi[0] > t_hi[1] ? t_hi[0] : t_hi[1];
  // The next key tile from t on that a warpgroup sees.
  auto next_tile = [&](int t) {
    while (t < t_end && !sees(0, t) && !sees(1, t)) ++t;
    return t;
  };
  // Loads key tile t (and, with `resident`, the block's q2 and dO rows)
  // into a stage: thread 0 announces the bytes and starts the TMA copies.
  auto issue = [&](int t, int stage, bool resident) {
    bf16* sK = sKV + 2 * stage * kB * D;
    if (threadIdx.x == 0) {
      uint64_t* bar = &bars[stage];
      mbar_expect_tx(bar, (resident ? 6 : 2) * kB * D * sizeof(bf16));
      if (resident) {
        for (int w = 0; w < kWgs; ++w) {
          tma_tile<D>(sQ + w * kB * D, &map_q, qb0 + w * kB, bh, bar);
          tma_tile<D>(sG + w * kB * D, &map_g, qb0 + w * kB, bh, bar);
        }
      }
      tma_tile<D>(sK, &map_k, t * kB, bkv, bar);
      tma_tile<D>(sK + kB * D, &map_v, t * kB, bkv, bar);
    }
    if constexpr (Ext) {
      int* sv = sVec + 2 * stage * kB;
      if (segk_row != nullptr) load_vec_async(sv, segk_row, t * kB, tk);
      if (posk_row != nullptr) load_vec_async(sv + kB, posk_row, t * kB, tk);
    }
  };

  // This thread's two query rows of the accumulator layout: lr and lr + 8
  // of its warpgroup's tile.
  const int lr = acc_row(0);
  bool row_ok[2];
  long long row_pos[2];
  float lse_r[2], delta_r[2];
  const unsigned char* mrow[2] = {nullptr, nullptr};
  int seg_r[2] = {0, 0}, pos_r[2] = {0, 0};
  unsigned int drop_rh[2] = {0u, 0u};
  unsigned int drop_bs = 0u;
  float slope = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + lr + 8 * h;
    row_ok[h] = row < tq;
    row_pos[h] = rel + row;
    lse_r[h] = row_ok[h] ? lse2[qoff + row] : 0.f;
    delta_r[h] = row_ok[h] ? delta[qoff + row] : 0.f;
    if (row_ok[h] && (HasMask || (Ext && mask.ptr != nullptr)))
      mrow[h] = mask_base(mask, bh) + static_cast<long long>(row) * mask.sr;
    if constexpr (Ext) {
      if (segk_row != nullptr && row_ok[h])
        seg_r[h] = vec_row(ext.segq, bh)[row];
      if (posk_row != nullptr && row_ok[h])
        pos_r[h] = vec_row(ext.posq, bh)[row];
      drop_rh[h] = static_cast<unsigned int>(
                       posk_row != nullptr ? pos_r[h] : causal_offset + row) *
                   2654435761u;
    }
  }
  if constexpr (Ext) {
    drop_bs = ext.seed + static_cast<unsigned int>(bh) * 668265263u;
    if (ext.alibi != nullptr) slope = ext.alibi[bh];
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  int t = next_tile(t_lo[0] < t_lo[1] ? t_lo[0] : t_lo[1]);
  int fetch = t;   // the next tile to load, kStages - 1 ahead of t
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (fetch < t_end) {
      issue(fetch, s, s == 0);
      fetch = next_tile(fetch + 1);
    }
    cp_async_commit();
  }
  const uint32_t tQ = smem_u32(sQ + wg * kB * D);
  const uint32_t tG = smem_u32(sG + wg * kB * D);
  const bool rows_full = q0 + kB <= tq;
  for (int it = 0, stage = 0; t < t_end; ++it) {
    const int fill = (stage + kStages - 1) % kStages;
    if (fetch < t_end) {
      issue(fetch, fill, false);
      fetch = next_tile(fetch + 1);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    mbar_wait(&bars[stage], (it / kStages) & 1);
    __syncthreads();   // stage `stage` landed for every thread

    if (sees(wg, t)) {
      const int k0 = t * kB;
      const uint32_t tK = smem_u32(sKV + 2 * stage * kB * D);
      const uint32_t tV = tK + kB * D * sizeof(bf16);
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<64>::ss(s, desc_kmajor(tQ, kk), desc_kmajor(tK, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<64>::ss(dp, desc_kmajor(tG, kk), desc_kmajor(tV, kk), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // dS = P * (dP - delta), P = exp2(S - lse2) where allowed, else 0. A
      // tile wholly inside the rows, the columns, the causal extent and the
      // window, with no mask or segments, needs no per-element test.
      bool full = !HasMask && rows_full && k0 + kB <= tk;
      if constexpr (Ext) {
        const int mn = wg ? qmin[1] : qmin[0], mx = wg ? qmax[1] : qmax[0];
        full = full && mask.ptr == nullptr && segk_row == nullptr &&
               (posk_row != nullptr
                    ? posk_mm[2 * t + 1] <= mn &&
                          (ext.window <= 0 ||
                           static_cast<long long>(mx) - posk_mm[2 * t] <
                               ext.window)
                    : (!causal || k0 + kB - 1 <= rel + q0) &&
                          (ext.window <= 0 ||
                           rel + q0 + kB - 1 - k0 < ext.window));
      } else {
        full = full && (!causal || k0 + kB - 1 <= rel + q0);
      }
      const int* sv = sVec + 2 * stage * kB;
      auto scores = [&](auto tested) {
        constexpr bool kTest = decltype(tested)::value;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int h = (i >> 1) & 1;
          const int cl = acc_col(i);
          const int col = k0 + cl;
          bool valid = true;
          if constexpr (kTest) {
            valid = row_ok[h] && col < tk && (!causal || col <= row_pos[h]);
            if constexpr (HasMask) valid = valid && !mrow[h][col];
          }
          float sc = s[i];
          float dpv = dp[i];
          if constexpr (Ext) {
            // pos_q - pos_k, as in K1.
            const long long back =
                posk_row != nullptr
                    ? static_cast<long long>(pos_r[h]) - sv[kB + cl]
                    : row_pos[h] - col;
            if constexpr (kTest) {
              if (mrow[h] != nullptr) valid = valid && !mrow[h][col];
              if (posk_row != nullptr) valid = valid && back >= 0;
              if (ext.window > 0) valid = valid && back < ext.window;
              if (segk_row != nullptr) valid = valid && seg_r[h] == sv[cl];
            }
            if (ext.alibi != nullptr)
              sc = __fadd_rn(sc, __fmul_rn(slope, static_cast<float>(-back)));
            if (ext.dropout) {
              const unsigned int ch =
                  static_cast<unsigned int>(posk_row != nullptr
                                                ? sv[kB + cl]
                                                : kv_offset + col) *
                  2246822519u;
              dpv = drop_hash(drop_rh[h], ch, drop_bs) >= ext.drop_threshold
                        ? dpv * ext.drop_inv : 0.f;
            }
          }
          const float p = valid ? exp2f(sc - lse_r[h]) : 0.f;
          dp[i] = p * (dpv - delta_r[h]);
        }
      };
      if (full)
        scores(std::false_type());
      else
        scores(std::true_type());
      uint32_t ds[4][4];
      to_frags(dp, ds);

      // dQ += dS . K, dS from registers, K read MN-major.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<D>::rs(acc, ds[kk], desc_mnmajor(tK, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    __syncthreads();   // every thread done with `stage` before its refill
    t = next_tile(t + 1);
    stage = stage + 1 == kStages ? 0 : stage + 1;
  }
  cp_async_wait<0>();

  OutT* out = dq + qoff * D;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = q0 + acc_row(i);
    if (row < tq)
      store_pair(out + static_cast<size_t>(row) * D + acc_col(i),
                 acc[i] * scale, acc[i + 1] * scale);
  }
}

// Per stage, the query tile's float32 row vectors: lse2 and delta, and
// with Quant its q scales sqf.
template <bool Quant>
constexpr int kRowVecs = Quant ? 3 : 2;

template <int D, bool Ext, bool Quant>
constexpr size_t dkv_smem_bytes() {
  return sizeof(bf16) * (2 * kRows + 2 * kStages * kB) * D  // sK, sV; sQ, sG
         + (Quant ? kStages * kB * D : 0)                   // int8 q
         + kStages * kRowVecs<Quant> * kB * sizeof(float)   // lse2, delta, sqf
         + (Ext ? kStages * 2 * kB * sizeof(int) : 0)       // segq, posq
         + kStages * sizeof(uint64_t);                      // the barriers
}

// dk and dv for one 128-row key block of one kv head: K and V stay in
// shared memory, the query tiles of every head of the GQA group stream
// through the stages (q2 and dO by TMA, one barrier a stage; lse2 and
// delta by cp.async); each warpgroup's S^T, dP^T, P^T and dS^T live in its
// registers and the group's sums in its float32 accumulators. The tensor
// maps as for dq; with Quant, map_k is the int8 k (resident, in the first
// half of K's room), map_q the dequantized q~ and map_q8 the int8 q (its
// own stage slots). dK is scaled by dk_mul on the way out.
template <int D, bool HasMask, typename OutT, bool Ext, bool Quant>
__global__ void __launch_bounds__(kBlockThreads)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_g,
                     const __grid_constant__ CUtensorMap map_q8,
                     const float* __restrict__ lse2,
                     const float* __restrict__ delta, OutT* __restrict__ dk,
                     OutT* __restrict__ dv, MaskArgs mask, int tq, int tk,
                     int group, int causal, int causal_offset, int kv_offset,
                     int n_qtiles, float dk_mul, ExtArgs ext) {
  static_assert(D % 32 == 0 && D <= 128, "head dim must be 32*n <= 128");
  static_assert(!(HasMask && Ext), "Ext reads the mask at run time");
  static_assert(!Quant || (Ext && !HasMask), "int8 scoring is Ext");
  constexpr int kRV = kRowVecs<Quant>;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);   // warpgroup w's keys at w*kB*D
                                              // (int8: byte w*kB*D)
  bf16* sV = sK + kRows * D;
  bf16* sQG = sV + kRows * D;   // stage s: q2 at sQG + 2s*kB*D, dO after it
  signed char* sQ8 = reinterpret_cast<signed char*>(
      sQG + 2 * kStages * kB * D);   // Quant, stage s: int8 q at s*kB*D
  float* sRow = reinterpret_cast<float*>(
      sQ8 + (Quant ? kStages * kB * D : 0));   // stage s at kRV*s*kB:
                                               // lse2, delta, sqf
  int* sVec = reinterpret_cast<int*>(sRow + kStages * kRV * kB);   // stage
                                           // s: segq at 2s*kB, posq after
  uint64_t* bars = reinterpret_cast<uint64_t*>(sVec +
                                               (Ext ? kStages * 2 * kB : 0));
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(&bars[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Early key blocks are seen by the most query rows under causal
  // masking: they launch first.
  const int kb0 = static_cast<int>(blockIdx.y) * kRows;
  const int bkv = blockIdx.x;
  const int wg = threadIdx.x / kThreads;
  const int k0 = kb0 + wg * kB;   // this warpgroup's first key
  const size_t kvoff = static_cast<size_t>(bkv) * tk * D;

  // Warpgroup w's keys are seen by query tiles [qt_lo[w], qt_hi[w]): row r
  // sees key column c when rel + r >= c; with a window, rows r < window +
  // (c + 63) - rel still see the tile's newest key.
  const long long rel = static_cast<long long>(causal_offset) - kv_offset;
  int qt_lo[kWgs], qt_hi[kWgs];
#pragma unroll
  for (int w = 0; w < kWgs; ++w) {
    const int c0 = kb0 + w * kB;
    qt_lo[w] = qt_hi[w] = 0;
    if (c0 >= tk) continue;
    qt_hi[w] = n_qtiles;
    if (causal) {
      const long long r_min = static_cast<long long>(c0) - rel;
      qt_lo[w] = r_min <= 0 ? 0
               : (r_min >= tq ? n_qtiles : static_cast<int>(r_min / kB));
    }
    if constexpr (Ext) {
      if (causal && ext.window > 0) {
        const long long r_end = ext.window + c0 + kB - 1 - rel;
        qt_hi[w] = r_end <= 0 ? 0
                 : (r_end >= tq ? n_qtiles
                                : static_cast<int>((r_end + kB - 1) / kB));
      }
    }
  }
  // Does warpgroup w see query tile qt of head h? Positions: K1's skip,
  // seen from the key side (the same in every thread).
  auto sees = [&](int w, int h, int qt) {
    const int lo = w ? qt_lo[1] : qt_lo[0], hi = w ? qt_hi[1] : qt_hi[0];
    bool yes = qt >= lo && qt < hi;
    if constexpr (Ext) {
      if (yes && ext.posk.ptr != nullptr) {
        const int bh = bkv * group + h;
        const int* posq_mm = vec_row(ext.posq_mm, bh);
        const int* posk_mm = vec_row(ext.posk_mm, bh) + 2 * (kb0 / kB + w);
        yes = !(posk_mm[0] > posq_mm[2 * qt + 1] ||
                (ext.window > 0 &&
                 static_cast<long long>(posq_mm[2 * qt]) - posk_mm[1] >=
                     ext.window));
      }
    }
    return yes;
  };
  const int qt_begin = qt_lo[0] < qt_lo[1] ? qt_lo[0] : qt_lo[1];
  const int qt_end = qt_hi[0] > qt_hi[1] ? qt_hi[0] : qt_hi[1];
  // Work items run over (head of the group, query tile); the next one from
  // item (h, qt) on that a warpgroup sees, or h == group when none is left.
  auto next_item = [&](int& h, int& qt) {
    while (h < group) {
      if (qt >= qt_end) {
        ++h;
        qt = qt_begin;
      } else if (!sees(0, h, qt) && !sees(1, h, qt)) {
        ++qt;
      } else {
        return;
      }
    }
  };
  // Loads item (h, qt) (and, with `resident`, the block's K and V rows)
  // into a stage: thread 0 announces the tiles' bytes and starts their TMA
  // copies, the first 64 threads copy the row vectors.
  auto issue = [&](int h, int qt, int stage, bool resident) {
    const int bh = bkv * group + h;
    const size_t qoff = static_cast<size_t>(bh) * tq;
    bf16* sQ = sQG + 2 * stage * kB * D;
    float* sr = sRow + kRV * stage * kB;
    if (threadIdx.x == 0) {
      uint64_t* bar = &bars[stage];
      // Resident: K (int8: 1 byte an element) and V for both warpgroups;
      // streamed: q2 (q~) and dO, and the int8 q.
      constexpr int kKB = Quant ? 1 : 2;
      mbar_expect_tx(bar, (resident ? kRows * D * (kKB + 2) : 0) +
                              (Quant ? 5 : 4) * kB * D);
      if (resident) {
        for (int w = 0; w < kWgs; ++w) {
          if constexpr (Quant)
            tma_tile<D>(reinterpret_cast<signed char*>(sK) + w * kB * D,
                        &map_k, kb0 + w * kB, bkv, bar);
          else
            tma_tile<D>(sK + w * kB * D, &map_k, kb0 + w * kB, bkv, bar);
          tma_tile<D>(sV + w * kB * D, &map_v, kb0 + w * kB, bkv, bar);
        }
      }
      tma_tile<D>(sQ, &map_q, qt * kB, bh, bar);
      tma_tile<D>(sQ + kB * D, &map_g, qt * kB, bh, bar);
      if constexpr (Quant)
        tma_tile<D>(sQ8 + stage * kB * D, &map_q8, qt * kB, bh, bar);
    }
    load_vec_async(sr, lse2 + qoff, qt * kB, tq);
    load_vec_async(sr + kB, delta + qoff, qt * kB, tq);
    if constexpr (Quant)
      load_vec_async(sr + 2 * kB, ext.sqf + qoff, qt * kB, tq);
    if constexpr (Ext) {
      int* sv = sVec + 2 * stage * kB;
      if (ext.segq.ptr != nullptr)
        load_vec_async(sv, vec_row(ext.segq, bh), qt * kB, tq);
      if (ext.posq.ptr != nullptr)
        load_vec_async(sv + kB, vec_row(ext.posq, bh), qt * kB, tq);
    }
  };

  // This thread's two key rows of the accumulator layout: lr and lr + 8 of
  // its warpgroup's tile.
  const int lr = acc_row(0);
  bool krow_ok[2];
  int kpos[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    kpos[j] = k0 + lr + 8 * j;
    krow_ok[j] = kpos[j] < tk;
  }
  // Quant: the block's k row scales in the unused half of sK (the loop's
  // first barrier orders them before their use).
  float* sSkr = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(sK) + kRows * D);
  if constexpr (Quant) {
    if (threadIdx.x < kRows)
      sSkr[threadIdx.x] = kb0 + threadIdx.x < tk
          ? ext.skr[static_cast<size_t>(bkv) * tk + kb0 + threadIdx.x] : 0.f;
  }

  float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  int h = 0, qt = qt_begin;
  next_item(h, qt);
  int fh = h, fqt = qt;   // the next item to load, kStages - 1 ahead
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (fh < group) {
      issue(fh, fqt, s, s == 0);
      ++fqt;
      next_item(fh, fqt);
    }
    cp_async_commit();
  }
  const uint32_t tK = smem_u32(reinterpret_cast<unsigned char*>(sK) +
                              wg * kB * D * (Quant ? 1 : 2));
  const uint32_t tV = smem_u32(sV + wg * kB * D);
  // The head's state: mask rows, the key rows' segments and positions, the
  // key tile's position range, the dropout salt and ALiBi slope (read per
  // query head, as they are addressed).
  int cur_h = -1;
  const unsigned char* mbase = nullptr;
  const int* posq_mm = nullptr;
  int kmin = 0, kmax = 0;
  int segk_r[2] = {0, 0}, posk_r[2] = {0, 0};
  unsigned int drop_ch[2] = {0u, 0u};
  unsigned int drop_bs = 0u;
  float slope = 0.f;
  for (int it = 0, stage = 0; h < group; ++it) {
    const int fill = (stage + kStages - 1) % kStages;
    if (fh < group) {
      issue(fh, fqt, fill, false);
      ++fqt;
      next_item(fh, fqt);
    }
    cp_async_commit();
    if (h != cur_h) {
      cur_h = h;
      const int bh = bkv * group + h;
      if (HasMask || (Ext && mask.ptr != nullptr)) mbase = mask_base(mask, bh);
      if constexpr (Ext) {
        drop_bs = ext.seed + static_cast<unsigned int>(bh) * 668265263u;
        if (ext.alibi != nullptr) slope = ext.alibi[bh];
        if (ext.posk.ptr != nullptr && k0 < tk) {
          posq_mm = vec_row(ext.posq_mm, bh);
          kmin = vec_row(ext.posk_mm, bh)[2 * (k0 / kB)];
          kmax = vec_row(ext.posk_mm, bh)[2 * (k0 / kB) + 1];
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (ext.segq.ptr != nullptr)
            segk_r[j] = krow_ok[j] ? vec_row(ext.segk, bh)[kpos[j]] : 0;
          if (ext.posk.ptr != nullptr)
            posk_r[j] = krow_ok[j] ? vec_row(ext.posk, bh)[kpos[j]] : 0;
          drop_ch[j] = static_cast<unsigned int>(
                           ext.posk.ptr != nullptr
                               ? posk_r[j]
                               : static_cast<long long>(kv_offset) + kpos[j]) *
                       2246822519u;
        }
      }
    }
    cp_async_wait<kStages - 1>();
    mbar_wait(&bars[stage], (it / kStages) & 1);
    __syncthreads();   // stage `stage` landed for every thread

    if (sees(wg, h, qt)) {
      const int q0 = qt * kB;
      const uint32_t tQ = smem_u32(sQG + 2 * stage * kB * D);
      const uint32_t tG = tQ + kB * D * sizeof(bf16);
      const float* sLse = sRow + kRV * stage * kB;
      const float* sDelta = sLse + kB;
      const int* sSegQ = sVec + 2 * stage * kB;
      const int* sPosQ = sSegQ + kB;
      // Transposed blocks: rows are this warpgroup's keys, columns the
      // queries.
      float s[32], dp[32];
      if constexpr (Quant) {
        // S^T = k8 q8^T as int32 dots (k32 steps), then (float(dot) *
        // sqf_q) * skr_k: the q scale first, as the forward applies it.
        const uint32_t tQ8 = smem_u32(sQ8 + stage * kB * D);
        int dot[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          dot[i] = 0;
          dp[i] = 0.f;
        }
        fence_regs(dot);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 32; ++kk)
          Wgmma<64>::ss(dot, desc_kmajor(tK, kk), desc_kmajor(tQ8, kk), kk);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<64>::ss(dp, desc_kmajor(tV, kk), desc_kmajor(tG, kk), kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dot);
        fence_regs(dp);
        const float2* sqf2 = reinterpret_cast<const float2*>(sLse + 2 * kB);
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const float2 c = sqf2[acc_col(i) / 2];
          const float r = sSkr[wg * kB + lr + 8 * ((i >> 1) & 1)];
          s[i] = __fmul_rn(__fmul_rn(static_cast<float>(dot[i]), c.x), r);
          s[i + 1] = __fmul_rn(__fmul_rn(static_cast<float>(dot[i + 1]), c.y),
                               r);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
        fence_regs(s);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<64>::ss(s, desc_kmajor(tK, kk), desc_kmajor(tQ, kk), kk);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<64>::ss(dp, desc_kmajor(tV, kk), desc_kmajor(tG, kk), kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
      }

      // P^T into s (the dropped, rescaled weights dv takes), dS^T into dp.
      // A tile wholly inside the rows, the columns, the causal extent and
      // the window, with no mask or segments, needs no per-element test.
      bool full = !HasMask && k0 + kB <= tk && q0 + kB <= tq;
      if constexpr (Ext) {
        full = full && mask.ptr == nullptr && ext.segq.ptr == nullptr &&
               (ext.posq.ptr != nullptr
                    ? kmax <= posq_mm[2 * qt] &&
                          (ext.window <= 0 ||
                           static_cast<long long>(posq_mm[2 * qt + 1]) -
                                   kmin <
                               ext.window)
                    : (!causal || k0 + kB - 1 <= rel + q0) &&
                          (ext.window <= 0 ||
                           rel + q0 + kB - 1 - k0 < ext.window));
      } else {
        full = full && (!causal || k0 + kB - 1 <= rel + q0);
      }
      auto scores = [&](auto tested) {
        constexpr bool kTest = decltype(tested)::value;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int j = (i >> 1) & 1;
          const int qc = acc_col(i);
          const int qrow = q0 + qc;
          bool valid = true;
          if constexpr (kTest) {
            valid = krow_ok[j] && qrow < tq &&
                    (!causal || kpos[j] <= rel + qrow);
            if constexpr (HasMask)
              valid = valid &&
                      !mbase[static_cast<long long>(qrow) * mask.sr + kpos[j]];
          }
          float sc = s[i];
          float dpv = dp[i];
          float keep_mul = 1.f;
          if constexpr (Ext) {
            // pos_q - pos_k, as in K1.
            const long long back =
                ext.posq.ptr != nullptr
                    ? static_cast<long long>(sPosQ[qc]) - posk_r[j]
                    : rel + qrow - kpos[j];
            if constexpr (kTest) {
              if (mbase != nullptr)
                valid = valid &&
                        !mbase[static_cast<long long>(qrow) * mask.sr +
                               kpos[j]];
              if (ext.posq.ptr != nullptr) valid = valid && back >= 0;
              if (ext.window > 0) valid = valid && back < ext.window;
              if (ext.segq.ptr != nullptr)
                valid = valid && sSegQ[qc] == segk_r[j];
            }
            if (ext.alibi != nullptr)
              sc = __fadd_rn(sc, __fmul_rn(slope, static_cast<float>(-back)));
            if (ext.dropout) {
              const unsigned int rh =
                  static_cast<unsigned int>(ext.posq.ptr != nullptr
                                                ? sPosQ[qc]
                                                : causal_offset + qrow) *
                  2654435761u;
              keep_mul = drop_hash(rh, drop_ch[j], drop_bs) >=
                                 ext.drop_threshold
                             ? ext.drop_inv : 0.f;
              dpv = keep_mul == 0.f ? 0.f : dpv * keep_mul;
            }
          }
          const float p = valid ? exp2f(sc - sLse[qc]) : 0.f;
          float pn = p;
          if constexpr (Ext) {
            if (ext.dropout) pn = keep_mul == 0.f ? 0.f : p * keep_mul;
          }
          s[i] = pn;
          dp[i] = p * (dpv - sDelta[qc]);
        }
      };
      if (full)
        scores(std::false_type());
      else
        scores(std::true_type());
      uint32_t pt[4][4], dst[4][4];
      to_frags(s, pt);
      to_frags(dp, dst);

      // dV += P^T . dO and dK += dS^T . q2 (q~), the query tiles read
      // MN-major.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<D>::rs(acc_dv, pt[kk], desc_mnmajor(tG, kk), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<D>::rs(acc_dk, dst[kk], desc_mnmajor(tQ, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_dv);
      fence_regs(acc_dk);
    }
    __syncthreads();   // every thread done with `stage` before its refill
    ++qt;
    next_item(h, qt);
    stage = stage + 1 == kStages ? 0 : stage + 1;
  }
  cp_async_wait<0>();

  // dk: dk_mul is 1/log2(e) for the folded q2, which carries
  // scale*log2(e), and the softmax scale for q~.
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = k0 + acc_row(i);
    if (row < tk) {
      const size_t at = kvoff + static_cast<size_t>(row) * D + acc_col(i);
      store_pair(dk + at, acc_dk[i] * dk_mul, acc_dk[i + 1] * dk_mul);
      store_pair(dv + at, acc_dv[i], acc_dv[i + 1]);
    }
  }
}

// int8 scoring's dq (the Quant instantiation of dq): the first version's
// body, on nvcuda::wmma fragments with score blocks through shared memory.
// Each warp owns 16 rows of every score block.

template <int D>
constexpr size_t dq_i8_smem_bytes() {
  return sizeof(bf16) * (4 * kB * D     // sQ (int8 q), sG, sK, sV
                         + kB * kB)     // sDS
         + sizeof(float) * 2 * kB * kB  // sS, sDP (the epilogue's stage)
         + kB * D                       // sK8
         + kB * (2 * sizeof(int) + sizeof(float));   // sSegK, sSkr, sPosK
}

template <int D, typename OutT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_i8_kernel(const bf16* __restrict__ v,
                       const bf16* __restrict__ g,
                       const float* __restrict__ lse2,
                       const float* __restrict__ delta, OutT* __restrict__ dq,
                       MaskArgs mask, int tq, int tk, int group, int causal,
                       int causal_offset, int kv_offset, float scale,
                       int n_qtiles, ExtArgs ext) {
  static_assert(D % 16 == 0 && D <= 128, "head dim must be 16*n <= 128");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sG = sQ + kB * D;
  bf16* sK = sG + kB * D;
  bf16* sV = sK + kB * D;
  bf16* sDS = sV + kB * D;
  float* sS = reinterpret_cast<float*>(sDS + kB * kB);
  float* sDP = sS + kB * kB;
  // The int8 q tile in the sQ region, the int8 k tile in sK8 and its
  // dequantized bf16 copy (the ds.k operand) in sK.
  signed char* sQ8 = reinterpret_cast<signed char*>(sQ);
  signed char* sK8 = reinterpret_cast<signed char*>(sDP + kB * kB);
  int* sSegK = reinterpret_cast<int*>(sK8 + kB * D);
  float* sSkr = reinterpret_cast<float*>(sSegK + kB);
  int* sPosK = reinterpret_cast<int*>(sSkr + kB);

  // Late query tiles see the most keys under causal masking: first.
  const int tile = n_qtiles - 1 - static_cast<int>(blockIdx.y);
  const int bh = blockIdx.x;
  const int bkv = bh / group;
  const int q0 = tile * kB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const size_t qoff = static_cast<size_t>(bh) * tq;
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
  if (causal && ext.window > 0) {
    const long long first = rel + q0 - ext.window + 1;
    t_begin = first <= 0 ? 0
            : (first >= kv_end ? n_ktiles : static_cast<int>(first) / kB);
  }

  load_i8_tile<D>(sQ8, ext.q8 + qoff * D, q0, tq);
  load_tile<D>(sG, g + qoff * D, q0, tq);

  // Elementwise ownership: lanes (2r, 2r+1) of warp w hold query row
  // w*16 + r, 32 key columns each.
  const int my_row = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const bool row_ok = q0 + my_row < tq;
  const long long row_pos = rel + q0 + my_row;
  const unsigned char* mrow = nullptr;
  if (row_ok && mask.ptr != nullptr)
    mrow = mask_base(mask, bh) + static_cast<long long>(q0 + my_row) * mask.sr;
  const float lse_r = row_ok ? lse2[qoff + q0 + my_row] : 0.f;
  const float delta_r = row_ok ? delta[qoff + q0 + my_row] : 0.f;
  const float sqf_r = row_ok ? ext.sqf[qoff + q0 + my_row] : 0.f;
  int seg_r = 0;
  const int* segk_row = nullptr;
  if (ext.segk.ptr != nullptr) {
    segk_row = vec_row(ext.segk, bh);
    seg_r = row_ok ? vec_row(ext.segq, bh)[q0 + my_row] : 0;
  }
  const float slope = ext.alibi != nullptr ? ext.alibi[bh] : 0.f;
  int pos_r = 0, qmin = 0, qmax = 0;
  const int* posk_row = nullptr;
  const int* posk_mm = nullptr;
  if (ext.posk.ptr != nullptr) {
    posk_row = vec_row(ext.posk, bh);
    posk_mm = vec_row(ext.posk_mm, bh);
    pos_r = row_ok ? vec_row(ext.posq, bh)[q0 + my_row] : 0;
    qmin = vec_row(ext.posq_mm, bh)[2 * tile];
    qmax = vec_row(ext.posq_mm, bh)[2 * tile + 1];
  }
  const unsigned int drop_rh =
      static_cast<unsigned int>(
          posk_row != nullptr ? pos_r : causal_offset + q0 + my_row) *
      2654435761u;
  const unsigned int drop_bs =
      ext.seed + static_cast<unsigned int>(bh) * 668265263u;

  FragC acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int t = t_begin; t < n_ktiles; ++t) {
    const int k0 = t * kB;
    // Positions: K1's tile skip (the same decision in every thread).
    if (posk_mm != nullptr &&
        (posk_mm[2 * t] > qmax ||
         (ext.window > 0 &&
          static_cast<long long>(qmin) - posk_mm[2 * t + 1] >= ext.window)))
      continue;
    __syncthreads();   // all warps done with the previous sK/sV
    load_i8_tile<D>(sK8, ext.k8 + static_cast<size_t>(bkv) * tk * D, k0, tk,
                    sK, ext.skc + static_cast<size_t>(bkv) * tk);
    load_tile<D>(sV, vb, k0, tk);
    for (int i = threadIdx.x; i < kB; i += kThreads) {
      const bool ok = k0 + i < tk;
      sSegK[i] = (segk_row != nullptr && ok) ? segk_row[k0 + i] : 0;
      sPosK[i] = (posk_row != nullptr && ok) ? posk_row[k0 + i] : 0;
      sSkr[i] = ok ? ext.skr[static_cast<size_t>(bkv) * tk + k0 + i] : 0.f;
    }
    __syncthreads();

    warp_abt_i8<D>(sQ8, warp * 16, sK8,
                   reinterpret_cast<int*>(sS) + warp * 16 * kB);
    warp_abt<D>(sG + warp * 16 * D, sV, sDP + warp * 16 * kB);
    __syncwarp();

    const int* srow = reinterpret_cast<const int*>(sS) + my_row * kB +
                      half * 32;
    const float* dprow = sDP + my_row * kB + half * 32;
    bf16* dsrow = sDS + my_row * kB + half * 32;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = k0 + half * 32 + c;
      // pos_q - pos_k, as in K1.
      const long long back = posk_row != nullptr
                                 ? static_cast<long long>(pos_r) -
                                       sPosK[half * 32 + c]
                                 : row_pos - col;
      bool valid = row_ok && col < tk && (!causal || col <= row_pos);
      if (mrow != nullptr) valid = valid && !mrow[col];
      if (posk_row != nullptr) valid = valid && back >= 0;
      if (ext.window > 0) valid = valid && back < ext.window;
      if (segk_row != nullptr) valid = valid && seg_r == sSegK[half * 32 + c];
      float sc = static_cast<float>(srow[c]) * sqf_r * sSkr[half * 32 + c];
      if (ext.alibi != nullptr)
        sc = __fadd_rn(sc, __fmul_rn(slope, static_cast<float>(-back)));
      float dpv = dprow[c];
      if (ext.dropout) {
        const unsigned int ch =
            static_cast<unsigned int>(posk_row != nullptr
                                          ? sPosK[half * 32 + c]
                                          : kv_offset + col) *
            2246822519u;
        dpv = drop_hash(drop_rh, ch, drop_bs) >= ext.drop_threshold
                  ? dpv * ext.drop_inv : 0.f;
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

// The maps of q2 and dO (batch_heads, tq, D) and of k and v (batch_heads /
// group, tk, D; k int8 with `k_i8`), in the kernels' parameter order; false
// when one fails.
template <int N>
bool operand_maps(CUtensorMap (&maps)[N], const void* q2, const void* k,
                  const void* v, const void* g, int batch_heads, int group,
                  int tq, int tk, int d, bool k_i8 = false) {
  return tile_map(&maps[0], q2, batch_heads, tq, d) &&
         tile_map(&maps[1], k, batch_heads / group, tk, d, k_i8) &&
         tile_map(&maps[2], v, batch_heads / group, tk, d) &&
         tile_map(&maps[3], g, batch_heads, tq, d);
}

template <int D, bool HasMask, typename OutT, bool Ext, bool Quant>
int launch_dq(const void* q2, const void* k, const void* v, const void* g,
              const void* lse2, const void* delta, void* dq,
              const MaskArgs& mask, int batch_heads, int group, int tq,
              int tk, int causal, int causal_offset, int kv_offset,
              float scale, const ExtArgs& ext, cudaStream_t stream) {
  const int n_qtiles = (tq + kB - 1) / kB;
  if (n_qtiles == 0 || batch_heads == 0) return 0;
  const float* lb = static_cast<const float*>(lse2);
  const float* db = static_cast<const float*>(delta);
  OutT* out = static_cast<OutT*>(dq);
  if constexpr (Quant) {
    // blockIdx.x the (batch, head) row, blockIdx.y the query tile from the
    // last.
    return launch(flash_bwd_dq_i8_kernel<D, OutT>,
                  dim3(batch_heads, n_qtiles), kThreads,
                  dq_i8_smem_bytes<D>(), stream, static_cast<const bf16*>(v),
                  static_cast<const bf16*>(g), lb, db, out, mask, tq, tk,
                  group, causal, causal_offset, kv_offset, scale, n_qtiles,
                  ext);
  } else {
    CUtensorMap maps[4];
    if (!operand_maps(maps, q2, k, v, g, batch_heads, group, tq, tk, D))
      return static_cast<int>(cudaErrorInvalidValue);
    // blockIdx.x the (batch, head) row, blockIdx.y the 128-row query block
    // from the last: every row's longest causal extents launch first.
    const int n_qblocks = (tq + kRows - 1) / kRows;
    return launch(flash_bwd_dq_kernel<D, HasMask, OutT, Ext>,
                  dim3(batch_heads, n_qblocks), kBlockThreads,
                  dq_smem_bytes<D, Ext>(), stream, maps[0], maps[1], maps[2],
                  maps[3], lb, db, out, mask, tq, tk, group, causal,
                  causal_offset, kv_offset, scale, n_qblocks, ext);
  }
}

template <int D, bool HasMask, typename OutT, bool Ext, bool Quant>
int launch_dkv(const void* q2, const void* k, const void* v, const void* g,
               const void* lse2, const void* delta, void* dk, void* dv,
               const MaskArgs& mask, int batch_heads, int group, int tq,
               int tk, int causal, int causal_offset, int kv_offset,
               float scale, const ExtArgs& ext, cudaStream_t stream) {
  if (tk == 0 || batch_heads == 0) return 0;
  // int8 scoring: k is the int8 k of ExtArgs and q2 the dequantized q~,
  // beside the int8 q.
  CUtensorMap maps[5];
  if (!operand_maps(maps, q2, Quant ? ext.k8 : k, v, g, batch_heads, group,
                    tq, tk, D, Quant) ||
      !tile_map(&maps[4], ext.q8, Quant ? batch_heads : 0, tq, D, true))
    return static_cast<int>(cudaErrorInvalidValue);
  // blockIdx.x the kv head, blockIdx.y the 128-row key block: every head's
  // early key blocks (seen by the most causal query rows) first.
  return launch(flash_bwd_dkv_kernel<D, HasMask, OutT, Ext, Quant>,
                dim3(batch_heads / group, (tk + kRows - 1) / kRows),
                kBlockThreads, dkv_smem_bytes<D, Ext, Quant>(), stream,
                maps[0], maps[1], maps[2], maps[3], maps[4],
                static_cast<const float*>(lse2),
                static_cast<const float*>(delta), static_cast<OutT*>(dk),
                static_cast<OutT*>(dv), mask, tq, tk, group, causal,
                causal_offset, kv_offset, (tq + kB - 1) / kB,
                Quant ? scale : kInvLog2e, ext);
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
// segments, window, dropout, int8 operands, ALiBi slopes and positions of
// ExtArgs (the Ext instantiations; with int8 operands dq reads neither q2
// nor k, and dk/dv reads the dequantized q~ as q2 and not k). All
// contiguous, bf16 unless stated. Returns a cudaError_t code (0 =
// launched).
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

// The dynamic shared memory a block of the dk/dv kernel takes at head dim
// d: the base instantiation, Ext, or Ext with int8 scoring (quant); 0 for
// a head dim the kernels do not take.
extern "C" long long flash_bwd_dkv_smem_bytes(int d, int ext, int quant) {
  switch (d) {
#define SMEM_CASE(D)                                                 \
    case D:                                                          \
      return quant ? dkv_smem_bytes<D, true, true>()                 \
                   : ext ? dkv_smem_bytes<D, true, false>()          \
                         : dkv_smem_bytes<D, false, false>();
    SMEM_CASE(32) SMEM_CASE(64) SMEM_CASE(96) SMEM_CASE(128)
#undef SMEM_CASE
    default:
      return 0;
  }
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
