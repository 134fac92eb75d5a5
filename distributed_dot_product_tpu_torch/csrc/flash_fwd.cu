// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 accumulation:
// kernel K1 and its bounded-softmax variant K2.
//
// Replaces the TPU kernels `_make_fwd_kernel` (exact softmax, K1) and
// `_make_fwd_kernel_bounded` (K2) in
// distributed_dot_product_tpu/ops/pallas_attention.py: causal masking with
// host-int global offsets of query row 0 and key column 0, a dense boolean
// mask, GQA, the optional row logsumexp that the backward recomputes from,
// and (the Ext instantiations) segment ids, a sliding window, the
// coordinate-hash dropout and int8 QK^T scoring; no explicit positions and
// no ALiBi.
//
// What bounds it on the H100: at the prefill shape (Tq = 1000 query rows
// against a 2048-row cache, head dim 96, causal) the work is ~6 GFLOP per
// layer against ~25 MB of q/k/v/o, so the floor is the HBM read of the
// operands (~7 us at 3.35 TB/s) with the tensor-core time just under it.
// The design keeps every score block out of device memory: one block owns a
// 64-row query tile and loops over 64-column key tiles up to the tile's
// causal extent (the TPU's sequential K grid axis becomes this in-block
// loop; tiles wholly in the causal future, including the unfilled tail of
// a cache buffer, are never loaded). Both products run on the tensor cores
// through nvcuda::wmma 16x16x16 bf16 fragments with f32 accumulators; the
// online softmax runs in shared memory, each warp owning 16 query rows so
// the softmax and the P.V product need only warp-level synchronisation.
// This is the simple first version: no cp.async/TMA pipelining and no
// register-resident accumulators, so it runs well below the bound.
//
// Numerics follow the TPU kernel: scale*log2(e) is folded into q (rounded
// back to bf16) so the softmax runs in exp2 units; the running max starts
// at NEG_BIG (finite), masked logits are -inf, and a row with no
// attendable key (l == 0) outputs exactly 0. With a non-null `lse` each
// row also writes ln2*(m2 + log2(l)), l == 0 counted as 1, as the TPU
// kernel saves it for the backward (a row with no attendable key writes
// ln2*NEG_BIG, which the ring merge and the backward rely on); a null
// `lse` (serving) writes nothing.
//
// Masks. Causal: row i (global position causal_offset + i) attends column
// j (global position kv_offset + j) when causal_offset + i >= kv_offset + j;
// tiles wholly past that are never loaded. Dense mask: a byte per (row,
// column), nonzero = masked, addressed through strides (batch, head, row;
// columns contiguous) so that a head-broadcast mask or a column slice of a
// wider mask needs no copy. Tiles that are wholly masked are still loaded
// (no per-tile summaries; the TPU's are an optimisation of that target).
// The mask and bounded flags are template parameters: the unmasked exact
// instantiation is the code the serving and training paths ran before.
//
// Ext (a template flag; ExtArgs at run time, a null field = unused):
//  - segments: one int32 id per query row and per key column (addressed
//    per flat (batch, head) row through strides, as the mask is); a pair
//    with different ids is masked. The key tile's ids are staged in shared
//    memory with the tile. No per-tile skip: a wholly cross-segment fold
//    loads every tile and writes out 0, lse ln2*NEG_BIG.
//  - window (needs causal): row i also drops column j when
//    (causal_offset + i) - (kv_offset + j) >= window; key tiles wholly
//    past the window of every row of the query tile are never loaded (the
//    TPU kernel's _causal_run arithmetic on both offsets).
//  - dropout: the reference's _dropout_keep in uint32 arithmetic, per
//    element, on the global row and column and the flat query (batch,
//    head) index; kept weights are scaled by 1/(1-rate) in the numerator
//    only, the row sum l (and so lse) stays undropped.
//  - a dense mask is read at run time (ExtArgs instantiations carry no
//    HasMask flag).
// Quant (with Ext): q and k arrive as per-row int8 with float32 row scales
// (sqf = the q scale times scale*log2(e), skr = the raw k scale); the
// score tile is an s8 x s8 -> s32 tensor-core product (wmma signed char
// 16x16x16 fragments; the int8 tiles sit in shared memory chunk-major,
// [d/16][64 rows][16], so every fragment starts 256-bit aligned) and each
// score is (float(dot) * sqf_i) * skr_j, the plain version's arithmetic
// bit for bit.
//
// K2 (Bounded): the running max is replaced by the per-row bound mvec (the
// wrapper computes it: ||q2_i|| * max_j ||k_j|| + 1, Cauchy-Schwarz in log2
// units), so the max reduction and both rescalings drop out. Softmax is
// shift-invariant, so K2 equals K1 while bound - rowmax stays inside the
// float32 exponent range; the wrapper runs K1 instead when 2*max(mvec) >
// 100 (the reference's guard). Built without flush-to-zero (no
// --use_fast_math, no -ftz): weights down to 2^-149 keep their denormals,
// as on the TPU, whose normal range also ends at 2^-126.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

constexpr int kBQ = 64;            // query rows per block: 4 warps x 16
constexpr int kBK = 64;            // key columns per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegBig = -0.7f * 3.4e38f;
constexpr float kLn2 = 0.693147180559945309f;

// A dense boolean mask: byte (b, h, row, col) at
// ptr + (bh / inner) * so + (bh % inner) * si + row * sr + col.
struct MaskArgs {
  const unsigned char* ptr;
  int inner;
  long long so, si, sr;
};

__device__ __forceinline__ const unsigned char* mask_row(const MaskArgs& m,
                                                         int bh, int row) {
  return m.ptr + (bh / m.inner) * m.so + (bh % m.inner) * m.si +
         static_cast<long long>(row) * m.sr;
}

// An int32 vector per flat (batch, head) row: element i of row bh at
// ptr + (bh / inner) * so + (bh % inner) * si + i (elements).
struct VecArgs {
  const int* ptr;
  int inner;
  long long so, si;
};

// The Ext instantiations' run-time arguments; a null pointer or a zero
// window / dropout flag leaves that feature off.
struct ExtArgs {
  VecArgs segq, segk;          // segment ids of query rows / key columns
  int window;                  // 0: none
  int dropout;                 // 0: none
  unsigned int drop_threshold; // keep when hash >= threshold
  float drop_inv;              // 1 / (1 - rate)
  unsigned int seed;
  const signed char* q8;       // (batch_heads, tq, d) int8 (Quant)
  const signed char* k8;       // (batch_heads / group, tk, d) int8
  const float* sqf;            // (batch_heads, tq): q row scale*scale*log2e
  const float* skr;            // (batch_heads / group, tk): raw k row scale
  const float* sqc;            // raw q row scale (backward)
  const float* skc;            // raw k row scale (backward)
};

__device__ __forceinline__ const int* vec_row(const VecArgs& a, int bh) {
  return a.ptr + (bh / a.inner) * a.so + (bh % a.inner) * a.si;
}

// The reference's _dropout_keep before the threshold: murmur3's fmix32 of
// row*2654435761 ^ col*2246822519 ^ (seed + b*668265263), all mod 2^32;
// `rh` is the row's term and `bs` the batch/seed term.
__device__ __forceinline__ unsigned int drop_hash(unsigned int rh,
                                                  unsigned int col,
                                                  unsigned int bs) {
  unsigned int x = rh ^ (col * 2246822519u) ^ bs;
  x ^= x >> 16;
  x *= 2246822507u;
  x ^= x >> 13;
  x *= 3266489909u;
  x ^= x >> 16;
  return x;
}

// Rows [row0, row0 + 64) of a (rows, D) int8 matrix into shared memory
// chunk-major ([D/16][64][16] bytes), 16 bytes a thread; rows at or past
// `limit` load as zeros.
template <int D>
__device__ __forceinline__ void load_i8_tile(signed char* dst,
                                             const signed char* src,
                                             int row0, int limit) {
  constexpr int kChunks = D / 16;
  for (int idx = threadIdx.x; idx < kBK * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit)
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(row0 + r) * D + c * 16);
    *reinterpret_cast<uint4*>(dst + (c * kBK + r) * 16) = val;
  }
}

template <int D, bool Ext = false>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * (kBQ * D        // sQ
                         + 2 * kBK * D  // sK, sV
                         + kBQ * kBK)   // sP
         + sizeof(float) * (kBQ * kBK   // sS
                            + kBQ * D)  // sO
         + (Ext ? kBK * (sizeof(int) + sizeof(float)) : 0);  // sSegK, sSkr
}

template <int D, bool HasMask, bool Bounded, bool Ext, bool Quant>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, const float* __restrict__ mvec,
                 MaskArgs mask, int tq, int tk, int group, int causal,
                 int causal_offset, int kv_offset, float qscale,
                 int n_qtiles, ExtArgs ext) {
  static_assert(!Quant || Ext, "int8 scoring is an Ext instantiation");
  static_assert(!(HasMask && Ext), "Ext reads the mask at run time");
  static_assert(D % 16 == 0 && D <= 128, "head dim must be 16*n <= 128");
  constexpr int kChunks = D / 8;   // 16-byte chunks per row
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kBQ * D;
  bf16* sV = sK + kBK * D;
  bf16* sP = sV + kBK * D;
  float* sS = reinterpret_cast<float*>(sP + kBQ * kBK);
  float* sO = sS + kBQ * kBK;
  // Ext: the key tile's segment ids and (Quant) raw k row scales; Quant:
  // the int8 q and k tiles in the sQ / sK regions.
  int* sSegK = reinterpret_cast<int*>(sO + kBQ * D);
  float* sSkr = reinterpret_cast<float*>(sSegK + kBK);
  signed char* sQ8 = reinterpret_cast<signed char*>(sQ);
  signed char* sK8 = reinterpret_cast<signed char*>(sK);

  // Late query tiles see the most keys under causal masking: schedule
  // them first so the short tiles fill the tail of the launch.
  const int tile = n_qtiles - 1 - static_cast<int>(blockIdx.x);
  const int bh = blockIdx.y;              // flat (batch, query head)
  const int bkv = bh / group;             // its kv head (GQA)
  const int q0 = tile * kBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const bf16* qb = q + static_cast<size_t>(bh) * tq * D;
  const bf16* kb = k + static_cast<size_t>(bkv) * tk * D;
  const bf16* vb = v + static_cast<size_t>(bkv) * tk * D;
  bf16* ob = out + static_cast<size_t>(bh) * tq * D;

  // Row i may attend local key column j when rel + i >= j.
  const long long rel = static_cast<long long>(causal_offset) - kv_offset;
  // Key columns any row of this tile may attend: [0, kv_end).
  int kv_end = tk;
  if (causal) {
    const int rows = (q0 + kBQ < tq ? q0 + kBQ : tq);
    const long long extent = rel + rows;
    kv_end = extent <= 0 ? 0 : (extent < tk ? static_cast<int>(extent) : tk);
  }
  const int n_ktiles = (kv_end + kBK - 1) / kBK;
  // Ext window: columns before the first one row q0 may still see.
  int t_begin = 0;
  if constexpr (Ext) {
    if (causal && ext.window > 0) {
      const long long first = rel + q0 - ext.window + 1;
      t_begin = first <= 0 ? 0
              : (first >= kv_end ? n_ktiles
                                 : static_cast<int>(first) / kBK);
    }
  }

  if constexpr (Quant) {
    load_i8_tile<D>(sQ8, ext.q8 + static_cast<size_t>(bh) * tq * D, q0, tq);
  } else {
    // q tile, pre-scaled by scale*log2(e) and rounded back to bf16; rows
    // past tq load as zeros (their outputs are never stored).
    for (int idx = threadIdx.x; idx < kBQ * kChunks; idx += kThreads) {
      const int r = idx / kChunks, c = idx % kChunks;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + r < tq) {
        val = *reinterpret_cast<const uint4*>(
            qb + static_cast<size_t>(q0 + r) * D + c * 8);
        bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          e[i] = __float2bfloat16(__bfloat162float(e[i]) * qscale);
      }
      *reinterpret_cast<uint4*>(sQ + r * D + c * 8) = val;
    }
  }
  for (int idx = threadIdx.x; idx < kBQ * D; idx += kThreads) sO[idx] = 0.f;
  __syncthreads();

  // Softmax ownership: lane pair (2r, 2r+1) of warp w holds row
  // w*16 + r, each lane half of the row's key columns / output features.
  const int my_row = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const bool row_ok = q0 + my_row < tq;
  const long long row_pos = rel + q0 + my_row;
  const unsigned char* mrow =
      (HasMask && row_ok) ? mask_row(mask, bh, q0 + my_row) : nullptr;
  // Ext: the row's segment id, the key side's id row, the dropout hash's
  // row and batch terms; Quant: the row's folded q scale.
  int seg_r = 0;
  const int* segk_row = nullptr;
  unsigned int drop_rh = 0u, drop_bs = 0u;
  float sqf_r = 0.f;
  if constexpr (Ext) {
    if (row_ok && mask.ptr != nullptr)
      mrow = mask_row(mask, bh, q0 + my_row);
    if (ext.segk.ptr != nullptr) {
      segk_row = vec_row(ext.segk, bh);
      seg_r = row_ok ? vec_row(ext.segq, bh)[q0 + my_row] : 0;
    }
    drop_rh = static_cast<unsigned int>(causal_offset + q0 + my_row) *
              2654435761u;
    drop_bs = ext.seed + static_cast<unsigned int>(bh) * 668265263u;
    if constexpr (Quant)
      sqf_r = row_ok ? ext.sqf[static_cast<size_t>(bh) * tq + q0 + my_row]
                     : 0.f;
  }
  // K1: the running max, from NEG_BIG. K2: the row's bound, fixed.
  float m_run = kNegBig;
  if constexpr (Bounded)
    m_run = row_ok ? mvec[static_cast<size_t>(bh) * tq + q0 + my_row] : 0.f;
  float l_run = 0.f;

  for (int t = t_begin; t < n_ktiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();   // all warps done with the previous sK/sV
    if constexpr (Quant) {
      load_i8_tile<D>(sK8, ext.k8 + static_cast<size_t>(bkv) * tk * D, k0,
                      tk);
      for (int idx = threadIdx.x; idx < kBK * kChunks; idx += kThreads) {
        const int r = idx / kChunks, c = idx % kChunks;
        uint4 vv = make_uint4(0u, 0u, 0u, 0u);
        if (k0 + r < tk)
          vv = *reinterpret_cast<const uint4*>(
              vb + static_cast<size_t>(k0 + r) * D + c * 8);
        *reinterpret_cast<uint4*>(sV + r * D + c * 8) = vv;
      }
    } else {
      for (int idx = threadIdx.x; idx < kBK * kChunks; idx += kThreads) {
        const int r = idx / kChunks, c = idx % kChunks;
        uint4 kv = make_uint4(0u, 0u, 0u, 0u);
        uint4 vv = make_uint4(0u, 0u, 0u, 0u);
        if (k0 + r < tk) {
          const size_t off = static_cast<size_t>(k0 + r) * D + c * 8;
          kv = *reinterpret_cast<const uint4*>(kb + off);
          vv = *reinterpret_cast<const uint4*>(vb + off);
        }
        *reinterpret_cast<uint4*>(sK + r * D + c * 8) = kv;
        *reinterpret_cast<uint4*>(sV + r * D + c * 8) = vv;
      }
    }
    if constexpr (Ext) {
      for (int i = threadIdx.x; i < kBK; i += kThreads) {
        const bool ok = k0 + i < tk;
        sSegK[i] = (segk_row != nullptr && ok) ? segk_row[k0 + i] : 0;
        if constexpr (Quant)
          sSkr[i] = ok ? ext.skr[static_cast<size_t>(bkv) * tk + k0 + i]
                       : 0.f;
      }
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows (log2 units: q is pre-scaled);
    // Quant: the int32 dots, scaled per element below.
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      if constexpr (Quant) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc;
        wmma::fill_fragment(acc, 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                         wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                         wmma::col_major> b;
          wmma::load_matrix_sync(a, sQ8 + (kk * kBQ + warp * 16) * 16, 16);
          wmma::load_matrix_sync(b, sK8 + (kk * kBK + j * 16) * 16, 16);
          wmma::mma_sync(acc, a, b, acc);
        }
        wmma::store_matrix_sync(
            reinterpret_cast<int*>(sS) + warp * 16 * kBK + j * 16, acc, kBK,
            wmma::mem_row_major);
      } else {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
          wmma::load_matrix_sync(a, sQ + warp * 16 * D + kk * 16, D);
          wmma::load_matrix_sync(b, sK + j * 16 * D + kk * 16, D);
          wmma::mma_sync(acc, a, b, acc);
        }
        wmma::store_matrix_sync(sS + warp * 16 * kBK + j * 16, acc, kBK,
                                wmma::mem_row_major);
      }
    }
    __syncwarp();

    // Online softmax over this tile's 64 columns of my_row.
    float sv[32];
    float mx = kNegBig;
    const float* srow = sS + my_row * kBK + half * 32;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = k0 + half * 32 + c;
      bool valid = col < tk && (!causal || col <= row_pos);
      if constexpr (HasMask) valid = valid && mrow != nullptr && !mrow[col];
      float sc = srow[c];
      if constexpr (Ext) {
        if (mrow != nullptr) valid = valid && !mrow[col];
        if (ext.window > 0) valid = valid && row_pos - col < ext.window;
        if (segk_row != nullptr)
          valid = valid && seg_r == sSegK[half * 32 + c];
        if constexpr (Quant)
          sc = static_cast<float>(reinterpret_cast<const int*>(srow)[c]) *
               sqf_r * sSkr[half * 32 + c];
      }
      sv[c] = valid ? sc : -INFINITY;
      if constexpr (!Bounded) mx = fmaxf(mx, sv[c]);
    }
    float m_new = m_run, corr = 1.f;
    if constexpr (!Bounded) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      m_new = fmaxf(m_run, mx);
      corr = exp2f(m_run - m_new);
    }
    float psum = 0.f;
    bf16* prow = sP + my_row * kBK + half * 32;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float p = exp2f(sv[c] - m_new);   // masked: exp2(-inf) = 0
      float pn = p;
      if constexpr (Ext) {
        // Dropout drops the numerator only: l sums the undropped p.
        if (ext.dropout) {
          const unsigned int col = static_cast<unsigned int>(
              kv_offset + k0 + half * 32 + c);
          pn = drop_hash(drop_rh, col, drop_bs) >= ext.drop_threshold
                   ? p * ext.drop_inv : 0.f;
        }
      }
      prow[c] = __float2bfloat16(pn);
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l_run = l_run * corr + psum;
    m_run = m_new;
    if constexpr (!Bounded) {
      float* orow = sO + my_row * D + half * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; ++c) orow[c] *= corr;
    }
    __syncwarp();

    // O += P V for this warp's 16 rows.
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, sO + warp * 16 * D + j * 16, D,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, sP + warp * 16 * kBK + kk * 16, kBK);
        wmma::load_matrix_sync(b, sV + kk * 16 * D + j * 16, D);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(sO + warp * 16 * D + j * 16, acc, D,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }

  // l == 0 <=> the row attends no key: output exactly 0.
  if (row_ok) {
    const float* orow = sO + my_row * D + half * (D / 2);
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
        ob + static_cast<size_t>(q0 + my_row) * D + half * (D / 2));
#pragma unroll
    for (int c = 0; c < D / 2; c += 2) {
      const float a = l_run == 0.f ? 0.f : orow[c] / l_run;
      const float b = l_run == 0.f ? 0.f : orow[c + 1] / l_run;
      dst[c / 2] = __floats2bfloat162_rn(a, b);
    }
    if (lse != nullptr && half == 0)
      lse[static_cast<size_t>(bh) * tq + q0 + my_row] =
          kLn2 * (m_run + log2f(l_run == 0.f ? 1.f : l_run));
  }
}

template <int D, bool HasMask, bool Bounded, bool Ext, bool Quant>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, const float* mvec, const MaskArgs& mask,
           int batch_heads, int group, int tq, int tk, int causal,
           int causal_offset, int kv_offset, float qscale,
           const ExtArgs& ext, cudaStream_t stream) {
  const size_t smem = smem_bytes<D, Ext>();
  auto kernel = flash_fwd_kernel<D, HasMask, Bounded, Ext, Quant>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qtiles = (tq + kBQ - 1) / kBQ;
  if (n_qtiles == 0 || batch_heads == 0) return 0;
  dim3 grid(n_qtiles, batch_heads);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, mvec, mask,
      tq, tk, group, causal, causal_offset, kv_offset, qscale, n_qtiles,
      ext);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dispatch(const void* q, const void* k, const void* v, void* out,
             float* lse, const float* mvec, const MaskArgs& mask,
             int batch_heads, int group, int tq, int tk, int causal,
             int causal_offset, int kv_offset, float qscale,
             const ExtArgs* ext, cudaStream_t s) {
  const ExtArgs none{};
#define FWD_LAUNCH(M, B, E, Q)                                               \
  return launch<D, M, B, E, Q>(q, k, v, out, lse, mvec, mask, batch_heads,  \
                               group, tq, tk, causal, causal_offset,        \
                               kv_offset, qscale, E ? *ext : none, s)
  // Built twice (csrc/../ops/_build.py): the base instantiations, and
  // with FLASH_EXT the Ext ones, each refusing the other's calls.
#ifdef FLASH_EXT
  if (ext == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (ext->q8 != nullptr) {
    // int8 scoring runs the exact kernel (the wrapper resolves
    // 'bounded' to it, as the reference does).
    if (mvec != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    FWD_LAUNCH(false, false, true, true);
  }
  if (mvec == nullptr) FWD_LAUNCH(false, false, true, false);
  if (ext->dropout) return static_cast<int>(cudaErrorInvalidValue);
  FWD_LAUNCH(false, true, true, false);
#else
  if (ext != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (mask.ptr == nullptr) {
    if (mvec == nullptr) FWD_LAUNCH(false, false, false, false);
    FWD_LAUNCH(false, true, false, false);
  }
  if (mvec == nullptr) FWD_LAUNCH(true, false, false, false);
  FWD_LAUNCH(true, true, false, false);
#endif
#undef FWD_LAUNCH
}

}  // namespace

// q (batch_heads, tq, d), k/v (batch_heads / group, tk, d), out like q;
// all contiguous bf16. lse: null, or (batch_heads, tq) float32. mvec: null
// (K1, exact softmax), or the (batch_heads, tq) float32 row bounds (K2).
// mask: null, or bytes addressed as MaskArgs (inner = heads; strides in
// bytes). ext: null (the base instantiations), or the segments, window,
// dropout and int8 operands of ExtArgs (the Ext instantiations, in the
// library built with FLASH_EXT; int8 and dropout with the exact kernel
// only). Returns a cudaError_t code (0 = launched).
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* out, void* lse, const void* mvec,
                              const void* mask, int mask_inner,
                              long long mask_so, long long mask_si,
                              long long mask_sr, int batch_heads, int group,
                              int tq, int tk, int d, int causal,
                              int causal_offset, int kv_offset, float qscale,
                              const void* ext, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const float* mv = static_cast<const float*>(mvec);
  const MaskArgs m{static_cast<const unsigned char*>(mask),
                   mask_inner > 0 ? mask_inner : 1, mask_so, mask_si,
                   mask_sr};
  const ExtArgs* e = static_cast<const ExtArgs*>(ext);
  switch (d) {
#define FWD_CASE(D)                                                       \
    case D:                                                               \
      return dispatch<D>(q, k, v, out, l, mv, m, batch_heads, group, tq,  \
                         tk, causal, causal_offset, kv_offset, qscale, e, \
                         s);
    FWD_CASE(32) FWD_CASE(64) FWD_CASE(96) FWD_CASE(128)
#undef FWD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
