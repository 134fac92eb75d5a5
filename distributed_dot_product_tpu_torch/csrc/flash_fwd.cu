// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 accumulation:
// kernel K1 and its bounded-softmax variant K2.
//
// Replaces the TPU kernels `_make_fwd_kernel` (exact softmax, K1) and
// `_make_fwd_kernel_bounded` (K2) in
// distributed_dot_product_tpu/ops/pallas_attention.py: causal masking with
// host-int global offsets of query row 0 and key column 0, a dense boolean
// mask, GQA, the optional row logsumexp that the backward recomputes from,
// int8 QK^T scoring (the Quant instantiations), and (the Ext
// instantiations) segment ids, a sliding window, the coordinate-hash
// dropout, ALiBi and explicit global positions.
//
// What bounds it on the H100: tensor-core operations. An attended (query,
// key) pair costs 4*d flops (S and P.V); at the LM's training shape (4 x 8
// heads, T = 4096, head dim 96, causal: 268 M pairs) that is 103 GFLOP,
// 0.10 ms at 989 TFLOP/s, against ~25 MB of q/k/v/o (0.008 ms at 3.35
// TB/s).
//
// The design (the backward's, csrc/flash_bwd.cu): a block is two
// warpgroups (256 threads), each owning one 64-row query tile of the
// block's 128 rows, and loops over 64-column key tiles up to the causal
// extent (the TPU's sequential K grid axis becomes this in-block loop;
// tiles wholly in the causal future, including the unfilled tail of a
// cache buffer, are never loaded).
//  - Every product is a wgmma (csrc/hopper.cuh): S = q.K^T an m64n64k16
//    (int8 scoring: m64n64k32 s8) with both operands in shared memory
//    (K-major), O += P.V an m64nDk16 with P from registers and V read
//    MN-major.
//  - S, P and O never leave registers. The online softmax runs on the
//    accumulator fragments: a row's 64 columns sit in the 4 lanes of a
//    quad, so its max is two shuffles; the O registers (D/2 floats a
//    thread) are rescaled by corr, and the 64-column P accumulator is,
//    element for element, the four m64k16 bf16 A fragments of P.V. A tile
//    wholly inside the rows, columns, causal extent and window, with no
//    mask or segments, skips the per-element tests.
//  - TMA loads the block's q rows once and streams K and V through three
//    stages, one mbarrier each, two tiles ahead of the one in use; both
//    warpgroups use every streamed tile (half the bytes a product against
//    one warpgroup a block). A dense mask's 128 x 64 bytes stage beside
//    their K/V tile by cp.async (16, 8 or 4 bytes a copy, the widest the
//    mask's address and strides allow; byte loads otherwise), the Ext
//    instantiations' key-side vectors likewise.
//  - The grid launches every (batch, head) row's longest causal extents
//    first. A warpgroup skips the key tiles its own rows do not see; the
//    block skips only those neither sees, so every barrier is uniform.
//  - The epilogue writes O / l from registers straight to device memory
//    (the ragged edge masked) and one lane a row writes the lse.
// No atomics: two runs of any case are equal bit for bit. At the LM's
// shape the streamed tiles' arrival sets the pace, as in K3/K4 (section
// timers: scripts/torch_k1_sections.py).
//
// Numerics follow the TPU kernel: scale*log2(e) is folded into q (rounded
// back to bf16, in shared memory after the load) so the softmax runs in
// exp2 units; the running max starts at NEG_BIG (finite), masked logits
// are -inf, and a row with no attendable key (l == 0) outputs exactly 0.
// With a non-null `lse` each row also writes ln2*(m2 + log2(l)), l == 0
// counted as 1, as the TPU kernel saves it for the backward (a row with no
// attendable key writes ln2*NEG_BIG, which the ring merge and the backward
// rely on); a null `lse` (serving) writes nothing.
//
// Masks. Causal: row i (global position causal_offset + i) attends column
// j (global position kv_offset + j) when causal_offset + i >= kv_offset + j;
// tiles wholly past that are never loaded. Dense mask: a byte per (row,
// column), nonzero = masked, addressed through strides (batch, head, row;
// columns contiguous) so that a head-broadcast mask or a column slice of a
// wider mask needs no copy. Tiles that are wholly masked are still loaded
// (no per-tile summaries; the TPU's are an optimisation of that target).
// The mask and bounded flags are template parameters.
//
// Ext (a template flag; ExtArgs at run time, a null field = unused):
//  - segments: one int32 id per query row and per key column (addressed
//    per flat (batch, head) row through strides, as the mask is); a pair
//    with different ids is masked. The key tile's ids are staged in shared
//    memory with the tile. No per-tile skip: a wholly cross-segment fold
//    loads every tile and writes out 0, lse ln2*NEG_BIG.
//  - window (needs causal): row i also drops column j when
//    (causal_offset + i) - (kv_offset + j) >= window; key tiles wholly
//    past the window of every row of a query tile are never loaded (the
//    TPU kernel's _causal_run arithmetic on both offsets).
//  - dropout: the reference's _dropout_keep in uint32 arithmetic, per
//    element, on the global row and column and the flat query (batch,
//    head) index; kept weights are scaled by 1/(1-rate) in the numerator
//    only, the row sum l (and so lse) stays undropped.
//  - a dense mask is read at run time (ExtArgs instantiations carry no
//    HasMask flag).
//  - positions (the zigzag ring's folds): one int32 global position per
//    query row and per key column, with causal off. A pair is masked when
//    pos_q < pos_k, and with a window when pos_q - pos_k >= window; the
//    dropout hash keys on (pos_q, pos_k). A key tile is skipped for a
//    query tile when its smallest position exceeds the query tile's
//    largest, or with a window when its largest lies a window or more
//    before the query tile's smallest: the wrapper passes each 64-row
//    tile's [min, max] of both vectors (the reference's _pos_setup
//    tables), so the zigzag layout's future half-blocks are never loaded.
//  - ALiBi: slope * (pos_k - pos_q) added to the log2-unit score after
//    the scoring and before the masks (the reference's _apply_masks
//    order), with the slope per flat (batch, head) row pre-folded by
//    log2(e) by the wrapper and the distance over global positions: the
//    position vectors when given, else kv_offset + j - (causal_offset +
//    i). Both operations round separately (__fmul_rn, __fadd_rn), as the
//    plain version's two tensor operations do.
// Quant (int8 scoring; exact; alone or with the Ext features): the same
// kernel with q and k arriving as per-row int8 with float32 row scales
// (sqf = the q scale times scale*log2(e), skr = the raw k scale). TMA loads the int8 q rows
// and each int8 K tile through int8 tensor maps into the bf16 tiles' byte
// geometry (d/16 panels of 64 rows x 16 bytes); V stays bf16, and each
// stage carries the K tile's 64 column scales beside it. S is an
// m64n64k32 s8 x s8 -> s32 wgmma (8-bit operands are K-major, which both
// are as stored), its int32 accumulator laid out as the float32 one, and
// each score is __fmul_rn(__fmul_rn(float(dot), sqf_i), skr_j): the plain
// version's (dot * sqf) * skr, bit for bit (the dot is exact; |dot| <
// 2^24 converts exactly). q is not folded: sqf carries scale*log2(e). The
// block's 128 sqf sit in the unused half of the q tile's room (kept out of
// registers: at d 128 every register counts).
//
// K2 (Bounded): the running max is replaced by the per-row bound mvec (the
// wrapper computes it: ||q2_i|| * max_j ||k_j|| + 1, Cauchy-Schwarz in log2
// units), so the max reduction and the rescaling of O drop out. Softmax is
// shift-invariant, so K2 equals K1 while bound - rowmax stays inside the
// float32 exponent range; the wrapper runs K1 instead when 2*max(mvec) >
// 100 (the reference's guard). Built without flush-to-zero (no
// --use_fast_math, no -ftz): weights down to 2^-149 keep their denormals,
// as on the TPU, whose normal range also ends at 2^-126.

#include <math.h>

#include <type_traits>

#include "hopper.cuh"   // kB, kWarps, kThreads and the Hopper helpers

namespace {

// The kernel: two warpgroups a block, one 64-row query tile each, and
// three stages for the streamed K/V tiles.
constexpr int kWgs = 2;
constexpr int kRows = kWgs * kB;
constexpr int kBlockThreads = kWgs * kThreads;
constexpr int kStages = 3;
constexpr float kNegBig = -0.7f * 3.4e38f;
constexpr float kLn2 = 0.693147180559945309f;

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
  const float* alibi;          // (batch_heads,): slope * log2e; null: none
  VecArgs posq, posk;          // global positions; posk.ptr null: none
  VecArgs posq_mm, posk_mm;    // per 64-row tile: [min, max] of posq/posk
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

// cp.async of N (4, 8 or 16) bytes of which the first `n` are read and
// the rest land as zeros.
template <int N>
__device__ __forceinline__ void cp_async_part(uint32_t dst, const void* src,
                                              int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(dst), "l"(src), "n"(N), "r"(n) : "memory");
}

// Columns [k0, k0 + 64) of the block's kRows query rows (from qb0) of a
// dense mask into a kRows x 64 byte stage, `w` bytes a copy: 16, 8 or 4 by
// cp.async, 1 by plain loads; bytes past tq or tk are never read (zeros).
__device__ __forceinline__ void load_mask_tile(unsigned char* dst,
                                               const unsigned char* base,
                                               long long sr, int qb0, int tq,
                                               int k0, int tk, int w) {
  const int ncols = tk - k0 < kB ? tk - k0 : kB;
  if (w == 1) {
    for (int idx = threadIdx.x; idx < kRows * kB; idx += kBlockThreads) {
      const int r = idx / kB, c = idx % kB;
      dst[idx] = (qb0 + r < tq && c < ncols)
                     ? base[static_cast<long long>(qb0 + r) * sr + k0 + c]
                     : 0;
    }
    return;
  }
  const int per_row = kB / w;
  for (int idx = threadIdx.x; idx < kRows * per_row; idx += kBlockThreads) {
    const int r = idx / per_row, c = (idx % per_row) * w;
    const bool row = qb0 + r < tq;
    int n = row ? ncols - c : 0;
    n = n < 0 ? 0 : (n > w ? w : n);
    const unsigned char* src =
        n > 0 ? base + static_cast<long long>(qb0 + r) * sr + k0 + c : base;
    const uint32_t d = smem_u32(dst + r * kB + c);
    if (w == 16)
      cp_async_part<16>(d, src, n);
    else if (w == 8)
      cp_async_part<8>(d, src, n);
    else
      cp_async_part<4>(d, src, n);
  }
}

// Per stage, the key-side vectors of the Ext instantiations: segment ids
// and positions, and with Quant the K tile's row scales.
template <bool Ext, bool Quant>
constexpr int kVecs = Quant ? 3 : (Ext ? 2 : 0);

template <int D, bool HasMask, bool Ext, bool Quant>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * (kRows + 2 * kStages * kB) * D   // sQ; sK, sV
         + ((HasMask || Ext) ? kStages * kRows * kB : 0)  // mask bytes
         + kStages * kVecs<Ext, Quant> * kB * sizeof(int) // segk, posk, skr
         + (kStages + 1) * sizeof(uint64_t);              // the barriers
}

// K1 (K2 with Bounded) for one 128-row query block of one (batch, head)
// row: q stays in shared memory, the key and value tiles stream through
// the stages (TMA, one barrier a stage); each warpgroup's S, P and O live
// in its registers. The tensor maps: q (batch_heads, tq, D), k and v
// (batch_heads / group, tk, D), 64-row x 16-byte boxes; with Quant q and k
// are the int8 operands. An int8 tile fills the first half of its bf16
// tile's room.
template <int D, bool HasMask, bool Bounded, bool Ext, bool Quant>
__global__ void __launch_bounds__(kBlockThreads)
flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 bf16* __restrict__ out, float* __restrict__ lse,
                 const float* __restrict__ mvec, MaskArgs mask, int mask_w,
                 int tq, int tk, int group, int causal, int causal_offset,
                 int kv_offset, float qscale, int n_qblocks, ExtArgs ext) {
  static_assert(D % 32 == 0 && D <= 128, "head dim must be 32*n <= 128");
  static_assert(!(HasMask && Ext), "Ext reads the mask at run time");
  static_assert(!Quant || (!HasMask && !Bounded),
                "int8 scoring is exact, its mask an Ext one");
  constexpr bool kMaskStage = HasMask || Ext;
  constexpr int kV = kVecs<Ext, Quant>;
  constexpr int kQB = Quant ? 1 : 2;   // bytes of a q or k element
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);   // warpgroup w's rows at
                                              // byte w*kB*D*kQB
  bf16* sKV = sQ + kRows * D;   // stage s: K at sKV + 2s*kB*D, V after it
  unsigned char* sMask = reinterpret_cast<unsigned char*>(
      sKV + 2 * kStages * kB * D);   // stage s at s*kRows*kB
  int* sVec = reinterpret_cast<int*>(
      sMask + (kMaskStage ? kStages * kRows * kB : 0));   // stage s at
                                       // kV*s*kB: segk, posk, skr (floats)
  uint64_t* bars = reinterpret_cast<uint64_t*>(sVec + kStages * kV * kB);
  uint64_t* qbar = bars + kStages;
  if (threadIdx.x == 0) {
    for (int st = 0; st <= kStages; ++st) mbar_init(&bars[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The longest causal extents (late query blocks) launch first.
  const int qb0 = (n_qblocks - 1 - static_cast<int>(blockIdx.y)) * kRows;
  const int bh = blockIdx.x;              // flat (batch, query head)
  const int bkv = bh / group;             // its kv head (GQA)
  const int wg = threadIdx.x / kThreads;
  const int q0 = qb0 + wg * kB;           // this warpgroup's first row
  const size_t qoff = static_cast<size_t>(bh) * tq;
  const bool has_mask = HasMask || (Ext && mask.ptr != nullptr);
  const unsigned char* mbase = has_mask ? mask_base(mask, bh) : nullptr;
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
  // Does warpgroup w see key tile t? Positions skip a tile wholly in the
  // query tile's future, or wholly a window or more in its past.
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
  // Loads key tile t into a stage: thread 0 announces the bytes and starts
  // the TMA copies; the mask bytes and key-side vectors by cp.async.
  auto issue = [&](int t, int stage) {
    bf16* sK = sKV + 2 * stage * kB * D;
    if (threadIdx.x == 0) {
      uint64_t* bar = &bars[stage];
      mbar_expect_tx(bar, (kQB + 2) * kB * D);
      if constexpr (Quant)
        tma_tile<D>(reinterpret_cast<signed char*>(sK), &map_k, t * kB, bkv,
                    bar);
      else
        tma_tile<D>(sK, &map_k, t * kB, bkv, bar);
      tma_tile<D>(sK + kB * D, &map_v, t * kB, bkv, bar);
    }
    if constexpr (kMaskStage) {
      if (has_mask)
        load_mask_tile(sMask + stage * kRows * kB, mbase, mask.sr, qb0, tq,
                       t * kB, tk, mask_w);
    }
    int* sv = sVec + kV * stage * kB;
    if constexpr (Ext) {
      if (segk_row != nullptr) load_vec_async(sv, segk_row, t * kB, tk);
      if (posk_row != nullptr) load_vec_async(sv + kB, posk_row, t * kB, tk);
    }
    if constexpr (Quant)
      load_vec_async(sv + 2 * kB, ext.skr + static_cast<size_t>(bkv) * tk,
                     t * kB, tk);
  };

  // The block's q rows, on their own barrier; rows past tq land as zeros.
  if (threadIdx.x == 0) {
    mbar_expect_tx(qbar, kRows * D * kQB);
    for (int w = 0; w < kWgs; ++w) {
      if constexpr (Quant)
        tma_tile<D>(reinterpret_cast<signed char*>(sQ) + w * kB * D, &map_q,
                    qb0 + w * kB, bh, qbar);
      else
        tma_tile<D>(sQ + w * kB * D, &map_q, qb0 + w * kB, bh, qbar);
    }
  }

  // This thread's two query rows of the accumulator layout: lr and lr + 8
  // of its warpgroup's tile. Ext: each row's segment id, position and
  // dropout row term, the (batch, head) row's dropout salt and ALiBi
  // slope. K1: the running max, from NEG_BIG; K2: the row's bound, fixed.
  const int lr = acc_row(0);
  bool row_ok[2];
  long long row_pos[2];
  float m_run[2], l_run[2] = {0.f, 0.f};
  int seg_r[2] = {0, 0}, pos_r[2] = {0, 0};
  unsigned int drop_rh[2] = {0u, 0u};
  unsigned int drop_bs = 0u;
  float slope = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + lr + 8 * h;
    row_ok[h] = row < tq;
    row_pos[h] = rel + row;
    m_run[h] = kNegBig;
    if constexpr (Bounded) m_run[h] = row_ok[h] ? mvec[qoff + row] : 0.f;
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

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

  int t = next_tile(t_lo[0] < t_lo[1] ? t_lo[0] : t_lo[1]);
  int fetch = t;   // the next tile to load, kStages - 1 ahead of t
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (fetch < t_end) {
      issue(fetch, s);
      fetch = next_tile(fetch + 1);
    }
    cp_async_commit();
  }

  // Quant: the block's q row scales sqf in the unused half of sQ (the
  // barrier below orders them before their use).
  float* sSqf = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(sQ) + kRows * D);
  if constexpr (Quant) {
    if (threadIdx.x < kRows)
      sSqf[threadIdx.x] =
          qb0 + threadIdx.x < tq ? ext.sqf[qoff + qb0 + threadIdx.x] : 0.f;
  }
  // Fold scale*log2(e) into q where it landed, rounding back to bf16 as
  // the TPU kernel does, then hand the tile to the async proxy (wgmma).
  // int8 q stays as it landed (sqf carries the fold).
  mbar_wait(qbar, 0);
  if constexpr (!Quant) {
    for (int idx = threadIdx.x; idx < kRows * D / 8; idx += kBlockThreads) {
      uint4* at = reinterpret_cast<uint4*>(sQ) + idx;
      uint4 val = *at;
      bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        e[i] = __float2bfloat16(__bfloat162float(e[i]) * qscale);
      *at = val;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  const uint32_t tQ =
      smem_u32(reinterpret_cast<unsigned char*>(sQ) + wg * kB * D * kQB);
  const bool rows_full = q0 + kB <= tq;
  for (int it = 0, stage = 0; t < t_end; ++it) {
    const int fill = (stage + kStages - 1) % kStages;
    if (fetch < t_end) {
      issue(fetch, fill);
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
      const int* sv = sVec + kV * stage * kB;
      float s[32];
      if constexpr (Quant) {
        // S = (float(q8 k8^T) * sqf) * skr, the int32 dots over k32 steps.
        int dot[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) dot[i] = 0;
        fence_regs(dot);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 32; ++kk)
          Wgmma<64>::ss(dot, desc_kmajor(tQ, kk), desc_kmajor(tK, kk), kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dot);
        const float2* skr2 = reinterpret_cast<const float2*>(sv + 2 * kB);
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const float2 c = skr2[acc_col(i) / 2];
          const float r = sSqf[wg * kB + lr + 8 * ((i >> 1) & 1)];
          s[i] = __fmul_rn(__fmul_rn(static_cast<float>(dot[i]), r), c.x);
          s[i + 1] = __fmul_rn(__fmul_rn(static_cast<float>(dot[i + 1]), r),
                               c.y);
        }
      } else {
        // S = q2 K^T (log2 units: q is folded).
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = 0.f;
        fence_regs(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<64>::ss(s, desc_kmajor(tQ, kk), desc_kmajor(tK, kk), kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
      }

      // Masked scores to -inf; ALiBi's bias. A tile wholly inside the
      // rows, the columns, the causal extent and the window, with no mask
      // or segments, needs no per-element test.
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
      const unsigned char* sm = sMask + stage * kRows * kB + (wg * kB + lr) * kB;
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
            if constexpr (HasMask) valid = valid && !sm[8 * h * kB + cl];
          }
          float sc = s[i];
          if constexpr (Ext) {
            // pos_q - pos_k: explicit positions, else the offsets'
            // arithmetic.
            const long long back =
                posk_row != nullptr
                    ? static_cast<long long>(pos_r[h]) - sv[kB + cl]
                    : row_pos[h] - col;
            if constexpr (kTest) {
              if (has_mask) valid = valid && !sm[8 * h * kB + cl];
              if (posk_row != nullptr) valid = valid && back >= 0;
              if (ext.window > 0) valid = valid && back < ext.window;
              if (segk_row != nullptr) valid = valid && seg_r[h] == sv[cl];
            }
            if (ext.alibi != nullptr)
              sc = __fadd_rn(sc, __fmul_rn(slope, static_cast<float>(-back)));
          }
          s[i] = valid ? sc : -INFINITY;
        }
      };
      if (full)
        scores(std::false_type());
      else
        scores(std::true_type());

      // The online softmax on the fragments: a row's 64 columns sit in the
      // 4 lanes of a quad (16 each).
      float corr[2] = {1.f, 1.f};
      if constexpr (!Bounded) {
        float mx[2] = {kNegBig, kNegBig};
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int h = (i >> 1) & 1;
          mx[h] = fmaxf(mx[h], s[i]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          const float m_new = fmaxf(m_run[h], mx[h]);
          corr[h] = exp2f(m_run[h] - m_new);
          m_run[h] = m_new;
        }
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      }
      // p = exp2(s - m) (masked: exp2(-inf) = 0); l sums the undropped p,
      // this thread's 16 columns of each row (the quad's sum at the end).
      float psum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i >> 1) & 1;
        const float p = exp2f(s[i] - m_run[h]);
        psum[h] += p;
        float pn = p;
        if constexpr (Ext) {
          // Dropout drops the numerator only.
          if (ext.dropout) {
            const int cl = acc_col(i);
            const unsigned int col = static_cast<unsigned int>(
                posk_row != nullptr ? sv[kB + cl] : kv_offset + k0 + cl);
            pn = drop_hash(drop_rh[h], col, drop_bs) >= ext.drop_threshold
                     ? p * ext.drop_inv : 0.f;
          }
        }
        s[i] = pn;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * corr[h] + psum[h];
      uint32_t pf[4][4];
      to_frags(s, pf);

      // O += P V, P from registers, V read MN-major.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<D>::rs(o, pf[kk], desc_mnmajor(tV, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }
    __syncthreads();   // every thread done with `stage` before its refill
    t = next_tile(t + 1);
    stage = stage + 1 == kStages ? 0 : stage + 1;
  }
  cp_async_wait<0>();

  // l over the quad; l == 0 <=> the row attends no key: output exactly 0.
  float l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = l_run[h] + __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  bf16* ob = out + qoff * D;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int h = (i >> 1) & 1;
    const int row = q0 + acc_row(i);
    if (row < tq) {
      const float a = l[h] == 0.f ? 0.f : o[i] / l[h];
      const float b = l[h] == 0.f ? 0.f : o[i + 1] / l[h];
      *reinterpret_cast<__nv_bfloat162*>(
          ob + static_cast<size_t>(row) * D + acc_col(i)) =
          __floats2bfloat162_rn(a, b);
    }
  }
  if (lse != nullptr && threadIdx.x % 4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row_ok[h])
        lse[qoff + q0 + lr + 8 * h] =
            kLn2 * (m_run[h] + log2f(l[h] == 0.f ? 1.f : l[h]));
  }
}

// Sets the kernel's dynamic shared memory and launches it; returns a
// cudaError_t code (0 = launched).
template <typename... Params, typename... Args>
int launch_kernel(void (*kernel)(Params...), dim3 grid, int threads,
                  size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// The widest copy (16, 8 or 4 bytes by cp.async; 1: byte loads) that
// every mask row's address allows: the base pointer and all three strides
// are multiples of it.
int mask_width(const MaskArgs& m) {
  const unsigned long long bits =
      reinterpret_cast<uintptr_t>(m.ptr) |
      static_cast<unsigned long long>(m.so) |
      static_cast<unsigned long long>(m.si) |
      static_cast<unsigned long long>(m.sr);
  for (int w = 16; w >= 4; w /= 2)
    if (bits % w == 0) return w;
  return 1;
}

template <int D, bool HasMask, bool Bounded, bool Ext, bool Quant>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, const float* mvec, const MaskArgs& mask,
           int batch_heads, int group, int tq, int tk, int causal,
           int causal_offset, int kv_offset, float qscale,
           const ExtArgs& ext, cudaStream_t stream) {
  if (tq == 0 || batch_heads == 0) return 0;
  // int8 scoring reads the int8 q and k of ExtArgs in place of q and k.
  CUtensorMap maps[3];
  if (!tile_map(&maps[0], Quant ? ext.q8 : q, batch_heads, tq, D, Quant) ||
      !tile_map(&maps[1], Quant ? ext.k8 : k, batch_heads / group, tk, D,
                Quant) ||
      !tile_map(&maps[2], v, batch_heads / group, tk, D))
    return static_cast<int>(cudaErrorInvalidValue);
  // blockIdx.x the (batch, head) row, blockIdx.y the 128-row query block
  // from the last: every row's longest causal extents launch first.
  const int n_qblocks = (tq + kRows - 1) / kRows;
  return launch_kernel(flash_fwd_kernel<D, HasMask, Bounded, Ext, Quant>,
                       dim3(batch_heads, n_qblocks), kBlockThreads,
                       smem_bytes<D, HasMask, Ext, Quant>(), stream, maps[0],
                       maps[1], maps[2], static_cast<bf16*>(out), lse, mvec,
                       mask, mask_width(mask), tq, tk, group, causal,
                       causal_offset, kv_offset, qscale, n_qblocks, ext);
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
                               kv_offset, qscale, (E || Q) ? *ext : none, s)
  // Built twice (csrc/../ops/_build.py): the base instantiations, and
  // with FLASH_EXT the Ext ones, each refusing the other's calls.
#ifdef FLASH_EXT
  if (ext == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (ext->q8 != nullptr) {
    // int8 scoring runs the exact kernel (the wrapper resolves
    // 'bounded' to it, as the reference does); alone, without the Ext
    // features' per-element work.
    if (mvec != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    if (mask.ptr == nullptr && ext->segk.ptr == nullptr &&
        ext->window == 0 && !ext->dropout && ext->alibi == nullptr &&
        ext->posk.ptr == nullptr)
      FWD_LAUNCH(false, false, false, true);
    FWD_LAUNCH(false, false, true, true);
  }
  if (mvec == nullptr) FWD_LAUNCH(false, false, true, false);
  if (ext->dropout || ext->alibi != nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
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

// The dynamic shared memory a block of the exact kernel takes at head dim
// d: the base or the Ext instantiation, with int8 scoring (quant) or not;
// 0 for a head dim the kernels do not take.
extern "C" long long flash_fwd_smem_bytes(int d, int ext, int quant) {
  switch (d) {
#define SMEM_CASE(D)                                                 \
    case D:                                                          \
      if (quant)                                                     \
        return ext ? smem_bytes<D, false, true, true>()              \
                   : smem_bytes<D, false, false, true>();            \
      return ext ? smem_bytes<D, false, true, false>()               \
                 : smem_bytes<D, false, false, false>();
    SMEM_CASE(32) SMEM_CASE(64) SMEM_CASE(96) SMEM_CASE(128)
#undef SMEM_CASE
    default:
      return 0;
  }
}

// q (batch_heads, tq, d), k/v (batch_heads / group, tk, d), out like q;
// all contiguous bf16. lse: null, or (batch_heads, tq) float32. mvec: null
// (K1, exact softmax), or the (batch_heads, tq) float32 row bounds (K2).
// mask: null, or bytes addressed as MaskArgs (inner = heads; strides in
// bytes). ext: null (the base instantiations), or the segments, window,
// dropout, int8 operands, ALiBi slopes and positions of ExtArgs (the Ext
// instantiations, in the library built with FLASH_EXT; int8, dropout and
// ALiBi with the exact kernel only). Returns a cudaError_t code (0 =
// launched).
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
