// Flash attention forward for Hopper (sm_90a) on float32 operands,
// float32-accurate: K1 and its bounded twin K2, computing what the bf16
// kernels of csrc/flash_fwd.cu compute, at the operands' own dtype (the
// float32 backward, K3 and K4, is csrc/flash_bwd_f32.cu).
//
// Replaces the TPU kernels `_make_fwd_kernel` (K1) and
// `_make_fwd_kernel_bounded` (K2) in
// distributed_dot_product_tpu/ops/pallas_attention.py when they run on
// float32 operands (the JAX package's default dtype): the reference's float32
// kernels on the CPU are exact float32, and so are these.
//
// Products: every matrix product is three TF32 tensor-core products
// (3xTF32) on mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32: each
// operand x is split into big = cvt.rna.tf32(x) and small =
// cvt.rna.tf32(x - big), and small.big + big.small accumulate before
// big.big; the dropped small.small term sits ~2^-22 below the product, so a
// sum carries float32's accuracy (a single TF32 product keeps ~2^-11). Only
// the int8 scoring's S (qk_quant='int8') is an exact s8 product
// (m16n8k32.s32.s8.s8), as in the bf16 kernels.
//
// What bounds them on the H100: the 3xTF32 products, 495 / 3 = 165 TFLOP/s
// of float32-accurate tensor-core work. At the LM's training shape (4 x 8
// heads, T 4096, head dim 96, causal: 268 M pairs) K1's 103 GFLOP take
// 0.62 ms there against ~50 MB of float32 q/k/v/o (0.015 ms at 3.35 TB/s).
//
// The design, one warpgroup (4 warps, 128 threads) a block, each warp 16
// rows of the block's 64-row query tile:
//  - The streamed tiles (K and V) come through up to three stages of
//    shared memory by cp.async (16 bytes a copy, rows past the end as
//    zeros), kN = 64 rows a stage, or 32 where two 64-row stages do not fit
//    beside the resident tiles (at (256, 256)). float32 rows are padded to
//    W + 4 floats, so both fragment patterns below read 32 different banks.
//  - Every fragment is a plain 32-bit shared load: wgmma's tf32 form reads
//    both shared operands K-major only and ldmatrix moves 16-bit elements,
//    so neither serves P.V's V, which is read with its d_v contiguous.
//    S = q.K^T reads A = q and B = K row-major (both K-major). P.V takes
//    P from the S accumulator registers: the m16n8 accumulator gives each
//    thread columns 2t and 2t+1 of an 8-column slice, and the k8 A
//    fragment wants columns t and t+4, so the slice's reduction order is
//    permuted (A's k = t is column 2t, k = t + 4 column 2t + 1) and V's B
//    fragment reads rows 2t and 2t + 1 to match: no shuffle.
//  - The m16n8 accumulators laid side by side are, element for element,
//    the bf16 kernels' wgmma accumulators (acc_row / acc_col of
//    csrc/hopper.cuh), so the masks, the online softmax and the Ext
//    features run on the same (row, column) arithmetic.
// No atomics: two runs of any case are equal bit for bit.
//
// Numerics follow the bf16 kernels at float32: scale*log2(e) folded into q
// (the reference rounds the fold back to q.dtype, here float32), an online
// exp2 softmax from NEG_BIG (K2: the row bound), masked logits -inf, exact
// zeros for a row with no attendable key, the row lse as
// ln2*(m2 + log2(l)). Masks, GQA, causal_offset / kv_offset, and the Ext
// features (segments, window, coordinate-hash dropout, ALiBi, explicit
// positions, int8 scoring) are the bf16 kernels' (see their sources), with
// a dense mask read straight from device memory.

#include <math.h>

#include <type_traits>

#include "hopper.cuh"      // kB, kWarps, kThreads, cp.async, acc_row/col
#include "flash_ext.cuh"   // MaskArgs, ExtArgs, drop_hash
#include "tf32x3.cuh"      // frag_a, mma3: the 3xTF32 products
#include "f32_tiles.cuh"   // kPf, kP8, tile sizes, mma_s8_abt

namespace {

constexpr float kNegBig = -0.7f * 3.4e38f;
constexpr float kLn2 = 0.693147180559945309f;

// The tensor core rounds each mma's sum toward zero: a long chain of
// products in one accumulator drifts by ~2^-24 of the sum a step, all the
// same way (the whole key axis of P.V: ~5e-5 at T 4096). So the products
// below go to fresh registers a 64-wide piece of the reduction at a time
// (at most 24 mma steps a chain, with 3xTF32), and each piece is added to
// the running sum with a rounded float add.

// acc (16 x 8 NT, the accumulators side by side) += A . B^T: A the warp's
// 16 rows of K columns at `a` (pitch pa floats), B 8 NT rows of K columns
// at `b` (pitch pb): both read K-major.
template <int K, int NT>
__device__ __forceinline__ void mma_abt(float* acc, const float* a, int pa,
                                        const float* b, int pb) {
  constexpr int kPiece = K < 64 ? K : 64;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const float* a0 = a + g * pa + t;
  const float* a1 = a0 + 8 * pa;
  const float* b0 = b + g * pb + t;
  for (int k0 = 0; k0 < K; k0 += kPiece) {
    float part[4 * NT];
#pragma unroll
    for (int i = 0; i < 4 * NT; ++i) part[i] = 0.f;
    const int k1 = k0 + kPiece < K ? k0 + kPiece : K;
#pragma unroll 2
    for (int kk = k0 / 8; kk < k1 / 8; ++kk) {
      const FragA fa = frag_a(a0[8 * kk], a1[8 * kk], a0[8 * kk + 4],
                              a1[8 * kk + 4]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* bp = b0 + 8 * nt * pb + 8 * kk;
        mma3(part + 4 * nt, fa, bp[0], bp[4]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4 * NT; ++i) acc[i] += part[i];
  }
}

// acc (16 x 8 NT) += P . B: P the 16 x 8 NK accumulators p (slice ks's
// columns 2t, 2t + 1 in p[4 ks + 0..3]), B 8 NK rows of 8 NT columns at `b`
// (pitch pb), read with its columns contiguous. Slice ks's reduction runs
// in the order 0, 2, 4, 6, 1, 3, 5, 7: A's k = t is column 2t and k = t + 4
// column 2t + 1, and B's rows follow. The product's columns go in pieces
// of at most 64 (N0: the first n-tile of this piece), each summed over the
// NK slices in fresh registers and added to acc.
template <int NK, int NT, int N0 = 0>
__device__ __forceinline__ void mma_pb(float* acc, const float* p,
                                       const float* b, int pb) {
  constexpr int W = NT - N0 < 8 ? NT - N0 : 8;   // n-tiles of this piece
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const float* b0 = b + 2 * t * pb + g + 8 * N0;
  float part[4 * W];
#pragma unroll
  for (int i = 0; i < 4 * W; ++i) part[i] = 0.f;
#pragma unroll
  for (int ks = 0; ks < NK; ++ks) {
    const FragA fa = frag_a(p[4 * ks], p[4 * ks + 2], p[4 * ks + 1],
                            p[4 * ks + 3]);
    const float* bk = b0 + 8 * ks * pb;
#pragma unroll
    for (int nt = 0; nt < W; ++nt)
      mma3(part + 4 * nt, fa, bk[8 * nt], bk[pb + 8 * nt]);
  }
#pragma unroll
  for (int i = 0; i < 4 * W; ++i) acc[4 * N0 + i] += part[i];
  if constexpr (N0 + W < NT) mma_pb<NK, NT, N0 + W>(acc, p, b, pb);
}

// ---------------------------------------------------------------------------
// Tiles into shared memory.

// Rows [row0, row0 + n) of a (rows, W) float32 matrix at `src` into `dst`
// (kPf<W> floats a row), 16 bytes a cp.async; rows at or past `limit` land
// as zeros and read nothing.
template <int W>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int n, int limit) {
  constexpr int kPieces = W / 4;
  for (int idx = threadIdx.x; idx < n * kPieces; idx += kThreads) {
    const int r = idx / kPieces, c = idx % kPieces;
    const bool ok = row0 + r < limit;
    cp_async16(smem_u32(dst + r * kPf<W> + 4 * c),
               src + (ok ? static_cast<size_t>(row0 + r) * W + 4 * c : 0),
               ok);
  }
}

// The same for an int8 matrix (kP8<W> bytes a row).
template <int W>
__device__ __forceinline__ void load_rows8(signed char* dst,
                                           const signed char* src, int row0,
                                           int n, int limit) {
  constexpr int kPieces = W / 16;
  for (int idx = threadIdx.x; idx < n * kPieces; idx += kThreads) {
    const int r = idx / kPieces, c = idx % kPieces;
    const bool ok = row0 + r < limit;
    cp_async16(smem_u32(dst + r * kP8<W> + 16 * c),
               src + (ok ? static_cast<size_t>(row0 + r) * W + 16 * c : 0),
               ok);
  }
}

// The streamed rows a stage of a kernel's shared memory `Sm` holds (64, or
// 32 where two 64-row stages do not fit beside the resident tiles), its
// stages (three, two or one that fit) and its bytes.
template <typename Sm>
__host__ __device__ constexpr int pick_rows() {
  return Sm::res() + 2 * Sm::stage(64) <= kSmemLimit ? 64 : 32;
}

template <typename Sm>
__host__ __device__ constexpr int pick_stages() {
  return Sm::res() + 3 * Sm::stage(pick_rows<Sm>()) <= kSmemLimit
             ? 3
             : (Sm::res() + 2 * Sm::stage(pick_rows<Sm>()) <= kSmemLimit
                    ? 2 : 1);
}

template <typename Sm>
__host__ __device__ constexpr size_t smem_of() {
  return Sm::res() + pick_stages<Sm>() * Sm::stage(pick_rows<Sm>());
}

// ---------------------------------------------------------------------------
// K1 / K2. Resident: the block's 64 q rows (int8 with Quant). A stage: kN
// key rows of K (int8 k with Quant) and of V, then 3 x 64 words: the key
// tile's segment ids, positions and (Quant) k scales.

template <int D, int DV, bool Quant>
struct FwdSmem {
  __host__ __device__ static constexpr size_t res() {
    return Quant ? tile_i8<D>(kB) : tile_f32<D>(kB);
  }
  __host__ __device__ static constexpr size_t off_v(int n) {
    return Quant ? tile_i8<D>(n) : tile_f32<D>(n);
  }
  __host__ __device__ static constexpr size_t off_vec(int n) {
    return off_v(n) + tile_f32<DV>(n);
  }
  __host__ __device__ static constexpr size_t stage(int n) {
    return off_vec(n) + 3 * kB * 4;
  }
};

// K1 (K2 with a non-null mvec: the row bounds in place of the running max,
// a branch the whole block takes alike) for one 64-row query block of one
// (batch, head) row.
// q (batch_heads, tq, D), k (batch_heads / group, tk, D), v (batch_heads /
// group, tk, DV), out (batch_heads, tq, DV), all float32; with Quant the
// int8 q and k of ExtArgs take q's and k's place in S.
template <int D, int DV, bool Ext, bool Quant>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, const float* __restrict__ mvec,
                     MaskArgs mask, int tq, int tk, int group, int causal,
                     int causal_offset, int kv_offset, float qscale,
                     int n_qblocks, ExtArgs ext) {
  static_assert(D % 32 == 0 && D <= 256 && DV % 32 == 0 && DV <= 256,
                "head dims must be 32*n <= 256");
  static_assert(!Quant || Ext, "int8 scoring is Ext");
  using S = FwdSmem<D, DV, Quant>;
  constexpr int kN = pick_rows<S>();
  constexpr int kS = pick_stages<S>();
  static_assert(smem_of<S>() <= kSmemLimit, "shared memory");
  constexpr int NKT = kN / 8;
  constexpr int PQ = kPf<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  signed char* sQ8 = reinterpret_cast<signed char*>(smem);
  unsigned char* sStages = smem + S::res();

  const int qb0 = (n_qblocks - 1 - static_cast<int>(blockIdx.y)) * kB;
  const int bh = blockIdx.x;
  const int bkv = bh / group;
  const int warp = threadIdx.x / 32;
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

  // Row i may attend local key column j when rel + i >= j: the block sees
  // key tiles [t_lo, t_hi) of kN columns (its causal extent and window)
  // and, with positions, its tile's [qmin, qmax].
  const long long rel = static_cast<long long>(causal_offset) - kv_offset;
  int t_lo = 0, t_hi, qmin = 0, qmax = 0;
  {
    int kv_end = tk;
    if (causal) {
      const long long extent = rel + (qb0 + kB < tq ? qb0 + kB : tq);
      kv_end = extent <= 0 ? 0 : (extent < tk ? static_cast<int>(extent) : tk);
    }
    t_hi = (kv_end + kN - 1) / kN;
    if constexpr (Ext) {
      if (causal && ext.window > 0) {
        const long long first = rel + qb0 - ext.window + 1;
        t_lo = first <= 0 ? 0
             : (first >= kv_end ? t_hi : static_cast<int>(first) / kN);
      }
      if (posk_mm != nullptr) {
        qmin = vec_row(ext.posq_mm, bh)[2 * (qb0 / kB)];
        qmax = vec_row(ext.posq_mm, bh)[2 * (qb0 / kB) + 1];
      }
    }
  }
  // Does the block see key tile t? Positions skip a tile wholly in the
  // query tile's future or a window or more in its past (the tables are
  // per 64 columns; a 32-column tile reads its 64-column tile's range).
  auto sees = [&](int t) {
    bool yes = t >= t_lo && t < t_hi;
    if constexpr (Ext) {
      const int mt = t * kN / kB;
      yes = yes && !(posk_mm != nullptr &&
                     (posk_mm[2 * mt] > qmax ||
                      (ext.window > 0 &&
                       static_cast<long long>(qmin) - posk_mm[2 * mt + 1] >=
                           ext.window)));
    }
    return yes;
  };
  auto next_tile = [&](int t) {
    while (t < t_hi && !sees(t)) ++t;
    return t;
  };
  const float* kbase = k + static_cast<size_t>(bkv) * tk * D;
  const float* vbase = v + static_cast<size_t>(bkv) * tk * DV;
  auto issue = [&](int t, int stage) {
    unsigned char* st = sStages + stage * S::stage(kN);
    if constexpr (Quant)
      load_rows8<D>(reinterpret_cast<signed char*>(st),
                    ext.k8 + static_cast<size_t>(bkv) * tk * D, t * kN, kN,
                    tk);
    else
      load_rows<D>(reinterpret_cast<float*>(st), kbase, t * kN, kN, tk);
    load_rows<DV>(reinterpret_cast<float*>(st + S::off_v(kN)), vbase, t * kN,
                  kN, tk);
    int* sv = reinterpret_cast<int*>(st + S::off_vec(kN));
    if constexpr (Ext) {
      if (segk_row != nullptr) load_vec_async(sv, segk_row, t * kN, tk);
      if (posk_row != nullptr) load_vec_async(sv + kB, posk_row, t * kN, tk);
    }
    if constexpr (Quant)
      load_vec_async(sv + 2 * kB, ext.skr + static_cast<size_t>(bkv) * tk,
                     t * kN, tk);
  };

  // The block's q rows first (the oldest cp.async group).
  if constexpr (Quant)
    load_rows8<D>(sQ8, ext.q8 + qoff * D, qb0, kB, tq);
  else
    load_rows<D>(sQ, q + qoff * D, qb0, kB, tq);
  cp_async_commit();

  // This thread's two query rows of the accumulator layout: lr and lr + 8.
  const int lr = acc_row(0);
  bool row_ok[2];
  long long row_pos[2];
  float m_run[2], l_run[2] = {0.f, 0.f}, sqf_r[2] = {0.f, 0.f};
  const unsigned char* mrow[2] = {nullptr, nullptr};
  int seg_r[2] = {0, 0}, pos_r[2] = {0, 0};
  unsigned int drop_rh[2] = {0u, 0u};
  unsigned int drop_bs = 0u;
  float slope = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = qb0 + lr + 8 * h;
    row_ok[h] = row < tq;
    row_pos[h] = rel + row;
    m_run[h] = kNegBig;
    if (mvec != nullptr) m_run[h] = row_ok[h] ? mvec[qoff + row] : 0.f;
    if constexpr (Quant) sqf_r[h] = row_ok[h] ? ext.sqf[qoff + row] : 0.f;
    if (row_ok[h] && mask.ptr != nullptr)
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

  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;

  int t = next_tile(t_lo);
  int fetch = t;   // the next tile to load, kS - 1 ahead of t
#pragma unroll
  for (int s = 0; s < kS - 1; ++s) {
    if (fetch < t_hi) {
      issue(fetch, s);
      fetch = next_tile(fetch + 1);
    }
    cp_async_commit();
  }
  // q landed: fold scale*log2(e) into it (float32, as the reference's fold
  // at q.dtype); int8 q stays as it landed (sqf carries the fold).
  cp_async_wait<kS - 1>();
  __syncthreads();
  if constexpr (!Quant) {
    for (int idx = threadIdx.x; idx < kB * D; idx += kThreads)
      sQ[idx / D * PQ + idx % D] *= qscale;
    __syncthreads();
  }

  const bool rows_full = qb0 + kB <= tq;
  for (int stage = 0; t < t_hi;) {
    const int fill = (stage + kS - 1) % kS;
    if (fetch < t_hi) {
      issue(fetch, fill);
      fetch = next_tile(fetch + 1);
    }
    cp_async_commit();
    cp_async_wait<kS - 1>();
    __syncthreads();   // stage `stage` landed for every thread

    const int k0 = t * kN;
    const int mt = k0 / kB;
    const unsigned char* st = sStages + stage * S::stage(kN);
    const float* sV = reinterpret_cast<const float*>(st + S::off_v(kN));
    const int* sv = reinterpret_cast<const int*>(st + S::off_vec(kN));
    float s[kN / 2];
    if constexpr (Quant) {
      // S = (float(q8 k8^T) * sqf) * skr, the int32 dots exact.
      int dot[kN / 2];
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) dot[i] = 0;
      mma_s8_abt<D, NKT>(dot, sQ8 + 16 * warp * kP8<D>,
                         reinterpret_cast<const signed char*>(st));
      const float* skr = reinterpret_cast<const float*>(sv + 2 * kB);
#pragma unroll
      for (int i = 0; i < kN / 2; ++i)
        s[i] = __fmul_rn(__fmul_rn(static_cast<float>(dot[i]),
                                   sqf_r[(i >> 1) & 1]),
                         skr[acc_col(i)]);
    } else {
      // S = q2 K^T (log2 units: q is folded).
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) s[i] = 0.f;
      mma_abt<D, NKT>(s, sQ + 16 * warp * PQ, PQ,
                      reinterpret_cast<const float*>(st), kPf<D>);
    }

    // Masked scores to -inf; ALiBi's bias. A tile wholly inside the rows,
    // the columns, the causal extent and the window, with no mask or
    // segments, needs no per-element test.
    bool full = rows_full && k0 + kN <= tk && mask.ptr == nullptr;
    if constexpr (Ext) {
      full = full && segk_row == nullptr &&
             (posk_row != nullptr
                  ? posk_mm[2 * mt + 1] <= qmin &&
                        (ext.window <= 0 ||
                         static_cast<long long>(qmax) - posk_mm[2 * mt] <
                             ext.window)
                  : (!causal || k0 + kN - 1 <= rel + qb0) &&
                        (ext.window <= 0 ||
                         rel + qb0 + kB - 1 - k0 < ext.window));
    } else {
      full = full && (!causal || k0 + kN - 1 <= rel + qb0);
    }
    auto scores = [&](auto tested) {
      constexpr bool kTest = decltype(tested)::value;
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) {
        const int h = (i >> 1) & 1;
        const int cl = acc_col(i);
        const int col = k0 + cl;
        bool valid = true;
        if constexpr (kTest) {
          valid = row_ok[h] && col < tk && (!causal || col <= row_pos[h]);
          if (mrow[h] != nullptr) valid = valid && !mrow[h][col];
        }
        float sc = s[i];
        if constexpr (Ext) {
          const long long back =
              posk_row != nullptr
                  ? static_cast<long long>(pos_r[h]) - sv[kB + cl]
                  : row_pos[h] - col;
          if constexpr (kTest) {
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

    // The online softmax on the fragments: a row's kN columns sit in the 4
    // lanes of a quad.
    float corr[2] = {1.f, 1.f};
    if (mvec == nullptr) {
      float mx[2] = {kNegBig, kNegBig};
#pragma unroll
      for (int i = 0; i < kN / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m_run[h], mx[h]);
        corr[h] = exp2f(m_run[h] - m_new);
        m_run[h] = m_new;
      }
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    }
    // p = exp2(s - m) (masked: 0); l sums the undropped p.
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) {
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
          pn = drop_hash(drop_rh[h], col * 2246822519u, drop_bs) >=
                       ext.drop_threshold
                   ? p * ext.drop_inv : 0.f;
        }
      }
      s[i] = pn;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * corr[h] + psum[h];

    // O += P V.
    mma_pb<NKT, DV / 8>(o, s, sV, kPf<DV>);

    __syncthreads();   // every thread done with `stage` before its refill
    t = next_tile(t + 1);
    stage = stage + 1 == kS ? 0 : stage + 1;
  }
  cp_async_wait<0>();

  // l over the quad; l == 0 <=> the row attends no key: output exactly 0.
  float l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = l_run[h] + __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  float* ob = out + qoff * DV;
#pragma unroll
  for (int i = 0; i < DV / 2; i += 2) {
    const int h = (i >> 1) & 1;
    const int row = qb0 + acc_row(i);
    if (row < tq)
      *reinterpret_cast<float2*>(ob + static_cast<size_t>(row) * DV +
                                 acc_col(i)) =
          make_float2(l[h] == 0.f ? 0.f : o[i] / l[h],
                      l[h] == 0.f ? 0.f : o[i + 1] / l[h]);
  }
  if (lse != nullptr && threadIdx.x % 4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row_ok[h])
        lse[qoff + qb0 + lr + 8 * h] =
            kLn2 * (m_run[h] + log2f(l[h] == 0.f ? 1.f : l[h]));
  }
}

// ---------------------------------------------------------------------------
// Launches.

// Sets the kernel's dynamic shared memory and launches it; returns a
// cudaError_t code (0 = launched).
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), dim3 grid, size_t smem,
           cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

MaskArgs mask_args(const void* mask, int inner, long long so, long long si,
                   long long sr) {
  return MaskArgs{static_cast<const unsigned char*>(mask),
                  inner > 0 ? inner : 1, so, si, sr};
}

// The query blocks of a (batch, head) row: blockIdx.y the block from the
// last, so every row's longest causal extents launch first.
int qblocks(int tq) { return (tq + kB - 1) / kB; }

template <int D, int DV, bool Ext, bool Quant>
int launch_fwd(const float* q, const float* k, const float* v, float* out,
               float* lse, const float* mvec, const MaskArgs& mask,
               int batch_heads, int group, int tq, int tk, int causal,
               int causal_offset, int kv_offset, float qscale,
               const ExtArgs& ext, cudaStream_t s) {
  if (tq == 0 || batch_heads == 0) return 0;
  return launch(flash_fwd_f32_kernel<D, DV, Ext, Quant>,
                dim3(batch_heads, qblocks(tq)),
                smem_of<FwdSmem<D, DV, Quant>>(), s,
                q, k, v, out, lse, mvec, mask, tq, tk, group, causal,
                causal_offset, kv_offset, qscale, qblocks(tq), ext);
}

}  // namespace

// Built twice (ops/_build.py), in parts nvcc compiles side by side: the
// base instantiations of K1/K2, and with FLASH_EXT=1 the Ext ones
// (segments, window, dropout, ALiBi, positions, int8 scoring), each library
// refusing the other's calls (cudaErrorInvalidValue).

// The float32 twin of flash_fwd_bf16 (csrc/flash_fwd.cu), with the same
// arguments: q (batch_heads, tq, d), k (batch_heads / group, tk, d), v
// (batch_heads / group, tk, dv), out (batch_heads, tq, dv), all contiguous
// float32, (d, dv) a FLASH_GRID pair; lse null or (batch_heads, tq); mvec
// null (K1) or the (batch_heads, tq) row bounds (K2); mask as MaskArgs;
// ext null (base) or ExtArgs (int8, dropout and ALiBi with the exact kernel
// only). Returns a cudaError_t code (0 = launched).
extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             void* out, void* lse, const void* mvec,
                             const void* mask, int mask_inner,
                             long long mask_so, long long mask_si,
                             long long mask_sr, int batch_heads, int group,
                             int tq, int tk, int d, int dv, int causal,
                             int causal_offset, int kv_offset, float qscale,
                             const void* ext, void* stream) {
  const MaskArgs m = mask_args(mask, mask_inner, mask_so, mask_si, mask_sr);
  const ExtArgs* e = static_cast<const ExtArgs*>(ext);
  const ExtArgs none{};
  const float* mv = static_cast<const float*>(mvec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FWD_LAUNCH(D, DV, E, Q)                                               \
  return launch_fwd<D, DV, E, Q>(                                             \
      static_cast<const float*>(q), static_cast<const float*>(k),            \
      static_cast<const float*>(v), static_cast<float*>(out),                \
      static_cast<float*>(lse), mv, m, batch_heads, group, tq, tk, causal,    \
      causal_offset, kv_offset, qscale, E ? *e : none, s)
#if !defined(FLASH_EXT)
  if (e != nullptr) return static_cast<int>(cudaErrorInvalidValue);
#define FWD_CASE(D, DV)                                                       \
  if (d == D && dv == DV) FWD_LAUNCH(D, DV, false, false);
  FLASH_GRID(FWD_CASE)
#elif FLASH_EXT == 1
  if (e == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (mv != nullptr && (e->q8 != nullptr || e->dropout || e->alibi != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
#define FWD_CASE(D, DV)                                                       \
  if (d == D && dv == DV) {                                                   \
    if (e->q8 != nullptr) FWD_LAUNCH(D, DV, true, true);                      \
    FWD_LAUNCH(D, DV, true, false);                                           \
  }
  FLASH_GRID(FWD_CASE)
#endif
#undef FWD_CASE
#undef FWD_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
