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
// (3xTF32, csrc/tf32x3.cuh): each operand x is split into big =
// cvt.rna.tf32(x) and small = cvt.rna.tf32(x - big), and small.big +
// big.small accumulate before big.big; the dropped small.small term sits
// ~2^-22 below the product, so a sum carries float32's accuracy (a single
// TF32 product keeps ~2^-11). Only the int8 scoring's S (qk_quant='int8')
// is an exact s8 product (mma.sync m16n8k32), as in the bf16 kernels.
//
// What bounds them on the H100: the 3xTF32 products, 495 / 3 = 165 TFLOP/s
// of float32-accurate tensor-core work. At the LM's training shape (4 x 8
// heads, T 4096, head dim 96, causal: 268 M pairs) K1's 103 GFLOP take
// 0.62 ms there against ~50 MB of float32 q/k/v/o (0.015 ms at 3.35 TB/s).
//
// Why wgmma fits here (it does not fit the backward, csrc/flash_bwd_f32.cu):
// wgmma's TF32 form reads its shared operand K-major only, and takes A from
// registers in mma.sync m16n8k8's A fragment. S = q.K^T reads K with d
// contiguous, K-major as stored; q's fragments are split in registers from
// padded float32 rows; P's fragments are the S accumulators (wgmma's
// m64nN accumulator is, element for element, the m16n8 ones side by side:
// acc_row / acc_col of csrc/hopper.cuh, so the masks, the online softmax
// and the Ext features keep the bf16 kernels' (row, column) arithmetic).
// Only O += P.V reads an MN-major operand, V, and the producer stores it
// transposed. So both products are wgmma m64nNk8 tf32 (the RS form), each
// three products in tf32x3_terms' order, B's big and small parts in two
// planes of shared memory.
//
// The design (the float32 backward's pipeline, csrc/f32_pipeline.cuh):
//  - Two consumer warpgroups a block where the tiles fit, each its own 64
//    query rows, m, l, O and lse (no reduction across them, no atomics:
//    two runs of any case are equal bit for bit); an SM runs 8 computing
//    warps at (96, 96).
//  - A producer warpgroup loads each key tile with 16-byte loads (V with
//    4-byte loads, a warp's 32 lanes on 32 consecutive columns), splits
//    every K and V element once, and stores the parts in wgmma's K-major
//    core-matrix layout: K's planes as its rows lie, V's planes transposed
//    (V^T: d_v rows of key columns) with each 8-key slice's keys in the
//    order 0, 2, 4, 6, 1, 3, 5, 7 that P's fragments take: the m64nN
//    accumulator gives a thread columns 2t and 2t + 1 of a slice and the
//    k8 A fragment wants columns t and t + 4, so A's k = t is key 2t and
//    k = t + 4 key 2t + 1, no shuffle. No product loop splits a K or V
//    element. A tile is two items of a ring of slots, K (with the per-key
//    vectors: segments, positions, k scales; int8 scoring's K tile) and
//    V^T, handed over by full / empty mbarriers (a wait traps after 4 s);
//    the consumers release K after the softmax and V^T after P.V, so the
//    next tile's K lands while P.V runs, and the producer's next loads are
//    in flight while it waits for a free slot. Two items a tile let 64-key
//    tiles (S as m64n64k8) fit at (96, 96), where two 64-key stages of
//    both would not.
//  - A consumer's S is a chain of m64nNk8 wgmma groups of kSGroup k8 steps
//    each, q's fragments of a group split in registers, the next group's q
//    loaded before waiting for the group before (two groups in flight);
//    P.V likewise, kPvGroup key slices a group, in column chunks of at
//    most 96.
//  - The grid launches every (batch, head) row's longest causal extents
//    first (blockIdx.y the 128-row block from the last).
// The plans (warpgroups / key rows a tile / slots, from the shared-memory
// arithmetic below; two warpgroups only where O's registers fit beside a
// chunk, d_v <= 128):
//   float32 S: (32, 32), (64, 64) 2 / 64 / 4; (96, 96) 2 / 64 / 3
//   (201,008 B); (128, 128) 2 / 32 / 4; (192, 128) 2 / 16 / 4; (256, 256)
//   1 / 16 / 4.
//   int8 S: (32, 32) ... (96, 96) 2 / 64 / 4; (128, 128), (192, 128) 2 /
//   64 / 3; (256, 256) 1 / 32 / 3.
//
// Numerics follow the bf16 kernels at float32: scale*log2(e) folded into q
// (the reference rounds the fold back to q.dtype, here float32), an online
// exp2 softmax from NEG_BIG (K2: the row bound), masked logits -inf, exact
// zeros for a row with no attendable key, the row lse as
// ln2*(m2 + log2(l)). The tensor core rounds each product's sum toward
// zero, so a long chain in one accumulator drifts (~5e-5 over 4096 keys):
// every reduction runs at most 64 wide in fresh accumulators (scale-d 0
// on its first product) and is added to the running sum with a rounded
// float add. Masks, GQA, causal_offset / kv_offset, and the Ext features
// (segments, window, coordinate-hash dropout, ALiBi, explicit positions,
// int8 scoring) are the bf16 kernels' (see their sources), with a dense
// mask read straight from device memory.

#include <math.h>

#include <type_traits>

#include "hopper.cuh"         // kB, acc_row/col, WgmmaTf32, make_desc
#include "flash_ext.cuh"      // MaskArgs, ExtArgs, drop_hash
#include "tf32x3.cuh"         // split, frag_a, tf32x3_terms
#include "f32_tiles.cuh"      // kPf, kP8, tile sizes, mma_s8_abt
#include "f32_pipeline.cuh"   // stages, mbarriers, spans, launches

namespace {

constexpr float kNegBig = -0.7f * 3.4e38f;
constexpr float kLn2 = 0.693147180559945309f;

// ---------------------------------------------------------------------------
// Split planes. A plane holds one TF32 part (big or small) of a tile in
// wgmma's K-major core-matrix layout (no swizzle): R rows (the product's
// N) of C columns (its reduction), as C / 4 panels of R rows x 16 bytes;
// element (r, c) at byte 16 R (c / 4) + 16 r + 4 (c % 4). A k8 step is two
// panels.

// The descriptor of k8 step kk of a plane of R rows, from row r0 on.
template <int R>
__device__ __forceinline__ uint64_t plane_desc(uint32_t plane, int kk,
                                               int r0 = 0) {
  return make_desc(plane + 2 * kk * 16 * R + 16 * r0, 16 * R,
                   kRowGroupBytes);
}

__device__ __forceinline__ void split4(const float4& x, uint4& big,
                                       uint4& small) {
  split(x.x, big.x, small.x);
  split(x.y, big.y, small.y);
  split(x.z, big.z, small.z);
  split(x.w, big.w, small.w);
}

// Key rows [row0, row0 + N) of a (rows, W) float32 matrix K, loaded by the
// producer's thread `tid` of 128 (rows at or past `limit` as zeros): a
// warp reads 8 rows x 64 contiguous bytes a load, two whole sectors a row.
template <int W, int N>
struct KRows {
  static constexpr int kPer = N * W / 4 / kProducer;   // 16-byte loads
  static_assert(N * W / 4 % kProducer == 0 && N % 8 == 0 && W % 16 == 0,
                "tile");
  float4 x[kPer];

  // Row r and 16-byte column j of load i.
  __device__ __forceinline__ static int row(int i, int tid) {
    return (((i * kProducer + tid) / 32) % (N / 8)) * 8 + tid % 8;
  }
  __device__ __forceinline__ static int col4(int i, int tid) {
    return (((i * kProducer + tid) / 32) / (N / 8)) * 4 + (tid % 32) / 8;
  }

  __device__ __forceinline__ void load(const float* src, int row0,
                                       int limit, int tid) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = row(i, tid);
      x[i] = row0 + r < limit
                 ? __ldg(reinterpret_cast<const float4*>(
                             src + static_cast<size_t>(row0 + r) * W) +
                         col4(i, tid))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  // Into K's planes of N rows and W columns: each load's 16 bytes to 8
  // consecutive rows of a panel across a quarter-warp (eight bank groups).
  __device__ __forceinline__ void store(unsigned char* big,
                                        unsigned char* small,
                                        int tid) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int off = 16 * N * col4(i, tid) + 16 * row(i, tid);
      uint4 b, s;
      split4(x[i], b, s);
      *reinterpret_cast<uint4*>(big + off) = b;
      *reinterpret_cast<uint4*>(small + off) = s;   // K's small part
    }
  }
};

// Key rows [row0, row0 + N) of a (rows, W) float32 matrix V, loaded by the
// producer's thread `tid` for V^T's planes (W rows of N key columns): unit
// u is column n = u % W of V^T's panel p = u / W, the four keys of columns
// 4p .. 4p + 3 of the permuted order (8 (p / 2) + p % 2 + 2e, e = 0..3),
// four 4-byte loads a warp makes on 32 consecutive columns of a key row.
template <int W, int N>
struct VtCols {
  static constexpr int kPer = N / 4 * W / kProducer;   // units
  static_assert(N / 4 * W % kProducer == 0 && W % 32 == 0 && N % 8 == 0,
                "tile");
  float x[kPer][4];

  __device__ __forceinline__ void load(const float* src, int row0,
                                       int limit, int tid) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int u = i * kProducer + tid, n = u % W, p = u / W;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * (p >> 1) + (p & 1) + 2 * e;   // key of column 4p + e
        x[i][e] = row0 + r < limit
                      ? __ldg(src + static_cast<size_t>(row0 + r) * W + n)
                      : 0.f;
      }
    }
  }

  // Column n's four keys are 16 contiguous bytes of panel p: a warp's 32
  // stores are 512 contiguous bytes.
  __device__ __forceinline__ void store(unsigned char* big,
                                        unsigned char* small,
                                        int tid) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int u = i * kProducer + tid;
      const int off = 16 * W * (u / W) + 16 * (u % W);
      uint4 b, s;
      split4(make_float4(x[i][0], x[i][1], x[i][2], x[i][3]), b, s);
      *reinterpret_cast<uint4*>(big + off) = b;
      *reinterpret_cast<uint4*>(small + off) = s;
    }
  }
};

// ---------------------------------------------------------------------------
// Products on split planes (a consumer warpgroup, 64 rows; the
// accumulators in csrc/hopper.cuh's m64nN layout).

// The k8 steps of a wgmma group (S: at most two groups in flight, so two
// groups' A fragments are live; P.V likewise): larger groups spill at
// (96, 96)'s 64-key tiles and run slower (scripts/torch_fwd_f32_variants.py).
constexpr int kSGroup = 1;
constexpr int kPvGroup = 1;

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

// S's 64-wide pieces of the reduction beyond the first, each in fresh
// accumulators (at least one array, so that the type exists).
template <int K>
constexpr int kFresh = K > 64 ? (K + 63) / 64 - 1 : 1;

// The accumulators of reduction piece P: S itself, then the fresh ones.
template <int P, int N, int F>
__device__ __forceinline__ auto& piece(float (&s)[N], float (&fresh)[F][N]) {
  if constexpr (P == 0)
    return s;
  else
    return fresh[P - 1];
}

// The four q values of the A fragments of k8 steps [KK0, KK1): the
// warp's rows g (at a0) and g + 8 (at a1), columns 8kk + t and 8kk + t + 4.
template <int KK0, int KK1>
__device__ __forceinline__ void load_q(float (&raw)[kSGroup][4],
                                       const float* a0, const float* a1) {
#pragma unroll
  for (int j = 0; j < KK1 - KK0; ++j) {
    const int kk = KK0 + j;
    raw[j][0] = a0[8 * kk];
    raw[j][1] = a1[8 * kk];
    raw[j][2] = a0[8 * kk + 4];
    raw[j][3] = a1[8 * kk + 4];
  }
}

// Steps [KK, KK1) of the group from G0: each its three products into its
// piece's accumulators (scale-d 0 on a piece's first).
template <int N, int K, int G0, int KK, int KK1>
__device__ __forceinline__ void s_steps(float (&s)[N / 2],
                                        float (&fresh)[kFresh<K>][N / 2],
                                        const FragA (&fa)[kSGroup],
                                        uint32_t kbig, uint32_t ksmall) {
  auto& acc = piece<KK / 8>(s, fresh);
  int scale_d = KK % 8 != 0;
  tf32x3_terms([&](bool a_small, bool b_small) {
    WgmmaTf32<N>::rs(acc, a_small ? fa[KK - G0].small : fa[KK - G0].big,
                     plane_desc<N>(b_small ? ksmall : kbig, KK), scale_d);
    scale_d = 1;
  });
  if constexpr (KK + 1 < KK1)
    s_steps<N, K, G0, KK + 1, KK1>(s, fresh, fa, kbig, ksmall);
}

// The groups of S from step G0, `raw` its q values: the group's fragments
// split, its products issued as one wgmma group, the next group's q values
// loaded before waiting for the group before this one.
template <int N, int K, int G0>
__device__ __forceinline__ void s_groups(float (&s)[N / 2],
                                         float (&fresh)[kFresh<K>][N / 2],
                                         const float* a0, const float* a1,
                                         uint32_t kbig, uint32_t ksmall,
                                         const float (&raw)[kSGroup][4]) {
  constexpr int G1 = cmin(G0 + kSGroup, K / 8);
  FragA fa[kSGroup];
#pragma unroll
  for (int j = 0; j < G1 - G0; ++j)
    fa[j] = frag_a(raw[j][0], raw[j][1], raw[j][2], raw[j][3]);
  wgmma_fence();
  s_steps<N, K, G0, G0, G1>(s, fresh, fa, kbig, ksmall);
  wgmma_commit();
  if constexpr (G1 < K / 8) {
    float next[kSGroup][4];
    load_q<G1, cmin(G1 + kSGroup, K / 8)>(next, a0, a1);
    wgmma_wait<1>();
    s_groups<N, K, G1>(s, fresh, a0, a1, kbig, ksmall, next);
  }
}

// S (64 x N) = q . K^T over K columns: q the warp's 16 rows at a0 (row g)
// and a1 (row g + 8), kPf<K> floats a row, split into A fragments in
// registers; K's planes kbig / ksmall of N rows. Each 64-wide piece of the
// reduction goes to its own accumulators (the first is s), added to s in
// order at the end.
template <int N, int K>
__device__ __forceinline__ void s_product(float (&s)[N / 2], const float* a0,
                                          const float* a1, uint32_t kbig,
                                          uint32_t ksmall) {
  constexpr int kPieces = (K + 63) / 64;
  float fresh[kFresh<K>][N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) s[i] = 0.f;
  fence_regs(s);
#pragma unroll
  for (int p = 0; p + 1 < kPieces; ++p) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) fresh[p][i] = 0.f;
    fence_regs(fresh[p]);
  }
  float raw[kSGroup][4];
  load_q<0, cmin(kSGroup, K / 8)>(raw, a0, a1);
  s_groups<N, K, 0>(s, fresh, a0, a1, kbig, ksmall, raw);
  wgmma_wait<0>();
  fence_regs(s);
#pragma unroll
  for (int p = 0; p + 1 < kPieces; ++p) {
    fence_regs(fresh[p]);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) s[i] += fresh[p][i];
  }
}

// O (64 x DV) += P . V over NK keys, columns [C0, DV) in chunks of at most
// kPvCols: P the (masked, exponentiated) S accumulators, whose key slice ks
// is the A fragment frag_a(p[4ks], p[4ks + 2], p[4ks + 1], p[4ks + 3]) of
// the permuted order; V^T's planes vbig / vsmall of DV rows. Each chunk
// sums the NK keys (at most 64) in fresh accumulators, kPvGroup slices a
// wgmma group, and is added to O.
template <int DV>
constexpr int kPvCols = DV <= 96 ? DV : 64;

template <int NK, int DV, int W, int C0, int KS0>
__device__ __forceinline__ void pv_groups(float (&fresh)[W / 2],
                                          const float (&p)[NK / 2],
                                          uint32_t vbig, uint32_t vsmall) {
  constexpr int KS1 = cmin(KS0 + kPvGroup, NK / 8);
  FragA fa[kPvGroup];
#pragma unroll
  for (int j = 0; j < KS1 - KS0; ++j) {
    const int ks = KS0 + j;
    fa[j] = frag_a(p[4 * ks], p[4 * ks + 2], p[4 * ks + 1], p[4 * ks + 3]);
  }
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < KS1 - KS0; ++j) {
    int scale_d = KS0 + j > 0;
    tf32x3_terms([&](bool a_small, bool b_small) {
      WgmmaTf32<W>::rs(fresh, a_small ? fa[j].small : fa[j].big,
                       plane_desc<DV>(b_small ? vsmall : vbig, KS0 + j, C0),
                       scale_d);
      scale_d = 1;
    });
  }
  wgmma_commit();
  if constexpr (KS1 < NK / 8) {
    wgmma_wait<1>();
    pv_groups<NK, DV, W, C0, KS1>(fresh, p, vbig, vsmall);
  }
}

template <int NK, int DV, int C0 = 0>
__device__ __forceinline__ void pv_product(float (&o)[DV / 2],
                                           const float (&p)[NK / 2],
                                           uint32_t vbig, uint32_t vsmall) {
  constexpr int W = DV - C0 < kPvCols<DV> ? DV - C0 : kPvCols<DV>;
  float fresh[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) fresh[i] = 0.f;
  fence_regs(fresh);
  pv_groups<NK, DV, W, C0, 0>(fresh, p, vbig, vsmall);
  wgmma_wait<0>();
  fence_regs(fresh);
#pragma unroll
  for (int i = 0; i < W / 2; ++i) o[C0 / 2 + i] += fresh[i];
  if constexpr (C0 + W < DV) pv_product<NK, DV, C0 + W>(o, p, vbig, vsmall);
}

// ---------------------------------------------------------------------------
// K1 / K2. Resident, per consumer warpgroup: its 64 q rows (int8 with
// Quant), kPf<D> floats a row. The key tiles stream through a ring of
// slots as two items each, in order: a K item (K's two planes, or the
// int8 K tile with Quant, then 3 x n words: the tile's segment ids,
// positions and (Quant) k scales) and a V item (V^T's two planes). A
// consumer releases the K item after its scores and softmax and the V
// item after P.V, so the producer fills the next tile's K while P.V runs.

template <int D, int DV, bool Quant>
struct FwdSmem {
  __host__ __device__ static constexpr size_t res_wg() {
    return Quant ? tile_i8<D>(kB) : tile_f32<D>(kB);
  }
  __host__ __device__ static constexpr size_t res(int wg) {
    return wg * res_wg();
  }
  // One plane of K (n rows, D columns) or of V^T (DV rows, n columns).
  __host__ __device__ static constexpr size_t plane_k(int n) {
    return 4 * static_cast<size_t>(n) * D;
  }
  __host__ __device__ static constexpr size_t plane_v(int n) {
    return 4 * static_cast<size_t>(n) * DV;
  }
  __host__ __device__ static constexpr size_t off_vec(int n) {
    return Quant ? (tile_i8<D>(n) + 127) / 128 * 128 : 2 * plane_k(n);
  }
  __host__ __device__ static constexpr size_t k_item(int n) {
    return (off_vec(n) + 3 * 4 * static_cast<size_t>(n) + 127) / 128 * 128;
  }
  // A slot of the ring: the larger item.
  __host__ __device__ static constexpr size_t stage(int n) {
    return k_item(n) > 2 * plane_v(n) ? k_item(n) : 2 * plane_v(n);
  }
};

// The forward's plan: the first of these that fits (csrc/f32_pipeline.cuh)
// with its mbarriers, two consumer warpgroups only where d_v <= 128 (O and
// a P.V chunk in one thread's registers); 64-key tiles before smaller ones
// and at least three slots (a tile's items and the next tile's K) before
// two.
struct Shape {
  int wg, n, slots;   // consumer warpgroups, key rows a tile, ring slots
};

template <typename Sm, int DV>
__host__ __device__ constexpr Shape fwd_shape() {
  constexpr Shape kShapes[] = {
      {2, 64, 4}, {2, 64, 3}, {2, 32, 4}, {2, 32, 3}, {2, 16, 4}, {2, 16, 3},
      {2, 64, 2}, {2, 32, 2}, {2, 16, 2}, {1, 64, 4}, {1, 64, 3}, {1, 32, 4},
      {1, 32, 3}, {1, 16, 4}, {1, 16, 3}, {1, 64, 2}, {1, 32, 2}, {1, 16, 2}};
  for (const Shape& p : kShapes)
    if ((p.wg == 1 || DV <= 128) && fits<Sm>(p.wg, p.n, p.slots)) return p;
  return Shape{1, 16, 2};
}

template <int D, int DV, bool Quant>
struct FwdPlan {
  using Sm = FwdSmem<D, DV, Quant>;
  static constexpr Shape kShape = fwd_shape<Sm, DV>();
  static constexpr int kWg = kShape.wg, kN = kShape.n, kS = kShape.slots;
  static constexpr int kThreads = kWgThreads * kWg + kProducer;
  static constexpr size_t kBars = Sm::res(kWg) + kS * Sm::stage(kN);
  static constexpr size_t kBytes = kBars + 2 * kS * sizeof(uint64_t);
  static_assert(kBytes <= kSmemLimit, "shared memory");
};

// The ring's position: slot and phase parity, advanced an item at a time.
struct Ring {
  int slot = 0;
  uint32_t phase = 0;
  template <int S>
  __device__ __forceinline__ void next() {
    if (++slot == S) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// K1 (K2 with a non-null mvec: the row bounds in place of the running max,
// a branch the whole block takes alike) for one block of 64 x kWg query
// rows of one (batch, head) row.
// q (batch_heads, tq, D), k (batch_heads / group, tk, D), v (batch_heads /
// group, tk, DV), out (batch_heads, tq, DV), all float32; with Quant the
// int8 q and k of ExtArgs take q's and k's place in S.
template <int D, int DV, bool Ext, bool Quant>
__global__ void __launch_bounds__(FwdPlan<D, DV, Quant>::kThreads, 1)
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
  using P = FwdPlan<D, DV, Quant>;
  constexpr int kWg = P::kWg, kN = P::kN, kS = P::kS;
  constexpr int NKT = kN / 8;
  constexpr int PQ = kPf<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sStages = smem + S::res(kWg);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::kBars);
  uint64_t* empty = full + kS;
  // [section] fwd start

  const int qb0 = (n_qblocks - 1 - static_cast<int>(blockIdx.y)) * kB * kWg;
  const int bh = blockIdx.x;
  const int bkv = bh / group;
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
  // Row i may attend local key column j when rel + i >= j. The key tiles
  // the block's rows see, in the order both roles walk them.
  const long long rel = static_cast<long long>(causal_offset) - kv_offset;
  const KeySpan span = key_span<Ext>(qb0, kB * kWg, tq, tk, kN, causal, rel,
                                     ext, bh, posk_mm != nullptr);
  auto next_tile = [&](int t) {
    while (t < span.hi && !span_sees<Ext>(span, t, kN, posk_mm, ext)) ++t;
    return t;
  };
  init_bars<kS>(full, empty, kWgThreads * kWg);

  const int wg = warpgroup_of_thread();   // the producer: wg == kWg
  if (wg == kWg) {
    // The producer: each key tile the block sees as its K item and its V
    // item into the next free slots, K and V split into their planes; the
    // next tile's loads are in flight while it waits for a free slot.
    const int ptid = threadIdx.x % kWgThreads;
    const float* kbase = k + static_cast<size_t>(bkv) * tk * D;
    const float* vbase = v + static_cast<size_t>(bkv) * tk * DV;
    KRows<D, kN> kr;
    VtCols<DV, kN> vt;
    auto load = [&](int t) {
      if constexpr (!Quant) kr.load(kbase, t * kN, tk, ptid);
      vt.load(vbase, t * kN, tk, ptid);
    };
    Ring ring;
    int t = next_tile(span.lo);
    if (t < span.hi) load(t);
    while (t < span.hi) {
      stage_wait(empty + ring.slot, ring.phase ^ 1);
      // [section] fwd producer: free stage
      unsigned char* st = sStages + ring.slot * S::stage(kN);
      if constexpr (Quant)
        copy_rows8<D, kN>(reinterpret_cast<signed char*>(st),
                          ext.k8 + static_cast<size_t>(bkv) * tk * D, t * kN,
                          tk, ptid);
      else
        kr.store(st, st + S::plane_k(kN), ptid);
      int* sv = reinterpret_cast<int*>(st + S::off_vec(kN));
      if constexpr (Ext) {
        if (segk_row != nullptr) copy_vec<kN>(sv, segk_row, t * kN, tk, ptid);
        if (posk_row != nullptr)
          copy_vec<kN>(sv + kN, posk_row, t * kN, tk, ptid);
      }
      if constexpr (Quant)
        copy_vec<kN>(sv + 2 * kN, ext.skr + static_cast<size_t>(bkv) * tk,
                     t * kN, tk, ptid);
      // The planes are read by wgmma (the async proxy).
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(full + ring.slot);
      ring.next<kS>();
      stage_wait(empty + ring.slot, ring.phase ^ 1);
      st = sStages + ring.slot * S::stage(kN);
      vt.store(st, st + S::plane_v(kN), ptid);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(full + ring.slot);
      ring.next<kS>();
      // [section] fwd producer: stage stored
      t = next_tile(t + 1);
      if (t < span.hi) load(t);
    }
    // [section] fwd producer: done
    return;
  }

  // A consumer warpgroup: its 64 rows' O and lse.
  const int tid = threadIdx.x % kWgThreads;
  const int warp = tid / 32;
  const int r0 = qb0 + kB * wg;
  unsigned char* mine = smem + wg * S::res_wg();
  float* sQ = reinterpret_cast<float*>(mine);
  signed char* sQ8 = reinterpret_cast<signed char*>(mine);
  if constexpr (Quant)
    load_rows8_wg<D>(sQ8, ext.q8 + qoff * D, r0, tq, tid);
  else
    load_rows_wg<D>(sQ, q + qoff * D, r0, tq, tid);
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
    const int row = r0 + lr + 8 * h;
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
  // The warpgroup's own rows: a tile none of them sees is skipped (its
  // terms are exactly zero), one wholly inside their extent is not tested.
  const bool live = r0 < tq;
  const KeySpan own = live ? key_span<Ext>(r0, kB, tq, tk, kN, causal, rel,
                                           ext, bh, posk_mm != nullptr)
                           : KeySpan{0, 0, 0, 0};
  const bool rows_full = r0 + kB <= tq;

  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  // q landed: fold scale*log2(e) into it (float32, as the reference's fold
  // at q.dtype); int8 q stays as it landed (sqf carries the fold).
  cp_async_wait<0>();
  wg_sync(wg);
  if constexpr (!Quant) {
    for (int idx = tid; idx < kB * D; idx += kWgThreads)
      sQ[idx / D * PQ + idx % D] *= qscale;
    wg_sync(wg);
  }
  const float* qa0 = sQ + (16 * warp + (tid % 32) / 4) * PQ + tid % 4;
  // [section] fwd consumer: prologue done

  Ring ring;
  for (int t = next_tile(span.lo); t < span.hi; t = next_tile(t + 1)) {
    const Ring kring = ring;   // this tile's K item, then its V item
    ring.next<kS>();
    const Ring vring = ring;
    ring.next<kS>();
    stage_wait(full + kring.slot, kring.phase);
    // [section] fwd consumer: stage landed
    if (live && span_sees<Ext>(own, t, kN, posk_mm, ext)) {
      const int k0 = t * kN;
      const int mt = k0 / kB;
      const unsigned char* st = sStages + kring.slot * S::stage(kN);
      const int* sv = reinterpret_cast<const int*>(st + S::off_vec(kN));
      float s[kN / 2];
      if constexpr (Quant) {
        // S = (float(q8 k8^T) * sqf) * skr, the int32 dots exact.
        int dot[kN / 2];
#pragma unroll
        for (int i = 0; i < kN / 2; ++i) dot[i] = 0;
        mma_s8_abt<D, NKT>(dot, sQ8 + 16 * warp * kP8<D>,
                           reinterpret_cast<const signed char*>(st));
        const float* skr = reinterpret_cast<const float*>(sv + 2 * kN);
#pragma unroll
        for (int i = 0; i < kN / 2; ++i)
          s[i] = __fmul_rn(__fmul_rn(static_cast<float>(dot[i]),
                                     sqf_r[(i >> 1) & 1]),
                           skr[acc_col(i)]);
      } else {
        // S = q2 K^T (log2 units: q is folded).
        const uint32_t kt = smem_u32(st);
        s_product<kN, D>(s, qa0, qa0 + 8 * PQ, kt, kt + S::plane_k(kN));
      }
      // [section] fwd consumer: S done

      // Masked scores to -inf; ALiBi's bias. A tile wholly inside the rows,
      // the columns, the causal extent and the window, with no mask or
      // segments, needs no per-element test.
      bool full_tile = rows_full && k0 + kN <= tk && mask.ptr == nullptr;
      if constexpr (Ext) {
        full_tile = full_tile && segk_row == nullptr &&
                    (posk_row != nullptr
                         ? posk_mm[2 * mt + 1] <= own.qmin &&
                               (ext.window <= 0 ||
                                static_cast<long long>(own.qmax) -
                                        posk_mm[2 * mt] <
                                    ext.window)
                         : (!causal || k0 + kN - 1 <= rel + r0) &&
                               (ext.window <= 0 ||
                                rel + r0 + kB - 1 - k0 < ext.window));
      } else {
        full_tile = full_tile && (!causal || k0 + kN - 1 <= rel + r0);
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
                    ? static_cast<long long>(pos_r[h]) - sv[kN + cl]
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
      if (full_tile)
        scores(std::false_type());
      else
        scores(std::true_type());

      // The online softmax on the fragments: a row's kN columns sit in the
      // 4 lanes of a quad.
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
                posk_row != nullptr ? sv[kN + cl] : kv_offset + k0 + cl);
            pn = drop_hash(drop_rh[h], col * 2246822519u, drop_bs) >=
                         ext.drop_threshold
                     ? p * ext.drop_inv : 0.f;
          }
        }
        s[i] = pn;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * corr[h] + psum[h];
      // [section] fwd consumer: softmax done
      mbar_arrive(empty + kring.slot);   // K's planes and vectors read

      // O += P V.
      stage_wait(full + vring.slot, vring.phase);
      // [section] fwd consumer: V landed
      const uint32_t vt = smem_u32(sStages + vring.slot * S::stage(kN));
      pv_product<kN, DV>(o, s, vt, vt + S::plane_v(kN));
      mbar_arrive(empty + vring.slot);
      // [section] fwd consumer: P.V done
    } else {
      // Nothing of this tile for these rows: both items pass on (a slot is
      // released only after its item landed).
      mbar_arrive(empty + kring.slot);
      stage_wait(full + vring.slot, vring.phase);
      mbar_arrive(empty + vring.slot);
    }
  }

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
    const int row = r0 + acc_row(i);
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
        lse[qoff + r0 + lr + 8 * h] =
            kLn2 * (m_run[h] + log2f(l[h] == 0.f ? 1.f : l[h]));
  }
  // [section] fwd consumer: done
}

// ---------------------------------------------------------------------------
// Launches.

template <int D, int DV, bool Ext, bool Quant>
int launch_fwd(const float* q, const float* k, const float* v, float* out,
               float* lse, const float* mvec, const MaskArgs& mask,
               int batch_heads, int group, int tq, int tk, int causal,
               int causal_offset, int kv_offset, float qscale,
               const ExtArgs& ext, cudaStream_t s) {
  if (tq == 0 || batch_heads == 0) return 0;
  using P = FwdPlan<D, DV, Quant>;
  // blockIdx.y the block from the last, so every row's longest causal
  // extents launch first.
  const int n_qblocks = (tq + kB * P::kWg - 1) / (kB * P::kWg);
  return launch(flash_fwd_f32_kernel<D, DV, Ext, Quant>,
                dim3(batch_heads, n_qblocks), P::kThreads, P::kBytes, s, q,
                k, v, out, lse, mvec, mask, tq, tk, group, causal,
                causal_offset, kv_offset, qscale, n_qblocks, ext);
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

// The kernel this library builds at widths (d, dv) of the grid, int8
// scoring or not: its dynamic shared memory, threads a block, the blocks an
// SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the threads
// a block computes with (the producer warpgroup aside). Returns a
// cudaError_t code; cudaErrorInvalidValue for a kernel the other library
// builds.
extern "C" int flash_fwd_f32_occupancy(int d, int dv, int quant, int* smem,
                                       int* threads, int* blocks,
                                       int* computing) {
#define FWD_OCC(D, DV, E, Q)                                                  \
  {                                                                           \
    *computing = kWgThreads * FwdPlan<D, DV, Q>::kWg;                         \
    return occupancy(flash_fwd_f32_kernel<D, DV, E, Q>,                       \
                     FwdPlan<D, DV, Q>::kThreads, FwdPlan<D, DV, Q>::kBytes,  \
                     smem, threads, blocks);                                  \
  }
#if !defined(FLASH_EXT)
#define OCC_CASE(D, DV)                                                       \
  if (d == D && dv == DV && !quant) FWD_OCC(D, DV, false, false)
#else
#define OCC_CASE(D, DV)                                                       \
  if (d == D && dv == DV) {                                                   \
    if (quant) FWD_OCC(D, DV, true, true)                                     \
    FWD_OCC(D, DV, true, false)                                               \
  }
#endif
  FLASH_GRID(OCC_CASE)
#undef OCC_CASE
#undef FWD_OCC
  return static_cast<int>(cudaErrorInvalidValue);
}
