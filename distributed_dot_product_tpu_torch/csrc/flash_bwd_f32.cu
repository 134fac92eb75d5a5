// The flash backward for Hopper (sm_90a) on float32 operands,
// float32-accurate: the dq kernel K3 and the dk/dv kernel K4, computing
// what csrc/flash_bwd.cu's bf16 kernels compute, at the operands' own
// dtype.
//
// Replaces the TPU kernels `_make_dq_kernel` (K3) and `_make_dkv_kernel`
// (K4) in distributed_dot_product_tpu/ops/pallas_attention.py when they run
// on float32 operands (the JAX package's default dtype).
//
// Products: every matrix product is three TF32 tensor-core products
// (3xTF32, csrc/tf32x3.cuh) on mma.sync m16n8k8: each operand x is split
// into big = cvt.rna.tf32(x) and small = cvt.rna.tf32(x - big), and
// small.big + big.small accumulate before big.big (the dropped small.small
// term sits ~2^-22 below the product). Only the int8 scoring's S
// (qk_quant='int8') is an exact s8 product, as in the bf16 kernels.
//
// What bounds them on the H100: the 3xTF32 products, 495 / 3 = 165 TFLOP/s
// of float32-accurate tensor-core work. At the LM's training shape (4 x 8
// heads, T 4096, head dim 96, causal: 268 M pairs) K3's (4d + 2d) flops a
// pair take 0.94 ms there and K4's 4(d + d) 1.25 ms, against ~80 MB of
// float32 operands and gradients (0.02 ms at 3.35 TB/s). wgmma's TF32 form
// reads both shared operands K-major only, and dQ = dS.K, dV = P^T.dO and
// dK = dS^T.q2 read theirs MN-major; 3xTF32 on wgmma would also need both
// parts of A in shared memory. So the products stay on mma.sync, whose
// fragments are plain shared loads, and the design feeds them:
//
//  - Split once. The streamed tiles (K3: K and V of each key tile; K4: q2
//    and dO of each query tile of each head of the GQA group) are split
//    into their (big, small) TF32 parts once, as they land, and stored as
//    interleaved pairs: every B fragment of every product is one 64-bit
//    shared load that yields both parts, and no product loop splits a B
//    operand. A pair tile's row r of W columns holds column c at pair
//    r * W + (c ^ swz(r)): the XOR (bits 2 and 3 of the column, from r mod
//    8) makes both fragment patterns conflict-free per half-warp: rows
//    g + 8 nt at columns t + 8 kk (S = q2.K^T, dP = dO.V^T and their K4
//    twins) and rows 2t, 2t + 1 at columns g + 8 nt (dQ, dV, dK, whose
//    reduction order is permuted as below). The resident A operands (K3:
//    q2, dO; K4: K, V) stay float32 rows padded to W + 4 floats, split in
//    registers once a k-step and used for every n-tile of the step.
//  - Two consumer warpgroups a block where the tiles fit (K3: 128 query
//    rows, K4: 128 key rows; each warpgroup its own 64 rows and its own
//    accumulators, no reduction across them), so an SM runs 8 computing
//    warps and each streamed tile is read from L2 and split once for 128
//    rows.
//  - A producer warpgroup owns the loads: 16-byte global loads into
//    registers, split there, stored to a ring of stages; full / empty
//    mbarriers hand each stage to the consumers and back, so the next
//    tiles land while the consumers compute.
//  - Products that share their k-steps run side by side (S with dP, S^T
//    with dP^T, dV with dK, where D == DV): twice the independent mma
//    chains a warp.
// A block of 384 threads holds 168 registers a thread (65536 / 384, a
// multiple of 8). setmaxnreg would hand the producer's share to the
// consumers at run time, but ptxas compiles the consumers to 168 all the
// same, so the kernels leave the shares as they are. At (96, 96) K4's 96
// accumulators and 32 score registers a thread do not fit beside the
// products' operands: part of dK / dV lives in local memory.
//
// The plans (computed from the shared-memory arithmetic below, for the
// float32 kernels; the int8-scored ones fit the same or more): consumer
// warpgroups / streamed rows a stage / stages
//   K3 and K4 at (32, 32), (64, 64): 2 / 64 / 2; (96, 96): 2 / 32 / 2;
//   (128, 128): 2 / 16 / 2; (192, 128): 1 / 16 / 2; (256, 256): 1 / 16 / 1
//   (one stage: the producer fills it as soon as the consumers release
//   it).
// K4 with D + DV > 192 splits into two blocks per key block (grid z): one
// accumulates dV, the other dK (both recompute S^T), so that a thread
// holds max(D, DV) / 2 accumulators and not (D + DV) / 2.
//
// Numerics are the float32 forward's (csrc/flash_f32.cu): p = exp2(q2.k^T -
// lse2), ds = p * (dO.v^T - delta) with no rounding between products; every
// reduction runs at most 64 wide in fresh registers (the tensor core rounds
// each mma's sum toward zero, so one long chain drifts) and is added to the
// running sum with a rounded float add; dS.K (P^T.dO, dS^T.q2) takes A from
// the score accumulators with each 8-wide slice's reduction in the order 0,
// 2, 4, 6, 1, 3, 5, 7 (A's k = t is column 2t, k = t + 4 column 2t + 1, and
// B's rows follow). Masks, GQA (K4 sums the group's heads in float32 in a
// fixed order), causal_offset / kv_offset, and the Ext features (segments,
// window, coordinate-hash dropout, ALiBi, explicit positions, int8 scoring
// with its straight-through backward) are the bf16 kernels' (see
// csrc/flash_bwd.cu), with a dense mask read straight from device memory. No
// atomics: two runs of any case are equal bit for bit.

#include <math.h>

#include <type_traits>

#include "hopper.cuh"      // kB, cp.async, mbarriers, acc_row/col
#include "flash_ext.cuh"   // MaskArgs, ExtArgs, drop_hash
#include "tf32x3.cuh"      // split, frag_a, mma3_parts
#include "f32_tiles.cuh"   // kPf, kP8, tile sizes, mma_s8_abt
#include "f32_pipeline.cuh"   // stages, mbarriers, spans, launches

namespace {

constexpr float kLn2 = 0.693147180559945309f;

// ---------------------------------------------------------------------------
// Split tiles: W (big, small) pairs a row, column c of row r at pair
// r * W + (c ^ swz(r)).

__device__ __forceinline__ int swz(int r) {
  return 4 * (((r ^ (r >> 2)) & 1) | (r & 2));
}

// Rows [row0, row0 + N) of a (rows, W) float32 matrix at `src` into the
// split tile `dst`, rows at or past `limit` as zeros, by the producer's
// thread `tid` of 128: all of the thread's 16-byte loads (at most 8 in
// every plan) in flight at once, then each becomes four pairs, 32
// contiguous bytes (the XOR moves groups of four pairs), stored half by
// half in an order that puts a quarter-warp's eight stores on eight bank
// groups.
template <int W, int N>
__device__ __forceinline__ void split_rows(uint2* dst, const float* src,
                                           int row0, int limit, int tid) {
  constexpr int kQ = W / 4;                      // 16-byte loads a row
  constexpr int kPer = N * kQ / kProducer;       // a thread's loads
  static_assert(N * kQ % kProducer == 0 && kPer <= 8, "tile");
  float4 x[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = i * kProducer + tid, r = idx / kQ;
    x[i] = row0 + r < limit
               ? __ldg(reinterpret_cast<const float4*>(
                           src + static_cast<size_t>(row0 + r) * W) +
                       idx % kQ)
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = i * kProducer + tid, r = idx / kQ, j = idx % kQ;
    uint4 lo, hi;
    split(x[i].x, lo.x, lo.y);
    split(x[i].y, lo.z, lo.w);
    split(x[i].z, hi.x, hi.y);
    split(x[i].w, hi.z, hi.w);
    uint4* p = reinterpret_cast<uint4*>(dst + r * W + ((4 * j) ^ swz(r)));
    if ((j >> 2) & 1) {
      p[1] = hi;
      p[0] = lo;
    } else {
      p[0] = lo;
      p[1] = hi;
    }
  }
}

// ---------------------------------------------------------------------------
// Products on split B tiles.

// One product of a fused group: acc += A . B^T (mma_abt_split) with A the
// warp's 16 rows at `a` (pitch pa floats), or acc += P . B (mma_pb_split)
// with P the accumulators at `a`; B the split tile `b`.
struct Prod {
  float* acc;
  const float* a;
  int pa;
  const uint2* b;
};

// For each of the M products: acc (16 x 8 NT, the accumulators side by
// side) += A . B^T, A 16 rows of K columns, B the split tile of 8 NT rows
// of K columns, both read K-major. The M products share their k-steps, so
// 4 M accumulators take mma steps side by side. Row g + 8 nt's column
// 8 kk + t (+ 4) sits at pair 8 kk + (t (+ 4) ^ (x & 4)) +- (x & 8), x =
// swz(g): the sign follows kk's parity (bit 3 of the XOR flips kk's
// lowest bit), so both offsets are fixed a thread.
template <int K, int NT, int M>
__device__ __forceinline__ void mma_abt_split(const Prod (&op)[M]) {
  constexpr int kPiece = K < 64 ? K : 64;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int x = swz(g), flip = x & 8;
  const int o0 = g * K + (t ^ (x & 4)), o1 = g * K + ((t + 4) ^ (x & 4));
  const int b0[2] = {o0 + flip, o0 - flip};
  const int b1[2] = {o1 + flip, o1 - flip};
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += kPiece) {
    float part[M][4 * NT];
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int i = 0; i < 4 * NT; ++i) part[m][i] = 0.f;
    const int k1 = k0 + kPiece < K ? k0 + kPiece : K;
#pragma unroll
    for (int kk = k0 / 8; kk < k1 / 8; ++kk) {
      FragA fa[M];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float* a0 = op[m].a + g * op[m].pa + t + 8 * kk;
        const float* a1 = a0 + 8 * op[m].pa;
        fa[m] = frag_a(a0[0], a1[0], a0[4], a1[4]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const uint2 lo = op[m].b[b0[kk & 1] + 8 * nt * K + 8 * kk];
          const uint2 hi = op[m].b[b1[kk & 1] + 8 * nt * K + 8 * kk];
          mma3_parts(part[m] + 4 * nt, fa[m], lo.x, lo.y, hi.x, hi.y);
        }
    }
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int i = 0; i < 4 * NT; ++i) op[m].acc[i] += part[m][i];
  }
}

// For each of the M products: acc (16 x 8 NT) += P . B, P the 16 x 8 NK
// accumulators at `a` (slice ks's columns 2t, 2t + 1 in a[4 ks + 0..3]),
// B the split tile of 8 NK rows of 8 NT columns. Slice ks's reduction runs
// in the order 0, 2, 4, 6, 1, 3, 5, 7: A's k = t is column 2t and k = t +
// 4 column 2t + 1, and B's rows follow (rows 2t and 2t + 1, column 8 nt +
// g at pair 8 nt + (g ^ (x & 4)) +- (x & 8), the sign from nt's parity).
// The product's columns go in pieces of at most 8 PW (N0: the first n-tile
// of this piece), each summed over the NK slices in fresh registers and
// added to acc.
template <int NK, int NT, int PW, int M, int N0 = 0>
__device__ __forceinline__ void mma_pb_split(const Prod (&op)[M]) {
  constexpr int W = NT - N0 < PW ? NT - N0 : PW;   // n-tiles of this piece
  constexpr int kRow = 8 * NT;                     // pairs a row
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int x0 = swz(2 * t), x1 = swz(2 * t + 1);
  const int o0 = 2 * t * kRow + (g ^ (x0 & 4));
  const int o1 = (2 * t + 1) * kRow + (g ^ (x1 & 4));
  const int b0[2] = {o0 + (x0 & 8), o0 - (x0 & 8)};
  const int b1[2] = {o1 + (x1 & 8), o1 - (x1 & 8)};
  float part[M][4 * W];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int i = 0; i < 4 * W; ++i) part[m][i] = 0.f;
#pragma unroll
  for (int ks = 0; ks < NK; ++ks) {
    FragA fa[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float* p = op[m].a;
      fa[m] = frag_a(p[4 * ks], p[4 * ks + 2], p[4 * ks + 1],
                     p[4 * ks + 3]);
    }
#pragma unroll
    for (int nt = N0; nt < N0 + W; ++nt)
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const uint2 lo = op[m].b[b0[nt & 1] + 8 * ks * kRow + 8 * nt];
        const uint2 hi = op[m].b[b1[nt & 1] + 8 * ks * kRow + 8 * nt];
        mma3_parts(part[m] + 4 * (nt - N0), fa[m], lo.x, lo.y, hi.x, hi.y);
      }
  }
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int i = 0; i < 4 * W; ++i) op[m].acc[4 * N0 + i] += part[m][i];
  if constexpr (N0 + W < NT) mma_pb_split<NK, NT, PW, M, N0 + W>(op);
}

// ---------------------------------------------------------------------------
// The plan.

// A kernel's plan, the first that fits (csrc/f32_pipeline.cuh) beside its
// mbarriers: two consumer warpgroups with 64, 32 or 16 rows a stage and
// two stages; one with 32 or 16 rows and two; two with 16 rows and one
// stage; one with 16 and one.
template <typename Sm>
__host__ __device__ constexpr int plan_of() {
  return fits<Sm>(2, 64, 2) ? 0 : fits<Sm>(2, 32, 2) ? 1
       : fits<Sm>(2, 16, 2) ? 2 : fits<Sm>(1, 32, 2) ? 3
       : fits<Sm>(1, 16, 2) ? 4 : fits<Sm>(2, 16, 1) ? 5 : 6;
}

template <typename Sm>
struct Plan {
  static constexpr int kCode = plan_of<Sm>();
  static constexpr int kWg = kCode <= 2 || kCode == 5 ? 2 : 1;
  static constexpr int kN = kCode == 0 ? 64 : (kCode == 1 || kCode == 3)
                                                 ? 32 : 16;
  static constexpr int kS = kCode >= 5 ? 1 : 2;
  static constexpr int kThreads = kWgThreads * kWg + kProducer;
  static constexpr size_t kBars = Sm::res(kWg) + kS * Sm::stage(kN);
  static constexpr size_t kBytes = kBars + 2 * kS * sizeof(uint64_t);
  static_assert(kBytes <= kSmemLimit, "shared memory");
};

// ---------------------------------------------------------------------------
// K3 (dq). Resident, per consumer warpgroup: its 64 q2 rows (int8 q with
// Quant) and dO rows. A stage: kN key rows of K (k~ with Quant) and V,
// split; the int8 k with Quant; then 3 x kN words: segment ids, positions,
// k scales.

template <int D, int DV, bool Quant>
struct DqSmem {
  __host__ __device__ static constexpr size_t res_q() {
    return Quant ? tile_i8<D>(kB) : tile_f32<D>(kB);
  }
  __host__ __device__ static constexpr size_t res_wg() {
    return res_q() + tile_f32<DV>(kB);
  }
  __host__ __device__ static constexpr size_t res(int wg) {
    return wg * res_wg();
  }
  __host__ __device__ static constexpr size_t off_v(int n) {
    return 8 * static_cast<size_t>(n) * D;
  }
  __host__ __device__ static constexpr size_t off_k8(int n) {
    return off_v(n) + 8 * static_cast<size_t>(n) * DV;
  }
  __host__ __device__ static constexpr size_t off_vec(int n) {
    return off_k8(n) + (Quant ? tile_i8<D>(n) : 0);
  }
  __host__ __device__ static constexpr size_t stage(int n) {
    return off_vec(n) + 3 * 4 * static_cast<size_t>(n);
  }
};

// dq for one block of 64 x kWg query rows of one (batch, head) row: q2
// (batch_heads, tq, D), dO (batch_heads, tq, DV), k (batch_heads / group,
// tk, D; k~ with Quant), v (batch_heads / group, tk, DV), lse2, delta
// (batch_heads, tq); dq = scale * ds.k, float32.
template <int D, int DV, bool Ext, bool Quant>
__global__ void __launch_bounds__(Plan<DqSmem<D, DV, Quant>>::kThreads, 1)
flash_dq_f32_kernel(const float* __restrict__ q2, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ g,
                    const float* __restrict__ lse2,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    MaskArgs mask, int tq, int tk, int group, int causal,
                    int causal_offset, int kv_offset, float scale,
                    int n_qblocks, ExtArgs ext) {
  static_assert(D % 32 == 0 && D <= 256 && DV % 32 == 0 && DV <= 256,
                "head dims must be 32*n <= 256");
  static_assert(!Quant || Ext, "int8 scoring is Ext");
  using S = DqSmem<D, DV, Quant>;
  using P = Plan<S>;
  constexpr int kWg = P::kWg, kN = P::kN, kS = P::kS;
  constexpr int NKT = kN / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sStages = smem + S::res(kWg);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::kBars);
  uint64_t* empty = full + kS;
  // [section] dq start

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
  const long long rel = static_cast<long long>(causal_offset) - kv_offset;
  // The key tiles the block's rows see, in the order both roles walk them.
  const KeySpan span = key_span<Ext>(qb0, kB * kWg, tq, tk, kN, causal, rel,
                                     ext, bh, posk_mm != nullptr);
  auto next_tile = [&](int t) {
    while (t < span.hi && !span_sees<Ext>(span, t, kN, posk_mm, ext)) ++t;
    return t;
  };
  init_bars<kS>(full, empty, kWgThreads * kWg);

  const int wg = warpgroup_of_thread();   // the producer: wg == kWg
  if (wg == kWg) {
    // The producer: each tile the block sees into the next free stage.
    const int ptid = threadIdx.x % kWgThreads;
    const float* kbase = k + static_cast<size_t>(bkv) * tk * D;
    const float* vbase = v + static_cast<size_t>(bkv) * tk * DV;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = next_tile(span.lo); t < span.hi; t = next_tile(t + 1)) {
      stage_wait(empty + stage, phase ^ 1);
      // [section] dq producer: free stage
      unsigned char* st = sStages + stage * S::stage(kN);
      split_rows<D, kN>(reinterpret_cast<uint2*>(st), kbase, t * kN, tk,
                        ptid);
      split_rows<DV, kN>(reinterpret_cast<uint2*>(st + S::off_v(kN)), vbase,
                         t * kN, tk, ptid);
      if constexpr (Quant)
        copy_rows8<D, kN>(reinterpret_cast<signed char*>(st + S::off_k8(kN)),
                          ext.k8 + static_cast<size_t>(bkv) * tk * D, t * kN,
                          tk, ptid);
      int* sv = reinterpret_cast<int*>(st + S::off_vec(kN));
      if constexpr (Ext) {
        if (segk_row != nullptr) copy_vec<kN>(sv, segk_row, t * kN, tk, ptid);
        if (posk_row != nullptr)
          copy_vec<kN>(sv + kN, posk_row, t * kN, tk, ptid);
      }
      if constexpr (Quant)
        copy_vec<kN>(sv + 2 * kN, ext.skr + static_cast<size_t>(bkv) * tk,
                     t * kN, tk, ptid);
      mbar_arrive(full + stage);
      // [section] dq producer: stage stored
      if (++stage == kS) {
        stage = 0;
        phase ^= 1;
      }
    }
    // [section] dq producer: done
  } else {
    // A consumer warpgroup: its 64 rows' dq.
    const int tid = threadIdx.x % kWgThreads;
    const int warp = tid / 32;
    const int r0 = qb0 + kB * wg;
    unsigned char* mine = smem + wg * S::res_wg();
    float* sQ = reinterpret_cast<float*>(mine);
    signed char* sQ8 = reinterpret_cast<signed char*>(mine);
    float* sG = reinterpret_cast<float*>(mine + S::res_q());
    if constexpr (Quant)
      load_rows8_wg<D>(sQ8, ext.q8 + qoff * D, r0, tq, tid);
    else
      load_rows_wg<D>(sQ, q2 + qoff * D, r0, tq, tid);
    load_rows_wg<DV>(sG, g + qoff * DV, r0, tq, tid);
    cp_async_commit();

    const int lr = acc_row(0);
    bool row_ok[2];
    long long row_pos[2];
    float lse_r[2], delta_r[2], sqf_r[2] = {0.f, 0.f};
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
      lse_r[h] = row_ok[h] ? lse2[qoff + row] : 0.f;
      delta_r[h] = row_ok[h] ? delta[qoff + row] : 0.f;
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

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    cp_async_wait<0>();
    wg_sync(wg);   // the warpgroup's resident rows landed
    // [section] dq consumer: prologue done

    int stage = 0;
    uint32_t phase = 0;
    for (int t = next_tile(span.lo); t < span.hi; t = next_tile(t + 1)) {
      stage_wait(full + stage, phase);
      // [section] dq consumer: stage landed
      if (live && span_sees<Ext>(own, t, kN, posk_mm, ext)) {
        const int k0 = t * kN;
        const int mt = k0 / kB;
        const unsigned char* st = sStages + stage * S::stage(kN);
        const uint2* sK = reinterpret_cast<const uint2*>(st);
        const uint2* sV = reinterpret_cast<const uint2*>(st + S::off_v(kN));
        const int* sv = reinterpret_cast<const int*>(st + S::off_vec(kN));
        // S (int8: (float(dot) * sqf_q) * skr_k) and dP = dO V^T.
        float s[kN / 2], dp[kN / 2];
#pragma unroll
        for (int i = 0; i < kN / 2; ++i) dp[i] = 0.f;
        if constexpr (Quant) {
          int dot[kN / 2];
#pragma unroll
          for (int i = 0; i < kN / 2; ++i) dot[i] = 0;
          mma_s8_abt<D, NKT>(
              dot, sQ8 + 16 * warp * kP8<D>,
              reinterpret_cast<const signed char*>(st + S::off_k8(kN)));
          const float* skr = reinterpret_cast<const float*>(sv + 2 * kN);
#pragma unroll
          for (int i = 0; i < kN / 2; ++i)
            s[i] = __fmul_rn(__fmul_rn(static_cast<float>(dot[i]),
                                       sqf_r[(i >> 1) & 1]),
                             skr[acc_col(i)]);
        }
        const Prod p_s{s, sQ + 16 * warp * kPf<D>, kPf<D>, sK};
        const Prod p_dp{dp, sG + 16 * warp * kPf<DV>, kPf<DV>, sV};
        if constexpr (!Quant) {
#pragma unroll
          for (int i = 0; i < kN / 2; ++i) s[i] = 0.f;
        }
        if constexpr (!Quant && D == DV) {
          // S and dP side by side: twice the independent mma chains.
          mma_abt_split<D, NKT>({p_s, p_dp});
        } else {
          if constexpr (!Quant) mma_abt_split<D, NKT>({p_s});
          mma_abt_split<DV, NKT>({p_dp});
        }
        // [section] dq consumer: S and dP done

        // dS = P * (dP - delta), P = exp2(S - lse2) where allowed, else 0.
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
            float dpv = dp[i];
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
              if (ext.dropout) {
                const unsigned int ch =
                    static_cast<unsigned int>(posk_row != nullptr
                                                  ? sv[kN + cl]
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
        if (full_tile)
          scores(std::false_type());
        else
          scores(std::true_type());
        // [section] dq consumer: scores done

        // dQ += dS . K (k~), 64 columns a piece.
        mma_pb_split<NKT, D / 8, 8>({Prod{acc, dp, 0, sK}});
        // [section] dq consumer: gradient products done
      }
      mbar_arrive(empty + stage);
      if (++stage == kS) {
        stage = 0;
        phase ^= 1;
      }
    }

    float* ob = dq + qoff * D;
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int row = r0 + acc_row(i);
      if (row < tq)
        *reinterpret_cast<float2*>(ob + static_cast<size_t>(row) * D +
                                   acc_col(i)) =
            make_float2(acc[i] * scale, acc[i + 1] * scale);
    }
    // [section] dq consumer: done
  }
}

// ---------------------------------------------------------------------------
// K4 (dk, dv). Resident, per consumer warpgroup: its 64 key rows of K
// (int8 k with Quant) and V. A stage: kN query rows of q2 (q~ with Quant)
// and dO, split; the int8 q with Quant; then 5 x kN words: lse2, delta,
// sqf, segment ids, positions.

template <int D, int DV, bool Quant>
struct DkvSmem {
  __host__ __device__ static constexpr size_t res_k() {
    return Quant ? tile_i8<D>(kB) : tile_f32<D>(kB);
  }
  __host__ __device__ static constexpr size_t res_wg() {
    return res_k() + tile_f32<DV>(kB);
  }
  __host__ __device__ static constexpr size_t res(int wg) {
    return wg * res_wg();
  }
  __host__ __device__ static constexpr size_t off_g(int n) {
    return 8 * static_cast<size_t>(n) * D;
  }
  __host__ __device__ static constexpr size_t off_q8(int n) {
    return off_g(n) + 8 * static_cast<size_t>(n) * DV;
  }
  __host__ __device__ static constexpr size_t off_vec(int n) {
    return off_q8(n) + (Quant ? tile_i8<D>(n) : 0);
  }
  __host__ __device__ static constexpr size_t stage(int n) {
    return off_vec(n) + 5 * 4 * static_cast<size_t>(n);
  }
};

// dk/dv split into a dV block and a dK block (grid z) past D + DV = 192:
// the accumulators of both would take (D + DV) / 2 registers a thread.
template <int D, int DV>
constexpr bool kDkvSplit = D + DV > 192;

// The query tiles of kN rows that key rows [key0, key0 + rows) see:
// [lo, hi) (row r sees key column c when rel + r >= c; with a window, rows
// r < window + c_last - rel + 1 still see the newest key) and, with
// positions, the keys' [kmin, kmax] in pk.
struct QuerySpan {
  int lo, hi;
};

template <bool Ext>
__device__ __forceinline__ QuerySpan query_span(int key0, int rows, int tq,
                                                int kn, int causal,
                                                long long rel,
                                                const ExtArgs& ext) {
  const int n_qtiles = (tq + kn - 1) / kn;
  QuerySpan sp{0, n_qtiles};
  if (causal) {
    const long long r_min = static_cast<long long>(key0) - rel;
    sp.lo = r_min <= 0 ? 0
          : (r_min >= tq ? n_qtiles : static_cast<int>(r_min / kn));
  }
  if constexpr (Ext) {
    if (causal && ext.window > 0) {
      const long long r_end = ext.window + key0 + rows - 1 - rel;
      sp.hi = r_end <= 0 ? 0
            : (r_end >= tq ? n_qtiles
                           : static_cast<int>((r_end + kn - 1) / kn));
    }
  }
  return sp;
}

// [kmin, kmax] of the positions of key rows [key0, key0 + rows) ∩ [0, tk)
// of flat row bh (the per-64-row table).
__device__ __forceinline__ int2 key_pos_range(const ExtArgs& ext, int bh,
                                              int key0, int rows, int tk) {
  const int* mm = vec_row(ext.posk_mm, bh);
  int2 r = make_int2(mm[2 * (key0 / kB)], mm[2 * (key0 / kB) + 1]);
  for (int m = key0 / kB + 1; m * kB < key0 + rows && m * kB < tk; ++m) {
    r.x = min(r.x, mm[2 * m]);
    r.y = max(r.y, mm[2 * m + 1]);
  }
  return r;
}

// Does a span (with the keys' position range pk, where positions are on)
// see query tile qt of flat row bh? Positions: K3's skip from the key side
// (64-row tables: a kN-row tile reads its 64-row tile's).
template <bool Ext>
__device__ __forceinline__ bool span_sees_q(const QuerySpan& sp, int qt,
                                            int kn, int bh, int2 pk,
                                            const ExtArgs& ext) {
  bool yes = qt >= sp.lo && qt < sp.hi;
  if constexpr (Ext) {
    if (yes && ext.posk.ptr != nullptr) {
      const int* pq = vec_row(ext.posq_mm, bh) + 2 * (qt * kn / kB);
      yes = !(pk.x > pq[1] ||
              (ext.window > 0 &&
               static_cast<long long>(pq[0]) - pk.y >= ext.window));
    }
  }
  return yes;
}

// dk and dv for one block of 64 x kWg key rows of one kv head (split: dV
// for z = 0, dK for z = 1), summing the GQA group's query heads in float32:
// q2 (batch_heads, tq, D; q~ with Quant), dO (batch_heads, tq, DV), k
// (batch_heads / group, tk, D), v (batch_heads / group, tk, DV), lse2,
// delta (batch_heads, tq); dk = dk_mul * ds^T.q2, dv = p^T.dO, float32.
template <int D, int DV, bool Ext, bool Quant>
__global__ void __launch_bounds__(Plan<DkvSmem<D, DV, Quant>>::kThreads, 1)
flash_dkv_f32_kernel(const float* __restrict__ q2,
                     const float* __restrict__ k, const float* __restrict__ v,
                     const float* __restrict__ g,
                     const float* __restrict__ lse2,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, MaskArgs mask, int tq, int tk,
                     int group, int causal, int causal_offset, int kv_offset,
                     float dk_mul, ExtArgs ext) {
  static_assert(D % 32 == 0 && D <= 256 && DV % 32 == 0 && DV <= 256,
                "head dims must be 32*n <= 256");
  static_assert(!Quant || Ext, "int8 scoring is Ext");
  using S = DkvSmem<D, DV, Quant>;
  using P = Plan<S>;
  constexpr int kWg = P::kWg, kN = P::kN, kS = P::kS;
  constexpr int NKT = kN / 8;
  constexpr bool kSplit = kDkvSplit<D, DV>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sStages = smem + S::res(kWg);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::kBars);
  uint64_t* empty = full + kS;
  // [section] dkv start

  const int kb0 = static_cast<int>(blockIdx.y) * kB * kWg;
  const int bkv = blockIdx.x;
  const bool do_dv = !kSplit || blockIdx.z == 0;
  const bool do_dk = !kSplit || blockIdx.z == 1;
  const long long rel = static_cast<long long>(causal_offset) - kv_offset;
  const bool pos = Ext && ext.posk.ptr != nullptr;
  // The query tiles the block's keys see, over the group's heads: work
  // items (head of the group, query tile), in the order both roles walk
  // them.
  const QuerySpan span = query_span<Ext>(kb0, kB * kWg, tq, kN, causal, rel,
                                         ext);
  auto sees = [&](int h, int qt) {
    const int bh = bkv * group + h;
    return span_sees_q<Ext>(span, qt, kN, bh,
                            pos ? key_pos_range(ext, bh, kb0, kB * kWg, tk)
                                : make_int2(0, 0),
                            ext);
  };
  auto next_item = [&](int& h, int& qt) {
    while (h < group) {
      if (qt >= span.hi) {
        ++h;
        qt = span.lo;
      } else if (!sees(h, qt)) {
        ++qt;
      } else {
        return;
      }
    }
  };
  init_bars<kS>(full, empty, kWgThreads * kWg);

  const int wg = warpgroup_of_thread();   // the producer: wg == kWg
  if (wg == kWg) {
    // The producer: each (head, query tile) item into the next free stage.
    const int ptid = threadIdx.x % kWgThreads;
    int stage = 0;
    uint32_t phase = 0;
    int h = 0, qt = span.lo;
    for (next_item(h, qt); h < group; ++qt, next_item(h, qt)) {
      stage_wait(empty + stage, phase ^ 1);
      // [section] dkv producer: free stage
      const int bh = bkv * group + h;
      const size_t qoff = static_cast<size_t>(bh) * tq;
      const int q0 = qt * kN;
      unsigned char* st = sStages + stage * S::stage(kN);
      split_rows<D, kN>(reinterpret_cast<uint2*>(st), q2 + qoff * D, q0, tq,
                        ptid);
      split_rows<DV, kN>(reinterpret_cast<uint2*>(st + S::off_g(kN)),
                         g + qoff * DV, q0, tq, ptid);
      if constexpr (Quant)
        copy_rows8<D, kN>(reinterpret_cast<signed char*>(st + S::off_q8(kN)),
                          ext.q8 + qoff * D, q0, tq, ptid);
      float* sr = reinterpret_cast<float*>(st + S::off_vec(kN));
      copy_vec<kN>(sr, lse2 + qoff, q0, tq, ptid);
      copy_vec<kN>(sr + kN, delta + qoff, q0, tq, ptid);
      if constexpr (Quant)
        copy_vec<kN>(sr + 2 * kN, ext.sqf + qoff, q0, tq, ptid);
      if constexpr (Ext) {
        if (ext.segq.ptr != nullptr)
          copy_vec<kN>(sr + 3 * kN, vec_row(ext.segq, bh), q0, tq, ptid);
        if (ext.posq.ptr != nullptr)
          copy_vec<kN>(sr + 4 * kN, vec_row(ext.posq, bh), q0, tq, ptid);
      }
      mbar_arrive(full + stage);
      // [section] dkv producer: stage stored
      if (++stage == kS) {
        stage = 0;
        phase ^= 1;
      }
    }
    // [section] dkv producer: done
  } else {
    // A consumer warpgroup: its 64 key rows' dk and dv.
    const int tid = threadIdx.x % kWgThreads;
    const int warp = tid / 32;
    const int k0 = kb0 + kB * wg;
    unsigned char* mine = smem + wg * S::res_wg();
    float* sK = reinterpret_cast<float*>(mine);
    signed char* sK8 = reinterpret_cast<signed char*>(mine);
    float* sV = reinterpret_cast<float*>(mine + S::res_k());
    if constexpr (Quant)
      load_rows8_wg<D>(sK8, ext.k8 + static_cast<size_t>(bkv) * tk * D, k0, tk,
                       tid);
    else
      load_rows_wg<D>(sK, k + static_cast<size_t>(bkv) * tk * D, k0, tk, tid);
    load_rows_wg<DV>(sV, v + static_cast<size_t>(bkv) * tk * DV, k0, tk, tid);
    cp_async_commit();

    // This thread's two key rows of the accumulator layout.
    const int lr = acc_row(0);
    bool krow_ok[2];
    int kpos[2];
    float skr_r[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      kpos[j] = k0 + lr + 8 * j;
      krow_ok[j] = kpos[j] < tk;
      if constexpr (Quant)
        skr_r[j] = krow_ok[j]
                       ? ext.skr[static_cast<size_t>(bkv) * tk + kpos[j]] : 0.f;
    }
    // The warpgroup's own keys: an item none of them sees is skipped.
    const bool live = k0 < tk;
    const QuerySpan own = query_span<Ext>(k0, kB, tq, kN, causal, rel, ext);

    // dK (or, split, the block's one part) and dV.
    constexpr int kAcc = kSplit ? (D > DV ? D : DV) : D;
    float acc_a[kAcc / 2], acc_v[kSplit ? 1 : DV / 2];
#pragma unroll
    for (int i = 0; i < kAcc / 2; ++i) acc_a[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (kSplit ? 1 : DV / 2); ++i) acc_v[i] = 0.f;
    cp_async_wait<0>();
    wg_sync(wg);   // the warpgroup's resident rows landed

    // The head's state (read per query head, as it is addressed).
    int cur_h = -1;
    const unsigned char* mbase = nullptr;
    int segk_r[2] = {0, 0}, posk_r[2] = {0, 0};
    unsigned int drop_ch[2] = {0u, 0u};
    unsigned int drop_bs = 0u;
    float slope = 0.f;
    int2 kmm = make_int2(0, 0);
    const int* posq_mm = nullptr;
    // [section] dkv consumer: prologue done
    int stage = 0;
    uint32_t phase = 0;
    int h = 0, qt = span.lo;
    for (next_item(h, qt); h < group; ++qt, next_item(h, qt)) {
      const int bh = bkv * group + h;
      if (h != cur_h && live) {
        cur_h = h;
        if (mask.ptr != nullptr) mbase = mask_base(mask, bh);
        if constexpr (Ext) {
          drop_bs = ext.seed + static_cast<unsigned int>(bh) * 668265263u;
          if (ext.alibi != nullptr) slope = ext.alibi[bh];
          if (pos) {
            posq_mm = vec_row(ext.posq_mm, bh);
            kmm = key_pos_range(ext, bh, k0, kB, tk);
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (ext.segq.ptr != nullptr)
              segk_r[j] = krow_ok[j] ? vec_row(ext.segk, bh)[kpos[j]] : 0;
            if (ext.posk.ptr != nullptr)
              posk_r[j] = krow_ok[j] ? vec_row(ext.posk, bh)[kpos[j]] : 0;
            const long long col =
                ext.posk.ptr != nullptr
                    ? posk_r[j]
                    : static_cast<long long>(kv_offset) + kpos[j];
            drop_ch[j] = static_cast<unsigned int>(col) * 2246822519u;
          }
        }
      }
      stage_wait(full + stage, phase);
      // [section] dkv consumer: stage landed
      if (live && span_sees_q<Ext>(own, qt, kN, bh, kmm, ext)) {
        const int q0 = qt * kN;
        const unsigned char* st = sStages + stage * S::stage(kN);
        const uint2* sQ = reinterpret_cast<const uint2*>(st);
        const uint2* sG = reinterpret_cast<const uint2*>(st + S::off_g(kN));
        const float* sLse = reinterpret_cast<const float*>(st + S::off_vec(kN));
        const float* sDelta = sLse + kN;
        const int* sSegQ = reinterpret_cast<const int*>(sLse + 3 * kN);
        const int* sPosQ = sSegQ + kN;
        // S^T = K q2^T (int8: (float(dot) * sqf_q) * skr_k) and dP^T = V
        // dO^T: rows are this warp's keys, columns the queries.
        float s[kN / 2], dp[kN / 2];
#pragma unroll
        for (int i = 0; i < kN / 2; ++i) dp[i] = 0.f;
        if constexpr (Quant) {
          int dot[kN / 2];
#pragma unroll
          for (int i = 0; i < kN / 2; ++i) dot[i] = 0;
          mma_s8_abt<D, NKT>(
              dot, sK8 + 16 * warp * kP8<D>,
              reinterpret_cast<const signed char*>(st + S::off_q8(kN)));
          const float* sqf = sLse + 2 * kN;
#pragma unroll
          for (int i = 0; i < kN / 2; ++i)
            s[i] = __fmul_rn(__fmul_rn(static_cast<float>(dot[i]),
                                       sqf[acc_col(i)]),
                             skr_r[(i >> 1) & 1]);
        }
        const Prod p_s{s, sK + 16 * warp * kPf<D>, kPf<D>, sQ};
        const Prod p_dp{dp, sV + 16 * warp * kPf<DV>, kPf<DV>, sG};
        if constexpr (!Quant) {
#pragma unroll
          for (int i = 0; i < kN / 2; ++i) s[i] = 0.f;
        }
        if constexpr (!Quant && D == DV) {
          // S^T and dP^T side by side (the dV block of a split needs S^T
          // alone).
          if (do_dk)
            mma_abt_split<D, NKT>({p_s, p_dp});
          else
            mma_abt_split<D, NKT>({p_s});
        } else {
          if constexpr (!Quant) mma_abt_split<D, NKT>({p_s});
          if (do_dk) mma_abt_split<DV, NKT>({p_dp});
        }
        // [section] dkv consumer: S and dP done

        // P^T into s (the dropped, rescaled weights dv takes), dS^T into dp.
        bool full_tile = k0 + kB <= tk && q0 + kN <= tq && mask.ptr == nullptr;
        if constexpr (Ext) {
          const int mq = q0 / kB;
          full_tile =
              full_tile && ext.segq.ptr == nullptr &&
              (ext.posq.ptr != nullptr
                   ? kmm.y <= posq_mm[2 * mq] &&
                         (ext.window <= 0 ||
                          static_cast<long long>(posq_mm[2 * mq + 1]) - kmm.x <
                              ext.window)
                   : (!causal || k0 + kB - 1 <= rel + q0) &&
                         (ext.window <= 0 ||
                          rel + q0 + kN - 1 - k0 < ext.window));
        } else {
          full_tile = full_tile && (!causal || k0 + kB - 1 <= rel + q0);
        }
        auto scores = [&](auto tested) {
          constexpr bool kTest = decltype(tested)::value;
#pragma unroll
          for (int i = 0; i < kN / 2; ++i) {
            const int j = (i >> 1) & 1;
            const int qc = acc_col(i);
            const int qrow = q0 + qc;
            bool valid = true;
            if constexpr (kTest) {
              valid = krow_ok[j] && qrow < tq &&
                      (!causal || kpos[j] <= rel + qrow);
              if (mbase != nullptr)
                valid = valid && !mbase[static_cast<long long>(qrow) *
                                            mask.sr +
                                        kpos[j]];
            }
            float sc = s[i];
            float dpv = dp[i];
            float keep_mul = 1.f;
            if constexpr (Ext) {
              const long long back =
                  ext.posq.ptr != nullptr
                      ? static_cast<long long>(sPosQ[qc]) - posk_r[j]
                      : rel + qrow - kpos[j];
              if constexpr (kTest) {
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
        if (full_tile)
          scores(std::false_type());
        else
          scores(std::true_type());
        // [section] dkv consumer: scores done

        // dV += P^T . dO and dK += dS^T . q2 (q~), 32 columns a piece: a
        // thread holds both accumulators.
        if constexpr (kSplit) {
          if (do_dv)
            mma_pb_split<NKT, DV / 8, 4>({Prod{acc_a, s, 0, sG}});
          else
            mma_pb_split<NKT, D / 8, 4>({Prod{acc_a, dp, 0, sQ}});
        } else if constexpr (D == DV) {
          // dV and dK side by side.
          mma_pb_split<NKT, D / 8, 4>({Prod{acc_v, s, 0, sG},
                                       Prod{acc_a, dp, 0, sQ}});
        } else {
          mma_pb_split<NKT, DV / 8, 4>({Prod{acc_v, s, 0, sG}});
          mma_pb_split<NKT, D / 8, 4>({Prod{acc_a, dp, 0, sQ}});
        }
        // [section] dkv consumer: gradient products done
      }
      mbar_arrive(empty + stage);
      if (++stage == kS) {
        stage = 0;
        phase ^= 1;
      }
    }

    const size_t kvrow = static_cast<size_t>(bkv) * tk;
    if (do_dk) {
#pragma unroll
      for (int i = 0; i < D / 2; i += 2) {
        const int row = k0 + acc_row(i);
        if (row < tk)
          *reinterpret_cast<float2*>(dk + (kvrow + row) * D + acc_col(i)) =
              make_float2(acc_a[i] * dk_mul, acc_a[i + 1] * dk_mul);
      }
    }
    if (do_dv) {
      const float* av = kSplit ? acc_a : acc_v;
#pragma unroll
      for (int i = 0; i < DV / 2; i += 2) {
        const int row = k0 + acc_row(i);
        if (row < tk)
          *reinterpret_cast<float2*>(dv + (kvrow + row) * DV + acc_col(i)) =
              make_float2(av[i], av[i + 1]);
      }
    }
    // [section] dkv consumer: done
  }
}

// ---------------------------------------------------------------------------
// Launches.

template <int D, int DV, bool Ext, bool Quant>
int launch_dq(const float* q2, const float* k, const float* v,
              const float* g, const float* lse2, const float* delta,
              float* dq, const MaskArgs& mask, int batch_heads, int group,
              int tq, int tk, int causal, int causal_offset, int kv_offset,
              float scale, const ExtArgs& ext, cudaStream_t s) {
  if (tq == 0 || batch_heads == 0) return 0;
  using P = Plan<DqSmem<D, DV, Quant>>;
  // blockIdx.y the block from the last, so every row's longest causal
  // extents launch first.
  const int n_qblocks = (tq + kB * P::kWg - 1) / (kB * P::kWg);
  return launch(flash_dq_f32_kernel<D, DV, Ext, Quant>,
                dim3(batch_heads, n_qblocks), P::kThreads, P::kBytes, s, q2,
                k, v, g, lse2, delta, dq, mask, tq, tk, group, causal,
                causal_offset, kv_offset, scale, n_qblocks, ext);
}

template <int D, int DV, bool Ext, bool Quant>
int launch_dkv(const float* q2, const float* k, const float* v,
               const float* g, const float* lse2, const float* delta,
               float* dk, float* dv, const MaskArgs& mask, int batch_heads,
               int group, int tq, int tk, int causal, int causal_offset,
               int kv_offset, float dk_mul, const ExtArgs& ext,
               cudaStream_t s) {
  if (tk == 0 || batch_heads == 0) return 0;
  using P = Plan<DkvSmem<D, DV, Quant>>;
  // blockIdx.x the kv head, blockIdx.y the key block, z the split's part.
  return launch(flash_dkv_f32_kernel<D, DV, Ext, Quant>,
                dim3(batch_heads / group,
                     (tk + kB * P::kWg - 1) / (kB * P::kWg),
                     kDkvSplit<D, DV> ? 2 : 1),
                P::kThreads, P::kBytes, s, q2, k, v, g, lse2, delta, dk, dv,
                mask, tq, tk, group, causal, causal_offset, kv_offset, dk_mul,
                ext);
}

}  // namespace

// Built three times (ops/_build.py), in parts nvcc compiles side by side:
// the base instantiations of K3 and K4, and with FLASH_EXT=2 / =3 the Ext
// ones (segments, window, dropout, ALiBi, positions, int8 scoring) of K3 /
// of K4, each library refusing the others' calls (cudaErrorInvalidValue).

// The float32 twin of flash_bwd_dq_bf16 (csrc/flash_bwd.cu), with the same
// arguments; dq is float32 (out_f32 must be set: a float32 operand's
// gradient is float32). With int8 operands dq reads the int8 q of ExtArgs
// and not q2, and the dequantized k~ as k.
extern "C" int flash_bwd_dq_f32(const void* q2, const void* k, const void* v,
                                const void* g, const void* lse2,
                                const void* delta, void* dq, const void* mask,
                                int mask_inner, long long mask_so,
                                long long mask_si, long long mask_sr,
                                int batch_heads, int group, int tq, int tk,
                                int d, int dv, int causal, int causal_offset,
                                int kv_offset, float scale, int out_f32,
                                const void* ext, void* stream) {
  const MaskArgs m = mask_args(mask, mask_inner, mask_so, mask_si, mask_sr);
  const ExtArgs* e = static_cast<const ExtArgs*>(ext);
  const ExtArgs none{};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!out_f32) return static_cast<int>(cudaErrorInvalidValue);
#define DQ_LAUNCH(D, DV, E, Q)                                                \
  return launch_dq<D, DV, E, Q>(                                              \
      static_cast<const float*>(q2), static_cast<const float*>(k),           \
      static_cast<const float*>(v), static_cast<const float*>(g),            \
      static_cast<const float*>(lse2), static_cast<const float*>(delta),     \
      static_cast<float*>(dq), m, batch_heads, group, tq, tk, causal,         \
      causal_offset, kv_offset, scale, E ? *e : none, s)
#if !defined(FLASH_EXT)
  if (e != nullptr) return static_cast<int>(cudaErrorInvalidValue);
#define DQ_CASE(D, DV)                                                        \
  if (d == D && dv == DV) DQ_LAUNCH(D, DV, false, false);
  FLASH_GRID(DQ_CASE)
#elif FLASH_EXT == 2
  if (e == nullptr) return static_cast<int>(cudaErrorInvalidValue);
#define DQ_CASE(D, DV)                                                        \
  if (d == D && dv == DV) {                                                   \
    if (e->q8 != nullptr) DQ_LAUNCH(D, DV, true, true);                       \
    DQ_LAUNCH(D, DV, true, false);                                            \
  }
  FLASH_GRID(DQ_CASE)
#endif
#undef DQ_CASE
#undef DQ_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// The float32 twin of flash_bwd_dkv_bf16, with the same arguments; dk like
// k and dv like v (each GQA group's query heads summed), float32. scale: the
// softmax scale, which only int8 scoring's dk uses (dk reads the
// dequantized q~ as q2, and the int8 k of ExtArgs and not k).
extern "C" int flash_bwd_dkv_f32(const void* q2, const void* k,
                                 const void* v, const void* g,
                                 const void* lse2, const void* delta,
                                 void* dk, void* dv, const void* mask,
                                 int mask_inner, long long mask_so,
                                 long long mask_si, long long mask_sr,
                                 int batch_heads, int group, int tq, int tk,
                                 int d, int d_v, int causal,
                                 int causal_offset, int kv_offset,
                                 float scale, int out_f32, const void* ext,
                                 void* stream) {
  const MaskArgs m = mask_args(mask, mask_inner, mask_so, mask_si, mask_sr);
  const ExtArgs* e = static_cast<const ExtArgs*>(ext);
  const ExtArgs none{};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!out_f32) return static_cast<int>(cudaErrorInvalidValue);
  const bool quant = e != nullptr && e->q8 != nullptr;
  const float dk_mul = quant ? scale : kLn2;   // kLn2 = 1 / log2(e)
#define DKV_LAUNCH(D, DV, E, Q)                                               \
  return launch_dkv<D, DV, E, Q>(                                             \
      static_cast<const float*>(q2), static_cast<const float*>(k),           \
      static_cast<const float*>(v), static_cast<const float*>(g),            \
      static_cast<const float*>(lse2), static_cast<const float*>(delta),     \
      static_cast<float*>(dk), static_cast<float*>(dv), m, batch_heads,      \
      group, tq, tk, causal, causal_offset, kv_offset, dk_mul,                \
      E ? *e : none, s)
#if !defined(FLASH_EXT)
  if (e != nullptr) return static_cast<int>(cudaErrorInvalidValue);
#define DKV_CASE(D, DV)                                                       \
  if (d == D && d_v == DV) DKV_LAUNCH(D, DV, false, false);
  FLASH_GRID(DKV_CASE)
#elif FLASH_EXT == 3
  if (e == nullptr) return static_cast<int>(cudaErrorInvalidValue);
#define DKV_CASE(D, DV)                                                       \
  if (d == D && d_v == DV) {                                                  \
    if (quant) DKV_LAUNCH(D, DV, true, true);                                 \
    DKV_LAUNCH(D, DV, true, false);                                           \
  }
  FLASH_GRID(DKV_CASE)
#endif
#undef DKV_CASE
#undef DKV_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// Each kernel this library builds (kind 0: K3, 1: K4), at widths (d, dv)
// of the grid and int8 scoring or not: its dynamic shared memory, threads
// a block and the blocks an SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns a cudaError_t
// code; cudaErrorInvalidValue for a kernel another library builds.
extern "C" int flash_bwd_f32_occupancy(int kind, int d, int dv, int quant,
                                       int* smem, int* threads,
                                       int* blocks) {
#define DQ_OCC(D, DV, E, Q)                                                   \
  return occupancy(flash_dq_f32_kernel<D, DV, E, Q>,                          \
                   Plan<DqSmem<D, DV, Q>>::kThreads,                          \
                   Plan<DqSmem<D, DV, Q>>::kBytes, smem, threads, blocks)
#define DKV_OCC(D, DV, E, Q)                                                  \
  return occupancy(flash_dkv_f32_kernel<D, DV, E, Q>,                         \
                   Plan<DkvSmem<D, DV, Q>>::kThreads,                         \
                   Plan<DkvSmem<D, DV, Q>>::kBytes, smem, threads, blocks)
#if !defined(FLASH_EXT)
#define OCC_CASE(D, DV)                                                       \
  if (d == D && dv == DV && !quant) {                                         \
    if (kind == 0) DQ_OCC(D, DV, false, false);                               \
    if (kind == 1) DKV_OCC(D, DV, false, false);                              \
  }
#elif FLASH_EXT == 2
#define OCC_CASE(D, DV)                                                       \
  if (kind == 0 && d == D && dv == DV) {                                      \
    if (quant) DQ_OCC(D, DV, true, true);                                     \
    DQ_OCC(D, DV, true, false);                                               \
  }
#else
#define OCC_CASE(D, DV)                                                       \
  if (kind == 1 && d == D && dv == DV) {                                      \
    if (quant) DKV_OCC(D, DV, true, true);                                    \
    DKV_OCC(D, DV, true, false);                                              \
  }
#endif
  FLASH_GRID(OCC_CASE)
#undef OCC_CASE
#undef DKV_OCC
#undef DQ_OCC
  return static_cast<int>(cudaErrorInvalidValue);
}
