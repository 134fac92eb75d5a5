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
// int8 scoring (the Quant instantiation) keeps the first version's body:
// nvcuda::wmma 16x16x16 fragments (s8 x s8 -> s32 scores), score blocks
// through shared memory, synchronous tile loads (flash_bwd_dq_i8_kernel,
// flash_bwd_dkv_i8_kernel).
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

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

constexpr int kB = 64;             // rows of a query tile and of a key tile
constexpr int kWarps = 4;          // 4 warps x 16 rows: one warpgroup
constexpr int kThreads = kWarps * 32;
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

// ---------------------------------------------------------------------------
// Hopper building blocks: TMA tile loads into the wgmma core-matrix layout
// and their mbarriers, cp.async for the small per-row vectors,
// shared-memory matrix descriptors, and the wgmma products.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// src-size 0 fills the 4 bytes with zeros (entries past the ragged edge).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// An mbarrier in shared memory that completes when `count` threads have
// arrived and the bytes they announced have landed.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Arrives on the barrier and announces `bytes` of TMA loads to land on it.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Waits for the barrier's phase `parity` to complete. A load that never
// lands traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (long long spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (spin > (1LL << 26)) __trap();
  }
}

// A 64 x D bf16 tile in shared memory is D/8 panels of 64 rows x 8 columns
// (16 bytes a row, 1 KB a panel): element (r, c) at element offset
// (c / 8) * 512 + r * 8 + c % 8. Every 8 x 8 block is one 128-byte wgmma
// core matrix (no swizzle); rows are 16 bytes apart inside a core matrix,
// 8-row groups 128 bytes, 8-column panels 1024 bytes.
constexpr uint32_t kRowGroupBytes = 128;
constexpr uint32_t kPanelBytes = 1024;

// Rows [row0, row0 + 64) of head `head` of a (heads, rows, D) bf16 tensor
// into such a tile by TMA, one 64 x 8 box a panel (the tensor map's box);
// rows past the head's end land as zeros. The bytes complete on `bar`.
template <int D>
__device__ __forceinline__ void tma_tile(bf16* dst, const CUtensorMap* map,
                                         int row0, int head, uint64_t* bar) {
  const uint32_t d = smem_u32(dst), b = smem_u32(bar);
  const uint64_t m = reinterpret_cast<uint64_t>(map);
#pragma unroll
  for (int p = 0; p < D / 8; ++p)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
        :: "r"(d + p * kPanelBytes), "l"(m), "r"(8 * p), "r"(row0),
           "r"(head), "r"(b)
        : "memory");
}

// 64 float32 or int32 values [i0, i0 + 64) of a vector into shared
// memory, asynchronously; entries at or past `limit` land as zeros.
__device__ __forceinline__ void load_vec_async(void* dst, const void* src,
                                               int i0, int limit) {
  const int i = threadIdx.x;
  if (i < kB) {
    const bool ok = i0 + i < limit;
    cp_async4(smem_u32(dst) + 4 * i,
              static_cast<const float*>(src) + (ok ? i0 + i : i0), ok);
  }
}

// A shared-memory matrix descriptor (no swizzle): start address, leading
// byte offset (between core matrices along K) and stride byte offset
// (between core matrices along M or N), all in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

// Step kk (columns [16kk, 16kk + 16) as K) of a tile read K-major: its
// rows are M (or N), its columns the reduction.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kk) {
  return make_desc(tile + 2 * kk * kPanelBytes, kPanelBytes, kRowGroupBytes);
}

// Step kk (rows [16kk, 16kk + 16) as K) of a tile read MN-major: its rows
// are the reduction, its columns N.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk) {
  return make_desc(tile + 2 * kk * kRowGroupBytes, kRowGroupBytes,
                   kPanelBytes);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pins accumulator registers at this point of the program: the compiler
// must not move their reads or writes across an asynchronous wgmma's issue
// or its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// The m64nNk16 accumulator layout: thread t of the warpgroup holds, in
// element i of N/2, row 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2)
// and column 8 * (i / 4) + 2 * (t % 4) + i % 2.
__device__ __forceinline__ int acc_row(int i) {
  return 16 * ((threadIdx.x / 32) % kWarps) + (threadIdx.x % 32) / 4 +
         8 * ((i >> 1) & 1);
}

__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x % 4) + (i & 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A 64 x 64 accumulator as bf16 A fragments of m64k16, one per 16 columns:
// the accumulator's elements 8kk..8kk+7 are fragment kk's, in order.
__device__ __forceinline__ void to_frags(const float (&s)[32],
                                         uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
}

template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  // d (64 x 32) += A . B with A in registers (the m64k16 A fragment) and
  // B in shared memory MN-major.
  static __device__ __forceinline__ void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  // d (64 x 64) += A . B with A and B in shared memory (K-major).
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // d (64 x 64) += A . B with A in registers (the m64k16 A fragment) and
  // B in shared memory MN-major.
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(scale_d));
  }
};

template <>
struct Wgmma<96> {
  // d (64 x 96) += A . B with A in registers (the m64k16 A fragment) and
  // B in shared memory MN-major.
  static __device__ __forceinline__ void rs(float (&d)[48],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
        "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  // d (64 x 128) += A . B with A in registers (the m64k16 A fragment) and
  // B in shared memory MN-major.
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(scale_d));
  }
};


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

template <int D, bool Ext>
constexpr size_t dkv_smem_bytes() {
  return sizeof(bf16) * (2 * kRows + 2 * kStages * kB) * D  // sK, sV; sQ, sG
         + kStages * 2 * kB * sizeof(float)                 // lse2, delta
         + (Ext ? kStages * 2 * kB * sizeof(int) : 0)       // segq, posq
         + kStages * sizeof(uint64_t);                      // the barriers
}

// dk and dv for one 128-row key block of one kv head: K and V stay in
// shared memory, the query tiles of every head of the GQA group stream
// through the stages (q2 and dO by TMA, one barrier a stage; lse2 and
// delta by cp.async); each warpgroup's S^T, dP^T, P^T and dS^T live in its
// registers and the group's sums in its float32 accumulators. The tensor
// maps as for dq.
template <int D, bool HasMask, typename OutT, bool Ext>
__global__ void __launch_bounds__(kBlockThreads)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_g,
                     const float* __restrict__ lse2,
                     const float* __restrict__ delta, OutT* __restrict__ dk,
                     OutT* __restrict__ dv, MaskArgs mask, int tq, int tk,
                     int group, int causal, int causal_offset, int kv_offset,
                     int n_qtiles, ExtArgs ext) {
  static_assert(D % 32 == 0 && D <= 128, "head dim must be 32*n <= 128");
  static_assert(!(HasMask && Ext), "Ext reads the mask at run time");
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);   // warpgroup w's keys at w*kB*D
  bf16* sV = sK + kRows * D;
  bf16* sQG = sV + kRows * D;   // stage s: q2 at sQG + 2s*kB*D, dO after it
  float* sRow = reinterpret_cast<float*>(sQG + 2 * kStages * kB * D);   //
                                 // stage s: lse2 at 2s*kB, delta after it
  int* sVec = reinterpret_cast<int*>(sRow + 2 * kStages * kB);   // stage s:
                                              // segq at 2s*kB, posq after
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
    float* sr = sRow + 2 * stage * kB;
    if (threadIdx.x == 0) {
      uint64_t* bar = &bars[stage];
      mbar_expect_tx(bar, (resident ? 6 : 2) * kB * D * sizeof(bf16));
      if (resident) {
        for (int w = 0; w < kWgs; ++w) {
          tma_tile<D>(sK + w * kB * D, &map_k, kb0 + w * kB, bkv, bar);
          tma_tile<D>(sV + w * kB * D, &map_v, kb0 + w * kB, bkv, bar);
        }
      }
      tma_tile<D>(sQ, &map_q, qt * kB, bh, bar);
      tma_tile<D>(sQ + kB * D, &map_g, qt * kB, bh, bar);
    }
    load_vec_async(sr, lse2 + qoff, qt * kB, tq);
    load_vec_async(sr + kB, delta + qoff, qt * kB, tq);
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
  const uint32_t tK = smem_u32(sK + wg * kB * D);
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
      const float* sLse = sRow + 2 * stage * kB;
      const float* sDelta = sLse + kB;
      const int* sSegQ = sVec + 2 * stage * kB;
      const int* sPosQ = sSegQ + kB;
      // Transposed blocks: rows are this warpgroup's keys, columns the
      // queries.
      float s[32], dp[32];
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

      // dV += P^T . dO and dK += dS^T . q2, the query tiles read MN-major.
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

  // dk: the folded q2 carries scale*log2(e), so 1/log2(e) restores the
  // scale.
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = k0 + acc_row(i);
    if (row < tk) {
      const size_t at = kvoff + static_cast<size_t>(row) * D + acc_col(i);
      store_pair(dk + at, acc_dk[i] * kInvLog2e, acc_dk[i + 1] * kInvLog2e);
      store_pair(dv + at, acc_dv[i], acc_dv[i + 1]);
    }
  }
}

// int8 scoring (the Quant instantiation): the first version's body, on
// nvcuda::wmma fragments with score blocks through shared memory. Each
// warp owns 16 rows of every score block.

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
  const int tile = n_qtiles - 1 - static_cast<int>(blockIdx.x);
  const int bh = blockIdx.y;
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

template <int D>
constexpr size_t dkv_i8_smem_bytes() {
  return sizeof(bf16) * (4 * kB * D     // sK (int8 k), sV, sQ, sG
                         + 2 * kB * kB) // sPT, sDST
         + sizeof(float) * (2 * kB * kB // sST, sDPT (the epilogue's stage)
                            + 2 * kB)   // sLse, sDelta
         + kB * D                       // sQ8
         + kB * (2 * sizeof(int) + sizeof(float));   // sSegQ, sSqf, sPosQ
}

template <int D, typename OutT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_i8_kernel(const bf16* __restrict__ v,
                        const bf16* __restrict__ g,
                        const float* __restrict__ lse2,
                        const float* __restrict__ delta,
                        OutT* __restrict__ dk, OutT* __restrict__ dv,
                        MaskArgs mask, int tq, int tk, int group, int causal,
                        int causal_offset, int kv_offset, float scale,
                        int n_qtiles, ExtArgs ext) {
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
  // The int8 k tile in the sK region, the query tile's int8 copy in sQ8
  // and its dequantized bf16 copy (the ds^T.q operand) in sQ.
  signed char* sK8 = reinterpret_cast<signed char*>(sK);
  signed char* sQ8 = reinterpret_cast<signed char*>(sDelta + kB);
  int* sSegQ = reinterpret_cast<int*>(sQ8 + kB * D);
  float* sSqf = reinterpret_cast<float*>(sSegQ + kB);
  int* sPosQ = reinterpret_cast<int*>(sSqf + kB);

  // Early key tiles are seen by the most query rows under causal masking.
  const int k0 = static_cast<int>(blockIdx.x) * kB;
  const int bkv = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const size_t kvoff = static_cast<size_t>(bkv) * tk * D;
  load_i8_tile<D>(sK8, ext.k8 + kvoff, k0, tk);
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
  // Window: query rows r < window + (k0 + 63) - rel can still see the
  // tile's newest key.
  int qt_end = n_qtiles;
  if (causal && ext.window > 0) {
    const long long r_end = ext.window + k0 + kB - 1 - rel;
    qt_end = r_end <= 0 ? 0
           : (r_end >= tq ? n_qtiles
                          : static_cast<int>((r_end + kB - 1) / kB));
  }

  // Elementwise ownership: lanes (2r, 2r+1) of warp w hold key row
  // w*16 + r, 32 query columns each.
  const int my_row = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const bool krow_ok = k0 + my_row < tk;
  const long long kpos = static_cast<long long>(k0) + my_row;
  const float skr_r =
      krow_ok ? ext.skr[static_cast<size_t>(bkv) * tk + kpos] : 0.f;

  FragC acc_dk[D / 16], acc_dv[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::fill_fragment(acc_dk[j], 0.f);
    wmma::fill_fragment(acc_dv[j], 0.f);
  }

  for (int h = 0; h < group; ++h) {
    const int bh = bkv * group + h;
    const size_t qoff = static_cast<size_t>(bh) * tq;
    const unsigned char* mbase =
        mask.ptr != nullptr ? mask_base(mask, bh) : nullptr;
    int segk_r = 0;
    const int* segq_row = nullptr;
    if (ext.segq.ptr != nullptr) {
      segq_row = vec_row(ext.segq, bh);
      segk_r = krow_ok ? vec_row(ext.segk, bh)[kpos] : 0;
    }
    const unsigned int drop_bs =
        ext.seed + static_cast<unsigned int>(bh) * 668265263u;
    const float slope = ext.alibi != nullptr ? ext.alibi[bh] : 0.f;
    // Positions: the key row's position, the query side's position row and
    // both sides' tile [min, max] tables (read per query head, as the
    // positions are addressed).
    unsigned int drop_ch =
        static_cast<unsigned int>(kv_offset + kpos) * 2246822519u;
    int posk_r = 0, kmin = 0, kmax = 0;
    const int* posq_row = nullptr;
    const int* posq_mm = nullptr;
    if (ext.posk.ptr != nullptr) {
      posq_row = vec_row(ext.posq, bh);
      posq_mm = vec_row(ext.posq_mm, bh);
      posk_r = krow_ok ? vec_row(ext.posk, bh)[kpos] : 0;
      kmin = vec_row(ext.posk_mm, bh)[2 * blockIdx.x];
      kmax = vec_row(ext.posk_mm, bh)[2 * blockIdx.x + 1];
      drop_ch = static_cast<unsigned int>(posk_r) * 2246822519u;
    }
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * kB;
      // Positions: skip a query tile that sees none of this key tile (K1's
      // skip, seen from the key side).
      if (posq_mm != nullptr &&
          (kmin > posq_mm[2 * qt + 1] ||
           (ext.window > 0 &&
            static_cast<long long>(posq_mm[2 * qt]) - kmax >= ext.window)))
        continue;
      __syncthreads();   // all warps done with the previous query tile
      load_i8_tile<D>(sQ8, ext.q8 + qoff * D, q0, tq, sQ, ext.sqc + qoff);
      load_tile<D>(sG, g + qoff * D, q0, tq);
      for (int i = threadIdx.x; i < kB; i += kThreads) {
        const bool ok = q0 + i < tq;
        sLse[i] = ok ? lse2[qoff + q0 + i] : 0.f;
        sDelta[i] = ok ? delta[qoff + q0 + i] : 0.f;
        sSegQ[i] = (segq_row != nullptr && ok) ? segq_row[q0 + i] : 0;
        sPosQ[i] = (posq_row != nullptr && ok) ? posq_row[q0 + i] : 0;
        sSqf[i] = ok ? ext.sqf[qoff + q0 + i] : 0.f;
      }
      __syncthreads();

      // Transposed blocks: rows are this warp's key rows, columns queries.
      warp_abt_i8<D>(sK8, warp * 16, sQ8,
                     reinterpret_cast<int*>(sST) + warp * 16 * kB);
      warp_abt<D>(sV + warp * 16 * D, sG, sDPT + warp * 16 * kB);
      __syncwarp();

      const int* strow = reinterpret_cast<const int*>(sST) + my_row * kB +
                         half * 32;
      const float* dptrow = sDPT + my_row * kB + half * 32;
      bf16* prow = sPT + my_row * kB + half * 32;
      bf16* dsrow = sDST + my_row * kB + half * 32;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const int qc = half * 32 + c;
        // pos_q - pos_k, as in K1.
        const long long back = posq_row != nullptr
                                   ? static_cast<long long>(sPosQ[qc]) -
                                         posk_r
                                   : rel + q0 + qc - kpos;
        bool valid = krow_ok && q0 + qc < tq &&
            (!causal || kpos <= rel + q0 + qc);
        if (mbase != nullptr)
          valid = valid &&
                  !mbase[static_cast<long long>(q0 + qc) * mask.sr + kpos];
        if (posq_row != nullptr) valid = valid && back >= 0;
        if (ext.window > 0) valid = valid && back < ext.window;
        if (segq_row != nullptr) valid = valid && sSegQ[qc] == segk_r;
        float sc = static_cast<float>(strow[c]) * sSqf[qc] * skr_r;
        if (ext.alibi != nullptr)
          sc = __fadd_rn(sc, __fmul_rn(slope, static_cast<float>(-back)));
        float dpv = dptrow[c];
        float keep_mul = 1.f;
        if (ext.dropout) {
          const unsigned int rh =
              static_cast<unsigned int>(posq_row != nullptr
                                            ? sPosQ[qc]
                                            : causal_offset + q0 + qc) *
              2654435761u;
          keep_mul = drop_hash(rh, drop_ch, drop_bs) >= ext.drop_threshold
                         ? ext.drop_inv : 0.f;
          dpv = keep_mul == 0.f ? 0.f : dpv * keep_mul;
        }
        const float p = valid ? exp2f(sc - sLse[qc]) : 0.f;
        const float pn =
            ext.dropout ? (keep_mul == 0.f ? 0.f : p * keep_mul) : p;
        prow[c] = __float2bfloat16(pn);
        dsrow[c] = __float2bfloat16(p * (dpv - sDelta[qc]));
      }
      __syncwarp();

      warp_ab_acc<D>(acc_dv, sPT + warp * 16 * kB, sG);
      warp_ab_acc<D>(acc_dk, sDST + warp * 16 * kB, sQ);
    }
  }

  __syncthreads();   // the stage overlays other warps' score rows
  // dk: sQ holds the dequantized raw q, so the softmax scale itself.
  store_rows<D, OutT>(acc_dk, sST, dk + kvoff, k0, tk, scale);
  store_rows<D, OutT>(acc_dv, sST, dv + kvoff, k0, tk, 1.f);
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

// The TMA map of a (heads, rows, d) bf16 tensor read in 64-row x 8-column
// boxes, one core-matrix panel of a tile each; rows past a head's end load
// as zeros. An empty tensor gets no map (nothing is loaded from it); false
// when the driver's encoder is missing or refuses the tensor.
bool tile_map(CUtensorMap* map, const void* ptr, int heads, int rows, int d) {
  *map = CUtensorMap{};
  if (heads == 0 || rows == 0) return true;
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  // The driver's encoder through the runtime: the library links no -lcuda.
  static const Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<Encode>(fn);
  }();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(d) * sizeof(bf16),
      static_cast<cuuint64_t>(rows) * d * sizeof(bf16)};
  const cuuint32_t box[3] = {8, kB, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The maps of q2 and dO (batch_heads, tq, D) and of k and v (batch_heads /
// group, tk, D), in the kernels' parameter order; false when one fails.
bool operand_maps(CUtensorMap (&maps)[4], const void* q2, const void* k,
                  const void* v, const void* g, int batch_heads, int group,
                  int tq, int tk, int d) {
  return tile_map(&maps[0], q2, batch_heads, tq, d) &&
         tile_map(&maps[1], k, batch_heads / group, tk, d) &&
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
    return launch(flash_bwd_dq_i8_kernel<D, OutT>,
                  dim3(n_qtiles, batch_heads), kThreads,
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
  const int n_ktiles = (tk + kB - 1) / kB;
  const int n_qtiles = (tq + kB - 1) / kB;
  if (n_ktiles == 0 || batch_heads == 0) return 0;
  const float* lb = static_cast<const float*>(lse2);
  const float* db = static_cast<const float*>(delta);
  OutT* dkb = static_cast<OutT*>(dk);
  OutT* dvb = static_cast<OutT*>(dv);
  if constexpr (Quant) {
    return launch(flash_bwd_dkv_i8_kernel<D, OutT>,
                  dim3(n_ktiles, batch_heads / group), kThreads,
                  dkv_i8_smem_bytes<D>(), stream, static_cast<const bf16*>(v),
                  static_cast<const bf16*>(g), lb, db, dkb, dvb, mask, tq, tk,
                  group, causal, causal_offset, kv_offset, scale, n_qtiles,
                  ext);
  } else {
    CUtensorMap maps[4];
    if (!operand_maps(maps, q2, k, v, g, batch_heads, group, tq, tk, D))
      return static_cast<int>(cudaErrorInvalidValue);
    // blockIdx.x the kv head, blockIdx.y the 128-row key block: every
    // head's early key blocks (seen by the most causal query rows) first.
    return launch(flash_bwd_dkv_kernel<D, HasMask, OutT, Ext>,
                  dim3(batch_heads / group, (tk + kRows - 1) / kRows),
                  kBlockThreads, dkv_smem_bytes<D, Ext>(), stream, maps[0],
                  maps[1], maps[2], maps[3], lb, db, dkb, dvb, mask, tq, tk,
                  group, causal, causal_offset, kv_offset, n_qtiles, ext);
  }
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
// ExtArgs (the Ext instantiations; with int8 operands q2 is unused and k is
// read only for its shape). All contiguous, bf16 unless stated. Returns a
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
