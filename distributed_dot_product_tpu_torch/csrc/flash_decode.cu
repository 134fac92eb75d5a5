// Fused KV-cache decode step for Hopper (sm_90a): in-place append plus
// split-K flash-decoding attention in one launch, bf16 cache, f32
// accumulation.
//
// Replaces the TPU kernel `_make_decode_kernel` in
// distributed_dot_product_tpu/ops/pallas_decode.py — the slab body
// `kernel_body` (K5, flash_decode_bf16) and the paged body `kernel_paged`
// (K5p, flash_decode_paged_bf16) — with verify-k (n new rows per slot,
// each slot appending its own count of them), the sliding window, the
// partial outputs, the int8 K mirror and ALiBi.
//
// What bounds it on the H100: a decode step's n * group query rows per
// kv head against the cached prefix do ~n*group FLOP per byte of K/V
// streamed, far below the card's ~295 FLOP/byte ridge, so the floor is
// one HBM read of the attended K and V rows (~12 MB a layer at batch 4,
// 8 heads, ~1000 filled rows: ~3.8 us); at these sizes a step is paced
// by two dependent memory round trips (the slot's vectors, then its
// rows) and the launch. The design:
//
// - One launch, a thread-block cluster per (slot, kv head). The grid is
//   (cluster, batch * h_kv) with a cluster of C blocks along x; C depends
//   only on (batch, h_kv, t_max, the SM count) (the wrapper's
//   `_launch_geometry`). Rank r of a cluster owns the 128-column chunks
//   c with c % C == r. Each block finds on the device, from valid_to, n
//   and the window, the attended span of its row and walks only its owned
//   chunks inside it, in increasing order, as 64-column steps; a chunk
//   outside every query row's span is neither loaded nor merged. Rank j
//   merges a slice of the output: every rank that walked a step stores
//   its partials (m, l, acc) of that slice into rank j's shared memory
//   with st.async, completing on rank j's mbarrier; rank j waits there,
//   merges ranks in order 0..C-1 and writes the output. Nothing outlives
//   the launch.
// - Each warp runs its own pipeline over its 16 columns of every step,
//   two stages, no block barrier in the loop: one lane a row issues the
//   K and V rows together with cp.async (16 bytes at a time) into rows
//   padded by 16 bytes, so the mma fragment reads of 8 rows hit 8
//   different bank groups at every head dim (unpadded rows 2*d bytes
//   apart would put them in one or two: an 8- or 4-way conflict). A
//   column outside the span, past t_max or on a -1 page is zero-filled
//   and never read; such a column is also cleared in the step's `held`
//   bit mask and scores -inf. A fresh column (an appended row) is copied
//   straight from k_new/v_new, so no read depends on the order of the
//   appends. Paged, a rank reads its chunks' page ids once, beside the
//   slot's vectors.
// - A pass's 16 query rows (one m-tile) against each step at once, V read
//   once a step: S = q K^T with mma.sync m16n8k16 bf16 (m16n8k32 s8 ->
//   s32 for the int8 mirror: the integer sums are exact), the online
//   softmax on the fragments, P (bf16) as the A fragments of O += P V,
//   O in registers. At the end of a pass the four warps' states are
//   combined in order; more rows take further passes over the same
//   steps.
//
// Bit-for-bit contracts. Every query row's result is a function of its
// own q row and its own columns alone: warp w takes the step's columns
// 16w..16w+15 whatever the row count, a row's max and sum are reduced in
// the same order over the same lanes, a column a row does not attend
// carries p = 0 exactly (a no-op on m, l and O), and the chunk -> rank
// map, the warp and rank merge orders do not depend on valid_to, n or
// the page table. So row j of a verify launch gives the bits of the j-th
// of n sequential one-row launches, and a paged step gives the bits of
// K5 on a slab that holds the same rows.
//
// Verify-k: the n * group rows are new-row-major (row j*group + g is
// query head g of new row j); new row j attends columns lo_j..hi_j with
// hi_j = valid_to + j clamped to the slab. The append is in place: row
// m < n_new of a slot lands at column append_at + m, written by the
// rank that owns that column's chunk; every other cache row keeps its
// bits. Numerics follow the TPU kernel: scale*log2(e) folded into q
// (rounded back to bf16), exp2 softmax, running max from NEG_BIG, and a
// row with no valid column (valid_to < 0) outputs exactly 0.
//
// The int8 K mirror (qk_quant='int8'): q's rows and k_new's rows are
// quantized per row in the kernel exactly as `quantize_rows` does (s =
// max(max|x| / 127, 1e-20), round half to even of x / s, both divisions
// correctly rounded); the scores are the exact int32 sums of int8
// products scaled in float32 as the TPU kernel orders it, (s * q_scale)
// * k_scale with q_scale = s_q * scale * log2(e); the bf16 K is then
// only written (the append), never read. The mirror rows (int8 and
// their float32 scales) are appended in place beside the bf16 rows.
//
// ALiBi: query head g's score at column col of new row j gains slope_g *
// log2(e) * (col - (valid_to + j)), after the appended rows' scores have
// replaced the buffer's; the multiplies and the add round separately
// (__fmul_rn, __fadd_rn), as the plain version's tensor operations do.
//
// A row attends columns lo..hi: hi is valid_to clamped to the slab (a
// shard of a sequence-sharded slab sees valid_to >= t_max when the slab
// lies wholly in the query's past, and valid_to < 0 when it lies wholly
// in its future), lo is 0, or with a window W the first column with col
// - valid_to > -W. With partial outputs the merge writes the folded
// un-normalised numerator and the base-2 running max and denominator of
// every query row in float32 instead of dividing; a row with no column
// gives numerator 0, max NEG_BIG and denominator 0.
//
// Paged (K5p): the cache is a pool of (pages + 1, h_kv, page_size, d)
// pages, and column c of slot b lives at row c % page_size of pool page
// table[b][c / page_size] (page sizes dividing 128, or multiples of 128:
// a chunk then covers part of a page). A -1 entry is never read: its
// columns score -inf and an append that lands on it writes nothing. The
// mirror pools share the table. The appends are the only writes
// (nothing goes to the pool's sink page); the host allocator copies a
// shared page before a step could append into it, so no page written
// here is read by another slot in the same launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 128;        // columns a cluster rank owns at a time
constexpr int kStep = 64;          // columns a step spans, 16 a warp
constexpr int kWarpCols = kStep / kWarps;
constexpr int kStages = 2;         // a warp's steps in flight
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kRowsPass = 16;      // query rows a pass holds (an m-tile)
constexpr float kNegBig = -0.7f * 3.4e38f;
constexpr float kLog2e = 1.4426950408889634f;

// The columns lo..hi a row at valid_to vt attends (hi < lo: none).
__device__ __forceinline__ void row_span(int vt, int t_max, int window,
                                         int& lo, int& hi) {
  hi = vt < t_max - 1 ? vt : t_max - 1;
  lo = window > 0 && vt - window + 1 > 0 ? vt - window + 1 : 0;
}

// Byte offsets of one block's dynamic shared memory, for `rows` = n *
// group query rows of head dim d. Each warp has its own stages of its 16
// columns of a step; every row of K, V and q is padded by 16 bytes
// (conflict-free fragment reads). After a pass a warp leaves its state
// (O, m, l of the pass's 16 rows) in its own stages.
struct Layout {
  int krow, vrow;            // bytes of a K row (q rows alike), a V row
  int v, ks, wstage;         // V, int8 scales within a warp's stage; size
  int q, qs, held, fresh, fresh_s, pages, part, part_ml, slices, bar, w;
  int bytes;
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

// Page ids a rank holds (paged): its chunks' pages, 128 / page_size a
// chunk (one when a page spans chunks), for ceil(chunks / cluster) chunks.
__host__ __device__ inline int page_entries(int t_max, int page_size,
                                            int cluster) {
  if (page_size <= 0) return 0;
  const int chunks = (t_max + kChunk - 1) / kChunk;
  return (chunks + cluster - 1) / cluster *
         (page_size < kChunk ? kChunk / page_size : 1);
}

__host__ __device__ inline Layout make_layout(int rows, int n, int d,
                                              bool quant, int pages) {
  Layout L;
  L.krow = (quant ? d : 2 * d) + 16;
  L.vrow = 2 * d + 16;
  L.v = kWarpCols * L.krow;
  L.ks = L.v + kWarpCols * L.vrow;
  L.wstage = align16(L.ks + (quant ? 4 * kWarpCols : 0));
  int o = kWarps * kStages * L.wstage;
  L.q = o;        o += kRowsPass * L.krow;        // a pass's q rows
  L.qs = o;       o = align16(o + 4 * kRowsPass); // int8: their scales
  L.held = o;     o = align16(o + 4 * kWarps * kStages);  // held columns
  L.fresh = o;    o = align16(o + (quant ? n * d : 0));   // int8 k_new
  L.fresh_s = o;  o = align16(o + (quant ? 4 * n : 0));   // and scales
  L.pages = o;    o = align16(o + 4 * pages);     // the rank's page ids
  L.part = o;     o += 4 * rows * d;              // this rank's acc
  L.part_ml = o;  o = align16(o + 8 * rows);      // and its m, l
  L.slices = o;   o += 12 * kMaxCluster + 16;     // the merge's slices
  L.bar = o;      o += 16;                        // its mbarrier
  // The merge's gathered partials, weights, m and l: at most this.
  L.w = o;        o = align16(o + 4 * (rows * d + 26 * rows + 16));
  L.bytes = o;
  return L;
}

// Every operand of one launch. Shapes (all contiguous): q (batch, h, n,
// D); k_new/v_new (batch, h_kv, n, D); slab caches (batch, h_kv, t_max,
// D), or pools (pages + 1, h_kv, page_size, D) read through page_table
// (batch, t_max / page_size); valid_to/append_at/n_new (batch,; n_new
// null: n rows wherever append_at >= 0). The int8 mirror (k_q !=
// nullptr): k_q / k_scale laid out as the bf16 cache with D and 1
// elements per row. alibi: null, or the (h,) slopes. Outputs: out
// (batch, h, n, D) bf16, or with num != nullptr the partials num (batch,
// h, n, D), m and l (batch, h, n), all f32.
struct Args {
  const bf16* q;
  const bf16* k_new;
  const bf16* v_new;
  bf16* cache_k;
  bf16* cache_v;
  const int* valid_to;
  const int* append_at;
  const int* n_new;
  const int* page_table;
  int8_t* k_q;
  float* k_scale;
  const float* alibi;
  bf16* out;
  float* num;
  float* m_out;
  float* l_out;
  int h, h_kv, group, n, t_max, page_size, window, cluster;
  int cluster_shift, page_shift;   // log2 of the cluster, of page sizes <= 128
  int pages;                 // page ids a rank holds (page_entries)
  float qscale;
};

// This block's (slot, kv head), its slot's vectors, and the union of its
// query rows' spans: row 0 has the earliest window start, row n-1 the
// latest end.
struct Slot {
  int b, hk, bh, vt, ap, nn, lo, hi;
};

__device__ __forceinline__ Slot make_slot(const Args& a, int vt, int ap,
                                          int nn) {
  Slot s;
  s.bh = blockIdx.y;
  s.b = s.bh / a.h_kv;
  s.hk = s.bh % a.h_kv;
  s.vt = vt;
  s.ap = ap;
  s.nn = ap < 0 || nn < 0 ? 0 : (nn > a.n ? a.n : nn);
  int unused;
  row_span(vt, a.t_max, a.window, s.lo, unused);
  row_span(vt + a.n - 1, a.t_max, a.window, unused, s.hi);
  return s;
}

// The first step at or after step s whose chunk rank `rank` owns.
__device__ __forceinline__ int owned_from(int s, int rank, int cluster) {
  const int c = s / (kChunk / kStep);
  const int own = c + ((rank - c % cluster) % cluster + cluster) % cluster;
  return own == c ? s : own * (kChunk / kStep);
}

// Where column `col` of the block's (slot, kv head) lives, in rows of the
// cache or pool (fewer than 2^31: the wrapper checks); -1 for a -1 page.
// Paged, `col` lies in one of this rank's chunks, whose page ids `pages`
// holds.
template <bool PAGED>
__device__ __forceinline__ int cache_row(const Args& a, const Slot& s,
                                         const int* pages, int col) {
  if (!PAGED) return s.bh * a.t_max + col;
  const int ps = a.page_size;
  const int k = col / kChunk >> a.cluster_shift;   // the rank's k-th chunk
  if (ps <= kChunk) {            // a power of two: shifts and masks
    const int sh = a.page_shift;
    const int page = pages[(k << (7 - sh)) + (col % kChunk >> sh)];
    if (page < 0) return -1;
    return ((page * a.h_kv + s.hk) << sh) + (col & (ps - 1));
  }
  const int page = pages[k];
  if (page < 0) return -1;
  return (page * a.h_kv + s.hk) * ps + col % ps;
}

// The row of column `lane` of the calling warp's 16 columns of `step`
// (lanes < 16), -1 outside the span or on a -1 page.
template <bool PAGED>
__device__ __forceinline__ int lookup(const Args& a, const Slot& s,
                                      const int* pages, int step) {
  const int lane = threadIdx.x % 32;
  const int col = step * kStep + kWarpCols * (threadIdx.x / 32) + lane;
  return lane < kWarpCols && col >= s.lo && col <= s.hi
             ? cache_row<PAGED>(a, s, pages, col) : -1;
}

// Issues the calling warp's 16 columns of one step into its stage, one
// row a lane (lanes 0-15 the K rows, int8 with their scales; lanes 16-31
// the V rows), and its `held` mask: bit i set when column col0 + i lies
// in the span, below t_max and on a held page. Lane i < 16 holds column
// i's row (`my_row`, from `lookup`). Fresh columns come from k_new/v_new
// (int8: zero-filled, replaced by the quantized row after the stage
// lands).
template <int D, bool PAGED, bool QUANT>
__device__ __forceinline__ void issue_warp(const Args& a, const Slot& s,
                                           const Layout& L, int step,
                                           unsigned char* stage,
                                           uint32_t* held, int my_row) {
  constexpr int KP = QUANT ? D / 16 : D / 8;   // 16-byte pieces of a K row
  constexpr int VP = D / 8;
  const int lane = threadIdx.x % 32;
  const int r = lane % kWarpCols;               // the column it copies
  const bool isv = lane >= kWarpCols;
  const int row = __shfl_sync(0xffffffffu, my_row, r);
  const int col0 = step * kStep + kWarpCols * (threadIdx.x / 32);
  const int m = col0 + r - s.ap;
  const bool fresh = s.ap >= 0 && m >= 0 && m < s.nn;
  const size_t at = static_cast<size_t>(row) * D;
  const size_t fresh_at = (static_cast<size_t>(s.bh) * a.n + m) * D;
  const void* src;
  bool copy = row >= 0;
  if (isv) {
    src = fresh ? a.v_new + fresh_at : a.cache_v + at;
  } else if (QUANT) {
    src = a.k_q + at;
    copy = copy && !fresh;
  } else {
    src = fresh ? a.k_new + fresh_at : a.cache_k + at;
  }
  const unsigned char* from = static_cast<const unsigned char*>(
      copy ? src : static_cast<const void*>(a.v_new));
  const uint32_t dst =
      smem_u32(stage) + (isv ? L.v + r * L.vrow : r * L.krow);
  const int pieces = isv ? VP : KP;
#pragma unroll
  for (int p = 0; p < VP; ++p)
    if (p < pieces) cp_async16(dst + 16 * p, from + (copy ? 16 * p : 0), copy);
  if constexpr (QUANT) {
    if (!isv)
      cp_async4(smem_u32(stage) + L.ks + 4 * r,
                a.k_scale + (copy ? row : 0), copy);
  }
  const uint32_t bits = __ballot_sync(0xffffffffu, my_row >= 0);
  if (lane == 0) *held = bits;
}

// The step after `step` on its rank: the second half of the same chunk,
// or the first half of the rank's next chunk (`cluster` chunks on).
__device__ __forceinline__ int next_step(int step, int cluster) {
  return step % 2 ? step + 2 * cluster - 1 : step + 1;
}

// quantize_rows of one bf16 row of D by a warp: s = max(max|x| / 127,
// 1e-20), x_i8 = round half to even (x / s), both divisions correctly
// rounded; the row into dst, s * mul into *scale.
template <int D>
__device__ __forceinline__ void quantize_row(const bf16* src, int8_t* dst,
                                             float* scale, float mul) {
  const int lane = threadIdx.x % 32;
  float x[D / 32];
  float amax = 0.f;
#pragma unroll
  for (int k = 0; k < D / 32; ++k) {
    x[k] = __bfloat162float(src[lane + 32 * k]);
    amax = fmaxf(amax, fabsf(x[k]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = fmaxf(__fdiv_rn(amax, 127.f), 1e-20f);
#pragma unroll
  for (int k = 0; k < D / 32; ++k)
    dst[lane + 32 * k] = static_cast<int8_t>(rintf(__fdiv_rn(x[k], s)));
  if (lane == 0) *scale = mul == 1.f ? s : __fmul_rn(s, mul);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d (16 x 8, f32) += a (16 x 16 bf16, row) . b (16 x 8 bf16, col).
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d (16 x 8, s32) += a (16 x 32 s8, row) . b (32 x 8 s8, col), exact.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The shared::cluster address of `p` (this block's shared memory) in the
// block of cluster rank `rank`.
__device__ __forceinline__ uint32_t peer_addr(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(smem_u32(p)), "r"(rank));
  return out;
}

// A 4-byte store into a peer's shared memory that completes its bytes on
// the peer's mbarrier (`bar`, a shared::cluster address in that peer).
__device__ __forceinline__ void st_async(uint32_t addr, float v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n"
      :: "r"(addr), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

// The two halves of a cluster barrier: arrive (release: this block's
// shared memory writes before it are visible to the cluster after the
// wait) and wait (acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The in-place append of slot rows m < n_new at append_at + m whose
// chunk this rank owns (int8: the quantized rows and scales `fresh`,
// `fresh_s` into the mirror as well). A -1 page takes nothing.
template <int D, bool PAGED, bool QUANT>
__device__ __forceinline__ void append_rows(const Args& a, const Slot& s,
                                            int rank, const int* pages,
                                            const int8_t* fresh,
                                            const float* fresh_s) {
  for (int idx = threadIdx.x; idx < s.nn * (D / 8); idx += kThreads) {
    const int m = idx / (D / 8), piece = idx % (D / 8);
    const int col = s.ap + m;
    if (col >= a.t_max || (col / kChunk) % a.cluster != rank) continue;
    const int row = cache_row<PAGED>(a, s, pages, col);
    if (row < 0) continue;
    const size_t at = static_cast<size_t>(row) * D;
    const size_t src = (static_cast<size_t>(s.bh) * a.n + m) * D;
    const uint4 k = *reinterpret_cast<const uint4*>(a.k_new + src + piece * 8);
    const uint4 v = *reinterpret_cast<const uint4*>(a.v_new + src + piece * 8);
    *reinterpret_cast<uint4*>(a.cache_k + at + piece * 8) = k;
    *reinterpret_cast<uint4*>(a.cache_v + at + piece * 8) = v;
    if constexpr (QUANT) {
      if (piece < D / 16)
        *reinterpret_cast<uint4*>(a.k_q + at + piece * 16) =
            *reinterpret_cast<const uint4*>(fresh + m * D + piece * 16);
      if (piece == 0) a.k_scale[row] = fresh_s[m];
    }
  }
}

// Grid (cluster, batch * h_kv), clusters of `cluster` blocks along x,
// 128 threads. Each warp runs its own pipeline over its 16 columns of the
// rank's steps (no block barrier in the loop): S = q K^T for a pass's 16
// query rows, the online softmax on the fragments, P to A fragments in
// registers, O += P V. Fragment coordinates: lane = 4 g + t; an m16n8
// accumulator element c holds row g + 8 (c / 2) and column 2 t + c % 2 of
// its n-tile.
template <int D, bool PAGED, bool QUANT>
__global__ void __launch_bounds__(kThreads, 3)
flash_decode_kernel(const Args a) {
  static_assert(D % 32 == 0 && D <= 128, "head dim must be 32, 64, 96, 128");
  constexpr int NT = D / 8;                     // O n-tiles
  constexpr int KS = QUANT ? D / 32 : D / 16;   // S k-steps
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int C = a.cluster;
  const int R = a.n * a.group;
  const Layout L = make_layout(R, a.n, D, QUANT, a.pages);
  int* pages = reinterpret_cast<int*>(smem + L.pages);
  // The slot's vectors and (paged) this rank's page ids, read together
  // (one round trip: neither depends on the other).
  const int b_ = blockIdx.y / a.h_kv;
  const int vt_ = a.valid_to[b_];
  const int ap_ = a.append_at[b_];
  const int nn_ = a.n_new == nullptr ? a.n : a.n_new[b_];
  if constexpr (PAGED) {
    const int ppc = a.page_size < kChunk ? kChunk / a.page_size : 1;
    const int pps = a.t_max / a.page_size;
    const int chunks = (a.t_max + kChunk - 1) / kChunk;
    const int owned = rank < chunks ? (chunks - rank + C - 1) / C * ppc : 0;
    for (int i = threadIdx.x; i < owned; i += kThreads) {
      const int c = rank + i / ppc * C;
      const int p = a.page_size < kChunk ? c * ppc + i % ppc
                                         : c * kChunk / a.page_size;
      pages[i] = __ldg(a.page_table + static_cast<size_t>(b_) * pps + p);
    }
    __syncthreads();   // the page ids before any warp looks a column up
  }
  const Slot s = make_slot(a, vt_, ap_, nn_);
  // The mbarrier the peers' partials complete on (one arrival: this
  // block's expectation of their bytes).
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Every block of the cluster has started, its mbarrier initialised,
  // once this phase completes (waited on before the first store into a
  // peer's shared memory).
  cluster_arrive();
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, its row

  const int s_first = s.lo / kStep;
  const int s_last = s.hi >= s.lo ? s.hi / kStep : s_first - 1;
  const int first = owned_from(s_first, rank, C);
  unsigned char* wstages = smem + warp * kStages * L.wstage;
  uint32_t* held =
      reinterpret_cast<uint32_t*>(smem + L.held) + warp * kStages;
  float* q_s = reinterpret_cast<float*>(smem + L.qs);
  int8_t* fresh = reinterpret_cast<int8_t*>(smem + L.fresh);
  float* fresh_s = reinterpret_cast<float*>(smem + L.fresh_s);
  float* part = reinterpret_cast<float*>(smem + L.part);
  float* part_ml = reinterpret_cast<float*>(smem + L.part_ml);

  for (int r0 = 0; r0 < R; r0 += kRowsPass) {
    const int rows_here = R - r0 < kRowsPass ? R - r0 : kRowsPass;
    // The first kStages steps: their rows looked up, then issued.
    int steps[kStages], rows0[kStages];
    int s_issue = first;
#pragma unroll
    for (int k = 0; k < kStages; ++k) {
      steps[k] = s_issue;
      rows0[k] = -1;
      if (s_issue <= s_last) {
        rows0[k] = lookup<PAGED>(a, s, pages, s_issue);
        s_issue = next_step(s_issue, C);
      }
    }
#pragma unroll
    for (int k = 0; k < kStages; ++k) {
      if (steps[k] <= s_last)
        issue_warp<D, PAGED, QUANT>(a, s, L, steps[k],
                                    wstages + k * L.wstage, held + k,
                                    rows0[k]);
      cp_async_commit();
    }
    // This pass's query rows, new-row-major: float path pre-scaled and
    // rounded to bf16 (their loads in flight while the appends run), int8
    // path quantized with their scales (a rank without a step reads
    // none). The in-place append of the rows whose columns lie in this
    // rank's chunks comes after this block issued its first loads: a
    // fresh column is never read from the cache.
    if constexpr (QUANT) {
      if (r0 == 0)
        for (int m = warp; m < s.nn; m += kWarps)
          quantize_row<D>(a.k_new + (static_cast<size_t>(s.bh) * a.n + m) * D,
                          fresh + m * D, fresh_s + m, 1.f);
      for (int i = warp; i < kRowsPass && first <= s_last; i += kWarps) {
        const int rr = r0 + i;
        int8_t* dst = reinterpret_cast<int8_t*>(smem + L.q + i * L.krow);
        if (i < rows_here) {
          const size_t qrow = static_cast<size_t>(
              s.b * a.h + s.hk * a.group + rr % a.group) * a.n + rr / a.group;
          quantize_row<D>(a.q + qrow * D, dst, q_s + i, a.qscale);
        } else {
          for (int e = lane; e < D; e += 32) dst[e] = 0;
          if (lane == 0) q_s[i] = 0.f;
        }
      }
      __syncthreads();
      if (r0 == 0)
        append_rows<D, PAGED, QUANT>(a, s, rank, pages, fresh, fresh_s);
    } else {
      constexpr int kQIters = (kRowsPass * (D / 8) + kThreads - 1) / kThreads;
      uint4 raw[kQIters];
#pragma unroll
      for (int k = 0; k < kQIters; ++k) {
        const int idx = tid + k * kThreads;
        const int i = idx / (D / 8), piece = idx % (D / 8);
        const int rr = r0 + i;
        raw[k] = make_uint4(0, 0, 0, 0);
        if (first <= s_last && idx < kRowsPass * (D / 8) && i < rows_here) {
          const size_t qrow = static_cast<size_t>(
              s.b * a.h + s.hk * a.group + rr % a.group) * a.n + rr / a.group;
          raw[k] = *reinterpret_cast<const uint4*>(a.q + qrow * D + piece * 8);
        }
      }
      if (r0 == 0)
        append_rows<D, PAGED, QUANT>(a, s, rank, pages, fresh, fresh_s);
#pragma unroll
      for (int k = 0; k < kQIters; ++k) {
        const int idx = tid + k * kThreads;
        if (idx >= kRowsPass * (D / 8)) continue;
        const int i = idx / (D / 8), piece = idx % (D / 8);
        uint4 val;
        const bf16* e = reinterpret_cast<const bf16*>(&raw[k]);
        bf16* o = reinterpret_cast<bf16*>(&val);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          o[j] = __float2bfloat16(__bfloat162float(e[j]) * a.qscale);
        *reinterpret_cast<uint4*>(smem + L.q + i * L.krow + piece * 16) = val;
      }
      __syncthreads();
    }

    // Per row of this thread (g, g + 8): its span, ALiBi distance origin
    // and slope (log2 units), int8 scale; q's A fragments are read from
    // shared memory at each step (registers go to O).
    const uint32_t sq = smem_u32(smem + L.q) + ((mi & 1) * 8 + mr) * L.krow +
                        (mi >> 1) * 16;
    int lo[2], hi[2], dist[2];
    float slope[2], qsc[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int rr = r0 + g + 8 * hf;
      lo[hf] = 1;                       // a padding row attends nothing
      hi[hf] = 0;
      dist[hf] = 0;
      slope[hf] = 0.f;
      qsc[hf] = QUANT ? q_s[g + 8 * hf] : 0.f;
      if (rr < R) {
        const int j = rr / a.group;
        row_span(s.vt + j, a.t_max, a.window, lo[hf], hi[hf]);
        dist[hf] = s.vt + j;
        if (a.alibi != nullptr)
          slope[hf] = __fmul_rn(a.alibi[s.hk * a.group + rr % a.group],
                                kLog2e);
      }
    }

    float o[NT][4];
    float m_run[2] = {kNegBig, kNegBig};
    float l_part[2] = {0.f, 0.f};   // this lane's columns; the quad at end
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[nt][c] = 0.f;

    int st = 0;
    for (int step = first; step <= s_last; step = next_step(step, C)) {
      cp_async_wait<kStages - 1>();
      __syncwarp();
      const int next_row =
          s_issue <= s_last ? lookup<PAGED>(a, s, pages, s_issue) : -1;
      unsigned char* stage = wstages + st * L.wstage;
      const uint32_t sk = smem_u32(stage);
      const uint32_t sv = sk + L.v;
      const int col0 = step * kStep + kWarpCols * warp;
      const uint32_t hmask = held[st];
      if constexpr (QUANT) {
        // The fresh columns' quantized rows and scales into the stage.
        const int m0 = col0 - s.ap;
        if (s.ap >= 0 && m0 + kWarpCols > 0 && m0 < s.nn) {
          for (int idx = lane; idx < kWarpCols * (D / 16); idx += 32) {
            const int cl = idx / (D / 16), piece = idx % (D / 16);
            const int m = m0 + cl;
            if (m < 0 || m >= s.nn || !((hmask >> cl) & 1)) continue;
            *reinterpret_cast<uint4*>(stage + cl * L.krow + piece * 16) =
                *reinterpret_cast<const uint4*>(fresh + m * D + piece * 16);
            if (piece == 0)
              reinterpret_cast<float*>(stage + L.ks)[cl] = fresh_s[m];
          }
          __syncwarp();
        }
      }

      // S = q K^T over the warp's 16 columns (two n-tiles).
      float sc[2][4];
      if constexpr (QUANT) {
        int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t aq[4], bq[4];
          ldsm_x4(aq, sq + kk * 32);
          ldsm_x4(bq, sk + ((mi >> 1) * 8 + mr) * L.krow + kk * 32 +
                          (mi & 1) * 16);
          mma_s8(acc[0], aq, bq[0], bq[1]);
          mma_s8(acc[1], aq, bq[2], bq[3]);
        }
        const float* ks = reinterpret_cast<const float*>(stage + L.ks);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            sc[nt][c] = __fmul_rn(
                __fmul_rn(static_cast<float>(acc[nt][c]), qsc[c >> 1]),
                ks[nt * 8 + 2 * t4 + (c & 1)]);
      } else {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) sc[nt][c] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t aq[4], bk[4];
          ldsm_x4(aq, sq + kk * 32);
          ldsm_x4(bk, sk + ((mi >> 1) * 8 + mr) * L.krow +
                          (kk * 16 + (mi & 1) * 8) * 2);
          mma_bf16(sc[0], aq, bk[0], bk[1]);
          mma_bf16(sc[1], aq, bk[2], bk[3]);
        }
      }

      // ALiBi, the row's span and the held columns; the running max over
      // the quad's 16 columns, the weights and this lane's sums.
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int hf = c >> 1;
          const int cl = nt * 8 + 2 * t4 + (c & 1);
          const int col = col0 + cl;
          float v = sc[nt][c];
          if (a.alibi != nullptr)
            v = __fadd_rn(v, __fmul_rn(slope[hf],
                                       static_cast<float>(col - dist[hf])));
          const bool ok =
              ((hmask >> cl) & 1) && col >= lo[hf] && col <= hi[hf];
          sc[nt][c] = ok ? v : -INFINITY;
          mx[hf] = fmaxf(mx[hf], sc[nt][c]);
        }
      float corr[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
        mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
        const float m_new = fmaxf(m_run[hf], mx[hf]);
        corr[hf] = exp2f(m_run[hf] - m_new);
        m_run[hf] = m_new;
      }
      float p[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          p[nt][c] = exp2f(sc[nt][c] - m_run[c >> 1]);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        l_part[hf] = l_part[hf] * corr[hf] +
                     (((p[0][2 * hf] + p[0][2 * hf + 1]) + p[1][2 * hf]) +
                      p[1][2 * hf + 1]);
      const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]),
                              pack_bf16(p[0][2], p[0][3]),
                              pack_bf16(p[1][0], p[1][1]),
                              pack_bf16(p[1][2], p[1][3])};

      // O = O * corr + P V (V's 16 rows as the k-group, two n-tiles a
      // load).
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[nt][c] *= corr[c >> 1];
#pragma unroll
      for (int dn = 0; dn < NT; dn += 2) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, sv + ((mi & 1) * 8 + mr) * L.vrow +
                              (dn + (mi >> 1)) * 16);
        mma_bf16(o[dn], pa, vb[0], vb[1]);
        mma_bf16(o[dn + 1], pa, vb[2], vb[3]);
      }
      __syncwarp();
      if (s_issue <= s_last) {
        issue_warp<D, PAGED, QUANT>(a, s, L, s_issue, stage, held + st,
                                    next_row);
        s_issue = next_step(s_issue, C);
      }
      cp_async_commit();
      st ^= 1;
    }
    cp_async_wait<0>();
    __syncwarp();

    // The warp's state of the pass's rows into its own stages: O, m and l
    // (this lane's sums over the quad, in a fixed order).
    float* w_o = reinterpret_cast<float*>(wstages);
    float* w_ml = w_o + kRowsPass * D;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = g + 8 * hf;
      float l = l_part[hf];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      if (t4 == 0) {
        w_ml[i] = m_run[hf];
        w_ml[kRowsPass + i] = l;
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        w_o[i * D + nt * 8 + 2 * t4] = o[nt][2 * hf];
        w_o[i * D + nt * 8 + 2 * t4 + 1] = o[nt][2 * hf + 1];
      }
    }
    __syncthreads();

    // This rank's partials of the pass's rows: the four warps in order.
    for (int idx = tid; idx < rows_here * D; idx += kThreads) {
      const int i = idx / D, dd = idx % D;
      float m = kNegBig;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float* ml = reinterpret_cast<const float*>(
            smem + w * kStages * L.wstage) + kRowsPass * D;
        m = fmaxf(m, ml[i]);
      }
      float l = 0.f, acc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float* wo = reinterpret_cast<const float*>(
            smem + w * kStages * L.wstage);
        const float* ml = wo + kRowsPass * D;
        const float wt = exp2f(ml[i] - m);
        l += wt * ml[kRowsPass + i];
        acc += wt * wo[i * D + dd];
      }
      part[(r0 + i) * D + dd] = acc;
      if (dd == 0) {
        part_ml[r0 + i] = m;
        part_ml[R + r0 + i] = l;
      }
    }
    __syncthreads();
  }

  // The merge. Rank j merges the output elements [j E / C, (j + 1) E / C)
  // of E = R * D: every rank that walked a step stores into rank j's
  // shared memory, at its own place, its partials of those elements and
  // of their rows' m and l, each store completing its bytes on rank j's
  // mbarrier. Rank j waits there for the bytes of the ranks that walked
  // a step, merges its slice, ranks in order, and leaves. `active`: the
  // ranks that walked a step (lane i answers for rank i).
  const int elems = R * D;
  float* gath = reinterpret_cast<float*>(smem + L.w);
  const uint32_t active = __ballot_sync(
      0xffffffffu, lane < C && owned_from(s_first, lane, C) <= s_last);
  // Per rank j (lane j of warp 0): its slice [f0, f1), rows q_n, and where
  // its values start in this rank's flat list of stores (an exclusive
  // prefix sum of 2 q_n + f1 - f0).
  int* slices = reinterpret_cast<int*>(smem + L.slices);   // (C, 3)
  if (warp == 0) {
    const int f0 = lane * elems / C, f1 = (lane + 1) * elems / C;
    const int q_n = lane < C && f1 > f0 ? (f1 - 1) / D - f0 / D + 1 : 0;
    const int q_per = lane < C ? 2 * q_n + f1 - f0 : 0;
    int base = q_per;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, base, o);
      if (lane >= o) base += t;
    }
    if (lane < C) {
      slices[3 * lane] = f0;
      slices[3 * lane + 1] = q_n;
      slices[3 * lane + 2] = base - q_per;
    }
    if (lane == C - 1) slices[3 * C] = base;   // the stores in all
  }
  cluster_wait();
  __syncthreads();
  if ((active >> rank) & 1) {
    // One store a thread (or a few): value idx of rank j's slice.
    for (int p = tid; p < slices[3 * C]; p += kThreads) {
      int j = 0;
      while (j + 1 < C && slices[3 * (j + 1) + 2] <= p) ++j;
      const int f0 = slices[3 * j], q_n = slices[3 * j + 1];
      const int idx = p - slices[3 * j + 2];
      const int q_per = (j + 1 < C ? slices[3 * (j + 1) + 2] : slices[3 * C]) -
                        slices[3 * j + 2];
      const int q_lo = f0 / D;
      st_async(peer_addr(gath + rank * q_per + idx, j),
               idx < q_n       ? part_ml[q_lo + idx]
               : idx < 2 * q_n ? part_ml[R + q_lo + idx - q_n]
                               : part[f0 + idx - 2 * q_n],
               peer_addr(bar, j));
    }
  }
  if (tid == 0)
    mbar_expect_tx(bar, 4u * __popc(active) *
                            (2 * slices[3 * rank + 1] +
                             (rank + 1) * elems / C - rank * elems / C));
  mbar_wait(bar, 0);
  // This rank's slice: stored at gath[i * per] by rank i (m, l of the
  // rows r_lo.., then the elements).
  const int e0 = rank * elems / C, e1 = (rank + 1) * elems / C;
  const int nr = slices[3 * rank + 1];
  const int r_lo = e0 / D;
  const int per = 2 * nr + (e1 - e0);
  float* w = gath + C * per;              // weights (C, nr), then m, l
  float* w_m = w + C * nr;
  float* w_l = w_m + nr;
  for (int r = warp; r < nr; r += kWarps) {
    const bool on = lane < C && ((active >> lane) & 1);
    const float mi_ = on ? gath[lane * per + r] : kNegBig;
    float m = mi_;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    m = fmaxf(m, kNegBig);
    const float wt = on ? exp2f(mi_ - m) : 0.f;
    const float li = on ? wt * gath[lane * per + nr + r] : 0.f;
    if (on) w[lane * nr + r] = wt;
    // l over the ranks in order.
    float l = 0.f;
    for (int i = 0; i < C; ++i) {
      const float t = __shfl_sync(0xffffffffu, li, i);
      if ((active >> i) & 1) l += t;
    }
    if (lane == 0) {
      w_m[r] = m;
      w_l[r] = l;
    }
  }
  __syncthreads();
  for (int e = e0 + tid; e < e1; e += kThreads) {
    const int r = e / D, dd = e % D, rl = r - r_lo;
    float acc = 0.f;
    for (int i = 0; i < C; ++i)
      if ((active >> i) & 1)
        acc += w[i * nr + rl] * gath[i * per + 2 * nr + e - e0];
    const size_t qrow = static_cast<size_t>(
        s.b * a.h + s.hk * a.group + r % a.group) * a.n + r / a.group;
    if (a.num != nullptr) {
      a.num[qrow * D + dd] = acc;
      if (dd == 0) {
        a.m_out[qrow] = w_m[rl];
        a.l_out[qrow] = w_l[rl];
      }
    } else {
      a.out[qrow * D + dd] =
          __float2bfloat16(w_l[rl] == 0.f ? 0.f : acc / w_l[rl]);
    }
  }
}

template <int D, bool PAGED, bool QUANT>
cudaError_t configure(int rows, int n, int cluster, int pages, int blocks,
                      cudaStream_t stream, cudaLaunchConfig_t& cfg,
                      cudaLaunchAttribute& attr) {
  const Layout L = make_layout(rows, n, D, QUANT, pages);
  auto kernel = flash_decode_kernel<D, PAGED, QUANT>;
  static int smem_set = 0;   // the attribute this kernel carries
  if (L.bytes > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    smem_set = L.bytes;
  }
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(cluster, blocks, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <int D, bool PAGED, bool QUANT>
int launch(const Args& a, int batch, cudaStream_t stream) {
  if (batch == 0) return 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<D, PAGED, QUANT>(
      a.n * a.group, a.n, a.cluster, a.pages, batch * a.h_kv, stream, cfg,
      attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, flash_decode_kernel<D, PAGED, QUANT>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Clusters of the instantiation that can be resident on the card at once
// (cudaOccupancyMaxActiveClusters), -1 on an error.
template <int D, bool PAGED, bool QUANT>
int max_clusters(int rows, int n, int cluster) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int found = -1;
  if (configure<D, PAGED, QUANT>(rows, n, cluster, 0, cluster, nullptr, cfg,
                                 attr) != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(
          &found, flash_decode_kernel<D, PAGED, QUANT>, &cfg) != cudaSuccess)
    return -1;
  return found;
}

template <bool PAGED>
int dispatch(const Args& a, int batch, int d, void* stream) {
  if (a.cluster < 1 || a.cluster > kMaxCluster ||
      (a.cluster & (a.cluster - 1)) || batch * a.h_kv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool quant = a.k_q != nullptr;
#define DECODE_CASE(DIM)                                                     \
  case DIM:                                                                  \
    return quant ? launch<DIM, PAGED, true>(a, batch, s)                     \
                 : launch<DIM, PAGED, false>(a, batch, s);
  switch (d) {
    DECODE_CASE(32)
    DECODE_CASE(64)
    DECODE_CASE(96)
    DECODE_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DECODE_CASE
}

Args make_args(const void* q, const void* k_new, const void* v_new,
               void* cache_k, void* cache_v, const void* valid_to,
               const void* append_at, const void* n_new,
               const void* page_table, void* k_q, void* k_scale,
               const void* alibi, void* out, void* num, void* m, void* l,
               int h, int h_kv, int n, int t_max, int page_size, int window,
               int cluster, float qscale) {
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k_new = static_cast<const bf16*>(k_new);
  a.v_new = static_cast<const bf16*>(v_new);
  a.cache_k = static_cast<bf16*>(cache_k);
  a.cache_v = static_cast<bf16*>(cache_v);
  a.valid_to = static_cast<const int*>(valid_to);
  a.append_at = static_cast<const int*>(append_at);
  a.n_new = static_cast<const int*>(n_new);
  a.page_table = static_cast<const int*>(page_table);
  a.k_q = static_cast<int8_t*>(k_q);
  a.k_scale = static_cast<float*>(k_scale);
  a.alibi = static_cast<const float*>(alibi);
  a.out = static_cast<bf16*>(out);
  a.num = static_cast<float*>(num);
  a.m_out = static_cast<float*>(m);
  a.l_out = static_cast<float*>(l);
  a.h = h;
  a.h_kv = h_kv;
  a.group = h / h_kv;
  a.n = n;
  a.t_max = t_max;
  a.page_size = page_size;
  a.window = window;
  a.cluster = cluster;
  a.cluster_shift = 0;
  while ((1 << (a.cluster_shift + 1)) <= cluster) ++a.cluster_shift;
  a.page_shift = 0;
  while ((1 << (a.page_shift + 1)) <= page_size) ++a.page_shift;
  a.pages = page_table == nullptr ? 0
                                  : page_entries(t_max, page_size, cluster);
  a.qscale = qscale;
  return a;
}

}  // namespace

extern "C" int flash_decode_chunk() { return kChunk; }

// Clusters of `cluster` blocks of the kernel for (rows = n * group, n, d,
// paged, int8 mirror) resident on the card at once; -1 on an error.
extern "C" int flash_decode_max_clusters(int rows, int n, int d, int paged,
                                         int quant, int cluster) {
#define DECODE_OCC(DIM, P, Q)                                                \
  if (d == DIM && (paged != 0) == P && (quant != 0) == Q)                    \
    return max_clusters<DIM, P, Q>(rows, n, cluster);
#define DECODE_OCC_D(DIM)                                                    \
  DECODE_OCC(DIM, false, false) DECODE_OCC(DIM, false, true)                 \
  DECODE_OCC(DIM, true, false) DECODE_OCC(DIM, true, true)
  DECODE_OCC_D(32)
  DECODE_OCC_D(64)
  DECODE_OCC_D(96)
  DECODE_OCC_D(128)
#undef DECODE_OCC_D
#undef DECODE_OCC
  return -1;
}

// Dynamic shared memory of one block with `rows` = n * group query rows
// of head dim d (quant: the int8 mirror) and, paged (page_size > 0), the
// page ids of a rank of `cluster`; the host refuses a launch past the
// card's limit.
extern "C" int flash_decode_smem(int rows, int n, int d, int quant,
                                 int t_max, int page_size, int cluster) {
  return make_layout(rows, n, d, quant != 0,
                     page_entries(t_max, page_size, cluster)).bytes;
}

// The slab step (K5). Operands as `Args` above: q (batch, h, n, d);
// k_new/v_new (batch, h_kv, n, d); cache_k/cache_v (batch, h_kv, t_max,
// d), appended in place; valid_to/append_at/n_new (batch,) int32; k_q /
// k_scale the int8 mirror, null for bf16 scoring; alibi null or (h,) f32
// slopes; out, or num/m/l for the partial outputs. window <= 0: no
// window. cluster: the blocks per (slot, kv head), a power of two up to 8.
// Returns a cudaError_t code (0 = launched).
extern "C" int flash_decode_bf16(
    const void* q, const void* k_new, const void* v_new, void* cache_k,
    void* cache_v, const void* valid_to, const void* append_at,
    const void* n_new, void* k_q, void* k_scale, const void* alibi,
    void* out, void* num, void* m, void* l, int batch, int h, int h_kv,
    int n, int t_max, int d, int window, int cluster, float qscale,
    void* stream) {
  const Args a = make_args(q, k_new, v_new, cache_k, cache_v, valid_to,
                           append_at, n_new, nullptr, k_q, k_scale, alibi,
                           out, num, m, l, h, h_kv, n, t_max, 1, window,
                           cluster, qscale);
  return dispatch<false>(a, batch, d, stream);
}

// The paged step (K5p): k_pool/v_pool (pages + 1, h_kv, page_size, d)
// and the mirror pools, appended in place through page_table (batch,
// pages_per_slot) int32 (-1 = unallocated); page_size must divide 128 or
// be a multiple of it. Other arguments as above.
extern "C" int flash_decode_paged_bf16(
    const void* q, const void* k_new, const void* v_new, void* k_pool,
    void* v_pool, const void* valid_to, const void* append_at,
    const void* n_new, const void* page_table, void* k_q, void* k_scale,
    const void* alibi, void* out, void* num, void* m, void* l, int batch,
    int h, int h_kv, int n, int pages_per_slot, int page_size, int d,
    int window, int cluster, float qscale, void* stream) {
  if (page_size < 1 || (kChunk % page_size && page_size % kChunk))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, k_new, v_new, k_pool, v_pool, valid_to,
                           append_at, n_new, page_table, k_q, k_scale, alibi,
                           out, num, m, l, h, h_kv, n,
                           pages_per_slot * page_size, page_size, window,
                           cluster, qscale);
  return dispatch<true>(a, batch, d, stream);
}
