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
//   K and V rows together with cp.async (16 bytes at a time; 8 or 4 where
//   the row width allows no more, byte loads for an odd width) into rows
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
// Widths: the kernel is a template on the FLASH_GRID pair (D, DV) of
// csrc/hopper.cuh that covers the true widths d (q, k) and dv (v), any
// from 1 to 256. The cache is appended in place and is never padded: rows
// are read and written at their true widths (row strides d and dv) and
// zero-filled to D and DV in shared memory, so the extra columns add
// nothing to S and give O columns that are never stored.
//
// The K split: rank r owns the chunks c with c % C == r of `chunk`
// columns each (kChunk = 128, or a slab call's block_k); a step is a
// 64-column piece of a chunk (the last piece shorter when the chunk is no
// multiple of 64).
//
// Float32 (the library built with -DDECODE_F32: flash_decode_f32,
// flash_decode_paged_f32; its kernel flash_decode_f32_kernel, the same
// TPU bodies replaced): q, k_new / v_new, the caches and the output are
// float32, and everything above holds with 4-byte elements, the q fold
// kept in float32 and the int8 mirror quantized from the float32 rows.
// What bounds it on this card is the bytes, one read of the attended K and
// V rows at 3.35 TB/s (the greedy shape, 4 slots x 8 heads of 96 over
// 1033 columns: 7.6 us; the serving shape: 17.3 us): a step does n *
// group products for each K or V value it reads. So the products are
// exact float32 FFMA on the CUDA cores over the real query rows only: a
// pass holds up to rows_of(DV) rows (16 at DV <= 128, 8 above, so that O
// fits in registers), and each row's S, softmax and P.V run on the landed
// stage in turn, its sums in a fixed order over its own columns whatever
// rows share its pass. S: lanes along d (lane l holds elements l, l + 32,
// ... of the row's q and of each of the step's 16 K rows), each column's
// 32 lane partials summed by one butterfly (column_sums: column c's score
// in lanes 2c and 2c + 1), the softmax there; P.V: lanes along dv, O in
// registers, p of column c from lane 2c, a column the row does not
// attend skipped (so the old bytes of a column not fetched add nothing).
// wgmma, which carries the float32 K1, takes 64-row tiles: at one query
// row it computes 64 rows for each real one (the earlier body's 16-row
// mma.sync tiles, each product three TF32 products, 16), where FFMA
// computes the real rows only, needs no split and rounds each product
// once. The int8 mirror keeps its exact s8 mma.sync scores on a 16-row q
// tile (int8 K rows padded by 16 bytes for ldmatrix, copied by cp.async),
// staged through a 16 x 16 score tile into the same layout; its P.V is the
// FFMA path. K and V rows lie unpadded in the stages (lanes along d or dv
// read consecutive words, no bank conflict), so a row whose bytes are a
// multiple of 16 is one contiguous run that the lane owning it fetches by
// one cp.async.bulk (the 1-D TMA; where the true width is the
// instantiation's, columns whose rows lie back to back, a slab's or a
// page's, by one copy from the first of them), completing on the warp's
// mbarrier for that stage; other widths by 4-byte cp.async. A stage's
// row tails (d to
// D, dv to DV) are zeroed once a pass and no copy writes them. The plan
// (steps a warp keeps in flight, blocks an SM) comes from the
// shared-memory arithmetic (stages_of, blocks_of): as many steps, at most
// kF32MaxSteps, as leave room for kF32Blocks blocks an SM, and one where
// one does not. With kF32MaxSteps 2 and kF32Blocks 2 the pairs run (one
// query row; steps a warp, blocks an SM): (32, 32) and (64, 64) 2, 2;
// (96, 96) 2, 2 (a warp's step 12,288 B, a block 100,192 B); (128, 128)
// and (192, 128) 1, 2; (256, 256) 1, 1 (131,072 B of stages); the int8
// mirror 2, 2 but at (256, 256) 1, 2. Three steps a warp at (96, 96)
// leave one block an SM and time slower at both the greedy and the
// serving shape; one step leaves three blocks an SM, which holds the
// greedy shape's 32 clusters of 8 in one wave (two blocks an SM hold 30:
// a second wave) but paces K5p's long chains by each step's loads
// (scripts/torch_decode_sections.py --f32 --plans times the three; PERF.md
// has the numbers). The fixed column partition and merge orders are the
// bf16 kernel's, so the bit-for-bit contracts above hold as they do there.
//
// Paged (K5p): the cache is a pool of (pages + 1, h_kv, page_size, d)
// pages, and column c of slot b lives at row c % page_size of pool page
// table[b][c / page_size], for any page size (a chunk holds the ids of
// every page its 128 columns touch; shifts for a power of two, divisions
// otherwise). A -1 entry is never read: its
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

// The element of q, k_new / v_new, the caches and the output: bf16, or
// float32 in the library built with -DDECODE_F32 (ops/_build.py).
#ifdef DECODE_F32
using elem = float;
#define DECODE_SYMBOL(name) name##_f32
#else
using elem = bf16;
#define DECODE_SYMBOL(name) name##_bf16
#endif
constexpr int kEB = sizeof(elem);  // bytes an element
constexpr int kEP = 16 / kEB;      // elements a 16-byte piece

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void store_elem(bf16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store_elem(float* p, float x) { *p = x; }
// q * qscale rounded back to the element type (the TPU kernel's fold).
__device__ __forceinline__ bf16 fold(bf16 x, float s) {
  return __float2bfloat16(__bfloat162float(x) * s);
}
__device__ __forceinline__ float fold(float x, float s) { return x * s; }

constexpr int kChunk = 128;        // columns a cluster rank owns at a time
                                   // (the default split; block_k on a slab)
constexpr int kStep = 64;          // columns a step spans, 16 a warp
constexpr int kWarpCols = kStep / kWarps;

constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr float kNegBig = -0.7f * 3.4e38f;
constexpr float kLog2e = 1.4426950408889634f;

// The columns lo..hi a row at valid_to vt attends (hi < lo: none).
__device__ __forceinline__ void row_span(int vt, int t_max, int window,
                                         int& lo, int& hi) {
  hi = vt < t_max - 1 ? vt : t_max - 1;
  lo = window > 0 && vt - window + 1 > 0 ? vt - window + 1 : 0;
}

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

// The page ids of one 128-column chunk: 128 / page_size for a divisor of
// 128, one for a multiple of 128, and otherwise the most pages 128
// consecutive columns can touch (ceil(127 / page_size) + 1).
__host__ __device__ inline int pages_per_chunk(int page_size) {
  if (kChunk % page_size == 0) return kChunk / page_size;
  if (page_size % kChunk == 0) return 1;
  return (kChunk - 1 + page_size - 1) / page_size + 1;
}

// Page ids a rank holds (paged): its chunks' pages, pages_per_chunk a
// chunk, for ceil(chunks / cluster) chunks.
__host__ __device__ inline int page_entries(int t_max, int page_size,
                                            int cluster) {
  if (page_size <= 0) return 0;
  const int chunks = (t_max + kChunk - 1) / kChunk;
  return (chunks + cluster - 1) / cluster * pages_per_chunk(page_size);
}

#ifndef DECODE_F32
// A warp's steps in flight: two.
__host__ __device__ constexpr int stages_of(int, int, bool) { return 2; }

// Blocks an SM should hold (__launch_bounds__): the shared memory of a
// block at these widths leaves room for about that many.
__host__ __device__ constexpr int min_blocks(int dv) {
  return dv > 128 ? 1 : 3;
}
constexpr int kRowsPass = 16;      // query rows a pass holds (an m-tile)

// Byte offsets of one block's dynamic shared memory, for `rows` = n *
// group query rows of the instantiation's widths D (q, k) and DV (v). Each
// warp has its own stages of its 16 columns of a step; every row of K, V
// and q is padded by 16 bytes (conflict-free fragment reads). After a pass
// a warp leaves its state (O, m, l of the pass's 16 rows) in its own
// stages.
struct Layout {
  int krow, vrow;            // bytes of a K row (q rows alike), a V row
  int v, ks, wstage;         // V, int8 scales within a warp's stage; size
  int q, qs, held, fresh, fresh_s, pages, part, part_ml, slices, bar, w;
  int bytes;
};

__host__ __device__ inline Layout make_layout(int rows, int n, int d, int dv,
                                              bool quant, int pages) {
  Layout L;
  L.krow = (quant ? d : kEB * d) + 16;
  L.vrow = kEB * dv + 16;
  L.v = kWarpCols * L.krow;
  L.ks = L.v + kWarpCols * L.vrow;
  L.wstage = align16(L.ks + (quant ? 4 * kWarpCols : 0));
  int o = kWarps * stages_of(d, dv, quant) * L.wstage;
  L.q = o;        o += kRowsPass * L.krow;        // a pass's q rows
  L.qs = o;       o = align16(o + 4 * kRowsPass); // int8: their scales
  L.held = o;     o = align16(o + 4 * kWarps * stages_of(d, dv, quant));
  L.fresh = o;    o = align16(o + (quant ? n * d : 0));   // int8 k_new
  L.fresh_s = o;  o = align16(o + (quant ? 4 * n : 0));   // and scales
  L.pages = o;    o = align16(o + 4 * pages);     // the rank's page ids
  L.part = o;     o += 4 * rows * dv;             // this rank's acc
  L.part_ml = o;  o = align16(o + 8 * rows);      // and its m, l
  L.slices = o;   o += 12 * kMaxCluster + 16;     // the merge's slices
  L.bar = o;      o += 16;                        // its mbarrier
  // The merge's gathered partials, weights, m and l: at most this.
  L.w = o;        o = align16(o + 4 * (rows * dv + 26 * rows + 16));
  L.bytes = o;
  return L;
}
#else
// The float32 body's plan: each warp keeps as many steps in flight, at
// most kF32MaxSteps, as leave room for kF32Blocks blocks an SM, and one
// where one does not. kF32Blocks and kF32MaxSteps are chosen by timing
// (scripts/torch_decode_sections.py --f32 --plans: the two plans of
// design item 3 in the head note).
constexpr int kF32MaxSteps = 2;
constexpr int kF32Blocks = 2;
constexpr int kSmemSm = 233472;    // shared memory of an SM (228 KB)
constexpr int kSmemReserve = 1024; // the system's share of it a block
constexpr int kF32Spare = 4096;    // the partials, the merge, page ids (a
                                   // few query rows)

// Query rows a pass holds: O (rows x DV / 32 a lane) stays in registers.
__host__ __device__ constexpr int rows_of(int dv) {
  return dv <= 128 ? 16 : 8;
}

// Bytes of a warp's stage: its 16 columns' K rows (float32, or int8
// padded by 16 bytes for ldmatrix, then their scales) and V rows.
__host__ __device__ constexpr int stage_bytes(int d, int dv, bool quant) {
  return quant ? 16 * (d + 16) + 64 * dv + 64 : 64 * (d + dv);
}

// Bytes beside the stages: the q rows of a pass (int8: a 16-row tile and
// the warps' 16 x 16 score tiles) and kF32Spare.
__host__ __device__ constexpr int fixed_bytes(int d, int dv, bool quant) {
  return (quant ? 16 * (d + 16) + kWarps * 1024 : rows_of(dv) * 4 * d) +
         kF32Spare;
}

// A warp's steps in flight (see kF32Blocks).
__host__ __device__ constexpr int stages_of(int d, int dv, bool quant) {
  const int fit = (kSmemSm / kF32Blocks - kSmemReserve -
                   fixed_bytes(d, dv, quant)) /
                  (kWarps * stage_bytes(d, dv, quant));
  return fit > kF32MaxSteps ? kF32MaxSteps : (fit < 1 ? 1 : fit);
}

// The blocks an SM that plan leaves room for (__launch_bounds__).
__host__ __device__ constexpr int blocks_of(int d, int dv, bool quant) {
  const int fit = kSmemSm / (kWarps * stages_of(d, dv, quant) *
                                 stage_bytes(d, dv, quant) +
                             fixed_bytes(d, dv, quant) + kSmemReserve);
  return fit > kF32Blocks ? kF32Blocks : (fit < 1 ? 1 : fit);
}

// Byte offsets of one block's dynamic shared memory, for `rows` = n *
// group query rows of the instantiation's widths D (q, k) and DV (v). Each
// warp has its own stages of its 16 columns of a step (K rows, then V
// rows, unpadded; int8 K rows padded by 16 bytes, then their scales) and
// an mbarrier a stage. After a pass a warp leaves its state (O, m, l of
// the pass's rows) in its own stages.
struct Layout {
  int kstride, vstride;      // bytes of a K row, a V row in a stage
  int v, ks, wstage;         // V, int8 scales within a warp's stage; size
  int sq;                    // int8: the warps' 16 x 16 score tiles
  int q, qrow, qs;           // a pass's q rows, their stride, int8 scales
  int rowc;                  // the pass's rows' spans, ALiBi origin, slope
  int held, bars;            // a warp's stages' held masks, mbarriers
  int fresh, fresh_s, pages, part, part_ml, slices, bar, w;
  int bytes;
};

__host__ __device__ inline Layout make_layout(int rows, int n, int d, int dv,
                                              bool quant, int pages) {
  Layout L;
  const int stages = stages_of(d, dv, quant);
  L.kstride = quant ? d + 16 : 4 * d;
  L.vstride = 4 * dv;
  L.v = kWarpCols * L.kstride;
  L.ks = L.v + kWarpCols * L.vstride;
  L.wstage = stage_bytes(d, dv, quant);
  int o = kWarps * stages * L.wstage;
  L.sq = o;       o += quant ? kWarps * 1024 : 0;
  L.qrow = quant ? d + 16 : 4 * d;
  L.q = o;        o += (quant ? 16 : (rows < rows_of(dv) ? rows
                                                         : rows_of(dv))) *
                       L.qrow;
  L.qs = o;       o = align16(o + 4 * 16);        // int8: q's scales
  L.rowc = o;     o += 16 * rows_of(dv);
  L.held = o;     o = align16(o + 4 * kWarps * stages);
  L.bars = o;     o = align16(o + 8 * kWarps * stages);
  L.fresh = o;    o = align16(o + (quant ? n * d : 0));   // int8 k_new
  L.fresh_s = o;  o = align16(o + (quant ? 4 * n : 0));   // and scales
  L.pages = o;    o = align16(o + 4 * pages);     // the rank's page ids
  L.part = o;     o += 4 * rows * dv;             // this rank's acc
  L.part_ml = o;  o = align16(o + 8 * rows);      // and its m, l
  L.slices = o;   o += 12 * kMaxCluster + 16;     // the merge's slices
  L.bar = o;      o += 16;                        // its mbarrier
  // The merge's gathered partials, weights, m and l: at most this.
  L.w = o;        o = align16(o + 4 * (rows * dv + 26 * rows + 16));
  L.bytes = o;
  return L;
}
#endif

// Every operand of one launch. Shapes (all contiguous; d and dv the true
// widths of k and v rows, at most the instantiation's D and DV): q (batch,
// h, n, d); k_new (batch, h_kv, n, d), v_new (batch, h_kv, n, dv); slab
// caches (batch, h_kv, t_max, d / dv), or pools (pages + 1, h_kv,
// page_size, d / dv) read through page_table (batch, t_max / page_size);
// valid_to/append_at/n_new (batch,; n_new null: n rows wherever append_at
// >= 0). The int8 mirror (k_q != nullptr): k_q / k_scale laid out as the
// bf16 K cache with d and 1 elements per row. alibi: null, or the (h,)
// slopes. Outputs: out (batch, h, n, dv) as the cache, or with num !=
// nullptr the partials num (batch, h, n, dv), m and l (batch, h, n), all
// f32. q, k_new, v_new, the caches and out are `elem` (bf16, or float32).
struct Args {
  const elem* q;
  const elem* k_new;
  const elem* v_new;
  elem* cache_k;
  elem* cache_v;
  const int* valid_to;
  const int* append_at;
  const int* n_new;
  const int* page_table;
  int8_t* k_q;
  float* k_scale;
  const float* alibi;
  elem* out;
  float* num;
  float* m_out;
  float* l_out;
  int h, h_kv, group, n, t_max, page_size, window, cluster;
  int d, dv;                 // the true row widths of k and v
  int kw, vw, k8w;           // copy widths of a k, v, int8 k row (16/8/4/2/1)
  int chunk, spc;            // columns of a chunk, 64-column steps in one
  int cluster_shift;         // log2 of the cluster
  int page_shift;            // log2 of a power-of-two page size, else -1
  int ppc;                   // page ids of a chunk (pages_per_chunk)
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

// Steps number a chunk's 64-column pieces: step s is piece s % spc of
// chunk s / spc (the last piece shorter when the chunk is no multiple of
// 64). The step holding column col, and the first column of step s.
__device__ __forceinline__ int step_of(const Args& a, int col) {
  const int c = col / a.chunk;
  return c * a.spc + (col - c * a.chunk) / kStep;
}

__device__ __forceinline__ int step_col(const Args& a, int s) {
  return s / a.spc * a.chunk + s % a.spc * kStep;
}

// The first step at or after step s whose chunk rank `rank` owns.
__device__ __forceinline__ int owned_from(int s, int rank, int cluster,
                                          int spc) {
  const int c = s / spc;
  const int own = c + ((rank - c % cluster) % cluster + cluster) % cluster;
  return own == c ? s : own * spc;
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
  const int c = col / kChunk;
  const int k = c >> a.cluster_shift;   // the rank's k-th chunk
  // The column's page, its chunk's first page and its row in the page:
  // shifts and masks for a power of two, divisions otherwise.
  int page_no, first, at;
  if (a.page_shift >= 0) {
    page_no = col >> a.page_shift;
    first = c * kChunk >> a.page_shift;
    at = col & (ps - 1);
  } else {
    page_no = col / ps;
    first = c * kChunk / ps;
    at = col - page_no * ps;
  }
  const int page = pages[k * a.ppc + page_no - first];
  if (page < 0) return -1;
  return (page * a.h_kv + s.hk) * ps + at;
}

// The row of column `lane` of the calling warp's 16 columns of `step`
// (lanes < 16), -1 outside the span or on a -1 page.
template <bool PAGED>
__device__ __forceinline__ int lookup(const Args& a, const Slot& s,
                                      const int* pages, int step) {
  const int lane = threadIdx.x % 32;
  const int in_chunk = step % a.spc * kStep + kWarpCols * (threadIdx.x / 32) +
                       lane;
  const int col = step / a.spc * a.chunk + in_chunk;
  return lane < kWarpCols && in_chunk < a.chunk && col >= s.lo && col <= s.hi
             ? cache_row<PAGED>(a, s, pages, col) : -1;
}

// One row of `bytes` bytes at `src` into the `ROOM` bytes (a multiple of
// 16) at shared address `dst` (generic pointer `dp`), the rest zeros: `w`
// bytes a copy by cp.async for w = 16, 8 or 4 (the widest the row's
// address allows), byte loads and stores otherwise (an odd bf16 width).
// `ok` false: all zeros, nothing read (`src` must still be a valid
// address).
template <int ROOM>
__device__ __forceinline__ void copy_row(uint32_t dst, unsigned char* dp,
                                         const unsigned char* src, int bytes,
                                         int w, bool ok) {
  if (w == 16) {
#pragma unroll
    for (int p = 0; p < ROOM / 16; ++p) {
      const bool in = ok && 16 * p < bytes;
      cp_async16(dst + 16 * p, src + (in ? 16 * p : 0), in);
    }
  } else if (w >= 4) {
    for (int o = 0; o < ROOM; o += w) {
      int n = ok ? bytes - o : 0;
      n = n < 0 ? 0 : (n > w ? w : n);
      const unsigned char* from = n > 0 ? src + o : src;
      if (w == 8)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                     :: "r"(dst + o), "l"(from), "r"(n) : "memory");
      else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                     :: "r"(dst + o), "l"(from), "r"(n) : "memory");
    }
  } else {
    for (int o = 0; o < ROOM; ++o) dp[o] = ok && o < bytes ? src[o] : 0;
  }
}

// The widest copy (16, 8, 4, 2 or 1 bytes) that every row of `row_bytes`
// bytes allows, its tensor's base 16-byte aligned.
__host__ __device__ inline int copy_width(int row_bytes) {
  for (int w = 16; w > 1; w /= 2)
    if (row_bytes % w == 0) return w;
  return 1;
}

// Where lane `lane` of the calling warp copies its row of `step` from:
// lanes 0-15 the K rows (int8: the mirror's), lanes 16-31 the V rows of
// the warp's columns r = lane % 16, `row` that column's cache or pool row
// (-1: nothing to copy). A fresh column (an appended row) comes from
// k_new/v_new (int8: nothing; the quantized row replaces it once the
// stage lands). Null when nothing is copied.
template <bool QUANT>
__device__ __forceinline__ const unsigned char* row_source(const Args& a,
                                                           const Slot& s,
                                                           int step,
                                                           int row) {
  const int lane = threadIdx.x % 32;
  const int r = lane % kWarpCols;
  const bool isv = lane >= kWarpCols;
  const int col0 = step_col(a, step) + kWarpCols * (threadIdx.x / 32);
  const int m = col0 + r - s.ap;
  const bool fresh = s.ap >= 0 && m >= 0 && m < s.nn;
  const size_t fresh_row = static_cast<size_t>(s.bh) * a.n + m;
  const void* src;
  bool copy = row >= 0;
  if (isv) {
    src = fresh ? a.v_new + fresh_row * a.dv
                : a.cache_v + static_cast<size_t>(row) * a.dv;
  } else if (QUANT) {
    src = a.k_q + static_cast<size_t>(row) * a.d;
    copy = copy && !fresh;
  } else {
    src = fresh ? a.k_new + fresh_row * a.d
                : a.cache_k + static_cast<size_t>(row) * a.d;
  }
  return copy ? static_cast<const unsigned char*>(src) : nullptr;
}

// The step after `step` on its rank: the next piece of the same chunk,
// or the first piece of the rank's next chunk (`cluster` chunks on).
__device__ __forceinline__ int next_step(int step, int cluster, int spc) {
  return (step + 1) % spc ? step + 1 : step + 1 + (cluster - 1) * spc;
}

// quantize_rows of one row of d <= D elements by a warp: s =
// max(max|x| / 127, 1e-20), x_i8 = round half to even (x / s), both
// divisions correctly rounded; the row into dst (zeros from d to D), s *
// mul into *scale.
template <int D>
__device__ __forceinline__ void quantize_row(const elem* src, int d,
                                             int8_t* dst, float* scale,
                                             float mul) {
  const int lane = threadIdx.x % 32;
  float x[D / 32];
  float amax = 0.f;
#pragma unroll
  for (int k = 0; k < D / 32; ++k) {
    x[k] = lane + 32 * k < d ? to_f(src[lane + 32 * k]) : 0.f;
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

// `n` bytes from src to dst: 16 at a time when both are 16-byte aligned
// (`vec`), else byte by byte.
__device__ __forceinline__ void copy_bytes(unsigned char* dst,
                                           const unsigned char* src, int n,
                                           bool vec) {
  if (vec && n == 16)
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  else
    for (int i = 0; i < n; ++i) dst[i] = src[i];
}

// The in-place append of slot rows m < n_new at append_at + m whose
// chunk this rank owns (int8: the quantized rows and scales `fresh`,
// `fresh_s` into the mirror as well). A -1 page takes nothing. Each
// thread copies a 16-byte piece of a row (the last piece of a row whose
// width is no multiple of 16 bytes shorter, byte by byte).
template <int D, int DV, bool PAGED, bool QUANT>
__device__ __forceinline__ void append_rows(const Args& a, const Slot& s,
                                            int rank, const int* pages,
                                            const int8_t* fresh,
                                            const float* fresh_s) {
  constexpr int P = (D > DV ? D : DV) / kEP;  // pieces a row at most
  const int kb = kEB * a.d, vb = kEB * a.dv;  // bytes of a k, v row
  for (int idx = threadIdx.x; idx < s.nn * P; idx += kThreads) {
    const int m = idx / P, o = 16 * (idx % P);
    const int col = s.ap + m;
    if (col >= a.t_max || (col / a.chunk) % a.cluster != rank) continue;
    const int row = cache_row<PAGED>(a, s, pages, col);
    if (row < 0) continue;
    const size_t src = static_cast<size_t>(s.bh) * a.n + m;
    if (o < kb)
      copy_bytes(reinterpret_cast<unsigned char*>(a.cache_k) +
                     static_cast<size_t>(row) * kb + o,
                 reinterpret_cast<const unsigned char*>(a.k_new) + src * kb +
                     o,
                 kb - o < 16 ? kb - o : 16, a.kw == 16);
    if (o < vb)
      copy_bytes(reinterpret_cast<unsigned char*>(a.cache_v) +
                     static_cast<size_t>(row) * vb + o,
                 reinterpret_cast<const unsigned char*>(a.v_new) + src * vb +
                     o,
                 vb - o < 16 ? vb - o : 16, a.vw == 16);
    if constexpr (QUANT) {
      if (o < a.d)
        copy_bytes(reinterpret_cast<unsigned char*>(a.k_q) +
                       static_cast<size_t>(row) * a.d + o,
                   reinterpret_cast<const unsigned char*>(fresh + m * D) + o,
                   a.d - o < 16 ? a.d - o : 16, a.k8w == 16);
      if (o == 0) a.k_scale[row] = fresh_s[m];
    }
  }
}

// Chunk c's page ids (paged) into `pages`, for the chunks rank `rank`
// owns: its first page (c * 128 / page_size) and the pages after it, -1
// past the table.
__device__ __forceinline__ void load_page_ids(const Args& a, int rank, int b,
                                              int* pages) {
  const int C = a.cluster;
  const int ppc = a.ppc;
  const int pps = a.t_max / a.page_size;
  const int chunks = (a.t_max + kChunk - 1) / kChunk;
  const int owned = rank < chunks ? (chunks - rank + C - 1) / C * ppc : 0;
  for (int i = threadIdx.x; i < owned; i += kThreads) {
    const int c = rank + i / ppc * C;
    const int p = c * kChunk / a.page_size + i % ppc;
    pages[i] = p < pps ? __ldg(a.page_table +
                               static_cast<size_t>(b) * pps + p)
                       : -1;
  }
}

// The int8 path's q tile of a pass: rows r0.. of the slot's n * group
// query rows (new-row-major), quantized with their scales into `dst`
// (rows `stride` bytes apart) and `q_s`, 16 rows, those past rows_here
// zero. One warp a row.
template <int D>
__device__ __forceinline__ void quantize_q(const Args& a, const Slot& s,
                                           unsigned char* dst, int stride,
                                           float* q_s, int r0,
                                           int rows_here) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < 16; i += kWarps) {
    const int rr = r0 + i;
    int8_t* row = reinterpret_cast<int8_t*>(dst + i * stride);
    if (i < rows_here) {
      const size_t qrow = static_cast<size_t>(
          s.b * a.h + s.hk * a.group + rr % a.group) * a.n + rr / a.group;
      quantize_row<D>(a.q + qrow * a.d, a.d, row, q_s + i, a.qscale);
    } else {
      for (int e = lane; e < D; e += 32) row[e] = 0;
      if (lane == 0) q_s[i] = 0.f;
    }
  }
}

// The int8 path: the fresh columns' quantized rows (`fresh`, D bytes
// each) and scales into a landed stage whose int8 K rows lie `kstride`
// bytes apart and scales at `ks`, for the calling warp's columns col0..
// that `hmask` holds.
template <int D>
__device__ __forceinline__ void put_fresh_rows(const Slot& s,
                                               unsigned char* stage,
                                               int kstride, int ks, int col0,
                                               uint32_t hmask,
                                               const int8_t* fresh,
                                               const float* fresh_s) {
  const int lane = threadIdx.x % 32;
  const int m0 = col0 - s.ap;
  if (s.ap >= 0 && m0 + kWarpCols > 0 && m0 < s.nn) {
    for (int idx = lane; idx < kWarpCols * (D / 16); idx += 32) {
      const int cl = idx / (D / 16), piece = idx % (D / 16);
      const int m = m0 + cl;
      if (m < 0 || m >= s.nn || !((hmask >> cl) & 1)) continue;
      *reinterpret_cast<uint4*>(stage + cl * kstride + piece * 16) =
          *reinterpret_cast<const uint4*>(fresh + m * D + piece * 16);
      if (piece == 0)
        reinterpret_cast<float*>(stage + ks)[cl] = fresh_s[m];
    }
    __syncwarp();
  }
}

// This rank's partials of a pass's rows r0..r0 + rows_here - 1: the four
// warps' states (O, then m and l, of `rows` rows, each left at the start
// of its warp's `wbytes` bytes of stages) merged in order.
template <int DV>
__device__ __forceinline__ void combine_warps(const unsigned char* smem,
                                              int wbytes, int rows, int r0,
                                              int rows_here, int R,
                                              float* part, float* part_ml) {
  for (int idx = threadIdx.x; idx < rows_here * DV; idx += kThreads) {
    const int i = idx / DV, dd = idx % DV;
    float m = kNegBig;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* ml =
          reinterpret_cast<const float*>(smem + w * wbytes) + rows * DV;
      m = fmaxf(m, ml[i]);
    }
    float l = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* wo = reinterpret_cast<const float*>(smem + w * wbytes);
      const float* ml = wo + rows * DV;
      const float wt = exp2f(ml[i] - m);
      l += wt * ml[rows + i];
      acc += wt * wo[i * DV + dd];
    }
    part[(r0 + i) * DV + dd] = acc;
    if (dd == 0) {
      part_ml[r0 + i] = m;
      part_ml[R + r0 + i] = l;
    }
  }
}

// The merge, after every pass: the rank's partials (part, part_ml in its
// shared memory) of the R query rows merged over the cluster. Rank j
// merges the output elements [j E / C, (j + 1) E / C) of E = R * DV: every
// rank that walked a step (s_first..s_last) stores into rank j's shared
// memory, at its own place, its partials of those elements and of their
// rows' m and l, each store completing its bytes on rank j's mbarrier
// `bar`. Rank j waits there for the bytes of the ranks that walked a step,
// merges its slice, ranks in order, and writes the output.
template <int DV>
__device__ __forceinline__ void merge_ranks(const Args& a, const Slot& s,
                                            const Layout& L,
                                            unsigned char* smem, int rank,
                                            int R, int s_first, int s_last,
                                            uint64_t* bar) {
  const int C = a.cluster;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const float* part = reinterpret_cast<const float*>(smem + L.part);
  const float* part_ml = reinterpret_cast<const float*>(smem + L.part_ml);
  // `active`: the ranks that walked a step (lane i answers for rank i).
  const int elems = R * DV;
  float* gath = reinterpret_cast<float*>(smem + L.w);
  const uint32_t active = __ballot_sync(
      0xffffffffu, lane < C && owned_from(s_first, lane, C, a.spc) <= s_last);
  // Per rank j (lane j of warp 0): its slice [f0, f1), rows q_n, and where
  // its values start in this rank's flat list of stores (an exclusive
  // prefix sum of 2 q_n + f1 - f0).
  int* slices = reinterpret_cast<int*>(smem + L.slices);   // (C, 3)
  if (warp == 0) {
    const int f0 = lane * elems / C, f1 = (lane + 1) * elems / C;
    const int q_n = lane < C && f1 > f0 ? (f1 - 1) / DV - f0 / DV + 1 : 0;
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
  // [section] decode merge: cluster barrier passed
  if ((active >> rank) & 1) {
    // One store a thread (or a few): value idx of rank j's slice.
    for (int p = tid; p < slices[3 * C]; p += kThreads) {
      int j = 0;
      while (j + 1 < C && slices[3 * (j + 1) + 2] <= p) ++j;
      const int f0 = slices[3 * j], q_n = slices[3 * j + 1];
      const int idx = p - slices[3 * j + 2];
      const int q_per = (j + 1 < C ? slices[3 * (j + 1) + 2] : slices[3 * C]) -
                        slices[3 * j + 2];
      const int q_lo = f0 / DV;
      st_async(peer_addr(gath + rank * q_per + idx, j),
               idx < q_n       ? part_ml[q_lo + idx]
               : idx < 2 * q_n ? part_ml[R + q_lo + idx - q_n]
                               : part[f0 + idx - 2 * q_n],
               peer_addr(bar, j));
    }
  }
  // [section] decode merge: partials stored
  if (tid == 0)
    mbar_expect_tx(bar, 4u * __popc(active) *
                            (2 * slices[3 * rank + 1] +
                             (rank + 1) * elems / C - rank * elems / C));
  mbar_wait(bar, 0);
  // [section] decode merge: peers landed
  // This rank's slice: stored at gath[i * per] by rank i (m, l of the
  // rows r_lo.., then the elements).
  const int e0 = rank * elems / C, e1 = (rank + 1) * elems / C;
  const int nr = slices[3 * rank + 1];
  const int r_lo = e0 / DV;
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
  // [section] decode merge: weights done
  for (int e = e0 + tid; e < e1; e += kThreads) {
    const int r = e / DV, dd = e % DV, rl = r - r_lo;
    if (dd >= a.dv) continue;   // a padding column
    float acc = 0.f;
    for (int i = 0; i < C; ++i)
      if ((active >> i) & 1)
        acc += w[i * nr + rl] * gath[i * per + 2 * nr + e - e0];
    const size_t qrow = static_cast<size_t>(
        s.b * a.h + s.hk * a.group + r % a.group) * a.n + r / a.group;
    if (a.num != nullptr) {
      a.num[qrow * a.dv + dd] = acc;
      if (dd == 0) {
        a.m_out[qrow] = w_m[rl];
        a.l_out[qrow] = w_l[rl];
      }
    } else {
      store_elem(a.out + qrow * a.dv + dd,
                 w_l[rl] == 0.f ? 0.f : acc / w_l[rl]);
    }
  }
}

#ifndef DECODE_F32
// Issues the calling warp's 16 columns of one step into its stage, one
// row a lane (lanes 0-15 the K rows, int8 with their scales; lanes 16-31
// the V rows; row_source says from where), and its `held` mask: bit i set
// when column col0 + i lies in the span, below t_max and on a held page.
// Lane i < 16 holds column i's row (`my_row`, from `lookup`). A row not
// copied is zero-filled (int8: a fresh row is replaced by the quantized
// row after the stage lands).
template <int D, int DV, bool PAGED, bool QUANT>
__device__ __forceinline__ void issue_warp(const Args& a, const Slot& s,
                                           const Layout& L, int step,
                                           unsigned char* stage,
                                           uint32_t* held, int my_row) {
  const int lane = threadIdx.x % 32;
  const int r = lane % kWarpCols;               // the column it copies
  const bool isv = lane >= kWarpCols;
  const int row = __shfl_sync(0xffffffffu, my_row, r);
  const unsigned char* src = row_source<QUANT>(a, s, step, row);
  const bool copy = src != nullptr;
  const unsigned char* from =
      copy ? src : reinterpret_cast<const unsigned char*>(a.v_new);
  unsigned char* dp = stage + (isv ? L.v + r * L.vrow : r * L.krow);
  const uint32_t dst = smem_u32(dp);
  if (isv)
    copy_row<kEB * DV>(dst, dp, from, kEB * a.dv, a.vw, copy);
  else if (QUANT)
    copy_row<D>(dst, dp, from, a.d, a.k8w, copy);
  else
    copy_row<kEB * D>(dst, dp, from, kEB * a.d, a.kw, copy);
  if constexpr (QUANT) {
    if (!isv)
      cp_async4(smem_u32(stage) + L.ks + 4 * r,
                a.k_scale + (copy ? row : 0), copy);
  }
  const uint32_t bits = __ballot_sync(0xffffffffu, my_row >= 0);
  if (lane == 0) *held = bits;
}

// Grid (cluster, batch * h_kv), clusters of `cluster` blocks along x,
// 128 threads. Each warp runs its own pipeline over its 16 columns of the
// rank's steps (no block barrier in the loop): S = q K^T for a pass's 16
// query rows, the online softmax on the fragments, P to A fragments in
// registers, O += P V. Fragment coordinates: lane = 4 g + t; an m16n8
// accumulator element c holds row g + 8 (c / 2) and column 2 t + c % 2 of
// its n-tile.
//
// D and DV are the instantiation's widths (a FLASH_GRID pair covering the
// true d and dv): k and q rows are zero-filled from d to D in shared
// memory, v rows from dv to DV, so the extra columns add nothing to S and
// give O columns that are never written.
template <int D, int DV, bool PAGED, bool QUANT>
__global__ void __launch_bounds__(kThreads, min_blocks(DV))
flash_decode_kernel(const Args a) {
  static_assert(D % 32 == 0 && D <= 256 && DV % 32 == 0 && DV <= 256,
                "head dims must be 32*n <= 256");
  constexpr int NT = DV / 8;                    // O n-tiles
  constexpr int KS = QUANT ? D / 32 : D / 16;  // S k-steps
  constexpr int kStages = stages_of(D, DV, QUANT);
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int C = a.cluster;
  const int R = a.n * a.group;
  const Layout L = make_layout(R, a.n, D, DV, QUANT, a.pages);
  int* pages = reinterpret_cast<int*>(smem + L.pages);
  // The slot's vectors and (paged) this rank's page ids, read together
  // (one round trip: neither depends on the other).
  const int b_ = blockIdx.y / a.h_kv;
  const int vt_ = a.valid_to[b_];
  const int ap_ = a.append_at[b_];
  const int nn_ = a.n_new == nullptr ? a.n : a.n_new[b_];
  if constexpr (PAGED) {
    load_page_ids(a, rank, b_, pages);
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
  // [section] decode bf16 start

  const int s_first = step_of(a, s.lo);
  const int s_last = s.hi >= s.lo ? step_of(a, s.hi) : s_first - 1;
  const int first = owned_from(s_first, rank, C, a.spc);
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
        s_issue = next_step(s_issue, C, a.spc);
      }
    }
#pragma unroll
    for (int k = 0; k < kStages; ++k) {
      if (steps[k] <= s_last)
        issue_warp<D, DV, PAGED, QUANT>(a, s, L, steps[k],
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
          quantize_row<D>(
              a.k_new + (static_cast<size_t>(s.bh) * a.n + m) * a.d, a.d,
              fresh + m * D, fresh_s + m, 1.f);
      if (first <= s_last)
        quantize_q<D>(a, s, smem + L.q, L.krow, q_s, r0, rows_here);
      __syncthreads();
      if (r0 == 0)
        append_rows<D, DV, PAGED, QUANT>(a, s, rank, pages, fresh, fresh_s);
    } else {
      constexpr int kQP = D / kEP;   // 16-byte pieces of a q row
      constexpr int kQIters = (kRowsPass * kQP + kThreads - 1) / kThreads;
      uint4 raw[kQIters];
#pragma unroll
      for (int k = 0; k < kQIters; ++k) {
        const int idx = tid + k * kThreads;
        const int i = idx / kQP, piece = idx % kQP;
        const int rr = r0 + i;
        raw[k] = make_uint4(0, 0, 0, 0);
        if (first <= s_last && idx < kRowsPass * kQP && i < rows_here &&
            kEP * piece < a.d) {
          const size_t qrow = static_cast<size_t>(
              s.b * a.h + s.hk * a.group + rr % a.group) * a.n + rr / a.group;
          const elem* src = a.q + qrow * a.d + piece * kEP;
          if (a.kw == 16) {
            raw[k] = *reinterpret_cast<const uint4*>(src);
          } else {   // a row no multiple of 16 bytes: element by element
            elem* e = reinterpret_cast<elem*>(&raw[k]);
            for (int j = 0; j < kEP && kEP * piece + j < a.d; ++j)
              e[j] = src[j];
          }
        }
      }
      if (r0 == 0)
        append_rows<D, DV, PAGED, QUANT>(a, s, rank, pages, fresh, fresh_s);
#pragma unroll
      for (int k = 0; k < kQIters; ++k) {
        const int idx = tid + k * kThreads;
        if (idx >= kRowsPass * kQP) continue;
        const int i = idx / kQP, piece = idx % kQP;
        uint4 val;
        const elem* e = reinterpret_cast<const elem*>(&raw[k]);
        elem* o = reinterpret_cast<elem*>(&val);
#pragma unroll
        for (int j = 0; j < kEP; ++j) o[j] = fold(e[j], a.qscale);
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

    // [section] decode bf16 prologue done
    int st = 0;
    for (int step = first; step <= s_last;
         step = next_step(step, C, a.spc)) {
      cp_async_wait<kStages - 1>();
      __syncwarp();
      const int next_row =
          s_issue <= s_last ? lookup<PAGED>(a, s, pages, s_issue) : -1;
      unsigned char* stage = wstages + st * L.wstage;
      const uint32_t sk = smem_u32(stage);
      const uint32_t sv = sk + L.v;
      const int col0 = step_col(a, step) + kWarpCols * warp;
      const uint32_t hmask = held[st];
      if constexpr (QUANT)
        put_fresh_rows<D>(s, stage, L.krow, L.ks, col0, hmask, fresh,
                          fresh_s);

      // [section] decode bf16 stage landed
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

      // [section] decode bf16 S done
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

      // [section] decode bf16 softmax done
      // O = O * corr + P V (V's 16 rows as the k-group, two n-tiles a
      // load).
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[nt][c] *= corr[c >> 1];
      const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]),
                              pack_bf16(p[0][2], p[0][3]),
                              pack_bf16(p[1][0], p[1][1]),
                              pack_bf16(p[1][2], p[1][3])};
#pragma unroll
      for (int dn = 0; dn < NT; dn += 2) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, sv + ((mi & 1) * 8 + mr) * L.vrow +
                              (dn + (mi >> 1)) * 16);
        mma_bf16(o[dn], pa, vb[0], vb[1]);
        mma_bf16(o[dn + 1], pa, vb[2], vb[3]);
      }
      // [section] decode bf16 P.V done
      __syncwarp();
      if (s_issue <= s_last) {
        issue_warp<D, DV, PAGED, QUANT>(a, s, L, s_issue, stage, held + st,
                                        next_row);
        s_issue = next_step(s_issue, C, a.spc);
      }
      cp_async_commit();
      // [section] decode bf16 next step issued
      st = kStages == 1 ? 0 : st ^ 1;
    }
    cp_async_wait<0>();
    __syncwarp();

    // The warp's state of the pass's rows into its own stages: O, m and l
    // (this lane's sums over the quad, in a fixed order).
    float* w_o = reinterpret_cast<float*>(wstages);
    float* w_ml = w_o + kRowsPass * DV;
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
        w_o[i * DV + nt * 8 + 2 * t4] = o[nt][2 * hf];
        w_o[i * DV + nt * 8 + 2 * t4 + 1] = o[nt][2 * hf + 1];
      }
    }
    __syncthreads();

    combine_warps<DV>(smem, kStages * L.wstage, kRowsPass, r0, rows_here,
                      R, part, part_ml);
    __syncthreads();
    // [section] decode bf16 pass epilogue done
  }
  merge_ranks<DV>(a, s, L, smem, rank, R, s_first, s_last, bar);
  // [section] decode bf16 done
}

// The kernel the library launches.
template <int D, int DV, bool PAGED, bool QUANT>
void (*kernel_of())(Args) {
  return flash_decode_kernel<D, DV, PAGED, QUANT>;
}
#else
// One cp.async.bulk (the 1-D TMA) of `bytes` bytes, a multiple of 16, from
// global `src` to shared `dst`, both 16-byte aligned, completing its bytes
// on the mbarrier `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// Orders the calling thread's shared-memory accesses before the async
// proxy's (the bulk copies) that follow.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Issues the calling warp's 16 columns of one step into its stage, one row
// a lane (lanes 0-15 the K rows, int8 with their scales; lanes 16-31 the V
// rows; row_source says from where), and its `held` mask (as the bf16
// kernel's issue_warp). A float32 row whose bytes are a multiple of 16 is
// fetched by cp.async.bulk completing on the stage's mbarrier `bar`, where
// lane 0 arrives announcing the step's bulk bytes: one copy a row, or,
// where the instantiation's width is the true one (the stage's rows lie
// back to back), one copy a run of columns whose rows lie back to back in
// memory (a slab's columns, a page's), issued by the run's first lane. A
// float32 row of another width is 4-byte cp.async pieces, an int8 K row
// copy_row's into its padded row. A row not copied keeps its stage's old
// bytes, which are never read.
template <int D, int DV, bool PAGED, bool QUANT>
__device__ __forceinline__ void issue_bulk(const Args& a, const Slot& s,
                                           const Layout& L, int step,
                                           unsigned char* stage,
                                           uint64_t* bar, uint32_t* held,
                                           int my_row) {
  const int lane = threadIdx.x % 32;
  const int r = lane % kWarpCols;               // the column it copies
  const bool isv = lane >= kWarpCols;
  const int row = __shfl_sync(0xffffffffu, my_row, r);
  const unsigned char* src = row_source<QUANT>(a, s, step, row);
  const bool int8_row = QUANT && !isv;
  const int bytes = int8_row ? a.d : 4 * (isv ? a.dv : a.d);
  const bool bulk =
      src != nullptr && !int8_row && (isv ? a.vw : a.kw) == 16;
  const uint32_t bulk_k = __ballot_sync(0xffffffffu, bulk && !isv);
  const uint32_t bulk_v = __ballot_sync(0xffffffffu, bulk && isv);
  // Lanes whose row continues the previous lane's run.
  const unsigned long long at = reinterpret_cast<unsigned long long>(src);
  const unsigned long long before = __shfl_up_sync(0xffffffffu, at, 1);
  const uint32_t joins = __ballot_sync(
      0xffffffffu, bulk && r > 0 && before != 0 && before + bytes == at &&
                       bytes == 4 * (isv ? DV : D));
  if (lane == 0)
    mbar_expect_tx(bar, 4 * (__popc(bulk_k) * a.d + __popc(bulk_v) * a.dv));
  __syncwarp();   // the bytes announced before any of them lands
  unsigned char* dp = stage + (isv ? L.v + r * L.vstride : r * L.kstride);
  const uint32_t dst = smem_u32(dp);
  if (bulk) {
    if (!((joins >> lane) & 1)) {
      // This run: the lane's row and the joining lanes' right after it.
      const uint32_t rest = lane == 31 ? 0u : joins >> (lane + 1);
      bulk_copy(dst, src, __ffs(~rest) * bytes, bar);
    }
  } else if (src != nullptr && int8_row)
    copy_row<D>(dst, dp, src, a.d, a.k8w, true);
  else if (src != nullptr)
    for (int o = 0; o < bytes; o += 4) cp_async4(dst + o, src + o, true);
  if constexpr (QUANT) {
    if (!isv)
      cp_async4(smem_u32(stage) + L.ks + 4 * r,
                a.k_scale + (src != nullptr ? row : 0), src != nullptr);
  }
  const uint32_t bits = __ballot_sync(0xffffffffu, my_row >= 0);
  if (lane == 0) *held = bits;
}

// The step's 16 column partials of the calling warp's lanes (part[c]: the
// lane's share of column c's dot product) summed over the 32 lanes by one
// butterfly in a fixed order: at each of four halvings a lane keeps the
// half of its columns that its lane bit (16, 8, 4, 2) picks and adds its
// partner's partials of that half; a fifth exchange adds lanes 2c and
// 2c + 1. Returns column lane / 2's sum (lanes 2c and 2c + 1 get the same
// bits).
__device__ __forceinline__ float column_sums(float (&part)[kWarpCols]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int half = kWarpCols / 2; half > 0; half /= 2) {
    const bool upper = lane & (2 * half);
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float keep = upper ? part[i + half] : part[i];
      const float send = upper ? part[i] : part[i + half];
      const float got = __shfl_xor_sync(0xffffffffu, send, 2 * half);
      part[i] = keep + got;
    }
  }
  return part[0] + __shfl_xor_sync(0xffffffffu, part[0], 1);
}

// Grid, threads, the column partition, the passes and the merge as the
// bf16 kernel's; each warp runs its own pipeline over its 16 columns of
// the rank's steps, waiting on its stage's mbarrier (the bulk copies) and
// its cp.async groups (the other copies). The products are exact float32
// FFMA over the real query rows: a pass holds rows_of(DV) rows at most,
// and row r's S, softmax and P.V run in turn on the landed stage. S: lanes
// along d, column_sums leaves column c's score in lanes 2c and 2c + 1; the
// softmax there; P.V: lanes along dv, O in registers, p of column c from
// lane 2c, a column the row does not attend skipped. The int8 mirror
// scores a 16-row q tile with s8 mma.sync into the warp's score tile,
// read back by the rows in the same layout.
//
// D and DV are the instantiation's widths: q rows are zero-filled from d
// to D and the stages' row tails zeroed once a pass, so the extra columns
// add nothing to S and give O columns that are never written.
template <int D, int DV, bool PAGED, bool QUANT>
__global__ void __launch_bounds__(kThreads, blocks_of(D, DV, QUANT))
flash_decode_f32_kernel(const Args a) {
  static_assert(D % 32 == 0 && D <= 256 && DV % 32 == 0 && DV <= 256,
                "head dims must be 32*n <= 256");
  constexpr int KD = D / 32, KV = DV / 32;   // a lane's share of a row
  constexpr int kRows = rows_of(DV);
  constexpr int kStages = stages_of(D, DV, QUANT);
  static_assert(kStages * stage_bytes(D, DV, QUANT) >= 4 * kRows * (DV + 2),
                "a warp's state after a pass fits in its stages");
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int C = a.cluster;
  const int R = a.n * a.group;
  const Layout L = make_layout(R, a.n, D, DV, QUANT, a.pages);
  int* pages = reinterpret_cast<int*>(smem + L.pages);
  // The slot's vectors and (paged) this rank's page ids, read together.
  const int b_ = blockIdx.y / a.h_kv;
  const int vt_ = a.valid_to[b_];
  const int ap_ = a.append_at[b_];
  const int nn_ = a.n_new == nullptr ? a.n : a.n_new[b_];
  if constexpr (PAGED) load_page_ids(a, rank, b_, pages);
  const Slot s = make_slot(a, vt_, ap_, nn_);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  // The mbarrier the peers' partials complete on, and each warp's stage
  // mbarriers (one arrival each: the expectation of their bytes).
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars) +
                   warp * kStages;
  if (lane == 0) {
    if (warp == 0) mbar_init(bar, 1);
    for (int k = 0; k < kStages; ++k) mbar_init(bars + k, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (PAGED) __syncthreads();   // the page ids, the mbarriers
  __syncwarp();
  // Every block of the cluster has started, its mbarrier initialised,
  // once this phase completes (waited on before the first store into a
  // peer's shared memory).
  cluster_arrive();
  // [section] decode f32 start

  const int s_first = step_of(a, s.lo);
  const int s_last = s.hi >= s.lo ? step_of(a, s.hi) : s_first - 1;
  const int first = owned_from(s_first, rank, C, a.spc);
  unsigned char* wstages = smem + warp * kStages * L.wstage;
  uint32_t* held =
      reinterpret_cast<uint32_t*>(smem + L.held) + warp * kStages;
  float* q_s = reinterpret_cast<float*>(smem + L.qs);
  int8_t* fresh = reinterpret_cast<int8_t*>(smem + L.fresh);
  float* fresh_s = reinterpret_cast<float*>(smem + L.fresh_s);
  float* part = reinterpret_cast<float*>(smem + L.part);
  float* part_ml = reinterpret_cast<float*>(smem + L.part_ml);
  int4* rowc = reinterpret_cast<int4*>(smem + L.rowc);
  float* tile = reinterpret_cast<float*>(smem + L.sq) + warp * 256;
  uint32_t phase = 0;   // bit k: the parity stage k's mbarrier completes

  for (int r0 = 0; r0 < R; r0 += kRows) {
    const int rows_here = R - r0 < kRows ? R - r0 : kRows;
    // The stages' row tails (d to D, dv to DV), which no copy writes,
    // zeroed; then this warp's shared-memory writes ordered before the
    // copies into the same stages.
    if ((!QUANT && a.d < D) || a.dv < DV) {
      for (int i = lane; i < kStages * kWarpCols; i += 32) {
        unsigned char* row = wstages + i / kWarpCols * L.wstage;
        if constexpr (!QUANT) {
          float* k = reinterpret_cast<float*>(row + i % kWarpCols *
                                                          L.kstride);
          for (int e = a.d; e < D; ++e) k[e] = 0.f;
        }
        float* v = reinterpret_cast<float*>(row + L.v + i % kWarpCols *
                                                            L.vstride);
        for (int e = a.dv; e < DV; ++e) v[e] = 0.f;
      }
    }
    fence_proxy_async();
    __syncwarp();
    // The first kStages steps: their rows looked up, then issued.
    int steps[kStages], rows0[kStages];
    int s_issue = first;
#pragma unroll
    for (int k = 0; k < kStages; ++k) {
      steps[k] = s_issue;
      rows0[k] = -1;
      if (s_issue <= s_last) {
        rows0[k] = lookup<PAGED>(a, s, pages, s_issue);
        s_issue = next_step(s_issue, C, a.spc);
      }
    }
#pragma unroll
    for (int k = 0; k < kStages; ++k) {
      if (steps[k] <= s_last)
        issue_bulk<D, DV, PAGED, QUANT>(a, s, L, steps[k],
                                        wstages + k * L.wstage, bars + k,
                                        held + k, rows0[k]);
      cp_async_commit();
    }
    // This pass's query rows, new-row-major: float path pre-scaled (the
    // fold kept in float32; their loads in flight while the appends run),
    // int8 path quantized with their scales (a rank without a step reads
    // none). The in-place append of the rows whose columns lie in this
    // rank's chunks comes after this block issued its first loads: a
    // fresh column is never read from the cache.
    if constexpr (QUANT) {
      if (r0 == 0)
        for (int m = warp; m < s.nn; m += kWarps)
          quantize_row<D>(
              a.k_new + (static_cast<size_t>(s.bh) * a.n + m) * a.d, a.d,
              fresh + m * D, fresh_s + m, 1.f);
      if (first <= s_last)
        quantize_q<D>(a, s, smem + L.q, L.qrow, q_s, r0, rows_here);
      __syncthreads();
      if (r0 == 0)
        append_rows<D, DV, PAGED, QUANT>(a, s, rank, pages, fresh, fresh_s);
    } else {
      constexpr int kQIters = (kRows * D + kThreads - 1) / kThreads;
      float raw[kQIters];
#pragma unroll
      for (int k = 0; k < kQIters; ++k) {
        const int idx = tid + k * kThreads;
        const int i = idx / D, e = idx % D;
        const int rr = r0 + i;
        raw[k] = 0.f;
        if (first <= s_last && i < rows_here && e < a.d) {
          const size_t qrow = static_cast<size_t>(
              s.b * a.h + s.hk * a.group + rr % a.group) * a.n + rr / a.group;
          raw[k] = a.q[qrow * a.d + e];
        }
      }
      if (r0 == 0)
        append_rows<D, DV, PAGED, QUANT>(a, s, rank, pages, fresh, fresh_s);
#pragma unroll
      for (int k = 0; k < kQIters; ++k) {
        const int idx = tid + k * kThreads;
        if (idx / D < rows_here)
          reinterpret_cast<float*>(smem + L.q + idx / D * L.qrow)[idx % D] =
              fold(raw[k], a.qscale);
      }
    }
    // The pass's rows: span lo..hi, ALiBi's distance origin and slope
    // (log2 units).
    if (tid < rows_here) {
      const int rr = r0 + tid, j = rr / a.group;
      int lo, hi;
      row_span(s.vt + j, a.t_max, a.window, lo, hi);
      const float slope =
          a.alibi == nullptr
              ? 0.f
              : __fmul_rn(a.alibi[s.hk * a.group + rr % a.group], kLog2e);
      rowc[tid] = make_int4(lo, hi, s.vt + j, __float_as_int(slope));
    }
    __syncthreads();

    float o[kRows][KV];
    float m_run[kRows];
    float l_part[kRows];   // this lane's column's sum; the columns' at end
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      m_run[r] = kNegBig;
      l_part[r] = 0.f;
#pragma unroll
      for (int k = 0; k < KV; ++k) o[r][k] = 0.f;
    }

    // [section] decode f32 prologue done
    int st = 0;
    for (int step = first; step <= s_last;
         step = next_step(step, C, a.spc)) {
      cp_async_wait<kStages - 1>();
      mbar_wait(bars + st, (phase >> st) & 1u);
      phase ^= 1u << st;
      __syncwarp();
      const int next_row =
          s_issue <= s_last ? lookup<PAGED>(a, s, pages, s_issue) : -1;
      unsigned char* stage = wstages + st * L.wstage;
      const int col0 = step_col(a, step) + kWarpCols * warp;
      const uint32_t hmask = held[st];
      // [section] decode f32 stage landed
      if constexpr (QUANT) {
        put_fresh_rows<D>(s, stage, L.kstride, L.ks, col0, hmask, fresh,
                          fresh_s);
        // S of the q tile's 16 rows against the 16 columns: exact int32
        // sums of s8 products (m16n8k32), scaled in float32 as the TPU
        // kernel orders it, into the warp's score tile.
        const int g = lane / 4, t4 = lane % 4;
        const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, row
        const uint32_t sq = smem_u32(smem + L.q) +
                            ((mi & 1) * 8 + mr) * L.qrow + (mi >> 1) * 16;
        const uint32_t sk = smem_u32(stage);
        int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
#pragma unroll
        for (int kk = 0; kk < D / 32; ++kk) {
          uint32_t aq[4], bq[4];
          ldsm_x4(aq, sq + kk * 32);
          ldsm_x4(bq, sk + ((mi >> 1) * 8 + mr) * L.kstride + kk * 32 +
                          (mi & 1) * 16);
          mma_s8(acc[0], aq, bq[0], bq[1]);
          mma_s8(acc[1], aq, bq[2], bq[3]);
        }
        const float* ks = reinterpret_cast<const float*>(stage + L.ks);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int i = g + 8 * (c >> 1), cl = nt * 8 + 2 * t4 + (c & 1);
            tile[16 * i + cl] = __fmul_rn(
                __fmul_rn(static_cast<float>(acc[nt][c]), q_s[i]), ks[cl]);
          }
        __syncwarp();
      }
      const float* kst = reinterpret_cast<const float*>(stage);
      const float* vst = reinterpret_cast<const float*>(stage + L.v);
      const int c = lane >> 1, col = col0 + c;   // this lane's column
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r >= rows_here) break;
        // S of row r at column c.
        float sc;
        if constexpr (QUANT) {
          sc = tile[16 * r + c];
        } else {
          const float* qr =
              reinterpret_cast<const float*>(smem + L.q + r * L.qrow);
          float qv[KD];
#pragma unroll
          for (int k = 0; k < KD; ++k) qv[k] = qr[lane + 32 * k];
          float part_s[kWarpCols];
#pragma unroll
          for (int cc = 0; cc < kWarpCols; ++cc) {
            const float* kr = kst + cc * D;
            float acc = 0.f;
#pragma unroll
            for (int k = 0; k < KD; ++k)
              acc = fmaf(qv[k], kr[lane + 32 * k], acc);
            part_s[cc] = acc;
          }
          sc = column_sums(part_s);
        }
        // [section] decode f32 S done
        // ALiBi, the row's span and the held columns; the running max over
        // the 16 columns, the weight and this lane's sum.
        const int4 rc = rowc[r];
        if (a.alibi != nullptr)
          sc = __fadd_rn(sc, __fmul_rn(__int_as_float(rc.w),
                                       static_cast<float>(col - rc.z)));
        const bool ok = ((hmask >> c) & 1) && col >= rc.x && col <= rc.y;
        sc = ok ? sc : -INFINITY;
        float mx = sc;
#pragma unroll
        for (int x = 2; x < 32; x <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
        const float m_new = fmaxf(m_run[r], mx);
        const float corr = exp2f(m_run[r] - m_new);
        m_run[r] = m_new;
        const float p = exp2f(sc - m_new);
        l_part[r] = l_part[r] * corr + p;
        const uint32_t attended = __ballot_sync(0xffffffffu, ok);
        // [section] decode f32 softmax done
        // O = O * corr + P V over the columns the row attends (bit 2c of
        // `attended`), p of column cc from lane 2 cc.
#pragma unroll
        for (int k = 0; k < KV; ++k) o[r][k] *= corr;
#pragma unroll
        for (int cc = 0; cc < kWarpCols; ++cc) {
          if (!((attended >> (2 * cc)) & 1)) continue;
          const float pc = __shfl_sync(0xffffffffu, p, 2 * cc);
          const float* vr = vst + cc * DV;
#pragma unroll
          for (int k = 0; k < KV; ++k)
            o[r][k] = fmaf(pc, vr[lane + 32 * k], o[r][k]);
        }
        // [section] decode f32 P.V done
      }
      fence_proxy_async();
      __syncwarp();
      if (s_issue <= s_last) {
        issue_bulk<D, DV, PAGED, QUANT>(a, s, L, s_issue, stage, bars + st,
                                        held + st, next_row);
        s_issue = next_step(s_issue, C, a.spc);
      }
      cp_async_commit();
      // [section] decode f32 next step issued
      st = st + 1 == kStages ? 0 : st + 1;
    }
    cp_async_wait<0>();
    __syncwarp();

    // The warp's state of the pass's rows into its own stages: O, m and l
    // (the 16 columns' sums, in a fixed order).
    float* w_o = reinterpret_cast<float*>(wstages);
    float* w_ml = w_o + kRows * DV;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= rows_here) break;
      float l = l_part[r];
#pragma unroll
      for (int x = 2; x < 32; x <<= 1)
        l += __shfl_xor_sync(0xffffffffu, l, x);
      if (lane == 0) {
        w_ml[r] = m_run[r];
        w_ml[kRows + r] = l;
      }
#pragma unroll
      for (int k = 0; k < KV; ++k) w_o[r * DV + lane + 32 * k] = o[r][k];
    }
    __syncthreads();
    combine_warps<DV>(smem, kStages * L.wstage, kRows, r0, rows_here, R,
                      part, part_ml);
    __syncthreads();
    // [section] decode f32 pass epilogue done
  }
  merge_ranks<DV>(a, s, L, smem, rank, R, s_first, s_last, bar);
  // [section] decode f32 done
}

// The kernel the library launches.
template <int D, int DV, bool PAGED, bool QUANT>
void (*kernel_of())(Args) {
  return flash_decode_f32_kernel<D, DV, PAGED, QUANT>;
}
#endif

template <int D, int DV, bool PAGED, bool QUANT>
cudaError_t configure(int rows, int n, int cluster, int pages, int blocks,
                      cudaStream_t stream, cudaLaunchConfig_t& cfg,
                      cudaLaunchAttribute& attr) {
  const Layout L = make_layout(rows, n, D, DV, QUANT, pages);
  auto kernel = kernel_of<D, DV, PAGED, QUANT>();
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

template <int D, int DV, bool PAGED, bool QUANT>
int launch(const Args& a, int batch, cudaStream_t stream) {
  if (batch == 0) return 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<D, DV, PAGED, QUANT>(
      a.n * a.group, a.n, a.cluster, a.pages, batch * a.h_kv, stream, cfg,
      attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, kernel_of<D, DV, PAGED, QUANT>(), a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Clusters of the instantiation that can be resident on the card at once
// (cudaOccupancyMaxActiveClusters), -1 on an error.
template <int D, int DV, bool PAGED, bool QUANT>
int max_clusters(int rows, int n, int cluster) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int found = -1;
  if (configure<D, DV, PAGED, QUANT>(rows, n, cluster, 0, cluster, nullptr,
                                     cfg, attr) != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(
          &found, kernel_of<D, DV, PAGED, QUANT>(), &cfg) !=
          cudaSuccess)
    return -1;
  return found;
}

// The instantiation (D, DV) that runs true widths (d, dv): the first
// FLASH_GRID pair covering both (the pairs run in increasing D + DV);
// false past 256.
bool grid_dims(int d, int dv, int& D, int& DV) {
#define GRID_PICK(GD, GDV)                                                   \
  if (d <= GD && dv <= GDV) {                                                \
    D = GD;                                                                  \
    DV = GDV;                                                                \
    return d >= 1 && dv >= 1;                                                \
  }
  FLASH_GRID(GRID_PICK)
#undef GRID_PICK
  return false;
}

template <bool PAGED>
int dispatch(const Args& a, int batch, void* stream) {
  if (a.cluster < 1 || a.cluster > kMaxCluster ||
      (a.cluster & (a.cluster - 1)) || batch * a.h_kv > 65535 ||
      a.chunk < 1 || (PAGED && a.chunk != kChunk))
    return static_cast<int>(cudaErrorInvalidValue);
  int D = 0, DV = 0;
  if (!grid_dims(a.d, a.dv, D, DV))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool quant = a.k_q != nullptr;
#define DECODE_CASE(GD, GDV)                                                 \
  if (D == GD && DV == GDV)                                                  \
    return quant ? launch<GD, GDV, PAGED, true>(a, batch, s)                 \
                 : launch<GD, GDV, PAGED, false>(a, batch, s);
  FLASH_GRID(DECODE_CASE)
#undef DECODE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

Args make_args(const void* q, const void* k_new, const void* v_new,
               void* cache_k, void* cache_v, const void* valid_to,
               const void* append_at, const void* n_new,
               const void* page_table, void* k_q, void* k_scale,
               const void* alibi, void* out, void* num, void* m, void* l,
               int h, int h_kv, int n, int t_max, int d, int dv,
               int page_size, int window, int cluster, int chunk,
               float qscale) {
  Args a;
  a.q = static_cast<const elem*>(q);
  a.k_new = static_cast<const elem*>(k_new);
  a.v_new = static_cast<const elem*>(v_new);
  a.cache_k = static_cast<elem*>(cache_k);
  a.cache_v = static_cast<elem*>(cache_v);
  a.valid_to = static_cast<const int*>(valid_to);
  a.append_at = static_cast<const int*>(append_at);
  a.n_new = static_cast<const int*>(n_new);
  a.page_table = static_cast<const int*>(page_table);
  a.k_q = static_cast<int8_t*>(k_q);
  a.k_scale = static_cast<float*>(k_scale);
  a.alibi = static_cast<const float*>(alibi);
  a.out = static_cast<elem*>(out);
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
  a.d = d;
  a.dv = dv;
  a.kw = copy_width(kEB * d);
  a.vw = copy_width(kEB * dv);
  a.k8w = copy_width(d);
  a.chunk = chunk;
  a.spc = (chunk + kStep - 1) / kStep;
  a.cluster_shift = 0;
  while ((1 << (a.cluster_shift + 1)) <= cluster) ++a.cluster_shift;
  a.page_shift = -1;
  for (int sh = 0; sh < 31 && page_size > 0; ++sh)
    if ((1 << sh) == page_size) a.page_shift = sh;
  a.ppc = page_table == nullptr ? 0 : pages_per_chunk(page_size);
  a.pages = page_table == nullptr ? 0
                                  : page_entries(t_max, page_size, cluster);
  a.qscale = qscale;
  return a;
}

}  // namespace

extern "C" int flash_decode_chunk() { return kChunk; }

// Clusters of `cluster` blocks of the kernel for (rows = n * group, n, the
// true widths d and dv, paged, int8 mirror) resident on the card at once;
// -1 on an error.
extern "C" int flash_decode_max_clusters(int rows, int n, int d, int dv,
                                         int paged, int quant, int cluster) {
  int D = 0, DV = 0;
  if (!grid_dims(d, dv, D, DV)) return -1;
#define DECODE_OCC(GD, GDV, P, Q)                                            \
  if (D == GD && DV == GDV && (paged != 0) == P && (quant != 0) == Q)        \
    return max_clusters<GD, GDV, P, Q>(rows, n, cluster);
#define DECODE_OCC_D(GD, GDV)                                                \
  DECODE_OCC(GD, GDV, false, false) DECODE_OCC(GD, GDV, false, true)         \
  DECODE_OCC(GD, GDV, true, false) DECODE_OCC(GD, GDV, true, true)
  FLASH_GRID(DECODE_OCC_D)
#undef DECODE_OCC_D
#undef DECODE_OCC
  return -1;
}

// Dynamic shared memory of one block with `rows` = n * group query rows
// of true widths d and dv (quant: the int8 mirror) and, paged (page_size >
// 0), the page ids of a rank of `cluster`; -1 for widths past 256. The
// host refuses a launch past the card's limit.
extern "C" int flash_decode_smem(int rows, int n, int d, int dv, int quant,
                                 int t_max, int page_size, int cluster) {
  int D = 0, DV = 0;
  if (!grid_dims(d, dv, D, DV)) return -1;
  return make_layout(rows, n, D, DV, quant != 0,
                     page_entries(t_max, page_size, cluster)).bytes;
}

// The steps a warp of the kernel for true widths d and dv (quant: the
// int8 mirror) keeps in flight; -1 for widths past 256.
extern "C" int flash_decode_stages(int d, int dv, int quant) {
  int D = 0, DV = 0;
  if (!grid_dims(d, dv, D, DV)) return -1;
  return stages_of(D, DV, quant != 0);
}

// The slab step (K5; flash_decode_bf16, or flash_decode_f32 with float32
// q, k_new, v_new, caches and output). Operands as `Args` above: q (batch,
// h, n, d); k_new (batch, h_kv, n, d), v_new (batch, h_kv, n, dv); cache_k
// (batch, h_kv, t_max, d), cache_v (batch, h_kv, t_max, dv), appended in
// place; valid_to/append_at/n_new (batch,) int32; k_q / k_scale the int8
// mirror, null for floating-point scoring; alibi null or (h,) f32 slopes;
// out, or num/m/l for the partial outputs. d, dv in 1..256. window <= 0:
// no window.
// cluster: the blocks per (slot, kv head), a power of two up to 8. chunk:
// the columns a cluster rank owns at a time (the K split; 0: kChunk).
// Returns a cudaError_t code (0 = launched).
extern "C" int DECODE_SYMBOL(flash_decode)(
    const void* q, const void* k_new, const void* v_new, void* cache_k,
    void* cache_v, const void* valid_to, const void* append_at,
    const void* n_new, void* k_q, void* k_scale, const void* alibi,
    void* out, void* num, void* m, void* l, int batch, int h, int h_kv,
    int n, int t_max, int d, int dv, int window, int cluster, int chunk,
    float qscale, void* stream) {
  const Args a = make_args(q, k_new, v_new, cache_k, cache_v, valid_to,
                           append_at, n_new, nullptr, k_q, k_scale, alibi,
                           out, num, m, l, h, h_kv, n, t_max, d, dv, 1,
                           window, cluster, chunk > 0 ? chunk : kChunk,
                           qscale);
  return dispatch<false>(a, batch, stream);
}

// The paged step (K5p): k_pool (pages + 1, h_kv, page_size, d), v_pool
// (pages + 1, h_kv, page_size, dv) and the mirror pools, appended in place
// through page_table (batch, pages_per_slot) int32 (-1 = unallocated); any
// page_size >= 1, the split kChunk. Other arguments as above.
extern "C" int DECODE_SYMBOL(flash_decode_paged)(
    const void* q, const void* k_new, const void* v_new, void* k_pool,
    void* v_pool, const void* valid_to, const void* append_at,
    const void* n_new, const void* page_table, void* k_q, void* k_scale,
    const void* alibi, void* out, void* num, void* m, void* l, int batch,
    int h, int h_kv, int n, int pages_per_slot, int page_size, int d, int dv,
    int window, int cluster, float qscale, void* stream) {
  if (page_size < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, k_new, v_new, k_pool, v_pool, valid_to,
                           append_at, n_new, page_table, k_q, k_scale, alibi,
                           out, num, m, l, h, h_kv, n,
                           pages_per_slot * page_size, d, dv, page_size,
                           window, cluster, kChunk, qscale);
  return dispatch<true>(a, batch, stream);
}
