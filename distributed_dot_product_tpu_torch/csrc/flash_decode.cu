// Fused KV-cache decode step for Hopper (sm_90a): in-place append plus
// split-K flash-decoding attention, bf16 cache, f32 accumulation.
//
// Replaces the TPU kernel `_make_decode_kernel` in
// distributed_dot_product_tpu/ops/pallas_decode.py — the slab body
// `kernel_body` (K5, flash_decode_bf16) and the paged body `kernel_paged`
// (K5p, flash_decode_paged_bf16) — with verify-k (n new rows per slot,
// each slot appending its own count of them), the sliding window, the
// partial outputs, the int8 K mirror and ALiBi.
//
// What bounds it on the H100: one query row per head against the cached
// prefix is ~1 FLOP per byte of K/V streamed, far below the card's ~295
// FLOP/byte ridge, so the floor is the HBM read of the filled K and V rows
// (~12 MB per layer at batch 4, 8 heads, ~1000 filled rows: ~3.8 us). The
// batch alone gives only B*H_kv = 32 rows of work for 132 SMs, so the
// columns are split across blocks (flash-decoding): block (split, b*h_kv)
// scores 128 cache columns for every query row of its group, writes an
// un-normalised partial (m, l, acc), and a second small kernel merges the
// partials per query row. Blocks wholly past a row's fill return at once
// and are skipped by the merge, so a short row streams only its prefix.
// Within a block four lanes share one cache row (16-byte loads, adjacent
// rows on adjacent lanes), so each warp reads contiguous memory.
//
// Verify-k: a block holds n * group query rows, new-row-major (row
// j*group + g is query head g of new row j), and new row j attends
// columns lo_j..hi_j with hi_j = valid_to + j clamped to the slab. Each
// row is reduced over its OWN span with the lane-to-column mapping, the
// reduction order and the merge order of a one-row launch at valid_to +
// j, so row j of a verify launch gives the bits of the j-th of n
// sequential one-row launches: the serving contract that speculative
// streams equal the plain ones rests on this. The scores of the block's
// columns do not depend on which rows read them, so they are computed
// once for the union of the rows' spans.
//
// The append is in place: row m < n_new of a slot lands at column
// append_at + m, written by the block whose chunk holds that column (the
// rows may straddle a split or a page), and every read of such a column
// in this launch takes the row from k_new/v_new instead, so no read
// depends on the order of the writes across blocks and every other cache
// row keeps its bits. Numerics follow the TPU kernel: scale*log2(e)
// folded into q (rounded back to bf16), exp2 softmax, running max from
// NEG_BIG, and a row with no valid column (valid_to < 0) outputs exactly
// 0.
//
// The int8 K mirror (qk_quant='int8'): the scores are the exact int32
// sums of int8 products (__dp4a) of the per-row quantized q and the
// mirror rows k_q, scaled in float32 as the TPU kernel orders it,
// (s * q_scale) * k_scale, q_scale holding scale*log2(e); the bf16 K is
// then only written (the append), never read. The new rows' scores come
// from their quantized copies, and the mirror rows (int8 and their
// float32 scales) are appended in place beside the bf16 rows.
//
// ALiBi: query head g's score at column col of new row j gains
// slope_g * (col - (valid_to + j)), after the appended rows' scores have
// replaced the buffer's (the TPU kernel's order), slopes pre-folded by
// log2(e) by the wrapper; the multiply and the add round separately
// (__fmul_rn, __fadd_rn), as the plain version's two tensor operations
// do, so the int8 scores stay bit-equal to it. With partial outputs the
// same distance holds on every rank's slab, whose valid_to is already
// localised there.
//
// A row attends columns lo..hi: hi is valid_to clamped to the slab (a
// shard of a sequence-sharded slab sees valid_to >= t_max when the slab
// lies wholly in the query's past, and valid_to < 0 when it lies wholly
// in its future), lo is 0, or with a window W the first column with
// col - valid_to > -W. Splits outside lo..hi return after the append
// and the merge skips them, so a windowed row streams only its window.
// With partial outputs the merge writes the folded un-normalised
// numerator and the base-2 running max and denominator of every query
// row in float32 instead of dividing (the flash-decoding cross-shard
// merge rescales and sums them); a row with no column gives numerator
// 0, max NEG_BIG and denominator 0.
//
// Paged (K5p): the cache is a pool of (pages + 1, h_kv, page_size, d)
// pages, and column c of slot b lives at row c % page_size of pool page
// table[b][c / page_size]. A split block's 128 columns cover 128 /
// page_size whole pages; the block reads their ids from the table once,
// into shared memory, and then streams rows in K5's column order with
// K5's arithmetic, so a paged step is bit-identical to K5 on a slab that
// holds the same rows. Only the row addresses differ, and each page's
// rows are contiguous, so a warp still reads contiguous memory. A -1
// entry is never read: its columns score -inf and an append that lands
// on it writes nothing. The mirror pools share the table. The appends
// are the only writes (nothing goes to the pool's sink page); the host
// allocator copies a shared page before a step could append into it, so
// no page written here is read by another slot in the same launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

namespace {

constexpr int kChunk = 128;             // cache columns per split block
constexpr int kThreads = 128;
constexpr int kLanesPerRow = 4;
constexpr int kRowsPerPass = kThreads / kLanesPerRow;   // 32
constexpr float kNegBig = -0.7f * 3.4e38f;

// The columns lo..hi a row attends (hi < lo: none), as described above.
__device__ __forceinline__ void row_span(int vt, int t_max, int window,
                                         int& lo, int& hi) {
  hi = vt < t_max - 1 ? vt : t_max - 1;
  lo = window > 0 && vt - window + 1 > 0 ? vt - window + 1 : 0;
}

// The columns cs..cs+ncols-1 of the chunk starting at c0 that a row at
// valid_to vt attends (ncols = 0: none).
__device__ __forceinline__ void chunk_cols(int vt, int c0, int t_max,
                                           int window, int& cs, int& ncols) {
  int lo, hi;
  row_span(vt, t_max, window, lo, hi);
  cs = c0 > lo ? c0 : lo;
  const int ce = c0 + kChunk - 1 < hi ? c0 + kChunk : hi + 1;
  ncols = ce > cs ? ce - cs : 0;
}

template <int PER>
__device__ __forceinline__ void load_row(const bf16* src, float* dst) {
#pragma unroll
  for (int c = 0; c < PER / 8; ++c) {
    uint4 raw = *reinterpret_cast<const uint4*>(src + c * 8);
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[c * 8 + i] = __bfloat162float(e[i]);
  }
}

// PER int8 values as PER / 4 packed words (8-byte loads).
template <int PER>
__device__ __forceinline__ void load_row_i8(const int8_t* src, int* dst) {
#pragma unroll
  for (int c = 0; c < PER / 8; ++c) {
    int2 raw = *reinterpret_cast<const int2*>(src + c * 8);
    dst[2 * c] = raw.x;
    dst[2 * c + 1] = raw.y;
  }
}

// Where a slot's cache column lives, for rows of W elements of T. Slab:
// row `col` of the (slot, head) strip. Paged: row col % page_size of the
// page the block staged for the column (nullptr for a -1 table entry).
template <typename T, int W, bool PAGED>
struct Rows {
  T* base;             // slab: the (slot, head) strip; paged: the pool
  const int* pages;    // paged: this chunk's page ids (shared memory)
  int c0, hk, h_kv, page_size;

  __device__ __forceinline__ T* at(int col) const {
    if (!PAGED) return base + static_cast<size_t>(col) * W;
    const int page = pages[(col - c0) / page_size];
    if (page < 0) return nullptr;
    return base + ((static_cast<size_t>(page) * h_kv + hk) * page_size +
                   col % page_size) * W;
  }
};

// Every operand of one launch. Shapes (all contiguous): q (batch, h, n,
// D); k_new/v_new (batch, h_kv, n, D); slab caches (batch, h_kv, t_max,
// D), or pools (pages + 1, h_kv, page_size, D) read through page_table
// (batch, t_max / page_size); valid_to/append_at/n_new (batch,; n_new
// null: n rows wherever append_at >= 0). The
// int8 mirror (k_q != nullptr): q_i8 (batch, h, n, D) with q_scale
// (batch, h, n) = row scale * scale * log2(e), kn_i8 (batch, h_kv, n, D)
// with kn_scale (batch, h_kv, n), and the mirror k_q / k_scale laid out
// as the bf16 cache with D and 1 elements per row. alibi: null, or (h,)
// slopes * log2(e) per query head. Scratch part_acc
// (batch*h*n, n_splits, D) and part_ml (batch*h*n, n_splits, 2).
// Outputs: out (batch, h, n, D) bf16, or with num != nullptr the
// partials num (batch, h, n, D), m and l (batch, h, n), all f32.
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
  const int8_t* q_i8;
  const float* q_scale;
  const int8_t* kn_i8;
  const float* kn_scale;
  int8_t* k_q;
  float* k_scale;
  const float* alibi;
  float* part_acc;
  float* part_ml;
  bf16* out;
  float* num;
  float* m_out;
  float* l_out;
  int h, h_kv, group, n, t_max, page_size, n_splits, window;
  float qscale;
};

// Rows slot b appends: n_new[b] clipped to [0, n] (every n when n_new is
// null), none when append_at is negative.
__device__ __forceinline__ int slot_rows(const Args& a, int b, int ap) {
  if (ap < 0) return 0;
  if (a.n_new == nullptr) return a.n;
  const int c = a.n_new[b];
  return c < 0 ? 0 : (c > a.n ? a.n : c);
}

// Grid (n_splits, batch * h_kv). Shared: sQ[rows*D] (int8 mirror: the
// quantized rows packed 4 to a word), sS[rows*kChunk], sRed[4*D],
// sM[rows], sL[rows], sQs[rows] (floats; rows = n * group); paged,
// sPage[kChunk] (ints).
template <int D, bool PAGED, bool QUANT>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const Args a) {
  static_assert(D % 32 == 0 && D <= 256, "head dim must be 32*n <= 256");
  constexpr int PER = D / kLanesPerRow;   // features per lane
  const int n = a.n;
  const int group = a.group;
  const int rows = n * group;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sS = sQ + rows * D;
  float* sRed = sS + rows * kChunk;
  float* sM = sRed + 4 * D;
  float* sL = sM + rows;
  float* sQs = sL + rows;
  __shared__ int sPage[PAGED ? kChunk : 1];

  const int split = blockIdx.x;
  const int bh = blockIdx.y;               // flat (batch, kv head)
  const int b = bh / a.h_kv;
  const int hk = bh % a.h_kv;
  const int vt = a.valid_to[b];
  const int ap = a.append_at[b];
  const int nn = slot_rows(a, b, ap);      // rows this slot appends
  const int t_max = a.t_max;
  const int window = a.window;
  const int c0 = split * kChunk;
  const int tid = threadIdx.x;

  const bf16* kn = a.k_new + static_cast<size_t>(bh) * n * D;
  const bf16* vn = a.v_new + static_cast<size_t>(bh) * n * D;
  const int8_t* kni = QUANT ? a.kn_i8 + static_cast<size_t>(bh) * n * D
                            : nullptr;
  const float* kns = QUANT ? a.kn_scale + static_cast<size_t>(bh) * n
                           : nullptr;
  if (PAGED) {
    // This chunk's page ids, read once from the slot's table row.
    const int pps = t_max / a.page_size;
    const int first = c0 / a.page_size;
    for (int i = tid; i < kChunk / a.page_size; i += kThreads)
      sPage[i] = first + i < pps
                     ? a.page_table[static_cast<size_t>(b) * pps + first + i]
                     : -1;
    __syncthreads();
  }
  // Slab: the (slot, head) strip; paged: the pool and this chunk's pages.
  const size_t strip = PAGED ? 0 : static_cast<size_t>(bh) * t_max;
  const Rows<bf16, D, PAGED> krows{a.cache_k + strip * D, sPage, c0, hk,
                                   a.h_kv, a.page_size};
  const Rows<bf16, D, PAGED> vrows{a.cache_v + strip * D, sPage, c0, hk,
                                   a.h_kv, a.page_size};
  const Rows<int8_t, D, PAGED> kqrows{a.k_q + strip * D, sPage, c0, hk,
                                      a.h_kv, a.page_size};
  const Rows<float, 1, PAGED> ksrows{a.k_scale + strip, sPage, c0, hk,
                                     a.h_kv, a.page_size};

  // In-place append of the rows whose columns lie in this chunk.
  for (int m = 0; m < nn; ++m) {
    const int col = ap + m;
    if (col < c0 || col >= c0 + kChunk || col >= t_max) continue;
    bf16* kdst = krows.at(col);
    if (PAGED && kdst == nullptr) continue;
    bf16* vdst = vrows.at(col);
    for (int i = tid; i < D; i += kThreads) {
      kdst[i] = kn[m * D + i];
      vdst[i] = vn[m * D + i];
    }
    if constexpr (QUANT) {
      int8_t* qdst = kqrows.at(col);
      for (int i = tid; i < D; i += kThreads) qdst[i] = kni[m * D + i];
      if (tid == 0) *ksrows.at(col) = kns[m];
    }
  }
  // The union of the rows' spans in this chunk: row 0 has the earliest
  // window start, row n-1 the latest end. A chunk wholly past every
  // row's fill or before every row's window returns, and the merge skips
  // it.
  int lo, hi, lo_last, hi_last;
  row_span(vt, t_max, window, lo, hi);
  row_span(vt + n - 1, t_max, window, lo_last, hi_last);
  (void)hi;
  (void)lo_last;
  const int cs_u = c0 > lo ? c0 : lo;
  const int ce_u = c0 + kChunk - 1 < hi_last ? c0 + kChunk : hi_last + 1;
  if (ce_u <= cs_u) return;
  const int ncols_u = ce_u - cs_u;

  // Query rows of this kv head's group, new-row-major; float path:
  // pre-scaled and rounded to bf16; int8 path: the quantized rows and
  // their scales.
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D, e = i % D;
    const size_t src =
        (static_cast<size_t>(bh * group + r % group) * n + r / group) * D + e;
    if constexpr (QUANT) {
      reinterpret_cast<int8_t*>(sQ)[i] = a.q_i8[src];
    } else {
      sQ[i] = __bfloat162float(
          __float2bfloat16(__bfloat162float(a.q[src]) * a.qscale));
    }
  }
  if constexpr (QUANT) {
    for (int r = tid; r < rows; r += kThreads)
      sQs[r] = a.q_scale[static_cast<size_t>(bh * group + r % group) * n +
                         r / group];
  }
  __syncthreads();

  const int lane = tid % 32;
  const int warp = tid / 32;
  const int sub = tid % kLanesPerRow;      // which quarter of the features
  const int rg = tid / kLanesPerRow;       // row slot within a pass

  // Scores (log2 units) of every column of the union for every query
  // row, at sS[r * kChunk + (col - c0)]; a column on a -1 page scores
  // -inf.
  for (int base = 0; base < ncols_u; base += kRowsPerPass) {
    const int c = base + rg;
    const int col = cs_u + c;
    const int m = col - ap;
    const bool fresh = ap >= 0 && m >= 0 && m < nn;
    bool scored = false;                   // slab: every column < ncols
    float kf[PER];
    int kw[PER / 4];
    float kscale = 0.f;
    if (c < ncols_u) {
      if constexpr (QUANT) {
        const int8_t* krow = kqrows.at(col);
        scored = !PAGED || krow != nullptr;
        if (scored) {
          if (fresh) {
            krow = kni + m * D;
            kscale = kns[m];
          } else {
            kscale = *ksrows.at(col);
          }
          load_row_i8<PER>(krow + sub * PER, kw);
        }
      } else {
        const bf16* krow = krows.at(col);
        scored = !PAGED || krow != nullptr;
        if (fresh && scored) krow = kn + m * D;
        if (scored) load_row<PER>(krow + sub * PER, kf);
      }
    }
    if (!scored) {
#pragma unroll
      for (int i = 0; i < PER / 4; ++i) kw[i] = 0;
#pragma unroll
      for (int i = 0; i < PER; ++i) kf[i] = 0.f;
    }
    for (int r = 0; r < rows; ++r) {
      float s;
      if constexpr (QUANT) {
        const int* qw = reinterpret_cast<const int*>(sQ) + r * (D / 4) +
                        sub * (PER / 4);
        int dot = 0;
#pragma unroll
        for (int i = 0; i < PER / 4; ++i) dot = __dp4a(kw[i], qw[i], dot);
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        s = __fmul_rn(__fmul_rn(static_cast<float>(dot), sQs[r]), kscale);
      } else {
        const float* qg = sQ + r * D + sub * PER;
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < PER; ++i) dot = fmaf(kf[i], qg[i], dot);
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        s = dot;
      }
      if (a.alibi != nullptr)
        s = __fadd_rn(s, __fmul_rn(a.alibi[hk * group + r % group],
                                   static_cast<float>(col - vt - r / group)));
      if (c < ncols_u && sub == 0)
        sS[r * kChunk + (col - c0)] = scored ? s : -INFINITY;
    }
  }
  __syncthreads();

  // Per query row, over its own columns cs..cs+ncols-1 of this chunk
  // (ncols = 0: none), counted from cs as a one-row launch counts them:
  // chunk max, weights exp2(s - m) in place, their sum. Every warp runs
  // the same loops and shuffles whatever its row's span.
  for (int r = warp; r < rows; r += kThreads / 32) {
    int cs, ncols;
    chunk_cols(vt + r / group, c0, t_max, window, cs, ncols);
    float* srow = sS + r * kChunk + (cs - c0);
    float mx = kNegBig;
    for (int c = lane; c < ncols; c += 32) mx = fmaxf(mx, srow[c]);
    __syncwarp();
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int c = lane; c < ncols; c += 32) {
      const float p = exp2f(srow[c] - mx);
      srow[c] = p;
      sum += p;
    }
    __syncwarp();
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      sM[r] = mx;
      sL[r] = sum;
    }
  }
  __syncthreads();

  // acc[r] = sum_c p[r, c] * v[c] over the row's own columns; reduce the
  // 8 row slots of a warp by shuffles (same `sub`, lanes 4 apart), then
  // the 4 warps in shared. A row with no column here writes nothing.
  for (int r = 0; r < rows; ++r) {
    const int j = r / group;
    int cs, ncols;
    chunk_cols(vt + j, c0, t_max, window, cs, ncols);
    const float* prow = sS + r * kChunk + (cs - c0);
    float acc[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[i] = 0.f;
    for (int base = 0; base < ncols; base += kRowsPerPass) {
      const int c = base + rg;
      if (c < ncols) {
        const int col = cs + c;
        const bf16* vrow = vrows.at(col);
        const bool held = !PAGED || vrow != nullptr;
        const int m = col - ap;
        if (ap >= 0 && m >= 0 && m < nn && held) vrow = vn + m * D;
        if (held) {
          float vf[PER];
          load_row<PER>(vrow + sub * PER, vf);
          const float p = prow[c];
#pragma unroll
          for (int i = 0; i < PER; ++i) acc[i] = fmaf(p, vf[i], acc[i]);
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 4);
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 8);
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 16);
    }
    if (lane < kLanesPerRow) {
#pragma unroll
      for (int i = 0; i < PER; ++i) sRed[warp * D + lane * PER + i] = acc[i];
    }
    __syncthreads();
    if (ncols > 0) {
      // Flat (batch, query head, new row) of this query row.
      const size_t qrow = static_cast<size_t>(bh * group + r % group) * n + j;
      const size_t slot = qrow * a.n_splits + split;
      for (int i = tid; i < D; i += kThreads)
        a.part_acc[slot * D + i] =
            sRed[i] + sRed[D + i] + sRed[2 * D + i] + sRed[3 * D + i];
      if (tid == 0) {
        a.part_ml[slot * 2] = sM[r];
        a.part_ml[slot * 2 + 1] = sL[r];
      }
    }
    __syncthreads();   // sRed is reused by the next query row
  }
}

// Grid (batch * h * n): one block per query row merges its active splits
// (those holding a column of its lo..hi) into the bf16 output, or with
// partial outputs (num != nullptr) into the float32 numerator, max and
// denominator.
template <int D>
__global__ void __launch_bounds__(kThreads)
decode_merge_kernel(const Args a) {
  const int row = blockIdx.x;              // flat (batch, query head, j)
  const int n_splits = a.n_splits;
  int lo, hi;
  row_span(a.valid_to[row / (a.h * a.n)] + row % a.n, a.t_max, a.window,
           lo, hi);
  const int first = lo / kChunk;
  const int last = hi >= lo ? hi / kChunk : first - 1;
  const float* ml = a.part_ml + static_cast<size_t>(row) * n_splits * 2;
  const float* pa = a.part_acc + static_cast<size_t>(row) * n_splits * D;
  float m = kNegBig;
  for (int s = first; s <= last; ++s) m = fmaxf(m, ml[2 * s]);
  float l = 0.f;
  for (int s = first; s <= last; ++s)
    l += exp2f(ml[2 * s] - m) * ml[2 * s + 1];
  for (int i = threadIdx.x; i < D; i += kThreads) {
    float acc = 0.f;
    for (int s = first; s <= last; ++s)
      acc += exp2f(ml[2 * s] - m) * pa[static_cast<size_t>(s) * D + i];
    if (a.num != nullptr)
      a.num[static_cast<size_t>(row) * D + i] = acc;
    else
      a.out[static_cast<size_t>(row) * D + i] =
          __float2bfloat16(l == 0.f ? 0.f : acc / l);
  }
  if (a.num != nullptr && threadIdx.x == 0) {
    a.m_out[row] = m;
    a.l_out[row] = l;
  }
}

size_t split_smem(int rows, int d) {
  return sizeof(float) *
         (static_cast<size_t>(rows) * (d + kChunk) + 4 * d + 3 * rows);
}

template <int D, bool PAGED, bool QUANT>
int launch(const Args& a, int batch, cudaStream_t stream) {
  if (batch == 0 || a.n_splits == 0) return 0;
  const size_t smem = split_smem(a.n * a.group, D);
  auto kernel = decode_split_kernel<D, PAGED, QUANT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(a.n_splits, batch * a.h_kv);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_merge_kernel<D><<<batch * a.h * a.n, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool PAGED>
int dispatch(const Args& a, int batch, int d, void* stream) {
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
               const void* page_table, const void* q_i8,
               const void* q_scale, const void* kn_i8,
               const void* kn_scale, void* k_q, void* k_scale,
               const void* alibi, void* part_acc, void* part_ml, void* out,
               void* num, void* m, void* l, int h, int h_kv, int n,
               int t_max, int page_size, int window, float qscale) {
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
  a.q_i8 = static_cast<const int8_t*>(q_i8);
  a.q_scale = static_cast<const float*>(q_scale);
  a.kn_i8 = static_cast<const int8_t*>(kn_i8);
  a.kn_scale = static_cast<const float*>(kn_scale);
  a.k_q = static_cast<int8_t*>(k_q);
  a.k_scale = static_cast<float*>(k_scale);
  a.alibi = static_cast<const float*>(alibi);
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float*>(part_ml);
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
  a.n_splits = (t_max + kChunk - 1) / kChunk;
  a.window = window;
  a.qscale = qscale;
  return a;
}

}  // namespace

extern "C" int flash_decode_chunk() { return kChunk; }

// Dynamic shared memory of one split block with `rows` = n * group query
// rows of head dim d (the host refuses a launch past the card's limit).
extern "C" int flash_decode_smem(int rows, int d) {
  return static_cast<int>(split_smem(rows, d) +
                          kChunk * sizeof(int));   // + paged sPage
}

// The slab step (K5). Operands as `Args` above: q (batch, h, n, d);
// k_new/v_new (batch, h_kv, n, d); cache_k/cache_v (batch, h_kv, t_max,
// d), appended in place; valid_to/append_at/n_new (batch,) int32; the
// int8 mirror pointers null for float scoring; alibi null or (h,) f32
// slopes * log2(e); part_acc/part_ml f32 scratch; out, or num/m/l for the
// partial outputs. window <= 0: no window. Returns a cudaError_t code (0 =
// launched).
extern "C" int flash_decode_bf16(
    const void* q, const void* k_new, const void* v_new, void* cache_k,
    void* cache_v, const void* valid_to, const void* append_at,
    const void* n_new, const void* q_i8, const void* q_scale,
    const void* kn_i8, const void* kn_scale, void* k_q, void* k_scale,
    const void* alibi, void* part_acc, void* part_ml, void* out, void* num,
    void* m, void* l, int batch, int h, int h_kv, int n, int t_max, int d,
    int window, float qscale, void* stream) {
  const Args a = make_args(q, k_new, v_new, cache_k, cache_v, valid_to,
                           append_at, n_new, nullptr, q_i8, q_scale, kn_i8,
                           kn_scale, k_q, k_scale, alibi, part_acc, part_ml,
                           out, num, m, l, h, h_kv, n, t_max, 1, window,
                           qscale);
  return dispatch<false>(a, batch, d, stream);
}

// The paged step (K5p): k_pool/v_pool (pages + 1, h_kv, page_size, d)
// and the mirror pools, appended in place through page_table (batch,
// pages_per_slot) int32 (-1 = unallocated); page_size must divide 128.
// Other arguments as above.
extern "C" int flash_decode_paged_bf16(
    const void* q, const void* k_new, const void* v_new, void* k_pool,
    void* v_pool, const void* valid_to, const void* append_at,
    const void* n_new, const void* page_table, const void* q_i8,
    const void* q_scale, const void* kn_i8, const void* kn_scale,
    void* k_q, void* k_scale, const void* alibi, void* part_acc,
    void* part_ml, void* out, void* num, void* m, void* l, int batch, int h,
    int h_kv, int n, int pages_per_slot, int page_size, int d, int window,
    float qscale, void* stream) {
  if (page_size < 1 || kChunk % page_size)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, k_new, v_new, k_pool, v_pool, valid_to,
                           append_at, n_new, page_table, q_i8, q_scale,
                           kn_i8, kn_scale, k_q, k_scale, alibi, part_acc,
                           part_ml, out, num, m, l, h, h_kv, n,
                           pages_per_slot * page_size, page_size, window,
                           qscale);
  return dispatch<true>(a, batch, d, stream);
}
