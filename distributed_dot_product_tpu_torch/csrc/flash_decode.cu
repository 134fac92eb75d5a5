// Fused KV-cache decode step for Hopper (sm_90a): in-place append plus
// split-K flash-decoding attention, bf16 cache, f32 accumulation.
//
// Replaces the TPU kernel `_make_decode_kernel` in
// distributed_dot_product_tpu/ops/pallas_decode.py — the slab body
// `kernel_body` (K5, flash_decode_bf16) and the paged body `kernel_paged`
// (K5p, flash_decode_paged_bf16) — for one new row per slot (n = 1)
// without the int8 mirror, window, ALiBi or partial outputs.
//
// What bounds it on the H100: one query row per head against the cached
// prefix is ~1 FLOP per byte of K/V streamed, far below the card's ~295
// FLOP/byte ridge, so the floor is the HBM read of the filled K and V rows
// (~12 MB per layer at batch 4, 8 heads, ~1000 filled rows: ~3.8 us). The
// batch alone gives only B*H_kv = 32 rows of work for 132 SMs, so the
// columns are split across blocks (flash-decoding): block (split, b*h_kv)
// scores 128 cache columns for every query head of its group, writes an
// un-normalised partial (m, l, acc), and a second small kernel merges the
// partials per query row. Blocks wholly past a row's fill return at once
// and are skipped by the merge, so a short row streams only its prefix.
// Within a block four lanes share one cache row (16-byte loads, adjacent
// rows on adjacent lanes), so each warp reads contiguous memory.
//
// The append is in place: the block whose chunk holds column append_at
// copies k_new/v_new into the cache there, and every read of that column
// in this launch takes the new row from k_new/v_new instead, so no read
// depends on the write's ordering and every other cache row keeps its
// bits. Numerics follow the TPU kernel: scale*log2(e) folded into q
// (rounded back to bf16), exp2 softmax, running max from NEG_BIG, and a
// row with no valid column (valid_to < 0) outputs exactly 0.
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
// on it writes nothing. The append is the only write (nothing goes to the
// pool's sink page); the host allocator copies a shared page before a
// step could append into it, so no page written here is read by another
// slot in the same launch.

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

// Where a slot's cache column lives. Slab: row `col` of the (slot, head)
// strip. Paged: row col % page_size of the page the block staged for the
// column (nullptr for a -1 table entry).
template <int D, bool PAGED>
struct Rows {
  bf16* base;          // slab: the (slot, head) strip; paged: the pool
  const int* pages;    // paged: this chunk's page ids (shared memory)
  int c0, hk, h_kv, page_size;

  __device__ __forceinline__ bf16* at(int col) const {
    if (!PAGED) return base + static_cast<size_t>(col) * D;
    const int page = pages[(col - c0) / page_size];
    if (page < 0) return nullptr;
    return base + ((static_cast<size_t>(page) * h_kv + hk) * page_size +
                   col % page_size) * D;
  }
};

// Grid (n_splits, batch * h_kv). Shared: sQ[group*D], sS[group*kChunk],
// sRed[4*D], sM[group], sL[group] (floats); paged, sPage[kChunk] (ints).
// Slab: cache_k/cache_v are (batch, h_kv, t_max, D) and page_table is
// unused. Paged: they are (pages + 1, h_kv, page_size, D) pools and
// page_table is (batch, t_max / page_size).
template <int D, bool PAGED>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_new,
                    const bf16* __restrict__ v_new, bf16* cache_k,
                    bf16* cache_v, const int* __restrict__ valid_to,
                    const int* __restrict__ append_at,
                    const int* __restrict__ page_table,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int h_kv, int group, int t_max, int page_size,
                    int n_splits, float qscale) {
  static_assert(D % 32 == 0 && D <= 256, "head dim must be 32*n <= 256");
  constexpr int PER = D / kLanesPerRow;   // features per lane
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sS = sQ + group * D;
  float* sRed = sS + group * kChunk;
  float* sM = sRed + 4 * D;
  float* sL = sM + group;
  __shared__ int sPage[PAGED ? kChunk : 1];

  const int split = blockIdx.x;
  const int bh = blockIdx.y;               // flat (batch, kv head)
  const int b = bh / h_kv;
  const int vt = valid_to[b];
  const int ap = append_at[b];
  const int c0 = split * kChunk;
  const int tid = threadIdx.x;

  const bf16* kn = k_new + static_cast<size_t>(bh) * D;
  const bf16* vn = v_new + static_cast<size_t>(bh) * D;
  if (PAGED) {
    // This chunk's page ids, read once from the slot's table row.
    const int pps = t_max / page_size;
    const int first = c0 / page_size;
    for (int i = tid; i < kChunk / page_size; i += kThreads)
      sPage[i] = first + i < pps
                     ? page_table[static_cast<size_t>(b) * pps + first + i]
                     : -1;
    __syncthreads();
  }
  // Slab: the (slot, head) strip; paged: the pool and this chunk's pages.
  const size_t strip = PAGED ? 0 : static_cast<size_t>(bh) * t_max * D;
  const Rows<D, PAGED> krows{cache_k + strip, sPage, c0, bh % h_kv, h_kv,
                             page_size};
  const Rows<D, PAGED> vrows{cache_v + strip, sPage, c0, bh % h_kv, h_kv,
                             page_size};

  // In-place append by the one block whose chunk holds the column.
  if (ap >= c0 && ap < c0 + kChunk && ap < t_max) {
    bf16* kdst = krows.at(ap);
    bf16* vdst = vrows.at(ap);
    if (!PAGED || kdst != nullptr) {
      for (int i = tid; i < D; i += kThreads) {
        kdst[i] = kn[i];
        vdst[i] = vn[i];
      }
    }
  }
  if (c0 > vt) return;    // wholly past the fill; the merge skips it
  const int c_end_fill = vt + 1 < t_max ? vt + 1 : t_max;
  const int c_end = c0 + kChunk < c_end_fill ? c0 + kChunk : c_end_fill;
  const int ncols = c_end - c0;            // >= 1 valid columns

  // Query rows of this kv head's group, pre-scaled and rounded to bf16.
  const bf16* qb = q + static_cast<size_t>(bh) * group * D;
  for (int i = tid; i < group * D; i += kThreads)
    sQ[i] = __bfloat162float(
        __float2bfloat16(__bfloat162float(qb[i]) * qscale));
  __syncthreads();

  const int lane = tid % 32;
  const int warp = tid / 32;
  const int sub = tid % kLanesPerRow;      // which quarter of the features
  const int rg = tid / kLanesPerRow;       // row slot within a pass

  // Scores (log2 units) for every valid column and query row; a column
  // on a -1 page scores -inf.
  for (int base = 0; base < ncols; base += kRowsPerPass) {
    const int c = base + rg;
    const int col = c0 + c;
    float kf[PER];
    const bf16* krow = nullptr;
    bool scored = false;                   // slab: every column < ncols
    if (c < ncols) {
      krow = krows.at(col);
      scored = !PAGED || krow != nullptr;
      if (col == ap && scored) krow = kn;
    }
    if (scored) {
      load_row<PER>(krow + sub * PER, kf);
    } else {
#pragma unroll
      for (int i = 0; i < PER; ++i) kf[i] = 0.f;
    }
    for (int g = 0; g < group; ++g) {
      const float* qg = sQ + g * D + sub * PER;
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) dot = fmaf(kf[i], qg[i], dot);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      if (c < ncols && sub == 0) sS[g * kChunk + c] = scored ? dot : -INFINITY;
    }
  }
  __syncthreads();

  // Per query row: chunk max, weights exp2(s - m) in place, their sum.
  for (int g = warp; g < group; g += kThreads / 32) {
    float mx = kNegBig;
    for (int c = lane; c < ncols; c += 32) mx = fmaxf(mx, sS[g * kChunk + c]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int c = lane; c < ncols; c += 32) {
      const float p = exp2f(sS[g * kChunk + c] - mx);
      sS[g * kChunk + c] = p;
      sum += p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      sM[g] = mx;
      sL[g] = sum;
    }
  }
  __syncthreads();

  // acc[g] = sum_c p[g, c] * v[c]; reduce the 8 row slots of a warp by
  // shuffles (same `sub`, lanes 4 apart), then the 4 warps in shared.
  for (int g = 0; g < group; ++g) {
    float acc[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[i] = 0.f;
    for (int base = 0; base < ncols; base += kRowsPerPass) {
      const int c = base + rg;
      if (c < ncols) {
        const int col = c0 + c;
        const bf16* vrow = vrows.at(col);
        const bool held = !PAGED || vrow != nullptr;
        if (col == ap && held) vrow = vn;
        if (held) {
          float vf[PER];
          load_row<PER>(vrow + sub * PER, vf);
          const float p = sS[g * kChunk + c];
#pragma unroll
          for (int i = 0; i < PER; ++i) acc[i] = fmaf(p, vf[i], acc[i]);
        }
      }
    }
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
    const size_t prow = static_cast<size_t>(bh) * group + g;
    const size_t slot = prow * n_splits + split;
    for (int i = tid; i < D; i += kThreads)
      part_acc[slot * D + i] =
          sRed[i] + sRed[D + i] + sRed[2 * D + i] + sRed[3 * D + i];
    if (tid == 0) {
      part_ml[slot * 2] = sM[g];
      part_ml[slot * 2 + 1] = sL[g];
    }
    __syncthreads();   // sRed is reused by the next query row
  }
}

// Grid (batch * h): one block per query row merges its active splits.
template <int D>
__global__ void __launch_bounds__(kThreads)
decode_merge_kernel(const float* __restrict__ part_acc,
                    const float* __restrict__ part_ml,
                    const int* __restrict__ valid_to, bf16* __restrict__ out,
                    int h, int n_splits) {
  const int row = blockIdx.x;              // flat (batch, query head)
  const int vt = valid_to[row / h];
  int active = 0;
  if (vt >= 0) {
    active = vt / kChunk + 1;
    if (active > n_splits) active = n_splits;
  }
  const float* ml = part_ml + static_cast<size_t>(row) * n_splits * 2;
  const float* pa = part_acc + static_cast<size_t>(row) * n_splits * D;
  float m = kNegBig;
  for (int s = 0; s < active; ++s) m = fmaxf(m, ml[2 * s]);
  float l = 0.f;
  for (int s = 0; s < active; ++s) l += exp2f(ml[2 * s] - m) * ml[2 * s + 1];
  for (int i = threadIdx.x; i < D; i += kThreads) {
    float a = 0.f;
    for (int s = 0; s < active; ++s)
      a += exp2f(ml[2 * s] - m) * pa[static_cast<size_t>(s) * D + i];
    out[static_cast<size_t>(row) * D + i] =
        __float2bfloat16(l == 0.f ? 0.f : a / l);
  }
}

template <int D, bool PAGED>
int launch(const void* q, const void* k_new, const void* v_new,
           void* cache_k, void* cache_v, const void* valid_to,
           const void* append_at, const void* page_table, void* part_acc,
           void* part_ml, void* out, int batch, int h, int h_kv, int t_max,
           int page_size, float qscale, cudaStream_t stream) {
  const int group = h / h_kv;
  const int n_splits = (t_max + kChunk - 1) / kChunk;
  if (batch == 0 || n_splits == 0) return 0;
  const size_t smem =
      sizeof(float) * (group * D + group * kChunk + 4 * D + 2 * group);
  dim3 grid(n_splits, batch * h_kv);
  decode_split_kernel<D, PAGED><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_new),
      static_cast<const bf16*>(v_new), static_cast<bf16*>(cache_k),
      static_cast<bf16*>(cache_v), static_cast<const int*>(valid_to),
      static_cast<const int*>(append_at), static_cast<const int*>(page_table),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), h_kv,
      group, t_max, page_size, n_splits, qscale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_merge_kernel<D><<<batch * h, kThreads, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<const int*>(valid_to), static_cast<bf16*>(out), h,
      n_splits);
  return static_cast<int>(cudaGetLastError());
}

template <bool PAGED>
int dispatch(const void* q, const void* k_new, const void* v_new,
             void* cache_k, void* cache_v, const void* valid_to,
             const void* append_at, const void* page_table, void* part_acc,
             void* part_ml, void* out, int batch, int h, int h_kv, int t_max,
             int page_size, int d, float qscale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DECODE_CASE(DIM)                                                     \
  case DIM:                                                                  \
    return launch<DIM, PAGED>(q, k_new, v_new, cache_k, cache_v, valid_to,   \
                              append_at, page_table, part_acc, part_ml, out, \
                              batch, h, h_kv, t_max, page_size, qscale, s);
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

}  // namespace

extern "C" int flash_decode_chunk() { return kChunk; }

// q (batch, h, 1, d); k_new/v_new (batch, h_kv, 1, d); cache_k/cache_v
// (batch, h_kv, t_max, d), appended in place; valid_to/append_at (batch,)
// int32; part_acc (batch*h, n_splits, d) and part_ml (batch*h, n_splits, 2)
// f32 scratch; out (batch, h, 1, d). All contiguous, bf16 unless noted.
// Returns a cudaError_t code (0 = launched).
extern "C" int flash_decode_bf16(const void* q, const void* k_new,
                                 const void* v_new, void* cache_k,
                                 void* cache_v, const void* valid_to,
                                 const void* append_at, void* part_acc,
                                 void* part_ml, void* out, int batch, int h,
                                 int h_kv, int t_max, int d, float qscale,
                                 void* stream) {
  return dispatch<false>(q, k_new, v_new, cache_k, cache_v, valid_to,
                         append_at, nullptr, part_acc, part_ml, out, batch, h,
                         h_kv, t_max, 1, d, qscale, stream);
}

// The paged step: k_pool/v_pool (pages + 1, h_kv, page_size, d), appended
// in place through page_table (batch, pages_per_slot) int32 (-1 =
// unallocated); page_size must divide 128. Other arguments as above.
extern "C" int flash_decode_paged_bf16(
    const void* q, const void* k_new, const void* v_new, void* k_pool,
    void* v_pool, const void* valid_to, const void* append_at,
    const void* page_table, void* part_acc, void* part_ml, void* out,
    int batch, int h, int h_kv, int pages_per_slot, int page_size, int d,
    float qscale, void* stream) {
  if (page_size < 1 || kChunk % page_size)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<true>(q, k_new, v_new, k_pool, v_pool, valid_to, append_at,
                        page_table, part_acc, part_ml, out, batch, h, h_kv,
                        pages_per_slot * page_size, page_size, d, qscale,
                        stream);
}
