// Fused KV-cache decode step for Hopper (sm_90a): in-place append plus
// split-K flash-decoding attention, bf16 cache, f32 accumulation.
//
// Replaces the TPU kernel `_make_decode_kernel` (slab body `kernel_body`)
// in distributed_dot_product_tpu/ops/pallas_decode.py for one new row per
// slot (n = 1) without the int8 mirror, window, ALiBi, page table or
// partial outputs.
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

// Grid (n_splits, batch * h_kv). Shared: sQ[group*D], sS[group*kChunk],
// sRed[4*D], sM[group], sL[group] (floats).
template <int D>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_new,
                    const bf16* __restrict__ v_new, bf16* cache_k,
                    bf16* cache_v, const int* __restrict__ valid_to,
                    const int* __restrict__ append_at,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int h_kv, int group, int t_max, int n_splits,
                    float qscale) {
  static_assert(D % 32 == 0 && D <= 256, "head dim must be 32*n <= 256");
  constexpr int PER = D / kLanesPerRow;   // features per lane
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sS = sQ + group * D;
  float* sRed = sS + group * kChunk;
  float* sM = sRed + 4 * D;
  float* sL = sM + group;

  const int split = blockIdx.x;
  const int bh = blockIdx.y;               // flat (batch, kv head)
  const int b = bh / h_kv;
  const int vt = valid_to[b];
  const int ap = append_at[b];
  const int c0 = split * kChunk;
  const int tid = threadIdx.x;

  const bf16* kn = k_new + static_cast<size_t>(bh) * D;
  const bf16* vn = v_new + static_cast<size_t>(bh) * D;
  bf16* kc = cache_k + static_cast<size_t>(bh) * t_max * D;
  bf16* vc = cache_v + static_cast<size_t>(bh) * t_max * D;

  // In-place append by the one block whose chunk holds the column.
  if (ap >= c0 && ap < c0 + kChunk && ap < t_max) {
    for (int i = tid; i < D; i += kThreads) {
      kc[static_cast<size_t>(ap) * D + i] = kn[i];
      vc[static_cast<size_t>(ap) * D + i] = vn[i];
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

  // Scores (log2 units) for every valid column and query row.
  for (int base = 0; base < ncols; base += kRowsPerPass) {
    const int c = base + rg;
    const int col = c0 + c;
    float kf[PER];
    if (c < ncols) {
      const bf16* krow = col == ap ? kn : kc + static_cast<size_t>(col) * D;
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
      if (c < ncols && sub == 0) sS[g * kChunk + c] = dot;
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
        const bf16* vrow = col == ap ? vn : vc + static_cast<size_t>(col) * D;
        float vf[PER];
        load_row<PER>(vrow + sub * PER, vf);
        const float p = sS[g * kChunk + c];
#pragma unroll
        for (int i = 0; i < PER; ++i) acc[i] = fmaf(p, vf[i], acc[i]);
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

template <int D>
int launch(const void* q, const void* k_new, const void* v_new,
           void* cache_k, void* cache_v, const void* valid_to,
           const void* append_at, void* part_acc, void* part_ml, void* out,
           int batch, int h, int h_kv, int t_max, float qscale,
           cudaStream_t stream) {
  const int group = h / h_kv;
  const int n_splits = (t_max + kChunk - 1) / kChunk;
  if (batch == 0 || n_splits == 0) return 0;
  const size_t smem =
      sizeof(float) * (group * D + group * kChunk + 4 * D + 2 * group);
  dim3 grid(n_splits, batch * h_kv);
  decode_split_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_new),
      static_cast<const bf16*>(v_new), static_cast<bf16*>(cache_k),
      static_cast<bf16*>(cache_v), static_cast<const int*>(valid_to),
      static_cast<const int*>(append_at), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), h_kv, group, t_max, n_splits, qscale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_merge_kernel<D><<<batch * h, kThreads, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<const int*>(valid_to), static_cast<bf16*>(out), h,
      n_splits);
  return static_cast<int>(cudaGetLastError());
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch<32>(q, k_new, v_new, cache_k, cache_v, valid_to,
                        append_at, part_acc, part_ml, out, batch, h, h_kv,
                        t_max, qscale, s);
    case 64:
      return launch<64>(q, k_new, v_new, cache_k, cache_v, valid_to,
                        append_at, part_acc, part_ml, out, batch, h, h_kv,
                        t_max, qscale, s);
    case 96:
      return launch<96>(q, k_new, v_new, cache_k, cache_v, valid_to,
                        append_at, part_acc, part_ml, out, batch, h, h_kv,
                        t_max, qscale, s);
    case 128:
      return launch<128>(q, k_new, v_new, cache_k, cache_v, valid_to,
                         append_at, part_acc, part_ml, out, batch, h, h_kv,
                         t_max, qscale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
