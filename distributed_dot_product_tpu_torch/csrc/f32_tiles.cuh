// Float32 and int8 tiles in shared memory and the exact int8 score product,
// shared by csrc/flash_f32.cu (K1/K2) and csrc/flash_bwd_f32.cu (K3/K4):
// a W-wide float32 row padded to W + 4 floats (W a multiple of 32, so 8
// rows 2t apart or 1 apart land on distinct banks), an int8 row to W + 16
// bytes, and int8 scoring's s8 m16n8k32 products. Each source that includes
// it gets its own copy (an anonymous namespace).

#pragma once

#include <stddef.h>
#include <stdint.h>

namespace {

template <int W>
constexpr int kPf = W + 4;
template <int W>
constexpr int kP8 = W + 16;

// Bytes of an n-row float32 or int8 tile.
template <int W>
__host__ __device__ constexpr size_t tile_f32(int n) {
  return 4 * static_cast<size_t>(n) * kPf<W>;
}

template <int W>
__host__ __device__ constexpr size_t tile_i8(int n) {
  return static_cast<size_t>(n) * kP8<W>;
}

// d (16 x 8, s32) += a (16 x 32 s8, row) . b (32 x 8 s8, col), exact.
__device__ __forceinline__ void mma_s8(int* d, const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const signed char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// acc (16 x 8 NT int32) += A8 . B8^T over K int8 columns: the warp's 16
// rows at `a`, 8 NT rows at `b`, both kP8<K> bytes a row. The s8 fragments:
// a0 (g, 4t..4t+3), a1 (g + 8, 4t..), a2 (g, 16 + 4t..), a3 (g + 8, 16 +
// 4t..); b0 (4t..4t+3, g), b1 (16 + 4t.., g).
template <int K, int NT>
__device__ __forceinline__ void mma_s8_abt(int* acc, const signed char* a,
                                           const signed char* b) {
  constexpr int P = kP8<K>;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const signed char* a0 = a + g * P + 4 * t;
  const signed char* b0 = b + g * P + 4 * t;
#pragma unroll 2
  for (int kk = 0; kk < K / 32; ++kk) {
    const uint32_t fa[4] = {ld32(a0 + 32 * kk), ld32(a0 + 8 * P + 32 * kk),
                            ld32(a0 + 32 * kk + 16),
                            ld32(a0 + 8 * P + 32 * kk + 16)};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const signed char* bp = b0 + 8 * nt * P + 32 * kk;
      mma_s8(acc + 4 * nt, fa, ld32(bp), ld32(bp + 16));
    }
  }
}

}  // namespace
