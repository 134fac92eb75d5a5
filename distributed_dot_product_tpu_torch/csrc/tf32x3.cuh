// Float32-accurate products on the TF32 tensor cores (3xTF32), shared by
// csrc/flash_f32.cu (K1/K2), csrc/flash_bwd_f32.cu (K3/K4) and
// csrc/flash_decode.cu's float32 library (K5/K5p): each operand x is
// split into big = cvt.rna.tf32(x) and small = cvt.rna.tf32(x - big), and
// small.big + big.small accumulate before big.big (mma.sync m16n8k8 here;
// K1/K2's wgmma products take the same order); the dropped small.small
// term lies ~2^-22 below the product, where one TF32 product keeps ~2^-11
// (without cvt.rna the tensor core truncates float32 to TF32). Three
// products at 495 TFLOP/s of TF32 make 165 TFLOP/s of float32-accurate
// work on an H100. Each source that includes it gets its own copy (an
// anonymous namespace).
//
// Fragment coordinates: lane = 4 g + t; A (16 x 8): a0 (g, t), a1 (g + 8,
// t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8): b0 (t, g), b1 (t + 4,
// g); the accumulator: c0, c1 (g, 2t, 2t + 1), c2, c3 (g + 8, 2t, 2t + 1).

#pragma once

#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small (to ~2^-22), both TF32.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

struct FragA {
  uint32_t big[4], small[4];
};

__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2,
                                        float a3) {
  FragA f;
  split(a0, f.big[0], f.small[0]);
  split(a1, f.big[1], f.small[1]);
  split(a2, f.big[2], f.small[2]);
  split(a3, f.big[3], f.small[3]);
  return f;
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The three TF32 products of a 3xTF32 product in their order, the small
// terms first: term(a_small, b_small) for A.small . B.big, A.big . B.small
// and A.big . B.big (mma3_parts on mma.sync; csrc/flash_f32.cu's wgmma
// products).
template <typename Term>
__device__ __forceinline__ void tf32x3_terms(Term&& term) {
  term(true, false);
  term(false, true);
  term(false, false);
}

// d (16 x 8) += A . B to float32 accuracy from B's parts (bb0, bs0 of b0;
// bb1, bs1 of b1).
__device__ __forceinline__ void mma3_parts(float* d, const FragA& a,
                                           uint32_t bb0, uint32_t bs0,
                                           uint32_t bb1, uint32_t bs1) {
  tf32x3_terms([&](bool a_small, bool b_small) {
    mma_tf32(d, a_small ? a.small : a.big, b_small ? bs0 : bb0,
             b_small ? bs1 : bb1);
  });
}

// The same with B split here.
__device__ __forceinline__ void mma3(float* d, const FragA& a, float b0,
                                     float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split(b0, bb0, bs0);
  split(b1, bb1, bs1);
  mma3_parts(d, a, bb0, bs0, bb1, bs1);
}

}  // namespace
