// The run-time arguments of the flash kernels' masks and Ext features,
// shared by csrc/flash_fwd.cu, csrc/flash_bwd.cu (bf16) and
// csrc/flash_f32.cu (float32): the dense mask's and the per-position
// vectors' addressing, the Ext instantiations' ExtArgs (ops/
// flash_attention.py mirrors its layout in _ExtArgs), and the dropout's
// coordinate hash. Each source that includes it gets its own copy (an
// anonymous namespace).

#pragma once

namespace {

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

// An int32 vector per flat (batch, head) row: element i of row bh at
// ptr + (bh / inner) * so + (bh % inner) * si + i (elements).
struct VecArgs {
  const int* ptr;
  int inner;
  long long so, si;
};

// The Ext instantiations' run-time arguments; a null pointer or a zero
// window / dropout flag leaves that feature off.
struct ExtArgs {
  VecArgs segq, segk;          // segment ids of query rows / key columns
  int window;                  // 0: none
  int dropout;                 // 0: none
  unsigned int drop_threshold; // keep when hash >= threshold
  float drop_inv;              // 1 / (1 - rate)
  unsigned int seed;
  const signed char* q8;       // (batch_heads, tq, d) int8 (Quant)
  const signed char* k8;       // (batch_heads / group, tk, d) int8
  const float* sqf;            // (batch_heads, tq): q row scale*scale*log2e
  const float* skr;            // (batch_heads / group, tk): raw k row scale
  const float* alibi;          // (batch_heads,): slope * log2e; null: none
  VecArgs posq, posk;          // global positions; posk.ptr null: none
  VecArgs posq_mm, posk_mm;    // per 64-row tile: [min, max] of posq/posk
};

__device__ __forceinline__ const int* vec_row(const VecArgs& a, int bh) {
  return a.ptr + (bh / a.inner) * a.so + (bh % a.inner) * a.si;
}

// The reference's _dropout_keep before the threshold: murmur3's fmix32 of
// row*2654435761 ^ col*2246822519 ^ (seed + b*668265263), all mod 2^32;
// `rh` is the row's term, `ch` the column's and `bs` the batch/seed term.
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

}  // namespace
