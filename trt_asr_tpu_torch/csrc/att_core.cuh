// What the persistent attention-block kernels (csrc/att_block_q8.cu, int8
// weights; csrc/att_block_f32.cu, f32 weights) share: the launch's
// arguments, the staging pitches of the scores and the scores' dot product
// in the order of the plain version's einsum on the H100. Each kernel keeps
// its own phases: the int8 one's carry its bf16 rounding points, and
// templates shared by the two read 0.3-0.4 us slower on it in pairs
// (att_variants.py --against).
#pragma once

#include <cooperative_groups.h>

#include "persistent.cuh"

namespace port {

namespace cg = cooperative_groups;

struct AttArgs {
  const float* x;
  int M, D, H, C, cD, ranges, slots;      // scores items: `ranges` a head, `slots` each
  int stages;                             // f32: stages of the weight ring
  const float *ln_g, *ln_b, *bias_u, *bias_v, *pos, *kv;
  const int* meta;                        // cursor, cache_len, valid_tq
  float scale;
  const void* packed;                     // the layer's weights, a block's slice contiguous
  float *y, *u, *k_new, *v_new;
  float* q;                               // scratch: [M, D]
  float* scores;                          // [H, M, att_s4(C + M)], ring-slot order
  void* ctx;                              // [M, D]: bf16 (int8 weights) or f32
};

// Row pitch (floats) of a head's scores: the C + M slots rounded up to 4,
// so that rows are copied in 16-byte pieces
__host__ __device__ inline int att_s4(int S) { return (S + 3) & ~3; }

// Row pitch (floats) of the staged [rows, dh] tiles of the scores: dh + 4,
// an odd number of float4s (dh is a multiple of 8), so that neighbouring
// rows start in distinct bank groups
__host__ __device__ inline int att_pitch(int dh) { return dh + 4; }

// The dot product of rows a and b (dh floats, 16-byte aligned), summed as
// the plain version's einsums sum on the H100 (cuBLAS; found by emulating
// candidate orders against its results at the full width): 16 partial sums,
// partial i over k = i, i + 16, ... in order (FMAs), then the partials added
// in order. dh is a multiple of 16.
__device__ __forceinline__ float dot_by16(const float* a, const float* b, int dh) {
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < dh; k0 += 16) {
    float4 x[4], y[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      x[u] = *reinterpret_cast<const float4*>(a + k0 + 4 * u);
      y[u] = *reinterpret_cast<const float4*>(b + k0 + 4 * u);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      acc[4 * u] = fmaf(x[u].x, y[u].x, acc[4 * u]);
      acc[4 * u + 1] = fmaf(x[u].y, y[u].y, acc[4 * u + 1]);
      acc[4 * u + 2] = fmaf(x[u].z, y[u].z, acc[4 * u + 2]);
      acc[4 * u + 3] = fmaf(x[u].w, y[u].w, acc[4 * u + 3]);
    }
  }
  float v = acc[0];
#pragma unroll
  for (int i = 1; i < 16; ++i) v = __fadd_rn(v, acc[i]);
  return v;
}

}  // namespace port
