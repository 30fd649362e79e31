// Fused conformer convolution module for B=1 streaming chunks (the int8
// conv module followed by the second FFN and the output LayerNorm is
// conv_ffn_ln.cu).
//
// Replaces: trt_asr_tpu/ops/pallas/conv_block_kernel.py:conv_block_pallas.
// For the Tq rows x of one layer:
//   u = LN(x); hw = u @ pw1 (D -> 2D); c = hw[:, :D] * sigmoid(hw[:, D:])
//   c = c * mask (padded steps are zero); ext = tc (K rows) ++ c ++ 0 (K rows)
//   cv[t] = sum_j ext[t + j] * dw[j]; cv = (cv - m) * g * rsqrt(v + 1e-5) + b
//   y = x + silu(cv) @ pw2
// and returns (y, c), c being the rows that feed the time cache.
//
// Bound on the H100: memory. Per layer at full size (D=1024, Tq=8) the
// conv module must read pw1 and pw2 once: 12.6 MB f32, 3.1 MB int8. The
// arithmetic is ~50 MFLOP. Design: LayerNorm once; pw1 as split-K
// partial sums (common.cuh); then one block per 32 columns reduces the
// partials of column n and of its GLU gate n + D itself, so the two halves
// meet without another pass, and walks all Tq rows of its columns: GLU,
// mask, the K taps of the depthwise conv over shared memory (the conv mixes
// rows, not columns), BatchNorm and SiLU, writing c and pw2's operand; then
// pw2 as a split-K pair whose epilogue adds the residual.
//
// Rounding points follow the TPU kernel: with bf16 or int8 weights u and
// silu(BN(conv)) are rounded to bf16; x, c and the residual stream are not.
// The time cache is read as it is stored, f32 or bf16 (a bf16 encoder
// state), as the TPU kernel reads it.
#include "common.cuh"

namespace port {

constexpr int CONV_COLS = 32;
constexpr int CONV_ROWS = 8;               // row groups of a block
constexpr int CONV_THREADS = CONV_COLS * CONV_ROWS;

// Element i of an f32 (bf16 = 0) or bf16 array, widened to f32.
__device__ __forceinline__ float load_f(const void* p, int bf16, size_t i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// grid ceil(D / 32); dynamic shared memory (M + kk - 1) * 32 floats.
// part [ksplit][M][2D] holds pw1's partial sums, s1 [2D] its scales or null;
// tc is f32, or bf16 when tc_bf16 is set.
__global__ void __launch_bounds__(CONV_THREADS)
conv_module_kernel(const float* __restrict__ part, int ksplit, int M, int D,
                   const float* __restrict__ s1, const float* __restrict__ mask,
                   const void* __restrict__ tc, int tc_bf16, const float* __restrict__ dw, int kk,
                   const float* __restrict__ bn_g, const float* __restrict__ bn_b,
                   const float* __restrict__ bn_m, const float* __restrict__ bn_v,
                   int round_out, float* __restrict__ c, float* __restrict__ a) {
  extern __shared__ float ext[];           // [M + kk - 1][CONV_COLS]
  const int col = threadIdx.x % CONV_COLS, r = threadIdx.x / CONV_COLS;
  const int n = blockIdx.x * CONV_COLS + col;
  const int half = (kk - 1) / 2;
  const bool ok = n < D;
  const size_t N = 2 * (size_t)D;
  for (int i = r; i < half; i += CONV_ROWS) {
    ext[i * CONV_COLS + col] = ok ? load_f(tc, tc_bf16, (size_t)i * D + n) : 0.f;
    ext[(half + M + i) * CONV_COLS + col] = 0.f;
  }
  for (int t = r; t < M; t += CONV_ROWS) {
    float v = 0.f;
    if (ok) {
      float sa = 0.f, sg = 0.f;
#pragma unroll 8
      for (int kb = 0; kb < ksplit; ++kb) {
        const float* p = part + ((size_t)kb * M + t) * N;
        sa += p[n];
        sg += p[n + D];
      }
      const float hv = __fmul_rn(sa, s1 ? s1[n] : 1.f);
      const float gate = __fmul_rn(sg, s1 ? s1[n + D] : 1.f);
      v = __fmul_rn(__fmul_rn(hv, sigmoid_f(gate)), mask[t]);
      c[(size_t)t * D + n] = v;
    }
    ext[(half + t) * CONV_COLS + col] = v;
  }
  __syncthreads();
  if (!ok) return;
  const float bscale = __fmul_rn(bn_g[n], rsqrtf(bn_v[n] + 1e-5f));
  const float mean = bn_m[n], beta = bn_b[n];
  for (int t = r; t < M; t += CONV_ROWS) {
    float cv = __fmul_rn(ext[t * CONV_COLS + col], dw[n]);
    for (int j = 1; j < kk; ++j)
      cv = __fadd_rn(cv, __fmul_rn(ext[(t + j) * CONV_COLS + col], dw[(size_t)j * D + n]));
    cv = __fadd_rn(__fmul_rn(__fsub_rn(cv, mean), bscale), beta);
    a[(size_t)t * D + n] = round_op(silu_f(cv), round_out);
  }
}

// (y, c) of the conv module; u and a [M, D] are scratch, part holds
// ksplit * M * 2D floats.
inline cudaError_t launch_conv_block(const float* x, int M, int D, const float* ln_g,
                                     const float* ln_b, const void* pw1, const float* s1,
                                     const float* dw, int kk, const float* bn_g,
                                     const float* bn_b, const float* bn_m, const float* bn_v,
                                     const void* pw2, const float* s2, int wtype,
                                     const void* tc, int tc_bf16, const float* mask,
                                     int ksplit, float* y,
                                     float* c, float* u, float* a, float* part,
                                     cudaStream_t stream) {
  if (M < 1 || D < 1 || kk < 1 || kk % 2 == 0) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)(M + kk - 1) * CONV_COLS;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const int bf = wtype != W_F32;
  cudaError_t err = launch_layernorm(x, M, D, ln_g, ln_b, u, stream);
  if (err != cudaSuccess) return err;
  const GemmBatch up = {1, {pw1}, {s1}, {nullptr}};
  err = launch_gemm_partial(wtype, u, M, D, up, 2 * D, ksplit, bf, part, stream);
  if (err != cudaSuccess) return err;
  conv_module_kernel<<<(D + CONV_COLS - 1) / CONV_COLS, CONV_THREADS, smem, stream>>>(
      part, ksplit, M, D, s1, mask, tc, tc_bf16, dw, kk, bn_g, bn_b, bn_m, bn_v, bf, c, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ArgmaxParts none = {};
  const GemmBatch down = {1, {pw2}, {s2}, {y}};
  return launch_small_m_gemm<false>(wtype, a, M, D, down, D, ksplit, x, 1.f, nullptr, ACT_NONE,
                                    0, 0, part, none, stream);
}

}  // namespace port

using namespace port;

// x, y, c [M, D] f32; dw [kk, D]; tc [(kk - 1) / 2, D], f32 or (tc_bf16) bf16; mask [M] (1 = valid
// step, 0 = padded). Weights: wtype 0 = f32, 1 = bf16, 2 = int8 (then s1
// [2D] and s2 [D] are the per-column scales, else null). u and a [M, D] and
// part [ksplit * M * 2D] are scratch. Returns the CUDA error code.
extern "C" int conv_block_launch(
    const float* x, int M, int D, const float* ln_g, const float* ln_b, const void* pw1,
    const float* s1, const float* dw, int kk, const float* bn_g, const float* bn_b,
    const float* bn_m, const float* bn_v, const void* pw2, const float* s2, int wtype,
    const void* tc, int tc_bf16, const float* mask, int ksplit, float* y, float* c, float* u,
    float* a, float* part, void* stream_ptr) {
  return (int)launch_conv_block(x, M, D, ln_g, ln_b, pw1, s1, dw, kk, bn_g, bn_b, bn_m, bn_v,
                                pw2, s2, wtype, tc, tc_bf16, mask, ksplit, y, c, u, a, part,
                                (cudaStream_t)stream_ptr);
}
