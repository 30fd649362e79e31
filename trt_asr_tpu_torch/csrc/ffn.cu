// Fused conformer feed-forward module: y = x + scale * silu(LN(x) @ W1) @ W2.
//
// Replaces: trt_asr_tpu/ops/pallas/ffn_kernel.py:fused_ffn_pallas. The TPU
// kernel grids the expansion axis so W1 and W2 fit VMEM and carries the
// output across grid steps; here each product is one split-K launch pair
// over the whole expansion (common.cuh), since Hopper blocks run in parallel
// and carry nothing from one to the next.
//
// Bound on the H100: memory. At B=1 streaming shapes (M <= 8 rows, D=1024,
// E=4096) it must read W1 and W2 once: 33.6 MB f32, 8.4 MB int8 (plus the
// 32 KB scales), against ~134 MFLOP. Design: LayerNorm once (a row's
// statistics need the whole row), then the two small-M products, each
// reading every weight element once for all rows with the loads of the
// whole matrix in flight in one wave of blocks; SiLU and the bf16 rounding
// of silu(h) ride the first product's epilogue, the scaled residual the
// second's.
//
// Rounding points follow the TPU kernel: with bf16 or int8 weights the LN
// output and silu(h) are rounded to bf16; accumulation is f32 and the int8
// scale multiplies the f32 accumulator. The residual stream is never
// rounded. (The f32 activation split of TRT_ASR_Q8_ACT=split is not applied
// here, as the TPU kernel does not apply it.)
#include "common.cuh"

using namespace port;

// x, y [M, D] f32. Weights: wtype 0 = f32, 1 = bf16, 2 = int8 (then s1 [E]
// and s2 [D] are the per-column scales, else null). u [M, D], h [M, E] and
// part [max(ks1 * E, ks2 * D) * M] are scratch. Returns the CUDA error code.
extern "C" int ffn_launch(const float* x, int M, int D, int E, const float* ln_g,
                          const float* ln_b, const void* w1, const float* s1, const void* w2,
                          const float* s2, int wtype, float scale, int ks1, int ks2, float* y,
                          float* u, float* h, float* part, void* stream_ptr) {
  if (M < 1 || D < 1 || E < 1) return (int)cudaErrorInvalidValue;
  return (int)launch_ffn(x, M, D, E, ln_g, ln_b, w1, s1, w2, s2, wtype, scale, ks1, ks2, y, u,
                         h, part, (cudaStream_t)stream_ptr);
}
