// Fused TDT joint decode step.
//
// Replaces: trt_asr_tpu/ops/pallas/joint_step_kernel.py:joint_step_pallas_prepadded
// (and joint_step_pallas / pad_joint_weights, which only pad for the TPU's
// 128-lane tiles). For rows = B*Tq encoder positions:
//   h      = relu(e + (g @ W_pred) * s_pred + b_pred)
//   logits = (h @ W_out) * s_out + b_out                 [rows, V]
//   tok    = first argmax of logits[:, :ths] (blank column less the penalty)
//   dur    = first argmax of logits[:, ths:ths+ndur]     (index relative to ths)
// The returned logits are pre-penalty.
//
// Bound on the H100: memory. W_out [640, 8198] is 21 MB in f32 and 5.2 MB in
// int8; it is read once per call, for all rows. Design: three launches. (1)
// the hidden layer, a small-M product over the 640 hidden columns with the
// bias/ReLU/rounding epilogue; (2) the output projection over 32-column
// vocabulary tiles, whose epilogue writes the logits and, per row, the
// (max, first index) of each tile for both heads; (3) one block per row reduces
// the tile pairs, smaller index winning ties, as jnp.argmax does. Only the
// real V columns are computed. Both products are split over K as well
// (common.cuh) so that enough weight loads are in flight. With bf16 or int8 weights g and h are rounded
// to bf16 (the TPU kernel's operand type); accumulation is f32 and the int8
// scale multiplies the accumulator.
#include "common.cuh"

namespace port {

constexpr int RED_THREADS = 128;

__global__ void __launch_bounds__(RED_THREADS)
argmax_reduce_kernel(const float* __restrict__ tok_val, const int* __restrict__ tok_idx,
                     const float* __restrict__ dur_val, const int* __restrict__ dur_idx,
                     int ntiles, int ths, int* __restrict__ tok, int* __restrict__ dur) {
  __shared__ float sv[2][RED_THREADS / 32];
  __shared__ int si[2][RED_THREADS / 32];
  const int r = blockIdx.x;
  float tv = -INFINITY, dv = -INFINITY;
  int ti = 0x7fffffff, di = 0x7fffffff;
  for (int i = threadIdx.x; i < ntiles; i += blockDim.x) {
    const size_t o = (size_t)r * ntiles + i;
    argmax_merge(tv, ti, tok_val[o], tok_idx[o]);
    argmax_merge(dv, di, dur_val[o], dur_idx[o]);
  }
  warp_argmax(tv, ti);
  warp_argmax(dv, di);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sv[0][warp] = tv;
    si[0][warp] = ti;
    sv[1][warp] = dv;
    si[1][warp] = di;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < RED_THREADS / 32; ++w) {
      argmax_merge(tv, ti, sv[0][w], si[0][w]);
      argmax_merge(dv, di, sv[1][w], si[1][w]);
    }
    tok[r] = ti;
    dur[r] = di - ths;
  }
}

}  // namespace port

using namespace port;

// e [rows, J] f32 (encoder projection incl. its bias), g [rows, P] f32.
// Weights: wtype 0 = f32, 1 = bf16, 2 = int8 (then sp/so are the per-column
// scales, else null). h [rows, J], the split-K partial sums part
// [max(ks_pred * J, ks_out * V) * rows] and the four tile-partial buffers
// [rows, ceil(V/32)] are scratch. Returns the CUDA error code.
extern "C" int joint_step_launch(
    const float* e, const float* g, int rows, int P, int J, int V,
    const void* wp, const float* sp, const float* bp,
    const void* wo, const float* so, const float* bo, int wtype,
    int ths, int ndur, int blank_id, float penalty, int ks_pred, int ks_out,
    float* h, float* logits, float* part, float* tok_val, int* tok_idx, float* dur_val, int* dur_idx,
    int* tok, int* dur, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int bf = wtype != W_F32;
  if (rows < 1 || ths + ndur > V) return (int)cudaErrorInvalidValue;
  ArgmaxParts none = {};
  const GemmBatch pred = {1, {wp}, {sp}, {h}};
  cudaError_t err = launch_small_m_gemm<false>(wtype, g, rows, P, pred, J, ks_pred, e, 1.f, bp,
                                               ACT_RELU, bf, bf, part, none, stream);
  if (err != cudaSuccess) return (int)err;

  const int ntiles = (V + EPI_TILE - 1) / EPI_TILE;
  ArgmaxParts am = {ths, ndur, blank_id, penalty, ntiles, tok_val, tok_idx, dur_val, dur_idx};
  const GemmBatch out = {1, {wo}, {so}, {logits}};
  err = launch_small_m_gemm<true>(wtype, h, rows, J, out, V, ks_out, nullptr, 1.f, bo,
                                  ACT_NONE, 0, 0, part, am, stream);
  if (err != cudaSuccess) return (int)err;

  argmax_reduce_kernel<<<rows, RED_THREADS, 0, stream>>>(tok_val, tok_idx, dur_val, dur_idx,
                                                         ntiles, ths, tok, dur);
  return (int)cudaGetLastError();
}
