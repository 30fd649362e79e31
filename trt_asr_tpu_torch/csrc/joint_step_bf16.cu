// Fused TDT joint decode step with bf16 weights: one persistent cooperative
// launch.
//
// Replaces: trt_asr_tpu/ops/pallas/joint_step_kernel.py:joint_step_pallas_prepadded
// (its pallas_call at :124) with bf16 weights (those of
// cast_params_for_compute); int8 weights take csrc/joint_step_q8.cu, f32
// weights csrc/joint_step_f32.cu. It took the place of the three launches
// of csrc/joint_step.cu, which stay for chip_smoke.py to time beside it.
// For rows = B*Tq encoder positions:
//   h      = bf16(relu(e + bf16(g) @ W_pred + b_pred))               [rows, J]
//   logits = h @ W_out + b_out                                       [rows, V]
//   tok    = first argmax of logits[:, :ths] (blank column less the penalty)
//   dur    = first argmax of logits[:, ths:ths+ndur]  (index relative to ths)
// The returned logits are pre-penalty; every sum is f32, the biases f32.
//
// Bound on the H100: memory. At full width (P = J = 640, V = 8198, rows 8)
// a call reads 11.3 MB of bf16 weights and their f32 biases: 3.4 us at 3.35
// TB/s, against 85 MFLOP of products.
//
// Design: the int8 kernel's plan, joint_body<bf16> of csrc/joint_core.cuh
// (its notes give the phases): 129 blocks at full width, each owning 8
// groups of W_out and 5 columns of W_pred, its bf16 slice (W_pred's columns
// 6.4 KB, W_out's groups 80 KB in int8's [J/16][8][16] layout, which feeds
// the mma as it is; no scales) whole in shared memory, packed once with the
// model's weights (ops/kernels/joint_step.py:pack_joint_step): 154,552 B,
// one block an SM. The hidden product widens bf16 exactly by shifts and sums
// in cuBLAS's order, as the int8 kernel does.
#include "joint_core.cuh"

namespace port {

__global__ void __launch_bounds__(TL_THREADS, 1) joint_step_bf16_kernel(JointArgs p) {
  joint_body<bf16>(p);
}

}  // namespace port

using namespace port;

static int jb_smem_set = -1;         // the kernel's dynamic shared memory limit, as set

static cudaError_t set_jb_smem(int smem) {
  const cudaError_t err = cudaFuncSetAttribute(
      joint_step_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  jb_smem_set = err == cudaSuccess ? smem : -1;
  return err;
}

// e [rows, J] f32 (the encoder projection with its bias), g [rows, P] f32
// (16-byte aligned, P a multiple of 4; J a multiple of 8); packed: the
// joint's bf16 weight slices and f32 biases, [blocks][joint_blob(P, J, hc,
// gb, 2, false).total] bytes (ops/kernels/joint_step.py:pack_joint_step).
// The launch plan (blocks, gb, hc, smem: dynamic shared bytes) comes from
// the wrapper and is checked against this file's layout. logits [rows, V]
// f32, tok and dur [rows] int32. scratch: the ticket (16 bytes), h [rows, J]
// bf16 (16-byte aligned), the pairs [rows][blocks] of float4. Returns the
// CUDA error code (cudaErrorCooperativeLaunchTooLarge when the blocks cannot
// all be resident).
extern "C" int joint_step_bf16_launch(const float* e, const float* g, int rows, int P, int J,
                                      int V, const void* packed, int blocks, int gb, int hc,
                                      int smem, int ths, int ndur, int blank_id, float penalty,
                                      float* logits, int* tok, int* dur, void* scratch,
                                      void* stream_ptr) {
  const size_t groups = ((size_t)V + TL_GW - 1) / TL_GW;
  if (rows < 1 || P < 4 || P % 4 || J < TL_GW || J % TL_GW || V < 1 || ths < 1 || ndur < 1 ||
      ths + ndur > V || blank_id < 0 || blank_id >= ths || gb < 1 || blocks < 1 ||
      (size_t)blocks * gb < groups || (size_t)(blocks - 1) * gb >= groups || hc < 1 ||
      (size_t)blocks * hc < (size_t)J ||
      joint_smem(P, J, hc, gb, 2, false).total != (size_t)smem)
    return (int)cudaErrorInvalidValue;
  if (smem != jb_smem_set) {
    const cudaError_t err = set_jb_smem(smem);
    if (err != cudaSuccess) return (int)err;
  }
  unsigned char* s = static_cast<unsigned char*>(scratch);
  const size_t hb = tail_align((size_t)rows * J * 2);
  JointArgs p = {e, g, rows, P, J, V, hc, gb, ths, ndur, blank_id, penalty, packed, logits,
                 tok, dur, reinterpret_cast<int*>(s), reinterpret_cast<bf16*>(s + 16),
                 reinterpret_cast<float4*>(s + 16 + hb)};
  void* args[] = {&p};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)joint_step_bf16_kernel, dim3(blocks), dim3(TL_THREADS), args, (size_t)smem,
      (cudaStream_t)stream_ptr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// info[0] = blocks of the kernel an SM holds with `smem` dynamic shared
// bytes (the CUDA occupancy API)
extern "C" int joint_step_bf16_occupancy(int smem, int* info) {
  const cudaError_t err = set_jb_smem(smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], joint_step_bf16_kernel,
                                                            TL_THREADS, (size_t)smem);
}
