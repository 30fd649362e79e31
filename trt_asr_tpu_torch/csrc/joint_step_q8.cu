// Fused TDT joint decode step with int8 weights: one persistent cooperative
// launch.
//
// Replaces: trt_asr_tpu/ops/pallas/joint_step_kernel.py:joint_step_pallas_prepadded
// (its pallas_call at :124) with int8 weights; f32 weights take
// csrc/joint_step_f32.cu, bf16 weights csrc/joint_step_bf16.cu. For rows =
// B*Tq encoder positions:
//   h      = bf16(relu(e + (bf16(g) @ W_pred) s_pred + b_pred))      [rows, J]
//   logits = (h @ W_out) s_out + b_out                               [rows, V]
//   tok    = first argmax of logits[:, :ths] (blank column less the penalty)
//   dur    = first argmax of logits[:, ths:ths+ndur]  (index relative to ths)
// The returned logits are pre-penalty; int8 widens exactly, each scale
// multiplies an f32 sum.
//
// Bound on the H100: memory. At full width (P = J = 640, V = 8198, rows 8)
// a call reads 5.6 MB of int8 weights, scales and biases: 1.7 us at 3.35
// TB/s, against 85 MFLOP of products.
//
// Design: joint_body<int8_t> of csrc/joint_core.cuh, whose notes give the
// phases: 129 blocks at full width, each owning 8 groups of W_out and 5
// columns of W_pred, its slice (24.5 KB) whole in shared memory; 110,664 B,
// two blocks an SM.
#include "joint_core.cuh"

namespace port {

__global__ void __launch_bounds__(TL_THREADS, 1) joint_step_q8_kernel(JointArgs p) {
  joint_body<int8_t>(p);
}

}  // namespace port

using namespace port;

static int joint_smem_set = -1;      // the kernel's dynamic shared memory limit, as set

static cudaError_t set_joint_smem(int smem) {
  const cudaError_t err = cudaFuncSetAttribute(
      joint_step_q8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  joint_smem_set = err == cudaSuccess ? smem : -1;
  return err;
}

// e [rows, J] f32 (the encoder projection with its bias), g [rows, P] f32
// (16-byte aligned, P a multiple of 4; J a multiple of 8); packed: the
// joint's weight slices, [blocks][joint_blob(P, J, hc, gb).total] bytes
// (ops/kernels/joint_step.py:pack_joint_step). The launch plan (blocks, gb,
// hc, smem: dynamic shared bytes) comes from the wrapper and is checked
// against this file's layout. logits [rows, V] f32, tok and dur [rows]
// int32. scratch: the ticket (16 bytes), h [rows, J] bf16 (16-byte
// aligned), the pairs [rows][blocks] of float4. Returns the CUDA error code
// (cudaErrorCooperativeLaunchTooLarge when the blocks cannot all be
// resident).
extern "C" int joint_step_q8_launch(const float* e, const float* g, int rows, int P, int J, int V,
                                    const void* packed, int blocks, int gb, int hc, int smem,
                                    int ths, int ndur, int blank_id, float penalty, float* logits,
                                    int* tok, int* dur, void* scratch, void* stream_ptr) {
  const size_t groups = ((size_t)V + TL_GW - 1) / TL_GW;
  if (rows < 1 || P < 4 || P % 4 || J < TL_GW || J % TL_GW || V < 1 || ths < 1 || ndur < 1 ||
      ths + ndur > V || blank_id < 0 || blank_id >= ths || gb < 1 || blocks < 1 ||
      (size_t)blocks * gb < groups || (size_t)(blocks - 1) * gb >= groups || hc < 1 ||
      (size_t)blocks * hc < (size_t)J || joint_smem(P, J, hc, gb).total != (size_t)smem)
    return (int)cudaErrorInvalidValue;
  if (smem != joint_smem_set) {
    const cudaError_t err = set_joint_smem(smem);
    if (err != cudaSuccess) return (int)err;
  }
  unsigned char* s = static_cast<unsigned char*>(scratch);
  const size_t hb = tail_align((size_t)rows * J * 2);
  JointArgs p = {e, g, rows, P, J, V, hc, gb, ths, ndur, blank_id, penalty, packed, logits,
                 tok, dur, reinterpret_cast<int*>(s), reinterpret_cast<bf16*>(s + 16),
                 reinterpret_cast<float4*>(s + 16 + hb)};
  void* args[] = {&p};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)joint_step_q8_kernel, dim3(blocks), dim3(TL_THREADS), args, (size_t)smem,
      (cudaStream_t)stream_ptr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// info[0] = blocks of the kernel an SM holds with `smem` dynamic shared
// bytes (the CUDA occupancy API)
extern "C" int joint_step_q8_occupancy(int smem, int* info) {
  const cudaError_t err = set_joint_smem(smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], joint_step_q8_kernel,
                                                            TL_THREADS, (size_t)smem);
}
