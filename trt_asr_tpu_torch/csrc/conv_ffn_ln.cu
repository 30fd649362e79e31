// Fused conformer conv module, second FFN and output LayerNorm with int8
// weights (B=1 streaming chunks): one persistent cooperative launch a layer.
//
// Replaces: trt_asr_tpu/ops/pallas/conv_block_kernel.py:conv_ffn_ln_pallas
// (its pallas_call at :184). The kernel is conv_tail<int8_t, true> of
// csrc/conv_tail.cuh, whose notes give the function and the design; the
// conv module alone with int8 weights is conv_tail<int8_t, false>
// (csrc/conv_block_q8.cu).
//
// Bound on the H100: memory. At full width (D 1024, E 4096, Tq 8) the four
// weights are 11.5 MB of int8, 3.4 us at 3.35 TB/s; the products are 185
// MFLOP, 0.2 us at the bf16 tensor-core rate.
#include "conv_tail.cuh"

namespace port {

__global__ void __launch_bounds__(TL_THREADS, 1) conv_ffn_ln_kernel(TailArgs p) {
  conv_tail<int8_t, true>(p);
}

}  // namespace port

using namespace port;

static int tail_smem_set = -1;       // the kernel's dynamic shared memory limit, as set

static cudaError_t set_tail_smem(int smem) {
  const cudaError_t err = cudaFuncSetAttribute(
      conv_ffn_ln_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  tail_smem_set = err == cudaSuccess ? smem : -1;
  return err;
}

// x, y, c [M, D] f32; tc [(kk - 1) / 2, D] (the time cache); mask [M] (1 =
// valid step, 0 = padded); the LayerNorms' g and b [D]; packed: the layer's
// weights and per-column constants, [blocks][tail_blob(D, E, kk, cD, cE)
// .total] bytes (ops/kernels/conv_block.py:pack_conv_ffn_ln); D and E
// multiples of 8. The launch plan (blocks, cD, cE, smem: dynamic shared
// bytes) comes from the wrapper and is checked against this file's
// layout. scratch holds
// M * (10 D + 2 E) bytes. Returns the CUDA error code
// (cudaErrorCooperativeLaunchTooLarge when the blocks cannot all be resident).
extern "C" int conv_ffn_ln_launch(const float* x, int M, int D, int E, int kk,
                                  const float* ln_g, const float* ln_b, const float* tc,
                                  const float* mask, const float* ff_ln_g, const float* ff_ln_b,
                                  const float* out_ln_g, const float* out_ln_b,
                                  const void* packed, int blocks, int cD, int cE, int smem,
                                  float* y, float* c, void* scratch, void* stream_ptr) {
  if (M < 1 || D < 8 || E < 8 || D % TL_GW || E % TL_GW || kk < 1 || kk % 2 == 0 ||
      cD < TL_GW || cE < TL_GW || cD % TL_GW || cE % TL_GW || blocks < 1 ||
      (size_t)blocks * cD < (size_t)D || (size_t)(blocks - 1) * cD >= (size_t)D ||
      (size_t)blocks * cE < (size_t)E ||
      tail_smem(M, D, E, kk, cD, cE).total != (size_t)smem)
    return (int)cudaErrorInvalidValue;
  if (smem != tail_smem_set) {
    const cudaError_t err = set_tail_smem(smem);
    if (err != cudaSuccess) return (int)err;
  }
  unsigned char* s = static_cast<unsigned char*>(scratch);
  const size_t md = (size_t)M * D;
  TailArgs p = {x, M, D, E, kk, cD, cE, ln_g, ln_b, tc, mask, ff_ln_g, ff_ln_b, out_ln_g,
                out_ln_b, static_cast<const unsigned char*>(packed), y, c,
                reinterpret_cast<bf16*>(s),
                reinterpret_cast<float*>(s + 2 * md),
                reinterpret_cast<bf16*>(s + 6 * md),
                reinterpret_cast<float*>(s + 6 * md + 2 * (size_t)M * E)};
  void* args[] = {&p};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)conv_ffn_ln_kernel, dim3(blocks), dim3(TL_THREADS), args, (size_t)smem,
      (cudaStream_t)stream_ptr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// info[0] = blocks of the kernel an SM holds with `smem` dynamic shared
// bytes (the CUDA occupancy API)
extern "C" int conv_ffn_ln_occupancy(int smem, int* info) {
  const cudaError_t err = set_tail_smem(smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], conv_ffn_ln_kernel,
                                                            TL_THREADS, (size_t)smem);
}
