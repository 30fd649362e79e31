// Fused conformer conv module with bf16 weights (B=1 streaming chunks): one
// persistent cooperative launch a call.
//
// Replaces: trt_asr_tpu/ops/pallas/conv_block_kernel.py:conv_block_pallas
// (its pallas_call at :99) with bf16 weights (those of
// cast_params_for_compute); int8 weights take csrc/conv_block_q8.cu, f32
// weights csrc/conv_block_f32.cu. It took the place of the five launches of
// csrc/conv_block.cu, which stay for chip_smoke.py to time beside it. For
// the Tq rows x of one layer:
//   u = bf16(LN(x)); hw = u @ pw1; c = hw[:, :D] * sigmoid(hw[:, D:]) * mask
//   a = bf16(silu(BN(depthwise taps over [time cache ++ c ++ 0])))
//   y = x + a @ pw2
// and returns (y, c). Every sum is f32; x, c and y are not rounded. The time
// cache is read as stored, f32 or bf16 (a bf16 encoder state), widened
// exactly where it is read.
//
// Bound on the H100: memory. At a steady chunk's Tq 8 (D 1024, a 9-tap
// conv) a call reads 6.3 MB of bf16 weights: 1.9 us at 3.35 TB/s; the
// products are 50 MFLOP, 0.05 us at the bf16 tensor-core rate.
//
// Design: the int8 conv module's plan (csrc/conv_block_q8.cu), the fused
// tail's phases (a)-(c), conv_tail<bf16, false> of csrc/conv_tail.cuh (its
// notes give the phases): 128 blocks at full width, block b owning cD = 8
// columns of pw1 (with their GLU gates) and of pw2 over the whole K, one grid
// barrier between the conv and pw2. A block's constants (48 KB of bf16
// slices in int8's [K/16][8][16] groups, which feed the mma as they are, no
// scales; 416 B of taps and BN) are packed once, when the model's weights
// are made (ops/kernels/conv_block.py:pack_conv_block), a block's slice
// contiguous: 116 KB of shared memory, one block an SM. Its bf16 columns of
// a go through a scratch [Tq, D] in L2. Every sum runs in a fixed order (no
// atomics): the kernel is deterministic, and a captured CUDA graph replays
// it bit for bit (chip_smoke.py phase 2). With TAIL_TIMELINE defined,
// thread 0 of each block records the phases.
#include "conv_tail.cuh"

namespace port {

__global__ void __launch_bounds__(TL_THREADS, 1) conv_block_bf16_kernel(TailArgs p) {
  conv_tail<bf16, false>(p);
}

}  // namespace port

using namespace port;

static int cb_smem_set = -1;         // the kernel's dynamic shared memory limit, as set

static cudaError_t set_cb_smem(int smem) {
  const cudaError_t err = cudaFuncSetAttribute(
      conv_block_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cb_smem_set = err == cudaSuccess ? smem : -1;
  return err;
}

// x, y, c [M, D] f32 (16-byte aligned, D a multiple of 8); tc [(kk - 1) / 2,
// D] (the time cache: f32, or bf16 when tc_bf16 is set); mask [M] (1 = valid
// step, 0 = padded); LN's g and b [D]; packed: the layer's bf16 weights and
// f32 taps and BN, [blocks][tail_blob(D, 0, kk, cD, 0, 2, false).total]
// bytes (ops/kernels/conv_block.py:pack_conv_block, 16-byte aligned). The
// launch plan (blocks, cD, smem: dynamic shared bytes) comes from the
// wrapper and is checked against the layout. scratch holds M * D bf16.
// Returns the CUDA error code (cudaErrorCooperativeLaunchTooLarge when the
// blocks cannot all be resident).
extern "C" int conv_block_bf16_launch(const float* x, int M, int D, int kk, const float* ln_g,
                                      const float* ln_b, const void* tc, int tc_bf16,
                                      const float* mask, const void* packed, int blocks, int cD,
                                      int smem, float* y, float* c, void* scratch,
                                      void* stream_ptr) {
  if (M < 1 || D < TL_GW || D % TL_GW || kk < 1 || kk % 2 == 0 || cD < TL_GW ||
      cD % TL_GW || blocks < 1 || (size_t)blocks * cD < (size_t)D ||
      (size_t)(blocks - 1) * cD >= (size_t)D ||
      tail_smem(M, D, 0, kk, cD, 0, 2, false).total != (size_t)smem)
    return (int)cudaErrorInvalidValue;
  if (smem != cb_smem_set) {
    const cudaError_t err = set_cb_smem(smem);
    if (err != cudaSuccess) return (int)err;
  }
  TailArgs p = {x, M, D, 0, kk, cD, 0, ln_g, ln_b, tc, mask, nullptr, nullptr, nullptr,
                nullptr, static_cast<const unsigned char*>(packed), y, c,
                static_cast<bf16*>(scratch), nullptr, nullptr, nullptr, tc_bf16 != 0};
  void* args[] = {&p};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)conv_block_bf16_kernel, dim3(blocks), dim3(TL_THREADS), args, (size_t)smem,
      (cudaStream_t)stream_ptr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// info[0] = blocks of the kernel an SM holds with `smem` dynamic shared
// bytes (the CUDA occupancy API)
extern "C" int conv_block_bf16_occupancy(int smem, int* info) {
  const cudaError_t err = set_cb_smem(smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], conv_block_bf16_kernel,
                                                            TL_THREADS, (size_t)smem);
}
