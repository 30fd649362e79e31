// Fused conformer feed-forward module with bf16 weights: one persistent
// cooperative launch a call.
//
// Replaces: trt_asr_tpu/ops/pallas/ffn_kernel.py:fused_ffn_pallas (its
// pallas_call at :115) with bf16 weights (those of cast_params_for_compute);
// int8 weights take csrc/ffn_q8.cu, f32 weights csrc/ffn_f32.cu. It took the
// place of the five launches of csrc/ffn.cu, which stay for chip_smoke.py to
// time beside it. For M rows x of width D and the expansion E:
//   u = bf16(LN(x)); h = bf16(silu(u @ W1)); y = x + scale * (h @ W2)
// u and h are rounded to bf16 (the TPU kernel's MXU operands); every sum is
// f32; x and y are not rounded.
//
// Bound on the H100: memory. At a steady chunk's M 8 (D 1024, E 4096) a call
// reads 16.8 MB of bf16 weights: 5.0 us at 3.35 TB/s; the products are 134
// MFLOP, 0.14 us at the bf16 tensor-core rate.
//
// Design: the split of csrc/ffn_q8.cu (its notes say more). One cooperative
// launch, one block an SM, 512 threads; block b owns cE = 32 expansion
// columns of W1 and cD = 8 columns of W2 over the whole of E (128 blocks at
// full width; the wrapper's plan, ops/kernels/ffn.py:ffn_bf16_plan), both
// slices whole in shared memory, 64 KB each at full width, packed once
// (ops/kernels/ffn.py:pack_ffn_bf16), a block's slice contiguous. A bf16
// copy of ffn_q8.cu's layout would take ~254 KB against the 227 KB a block
// may have; it fits at 221 KB because x's rows (32 KB, read only by the
// LayerNorm: the residual is read from device memory) lie in the operand
// buffer of h's rows past u's, which h's rows overwrite only after the grid
// barrier. So neither slice waits for the other's room: thread 0 issues x's
// rows and the norms, then W1, and W2 once W1 has landed (the two share the
// memory's rate; W2's copy runs under phase (b) and the barrier), the
// weights under an L2 evict-first policy. (W2 copied into W1's room once
// phase (b) has read W1 is the other way to fit: tail_variants.py --ffn
// --bf16 --w2-late times that copy's order against this one.) Phases, 8
// rows a pass:
//   (a) u = bf16(LN(x)) of the pass's rows (every block, one warp a row);
//   (b) W1 on the block's cE columns on the tensor cores (block_product:
//       mma.sync.m16n8k16, bf16 operands, f32 sums; warp w sums its run of
//       K, the warps' sums added in order), SiLU, rounded to bf16: the
//       block's columns of h, to scratch;
//   grid barrier;
//   (c) h's rows bulk-copied out of L2 in four K chunks, each warp starting
//       once its own has landed; W2 on the block's cD columns
//       (block_product over K = E), times scale, plus x.
// Every sum runs in a fixed order (no atomics): the kernel is deterministic,
// and a captured CUDA graph replays it bit for bit (chip_smoke.py phase 2).
// Passes of more than 8 rows alternate between two buffers of h (the
// barrier of pass p + 1 comes after every block has read pass p's); the
// weights stay in shared memory. With TAIL_TIMELINE defined, thread 0 of
// each block records the phases (tail_variants.py --ffn --bf16).
#include <cooperative_groups.h>

#include "persistent.cuh"

namespace port {

namespace cg = cooperative_groups;

constexpr int FB_SLICE = 32;              // expansion columns a block takes a multiple of

// mbarriers of the bulk copies: x's rows (and, in the first pass, the
// norms); W1's slice; W2's slice; the four K chunks of h's rows
enum { FB_X, FB_W1, FB_W2, FB_CHUNK, FB_BARS = FB_CHUNK + 4 };

// A block's packed slice (pack_ffn_bf16 in ops/kernels/ffn.py), in bf16
// elements: W1's cE columns [cE / 8][Dp / 16][8][16] at 0, W2's cD columns
// [cD / 8][Ep / 16][8][16] at w2. Zero past D and E.
struct FbBlob {
  size_t w2, total;
};

__host__ __device__ inline FbBlob fb_blob(int D, int E, int cE, int cD) {
  FbBlob b;
  b.w2 = (size_t)tail_pad(D) * cE;
  b.total = b.w2 + (size_t)tail_pad(E) * cD;
  return b;
}

// Byte offsets of the dynamic shared memory, mirrored by the wrapper's plan:
// the operand buffer holds u's rows then, from xs on, x's rows; after the
// barrier h's rows over both.
struct FbSmem {
  size_t w, act, xs, norms, red, bars, total;
};

__host__ __device__ inline FbSmem fb_smem(int D, int E, int cE, int cD) {
  const size_t act_d = (size_t)TL_MR * (tail_pad(D) + TL_KS) * 2;
  const size_t act_e = (size_t)TL_MR * (tail_pad(E) + TL_KS) * 2;
  const size_t act_x = act_d + (size_t)TL_MR * D * 4;
  FbSmem s;
  size_t o = 0;
  s.w = o;     o += fb_blob(D, E, cE, cD).total * 2;                 // the block's slices
  s.act = o;   s.xs = o + act_d;
  o += act_x > act_e ? act_x : act_e;                                // u's, x's, then h's rows
  s.norms = o; o += (size_t)2 * D * 4;                               // LN's g, b
  s.red = o;   o += (size_t)TL_WARPS * tail_max(cE, cD) * TL_MR * 4;  // per-warp sums
  s.bars = o;  o += FB_BARS * 8;
  s.total = o;
  return s;
}

struct FbArgs {
  const float* x;
  int M, D, E, cE, cD;
  const float *ln_g, *ln_b;
  const bf16* packed;                     // [blocks][fb_blob elements]
  float scale;
  float* y;
  bf16* h;                                // scratch: [2][8][E], a buffer a pass
};

__global__ void __launch_bounds__(TL_THREADS, 1) ffn_bf16_kernel(FbArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int M = p.M, D = p.D, E = p.E, cE = p.cE, cD = p.cD;
  const FbSmem L = fb_smem(D, E, cE, cD);
  const FbBlob B = fb_blob(D, E, cE, cD);
  const bf16* w1 = reinterpret_cast<const bf16*>(smem + L.w);
  const bf16* w2 = w1 + B.w2;
  bf16* act = reinterpret_cast<bf16*>(smem + L.act);
  float* xs = reinterpret_cast<float*>(smem + L.xs);          // [8][D]
  float* norms = reinterpret_cast<float*>(smem + L.norms);
  float* red = reinterpret_cast<float*>(smem + L.red);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  const int Dp = tail_pad(D), Ep = tail_pad(E), pd = Dp + TL_KS, pe = Ep + TL_KS;
  const int e0 = blockIdx.x * cE, n0 = blockIdx.x * cD, ge = cE / TL_GW, gd = cD / TL_GW;
  const bf16* mine = p.packed + (size_t)blockIdx.x * B.total;
  const uint32_t nb = D * 4;
  const cg::grid_group grid = cg::this_grid();
  TL_MARK(0);

  // Thread 0: x's first rows and the norms, then W1 (x first: the LN runs
  // while W1 lands), each group on its own mbarrier
  if (threadIdx.x == 0) {
    for (int i = 0; i < FB_BARS; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const uint32_t xb = min(TL_MR, M) * nb;
    mbar_expect(bars + FB_X, xb + 2 * nb);
    bulk_copy(xs, p.x, xb, bars + FB_X);
    bulk_copy(norms, p.ln_g, nb, bars + FB_X);
    bulk_copy(norms + D, p.ln_b, nb, bars + FB_X);
    mbar_expect(bars + FB_W1, (uint32_t)(B.w2 * 2));
    bulk_copy_hint(smem + L.w, mine, (uint32_t)(B.w2 * 2), bars + FB_W1, evict_first());
  }
  __syncthreads();                          // the mbarriers are ready
  TL_MARK(1);
  for (int m0 = 0, pass = 0; m0 < M; m0 += TL_MR, ++pass) {
    const int mr = min(TL_MR, M - m0), parity = pass & 1;
    bf16* h = p.h + (size_t)parity * TL_MR * E;
    if (pass > 0) {
      __syncthreads();                      // the previous pass has read act
      if (threadIdx.x == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bulk_rows(xs, 0, p.x + (size_t)m0 * D, 0, 1, mr * nb, bars + FB_X);
      }
    }
    mbar_wait(bars + FB_X, parity);
    TL_MARK(2);

    // (a) u = bf16(LN(x)) into the operand rows; thread 0 issues W2's copy
    // once W1 has landed
    ln_rows(act, pd, xs, mr, D, norms, norms + D);
    mbar_wait(bars + FB_W1);
    if (threadIdx.x == 0 && pass == 0) {
      mbar_expect(bars + FB_W2, (uint32_t)((B.total - B.w2) * 2));
      bulk_copy_hint(smem + L.w + B.w2 * 2, mine + B.w2, (uint32_t)((B.total - B.w2) * 2),
                     bars + FB_W2, evict_first());
    }
    __syncthreads();
    TL_MARK(3);

    // (b) the block's columns of h = bf16(silu(u @ W1)), to scratch
    block_product(act, pd, w1, Dp, ge, red, nullptr, 0, 17);
    for (int i = threadIdx.x; i < TL_MR * cE; i += TL_THREADS) {
      const int r = i / cE, j = i - r * cE;
      if (e0 + j < E)
        h[(size_t)r * E + e0 + j] = __float2bfloat16_rn(silu_f(product_sum(red, ge, r, j)));
    }
    TL_MARK(4);
    grid.sync();
    TL_MARK(5);

    // (c) y = x + scale * (h @ W2) on the block's cD columns: h's rows
    // (written by every block) in four K chunks in place of u's and x's
    if (n0 < D) {
      bulk_chunks(act, pe, h, 0, mr, E, bars + FB_CHUNK);
      zero_pad(act, pe, mr, E);
      mbar_wait(bars + FB_W2);
      __syncthreads();
      TL_MARK(6);
      block_product(act, pe, w2, Ep, gd, red, bars + FB_CHUNK, parity, 19);
      for (int i = threadIdx.x; i < mr * cD; i += TL_THREADS) {
        const int r = i / cD, j = i - r * cD, n = n0 + j;
        if (n < D)
          p.y[(size_t)(m0 + r) * D + n] = __fadd_rn(
              p.x[(size_t)(m0 + r) * D + n], __fmul_rn(p.scale, product_sum(red, gd, r, j)));
      }
    }
    TL_MARK(7);
  }
}

}  // namespace port

using namespace port;

static int fb_smem_set = -1;         // the kernel's dynamic shared memory limit, as set

static cudaError_t set_fb_smem(int smem) {
  const cudaError_t err =
      cudaFuncSetAttribute(ffn_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  fb_smem_set = err == cudaSuccess ? smem : -1;
  return err;
}

// x, y [M, D] f32 (16-byte aligned, D a multiple of 8); the LN's g, b [D];
// packed: the bf16 weights, [blocks][fb_blob(D, E, cE, cD).total] bf16
// (ops/kernels/ffn.py:pack_ffn_bf16, 16-byte aligned). The launch plan
// (blocks, cE, cD, smem: dynamic shared bytes) comes from the wrapper and is
// checked against this file's layout. scratch holds 2 * 8 * E bf16 (16-byte
// aligned; E a multiple of 8). Returns the CUDA error code
// (cudaErrorCooperativeLaunchTooLarge when the blocks cannot all be
// resident).
extern "C" int ffn_bf16_launch(const float* x, int M, int D, int E, const float* ln_g,
                               const float* ln_b, const void* packed, int blocks, int cE,
                               int cD, int smem, float scale, float* y, void* scratch,
                               void* stream_ptr) {
  if (M < 1 || D < TL_GW || D % TL_GW || E < TL_GW || E % TL_GW || cE < FB_SLICE ||
      cE % FB_SLICE || blocks < 1 || (size_t)blocks * cE < (size_t)E ||
      (size_t)(blocks - 1) * cE >= (size_t)E || cD < TL_GW || cD % TL_GW ||
      (size_t)blocks * cD < (size_t)D || fb_smem(D, E, cE, cD).total != (size_t)smem)
    return (int)cudaErrorInvalidValue;
  if (smem != fb_smem_set) {
    const cudaError_t err = set_fb_smem(smem);
    if (err != cudaSuccess) return (int)err;
  }
  FbArgs p = {x, M, D, E, cE, cD, ln_g, ln_b, static_cast<const bf16*>(packed), scale, y,
              static_cast<bf16*>(scratch)};
  void* args[] = {&p};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)ffn_bf16_kernel, dim3(blocks), dim3(TL_THREADS), args, (size_t)smem,
      (cudaStream_t)stream_ptr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// info[0] = blocks of the kernel an SM holds with `smem` dynamic shared
// bytes (the CUDA occupancy API)
extern "C" int ffn_bf16_occupancy(int smem, int* info) {
  const cudaError_t err = set_fb_smem(smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], ffn_bf16_kernel,
                                                            TL_THREADS, (size_t)smem);
}
