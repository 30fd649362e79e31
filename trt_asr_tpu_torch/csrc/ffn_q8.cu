// Fused conformer feed-forward module with int8 weights: one persistent
// cooperative launch a call.
//
// Replaces: trt_asr_tpu/ops/pallas/ffn_kernel.py:fused_ffn_pallas (its
// pallas_call at :115) with int8 weights; f32 weights take csrc/ffn_f32.cu,
// bf16 weights the chain of csrc/ffn.cu. For M rows x of width D and the
// expansion E:
//   u = bf16(LN(x)); h = bf16(silu((u @ W1) * s1)); y = x + scale * ((h @ W2) * s2)
// W1 and W2 are int8 with a per-column f32 scale (s1 [E], s2 [D]) applied to
// the f32 sum, as the TPU kernel and the plain version apply it: s1 before
// the SiLU, s2 after the whole sum over E. u and h are rounded to bf16 (the
// TPU kernel's MXU operands); x and y are not.
//
// Bound on the H100: memory. At a steady chunk's M 8 (D 1024, E 4096) a call
// reads 8.39 MB of int8 weights and 20 KB of scales: 2.5 us at 3.35 TB/s;
// the products are 134 MFLOP, 0.14 us at the bf16 tensor-core rate.
//
// Design. As csrc/conv_ffn_ln.cu's phases (d)-(e): one cooperative launch,
// one block an SM, 512 threads; block b owns cE expansion columns of W1 (32
// at full width, 128 blocks; the wrapper's plan, ops/kernels/ffn.py:
// ffn_q8_plan) and cD columns of W2 over the whole of E (8), both slices
// whole in shared memory (32 KB each at full width), packed once with the
// block's scales (ops/kernels/ffn.py:pack_ffn_q8), a block's slice
// contiguous. Thread 0 issues one bulk copy for x's rows and the norms,
// then one for W1 with the scales, and once W1 has landed one for W2
// (issued at once, the two slices share the memory's rate and W1 lands ~1
// us later); the weights' copies carry an L2 evict-first policy. Phases, 8
// rows a pass:
//   (a) u = bf16(LN(x)) of the pass's rows (every block, one warp a row);
//   (b) W1 on the block's cE columns (block_product: warp w sums its run
//       of K, the warps' sums added in order), times s1, SiLU, rounded to
//       bf16: the block's columns of h, 512 bytes, to scratch;
//   grid barrier;
//   (c) h's rows (8 KB each) bulk-copied out of L2 in four K chunks, each
//       warp starting once its own has landed; W2 on the block's cD
//       columns (block_product over K = E), times s2, times scale, plus x.
// This splits W2 by its columns rather than by the expansion (each block's
// [8, D] partial of y to scratch, all of them added after the barrier, as
// csrc/ffn_f32.cu does): that split wrote 4 MB of partials and read them
// back, 3 us of stores and 1.7 us of reading and adding at full width
// (tail_variants.py --ffn), against 512 B of h written and 64 KB read a
// block here. (In f32 h would be 128 KB a block.)
// Products: tensor cores, mma.sync.m16n8k16 (bf16 operands, f32 sums), the
// 8 rows as A (rows 8 .. 15 zero) and 8 weight columns as B; the int8
// weights widen exactly to bf16 in registers. Every sum runs in a fixed
// order (no atomics): the kernel is deterministic, and a captured CUDA
// graph replays it bit for bit (chip_smoke.py phase 2). Passes of more than
// 8 rows alternate between two buffers of h (the barrier of pass p + 1
// comes after every block has read pass p's); the weights stay in shared
// memory. With TAIL_TIMELINE defined, thread 0 of each block records the
// phases (tail_variants.py --ffn).
#include <cooperative_groups.h>

#include "persistent.cuh"

namespace port {

namespace cg = cooperative_groups;

constexpr int FQ_SLICE = 32;              // expansion columns a block takes a multiple of

// mbarriers of the bulk copies: x's rows (and, in the first pass, the
// norms); W1's slice with the scales; W2's slice; the four K chunks of h's
// rows
enum { FQ_X, FQ_W1, FQ_W2, FQ_CHUNK, FQ_BARS = FQ_CHUNK + 4 };

// A block's packed slice (pack_ffn_q8 in ops/kernels/ffn.py), byte offsets:
// W1's cE columns [cE / 8][Dp / 16][8][16] int8 at 0; the f32 columns s1
// [cE], s2 [cD] at cols; W2's cD columns [cD / 8][Ep / 16][8][16] int8 at
// w2. Zero past D and E.
struct FqBlob {
  size_t cols, w2, total;
};

__host__ __device__ inline FqBlob fq_blob(int D, int E, int cE, int cD) {
  FqBlob b;
  b.cols = (size_t)tail_pad(D) * cE;
  b.w2 = b.cols + (size_t)(cE + cD) * 4;
  b.total = b.w2 + (size_t)tail_pad(E) * cD;
  return b;
}

// Byte offsets of the dynamic shared memory, mirrored by the wrapper's plan.
struct FqSmem {
  size_t w, act, xs, norms, red, bars, total;
};

__host__ __device__ inline FqSmem fq_smem(int D, int E, int cE, int cD) {
  const size_t act_d = (size_t)TL_MR * (tail_pad(D) + TL_KS) * 2;
  const size_t act_e = (size_t)TL_MR * (tail_pad(E) + TL_KS) * 2;
  FqSmem s;
  size_t o = 0;
  s.w = o;     o += fq_blob(D, E, cE, cD).total;                     // the block's slices
  s.act = o;   o += act_d > act_e ? act_d : act_e;                   // u's rows, then h's (bf16)
  s.xs = o;    o += (size_t)TL_MR * D * 4;                           // x's rows
  s.norms = o; o += (size_t)2 * D * 4;                               // LN's g, b
  s.red = o;   o += (size_t)TL_WARPS * tail_max(cE, cD) * TL_MR * 4;  // per-warp sums
  s.bars = o;  o += FQ_BARS * 8;
  s.total = o;
  return s;
}

struct FqArgs {
  const float* x;
  int M, D, E, cE, cD;
  const float *ln_g, *ln_b;
  const unsigned char* packed;            // [blocks][fq_blob bytes]
  float scale;
  float* y;
  bf16* h;                                // scratch: [2][8][E], a buffer a pass
};

__global__ void __launch_bounds__(TL_THREADS, 1) ffn_q8_kernel(FqArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int M = p.M, D = p.D, E = p.E, cE = p.cE, cD = p.cD;
  const FqSmem L = fq_smem(D, E, cE, cD);
  const FqBlob B = fq_blob(D, E, cE, cD);
  const int8_t* w1 = reinterpret_cast<const int8_t*>(smem + L.w);
  const float* s1 = reinterpret_cast<const float*>(smem + L.w + B.cols);   // [cE]
  const float* s2 = s1 + cE;                                                 // [cD]
  const int8_t* w2 = reinterpret_cast<const int8_t*>(smem + L.w + B.w2);
  bf16* act = reinterpret_cast<bf16*>(smem + L.act);
  float* xs = reinterpret_cast<float*>(smem + L.xs);          // [8][D]
  float* norms = reinterpret_cast<float*>(smem + L.norms);
  float* red = reinterpret_cast<float*>(smem + L.red);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  const int Dp = tail_pad(D), Ep = tail_pad(E), pd = Dp + TL_KS, pe = Ep + TL_KS;
  const int e0 = blockIdx.x * cE, n0 = blockIdx.x * cD, ge = cE / TL_GW, gd = cD / TL_GW;
  const unsigned char* mine = p.packed + (size_t)blockIdx.x * B.total;
  const uint32_t nb = D * 4;
  const cg::grid_group grid = cg::this_grid();
  TL_MARK(0);

  // Thread 0: x's first rows and the norms, then W1 (x first: the LN runs
  // while W1 lands), each group on its own mbarrier
  if (threadIdx.x == 0) {
    for (int i = 0; i < FQ_BARS; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const uint32_t xb = min(TL_MR, M) * nb;
    mbar_expect(bars + FQ_X, xb + 2 * nb);
    bulk_copy(xs, p.x, xb, bars + FQ_X);
    bulk_copy(norms, p.ln_g, nb, bars + FQ_X);
    bulk_copy(norms + D, p.ln_b, nb, bars + FQ_X);
    mbar_expect(bars + FQ_W1, (uint32_t)B.w2);
    bulk_copy_hint(smem + L.w, mine, (uint32_t)B.w2, bars + FQ_W1, evict_first());
  }
  __syncthreads();                          // the mbarriers are ready
  TL_MARK(1);
  for (int m0 = 0, pass = 0; m0 < M; m0 += TL_MR, ++pass) {
    const int mr = min(TL_MR, M - m0), parity = pass & 1;
    bf16* h = p.h + (size_t)parity * TL_MR * E;
    if (pass > 0) {
      __syncthreads();                      // the previous pass has read xs and act
      if (threadIdx.x == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bulk_rows(xs, 0, p.x + (size_t)m0 * D, 0, 1, mr * nb, bars + FQ_X);
      }
    }
    mbar_wait(bars + FQ_X, parity);
    TL_MARK(2);

    // (a) u = bf16(LN(x)) into the operand rows; thread 0 issues W2's copy
    // once W1 has landed
    ln_rows(act, pd, xs, mr, D, norms, norms + D);
    mbar_wait(bars + FQ_W1);
    if (threadIdx.x == 0 && pass == 0) {
      mbar_expect(bars + FQ_W2, (uint32_t)(B.total - B.w2));
      bulk_copy_hint(smem + L.w + B.w2, mine + B.w2, (uint32_t)(B.total - B.w2), bars + FQ_W2,
                     evict_first());
    }
    __syncthreads();
    TL_MARK(3);

    // (b) the block's columns of h = bf16(silu(s1 * u @ W1)), to scratch
    block_product(act, pd, w1, Dp, ge, red, nullptr, 0, 17);
    for (int i = threadIdx.x; i < TL_MR * cE; i += TL_THREADS) {
      const int r = i / cE, j = i - r * cE;
      if (e0 + j < E)
        h[(size_t)r * E + e0 + j] =
            __float2bfloat16_rn(silu_f(__fmul_rn(product_sum(red, ge, r, j), s1[j])));
    }
    TL_MARK(4);
    grid.sync();
    TL_MARK(5);

    // (c) y = x + scale * s2 * (h @ W2) on the block's cD columns: h's rows
    // (written by every block) in four K chunks in place of u's
    if (n0 < D) {
      bulk_chunks(act, pe, h, 0, mr, E, bars + FQ_CHUNK);
      zero_pad(act, pe, mr, E);
      mbar_wait(bars + FQ_W2);
      __syncthreads();
      TL_MARK(6);
      block_product(act, pe, w2, Ep, gd, red, bars + FQ_CHUNK, parity, 19);
      for (int i = threadIdx.x; i < mr * cD; i += TL_THREADS) {
        const int r = i / cD, j = i - r * cD, n = n0 + j;
        if (n < D)
          p.y[(size_t)(m0 + r) * D + n] = __fadd_rn(
              xs[(size_t)r * D + n],
              __fmul_rn(p.scale, __fmul_rn(product_sum(red, gd, r, j), s2[j])));
      }
    }
    TL_MARK(7);
  }
}

}  // namespace port

using namespace port;

static int fq_smem_set = -1;         // the kernel's dynamic shared memory limit, as set

static cudaError_t set_fq_smem(int smem) {
  const cudaError_t err =
      cudaFuncSetAttribute(ffn_q8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  fq_smem_set = err == cudaSuccess ? smem : -1;
  return err;
}

// x, y [M, D] f32 (16-byte aligned, D a multiple of 8); the LN's g, b [D];
// packed: the weights and their scales, [blocks][fq_blob(D, E, cE, cD)
// .total] bytes (ops/kernels/ffn.py:pack_ffn_q8, 16-byte aligned). The
// launch plan (blocks, cE, cD, smem: dynamic shared bytes) comes from the
// wrapper and is checked against this file's layout. scratch holds 2 * 8 *
// E bf16 (16-byte aligned; E a multiple of 8). Returns the CUDA error code
// (cudaErrorCooperativeLaunchTooLarge when the blocks cannot all be
// resident).
extern "C" int ffn_q8_launch(const float* x, int M, int D, int E, const float* ln_g,
                             const float* ln_b, const void* packed, int blocks, int cE, int cD,
                             int smem, float scale, float* y, void* scratch, void* stream_ptr) {
  if (M < 1 || D < TL_GW || D % TL_GW || E < TL_GW || E % TL_GW || cE < FQ_SLICE ||
      cE % FQ_SLICE || blocks < 1 || (size_t)blocks * cE < (size_t)E ||
      (size_t)(blocks - 1) * cE >= (size_t)E || cD < TL_GW || cD % TL_GW ||
      (size_t)blocks * cD < (size_t)D || fq_smem(D, E, cE, cD).total != (size_t)smem)
    return (int)cudaErrorInvalidValue;
  if (smem != fq_smem_set) {
    const cudaError_t err = set_fq_smem(smem);
    if (err != cudaSuccess) return (int)err;
  }
  FqArgs p = {x, M, D, E, cE, cD, ln_g, ln_b, static_cast<const unsigned char*>(packed), scale,
              y, static_cast<bf16*>(scratch)};
  void* args[] = {&p};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)ffn_q8_kernel, dim3(blocks), dim3(TL_THREADS), args, (size_t)smem,
      (cudaStream_t)stream_ptr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// info[0] = blocks of the kernel an SM holds with `smem` dynamic shared
// bytes (the CUDA occupancy API)
extern "C" int ffn_q8_occupancy(int smem, int* info) {
  const cudaError_t err = set_fq_smem(smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], ffn_q8_kernel, TL_THREADS,
                                                            (size_t)smem);
}
