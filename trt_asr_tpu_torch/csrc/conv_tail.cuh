// The conformer conv module for B=1 streaming chunks as one persistent
// cooperative launch: the one body, conv_tail<WT, FFN>, of the conv module
// alone with int8 weights (csrc/conv_block_q8.cu) and with bf16 weights
// (csrc/conv_block_bf16.cu), FFN false, and of the int8 conv module
// followed by the second FFN and the output LayerNorm (csrc/conv_ffn_ln.cu,
// FFN true). For the Tq rows x of one layer:
//   u = LN_conv(x); hw = u @ pw1 (D -> 2D); c = hw[:, :D] * sigmoid(hw[:, D:])
//   c = c * mask (padded steps are zero); ext = tc ((K-1)/2 rows) ++ c ++ 0
//   cv[t] = sum_j ext[t + j] * dw[j]; a = silu((cv - m) * g * rsqrt(v + 1e-5) + b)
//   y1 = x + a @ pw2
// and, with FFN, h = silu(LN_ff(y1) @ W1); y2 = y1 + 0.5 * h @ W2;
// y = LN_out(y2); without it y = y1. Returns (y, c), c being the rows that
// feed the time cache. An int8 weight (WT int8_t) is an int8 matrix [K, N]
// with a per-column f32 scale applied to the f32 sum; a bf16 weight (WT
// bf16) has no scale. The product operands u, a, LN_ff(y1) and h are
// rounded to bf16 (the TPU kernel's MXU operands); x, c and the residual
// stream are not. The int8 kernels read an f32 time cache; the bf16 one an
// f32 or a bf16 cache as stored, widened exactly where it is read.
//
// Design. One cooperative launch (cudaLaunchCooperativeKernel: every block
// co-resident, one an SM; grid-wide barriers by cooperative_groups). Block
// b owns a fixed column slice of each product over the whole K, so no
// split-K partial sums reach device memory: cD columns of pw1 (n and its
// GLU gate n + D together), of pw2 and of W2, and cE columns of W1 (cD = 8,
// cE = 32 and 128 blocks at full width; the wrapper's plans,
// ops/kernels/conv_block.py:conv_ffn_ln_plan, conv_block_q8_plan and
// conv_block_bf16_plan). The conv module alone is the FFN case with E = cE
// = 0: its blob, its shared memory and its scratch hold nothing of the FFN.
//
// Weights. A block's 8 columns of a [K, N] int8 matrix are 8 bytes a row,
// too narrow for a 16-byte copy and a quarter of a 32-byte sector. So each
// layer's constants are packed once, when its weights are made
// (ops/kernels/conv_block.py:pack_tail): block b's slices of the weights
// and its f32 columns of the scales (int8 only), taps and BN lie contiguous
// (tail_blob); bf16 slices lie in the same [K/16][8][16] groups, twice the
// bytes. Thread 0 starts bulk copies (the copy engine, each on its own
// mbarrier): x's first rows, LN_conv's g and b, the columns and pw1 at
// entry, the rest of the weights once x has landed; each phase waits for
// its own bytes only.
//
// Phases:
//   (a) LN_conv of all rows, in every block (one warp a row);
//   (b) pw1 on the block's GLU pairs, GLU, mask, c; the depthwise taps over
//       [time cache ++ c ++ 0], BatchNorm, SiLU: column-local, since the
//       conv mixes rows, not columns; a is written as bf16;
//   barrier; (c) pw2 + x -> y1 (without FFN: y, and the kernel ends);
//   barrier; (d) LN_ff of all rows in every block, W1, SiLU -> h (bf16);
//   barrier; (e) W2 * 0.5 + y1 -> y2;
//   barrier; (f) LN_out, one row a block.
// After a barrier, the rows other blocks wrote are bulk-copied out of L2
// (a, h in four K chunks, so a warp's product starts when its chunk has
// landed) or read with __ldcg, never through a possibly stale L1 line.
//
// Products: tensor cores, mma.sync.m16n8k16 (bf16 operands, f32 sums) with
// the 8 rows as A (rows 8 .. 15 zero) and 8 weight columns as B; the int8
// weights widen exactly to bf16 in registers (byte permutes and one bf16
// subtraction), bf16 weights feed the mma as they are. Each warp sums its
// run of K; the warps' sums are added in a fixed order, so the kernel is
// deterministic (no atomics). Rows are taken 8 at a time, so any Tq runs.
//
// CUDA graphs: the cooperative launch can be captured. chip_smoke.py phase
// 2 captures one call of each kernel into a torch.cuda.CUDAGraph, replays
// it and fails unless the replay equals the direct call.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "persistent.cuh"

namespace port {

namespace cg = cooperative_groups;

// mbarriers of the bulk copies: x's first rows, LN_conv's norms and the
// block's f32 columns; the weight slices pw1, pw2, W1, W2; LN_ff's norms
// (and, in a row's block, LN_out's); the f32 rows a phase stages; the four
// K chunks of a product's operand rows (each reused, phase by phase)
enum { BAR_X, BAR_PW1, BAR_PW2, BAR_W1, BAR_W2, BAR_NORMS, BAR_ROWS, BAR_CHUNK, TL_BARS =
       BAR_CHUNK + 4 };

struct TailArgs {
  const float* x;
  int M, D, E, kk, cD, cE;                // E = cE = 0: the conv module alone
  const float *ln_g, *ln_b;
  const void* tc;                         // [(kk - 1) / 2, D]: f32, or bf16 with tc_bf16
  const float *mask, *ff_g, *ff_b, *out_g, *out_b;
  const unsigned char* packed;            // [blocks][tail_blob bytes], see tail_blob
  float *y, *c;
  bf16* a;                                // scratch: [M, D] bf16
  float* y1;                              // [M, D]
  bf16* h;                                // [M, E] bf16
  float* y2;                              // [M, D]
  int tc_bf16;                            // the time cache is bf16 (bf16 weights only)
};

// A block's packed slice of the layer's constants (pack_tail in
// ops/kernels/conv_block.py), byte offsets, in the order of the weights' shared memory:
//   pw1 [2 cD / 8][Dp / 16][8][16] int8 or bf16 (the groups of columns n,
//   then those of their gates n + D), pw2 [cD / 8][Dp / 16][8][16], W1 [cE /
//   8][Dp / 16][8][16], W2 [cD / 8][Ep / 16][8][16]; then f32 columns: with
//   int8 weights pw1's scales (n, then n + D), pw2's, W1's, W2's; the conv
//   taps [kk][cD], BN g, b, m, v: each [cD] (W1's [cE]), zero past D (E) and
//   K past its end. The conv module alone (E = cE = 0) has neither W1, W2
//   nor their scales. wb: bytes a weight (1 int8, 2 bf16); sc: int8's scales.
struct TailBlob {
  size_t pw1, pw2, w1, w2, cols, total;
};

__host__ __device__ inline int tail_cols(int kk, int cD, int cE, bool sc = true) {
  return (4 + kk) * cD + (sc ? 3 * cD + (cE ? cD + cE : 0) : 0);
}

__host__ __device__ inline TailBlob tail_blob(int D, int E, int kk, int cD, int cE, int wb = 1,
                                              bool sc = true) {
  const size_t Dp = (D + TL_KS - 1) / TL_KS * TL_KS, Ep = (E + TL_KS - 1) / TL_KS * TL_KS;
  TailBlob b;
  b.pw1 = 0;
  b.pw2 = b.pw1 + Dp * 2 * cD * wb;
  b.w1 = b.pw2 + Dp * cD * wb;
  b.w2 = b.w1 + Dp * cE * wb;
  b.cols = b.w2 + Ep * cD * wb;
  b.total = b.cols + (size_t)tail_cols(kk, cD, cE, sc) * 4;
  return b;
}

// Byte offsets of the dynamic shared memory, mirrored by the wrapper's plans.
struct TailSmem {
  size_t w, act, xs, norms, cols, mask, ext, y1c, red, bars, total;
};

__host__ __device__ inline TailSmem tail_smem(int M, int D, int E, int kk, int cD, int cE,
                                              int wb = 1, bool sc = true) {
  const int Dp = tail_pad(D), Ep = tail_pad(E);
  const size_t act_d = (size_t)TL_MR * (Dp + TL_KS) * 2;   // operand rows of K = D, bf16
  const size_t act_e = (size_t)TL_MR * (Ep + TL_KS) * 2;
  const size_t xs = (size_t)TL_MR * D * 4;                 // f32 rows to normalize
  const TailBlob blob = tail_blob(D, E, kk, cD, cE, wb, sc);
  TailSmem s;
  size_t o = 0;
  s.w = o;    o += blob.cols;                               // weight slices, as in the blob
  s.act = o;  s.xs = o + act_d;                             // xs is free while h is staged
  o += act_d + xs > act_e ? act_d + xs : act_e;
  s.norms = o; o += (size_t)(E ? 6 : 2) * D * 4;            // g, b of the LayerNorms
  s.cols = o; o += blob.total - blob.cols;                  // the blob's f32 columns
  s.mask = o; o += tail_align((size_t)M * 4);
  s.ext = o;  o += tail_align((size_t)(M + kk - 1) * cD * 4);   // conv rows
  s.y1c = o;  o += E ? tail_align((size_t)M * cD * 4) : 0;  // the block's columns of y1
  s.red = o;  o += (size_t)TL_WARPS * tail_max(2 * cD, cE) * TL_MR * 4;   // per-warp sums
  s.bars = o; o += TL_BARS * 8;                             // mbarriers of the bulk copies
  s.total = o;
  return s;
}

// Element i of the time cache, f32 or (bf16 weights only) bf16 widened exactly
template <typename WT>
__device__ __forceinline__ float tc_at(const TailArgs& p, size_t i) {
  if constexpr (!std::is_same_v<WT, int8_t>) {
    if (p.tc_bf16) return __bfloat162float(static_cast<const bf16*>(p.tc)[i]);
  }
  return static_cast<const float*>(p.tc)[i];
}

template <typename WT, bool FFN>
__device__ __forceinline__ void conv_tail(const TailArgs& p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool SC = std::is_same_v<WT, int8_t>;          // int8: per-column scales
  constexpr int WB = sizeof(WT);
  static_assert(SC || !FFN, "the fused tail takes int8 weights only");
  const int M = p.M, D = p.D, E = p.E, cD = p.cD, cE = p.cE, kk = p.kk;
  const TailSmem L = tail_smem(M, D, E, kk, cD, cE, WB, SC);
  const TailBlob B = tail_blob(D, E, kk, cD, cE, WB, SC);
  const WT* w_pw1 = reinterpret_cast<const WT*>(smem + L.w + B.pw1);
  const WT* w_pw2 = reinterpret_cast<const WT*>(smem + L.w + B.pw2);
  const WT* w_w1 = reinterpret_cast<const WT*>(smem + L.w + B.w1);
  const WT* w_w2 = reinterpret_cast<const WT*>(smem + L.w + B.w2);
  bf16* act = reinterpret_cast<bf16*>(smem + L.act);
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  float* norms = reinterpret_cast<float*>(smem + L.norms);    // LN_conv, LN_ff, LN_out
  float* sc1 = reinterpret_cast<float*>(smem + L.cols);       // [2 cD]: n, n + D
  float* sc2 = sc1 + 2 * cD;                                  // [cD]
  float* fsc1 = sc2 + cD;                                     // [cE]
  float* fsc2 = fsc1 + cE;                                    // [cD]
  float* dw = SC ? fsc2 + (FFN ? cD : 0) : sc1;               // [kk][cD]
  float* bn = dw + kk * cD;                                   // [4][cD]: g, b, m, v
  float* mask = reinterpret_cast<float*>(smem + L.mask);
  float* ext = reinterpret_cast<float*>(smem + L.ext);
  float* y1c = reinterpret_cast<float*>(smem + L.y1c);
  float* red = reinterpret_cast<float*>(smem + L.red);
  const int Dp = tail_pad(D), Ep = tail_pad(E), pd = Dp + TL_KS, pe = Ep + TL_KS;
  const int n0 = blockIdx.x * cD, e0 = blockIdx.x * cE;
  const int gd = cD / TL_GW, ge = cE / TL_GW, half = (kk - 1) / 2;
  const size_t b = blockIdx.x;
  const cg::grid_group grid = cg::this_grid();
  TL_MARK(0);

  // Thread 0 starts the bulk copies of pw1's slice and of what phase (a)
  // reads (x's first rows, LN_conv's g and b, the block's f32 columns of
  // the blob); once x has landed, those of pw2 (with FFN also W1 and W2
  // and the other norms): each group on its own mbarrier, so each phase
  // waits for its own bytes only, and pw1 has a head start on the 9.4 MB
  // that the fused tail needs later. Meanwhile the other threads load the
  // block's columns of the time cache and the mask.
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  const unsigned char* mine = p.packed + b * B.total;
  const uint32_t nb = D * 4;
  if (threadIdx.x == 0) {
    for (int i = 0; i < TL_BARS; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const uint32_t xb = min(TL_MR, M) * D * 4, cb = (uint32_t)(B.total - B.cols);
    mbar_expect(bars + BAR_PW1, (uint32_t)(B.pw2 - B.pw1));
    bulk_copy(smem + L.w + B.pw1, mine + B.pw1, (uint32_t)(B.pw2 - B.pw1), bars + BAR_PW1);
    mbar_expect(bars + BAR_X, xb + 2 * nb + cb);
    bulk_copy(xs, p.x, xb, bars + BAR_X);
    bulk_copy(norms, p.ln_g, nb, bars + BAR_X);
    bulk_copy(norms + D, p.ln_b, nb, bars + BAR_X);
    bulk_copy(sc1, mine + B.cols, cb, bars + BAR_X);
  }
  TL_MARK(1);
  for (int i = threadIdx.x; i < half * cD; i += TL_THREADS) {
    const int r = i / cD, j = i - r * cD;
    ext[i] = n0 + j < D ? tc_at<WT>(p, (size_t)r * D + n0 + j) : 0.f;
  }
  for (int i = threadIdx.x; i < M; i += TL_THREADS) mask[i] = p.mask[i];
  for (int i = threadIdx.x; i < half * cD; i += TL_THREADS) ext[(half + M) * cD + i] = 0.f;
  __syncthreads();                          // the mbarriers are ready
  mbar_wait(bars + BAR_X);
  TL_MARK(2);
  // x has landed: the weights needed later stream behind pw1
  if (threadIdx.x == 0) {
    if constexpr (FFN) {
      const size_t wo[4] = {B.pw2, B.w1, B.w2, B.cols};
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        mbar_expect(bars + BAR_PW2 + i, (uint32_t)(wo[i + 1] - wo[i]));
        bulk_copy(smem + L.w + wo[i], mine + wo[i], (uint32_t)(wo[i + 1] - wo[i]),
                  bars + BAR_PW2 + i);
      }
      const bool row_block = blockIdx.x < M;
      mbar_expect(bars + BAR_NORMS, (row_block ? 4 : 2) * nb);
      bulk_copy(norms + 2 * D, p.ff_g, nb, bars + BAR_NORMS);
      bulk_copy(norms + 3 * D, p.ff_b, nb, bars + BAR_NORMS);
      if (row_block) {
        bulk_copy(norms + 4 * D, p.out_g, nb, bars + BAR_NORMS);
        bulk_copy(norms + 5 * D, p.out_b, nb, bars + BAR_NORMS);
      }
    } else {
      mbar_expect(bars + BAR_PW2, (uint32_t)(B.cols - B.pw2));
      bulk_copy(smem + L.w + B.pw2, mine + B.pw2, (uint32_t)(B.cols - B.pw2), bars + BAR_PW2);
    }
  }
  int rows_parity = 0, chunk_parity = 0;    // of BAR_ROWS and BAR_CHUNK, a phase a staging

  // (a, b) c = GLU(LN_conv(x) @ pw1) * mask, then the conv's taps, BN, SiLU
  for (int m0 = 0; m0 < M; m0 += TL_MR) {
    const int mr = min(TL_MR, M - m0);
    if (m0 > 0) {
      if (threadIdx.x == 0)
        bulk_rows(xs, 0, p.x + (size_t)m0 * D, 0, 1, mr * nb, bars + BAR_ROWS);
      mbar_wait(bars + BAR_ROWS, rows_parity);
      rows_parity ^= 1;
    }
    ln_rows(act, pd, xs, mr, D, norms, norms + D);
    mbar_wait(bars + BAR_PW1);
    __syncthreads();
    TL_MARK(3);
    block_product(act, pd, w_pw1, Dp, 2 * gd, red, nullptr, 0, 17);
    TL_MARK(4);
    for (int i = threadIdx.x; i < mr * cD; i += TL_THREADS) {
      const int r = i / cD, j = i - r * cD, n = n0 + j, t = m0 + r;
      float v = 0.f;
      if (n < D) {
        float hv, gate;
        if constexpr (SC) {
          hv = __fmul_rn(product_sum(red, 2 * gd, r, j), sc1[j]);
          gate = __fmul_rn(product_sum(red, 2 * gd, r, cD + j), sc1[cD + j]);
        } else {
          hv = product_sum(red, 2 * gd, r, j);
          gate = product_sum(red, 2 * gd, r, cD + j);
        }
        v = __fmul_rn(__fmul_rn(hv, sigmoid_f(gate)), mask[t]);
        p.c[(size_t)t * D + n] = v;
      }
      ext[(half + t) * cD + j] = v;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < M * cD; i += TL_THREADS) {
    const int t = i / cD, j = i - t * cD, n = n0 + j;
    if (n >= D) continue;
    const float bscale = __fmul_rn(bn[j], rsqrtf(bn[3 * cD + j] + 1e-5f));
    float cv = __fmul_rn(ext[t * cD + j], dw[j]);
    for (int q = 1; q < kk; ++q)
      cv = __fadd_rn(cv, __fmul_rn(ext[(t + q) * cD + j], dw[q * cD + j]));
    cv = __fadd_rn(__fmul_rn(__fsub_rn(cv, bn[2 * cD + j]), bscale), bn[cD + j]);
    p.a[(size_t)t * D + n] = __float2bfloat16_rn(silu_f(cv));
  }
  TL_MARK(5);
  grid.sync();
  TL_MARK(6);

  // (c) y1 = x + a @ pw2 (the block keeps its columns of y1 for (e));
  // without FFN, y
  for (int m0 = 0; m0 < M; m0 += TL_MR) {
    const int mr = min(TL_MR, M - m0);
    bulk_chunks(act, pd, p.a, m0, mr, D, bars + BAR_CHUNK);
    zero_pad(act, pd, mr, D);
    mbar_wait(bars + BAR_PW2);
    __syncthreads();
    TL_MARK(7);
    block_product(act, pd, w_pw2, Dp, gd, red, bars + BAR_CHUNK, chunk_parity, 19);
    chunk_parity ^= 1;
    for (int i = threadIdx.x; i < mr * cD; i += TL_THREADS) {
      const int r = i / cD, j = i - r * cD, n = n0 + j, t = m0 + r;
      const float xv = n >= D ? 0.f : M <= TL_MR ? xs[t * D + n] : p.x[(size_t)t * D + n];
      float v;
      if constexpr (SC) v = __fadd_rn(xv, __fmul_rn(product_sum(red, gd, r, j), sc2[j]));
      else v = __fadd_rn(xv, product_sum(red, gd, r, j));
      if constexpr (FFN) {
        y1c[t * cD + j] = v;
        if (n < D) p.y1[(size_t)t * D + n] = v;
      } else if (n < D) {
        p.y[(size_t)t * D + n] = v;
      }
    }
    __syncthreads();
  }
  TL_MARK(8);
  if constexpr (!FFN) return;
  grid.sync();
  TL_MARK(9);

  // (d) h = bf16(silu(LN_ff(y1) @ W1))
  for (int m0 = 0; m0 < M; m0 += TL_MR) {
    const int mr = min(TL_MR, M - m0);
    if (threadIdx.x == 0)
      bulk_rows(xs, 0, p.y1 + (size_t)m0 * D, 0, 1, mr * nb, bars + BAR_ROWS);
    mbar_wait(bars + BAR_W1);
    mbar_wait(bars + BAR_NORMS);
    mbar_wait(bars + BAR_ROWS, rows_parity);
    rows_parity ^= 1;
    ln_rows(act, pd, xs, mr, D, norms + 2 * D, norms + 3 * D);
    __syncthreads();
    TL_MARK(10);
    block_product(act, pd, w_w1, Dp, ge, red, nullptr, 0, 21);
    for (int i = threadIdx.x; i < mr * cE; i += TL_THREADS) {
      const int r = i / cE, j = i - r * cE, ne = e0 + j, t = m0 + r;
      if (ne < E)
        p.h[(size_t)t * E + ne] =
            __float2bfloat16_rn(silu_f(__fmul_rn(product_sum(red, ge, r, j), fsc1[j])));
    }
    __syncthreads();
  }
  TL_MARK(11);
  grid.sync();
  TL_MARK(12);

  // (e) y2 = y1 + 0.5 * h @ W2
  for (int m0 = 0; m0 < M; m0 += TL_MR) {
    const int mr = min(TL_MR, M - m0);
    bulk_chunks(act, pe, p.h, m0, mr, E, bars + BAR_CHUNK);
    zero_pad(act, pe, mr, E);
    mbar_wait(bars + BAR_W2);
    __syncthreads();
    TL_MARK(13);
    block_product(act, pe, w_w2, Ep, gd, red, bars + BAR_CHUNK, chunk_parity, 23);
    chunk_parity ^= 1;
    for (int i = threadIdx.x; i < mr * cD; i += TL_THREADS) {
      const int r = i / cD, j = i - r * cD, n = n0 + j, t = m0 + r;
      if (n < D)
        p.y2[(size_t)t * D + n] = __fadd_rn(
            y1c[t * cD + j], __fmul_rn(0.5f, __fmul_rn(product_sum(red, gd, r, j), fsc2[j])));
    }
    __syncthreads();
  }
  TL_MARK(14);
  grid.sync();
  TL_MARK(15);

  // (f) y = LN_out(y2), one row a block, read straight from L2 (a row is
  // one load a thread); every warp sums the whole row itself (the same
  // order in each), so no warp waits for another
  const float* og = norms + 4 * D;
  const float* ob = norms + 5 * D;
  const int lane = threadIdx.x & 31;
  for (int m = blockIdx.x; m < M; m += gridDim.x) {
    for (int i = threadIdx.x; i < D / 4; i += TL_THREADS)
      reinterpret_cast<float4*>(xs)[i] =
          __ldcg(reinterpret_cast<const float4*>(p.y2 + (size_t)m * D) + i);
    __syncthreads();
    float s = 0.f;
    for (int i = 4 * lane; i < D; i += 128) {
      const float4 v = *reinterpret_cast<const float4*>(xs + i);
      s += v.x + v.y + v.z + v.w;
    }
    const float mu = warp_sum(s) / (float)D;
    float q = 0.f;
    for (int i = 4 * lane; i < D; i += 128) {
      const float4 v = *reinterpret_cast<const float4*>(xs + i);
      q = fmaf(v.x - mu, v.x - mu, q);
      q = fmaf(v.y - mu, v.y - mu, q);
      q = fmaf(v.z - mu, v.z - mu, q);
      q = fmaf(v.w - mu, v.w - mu, q);
    }
    const float inv = 1.0f / sqrtf(warp_sum(q) / (float)D + 1e-5f);
    for (int i = threadIdx.x; i < D; i += TL_THREADS)
      p.y[(size_t)m * D + i] = __fadd_rn(__fmul_rn(__fmul_rn(xs[i] - mu, inv), og[i]), ob[i]);
    __syncthreads();
  }
  TL_MARK(16);
}

}  // namespace port
