// The persistent TDT joint decode step: one body, joint_body<WT>, of the
// int8 kernel (csrc/joint_step_q8.cu) and the bf16 one
// (csrc/joint_step_bf16.cu), one cooperative launch a call. For rows = B*Tq
// encoder positions:
//   h      = bf16(relu(e + (bf16(g) @ W_pred) [s_pred] + b_pred))    [rows, J]
//   logits = (h @ W_out) [s_out] + b_out                             [rows, V]
//   tok    = first argmax of logits[:, :ths] (blank column less the penalty)
//   dur    = first argmax of logits[:, ths:ths+ndur]  (index relative to ths)
// The returned logits are pre-penalty. int8 weights widen exactly and each
// per-column scale s multiplies an f32 sum; bf16 weights have no scale.
//
// Design. One cooperative launch, one block an SM, 512 threads (the
// building blocks of csrc/persistent.cuh). Block b owns `gb` 8-column
// groups of W_out (8 at full width, 129 blocks on 132 SMs; the wrapper's
// plans, ops/kernels/joint_step.py:joint_step_q8_plan and
// joint_step_bf16_plan) and `hc` columns of W_pred (5), packed contiguous
// once with the model's weights (pack_joint_step). At entry thread 0 starts
// three bulk copies, each on its own mbarrier: W_pred's slice with its
// scales and biases, g's first 8 rows, then W_out's slice, so that W_out
// lands while the hidden phase runs. Phases, 8 rows a pass:
//   (1) the block's hc columns of h on the CUDA cores (g's rows from shared
//       memory, rounded to bf16 once there; int8 widened by byte permutes,
//       bf16 by shifts; the pass's e loaded before the sums), in the order
//       of the plain version's product on the H100 (cuBLAS's split-K: K in
//       runs of JS_RUN rows, each summed in order, FMA by FMA, the runs added
//       in order; held by chip_smoke.py and att_variants.py --orders):
//       h passes a bf16 rounding point, where one f32 ulp of the sum moves
//       it by a bf16 ulp, and a logit by ~3e-4 at full width. h is written
//       to scratch, rounded to bf16 once;
//   grid barrier (block 0 zeroes the ticket before it);
//   (2) h's rows loaded out of L2 (__ldcg); the block's logits on the
//       tensor cores (mma.sync.m16n8k16, int8 widened exactly to bf16 in
//       registers, bf16 as it is, f32 sums; the 8 live rows of a pass in the
//       mma's 16), a warp a group and a run of K (joint_product); the
//       logits, sum [s_out] + b_out, written out; then, one warp a row, the
//       (max, first index) of the block's token and duration columns,
//       written to scratch (one fence, thread 0's, before the ticket: the
//       block barrier orders the other threads' writes before it);
//   (3) the last block to arrive (an atomic ticket) reduces the blocks'
//       pairs of each row, smaller index winning ties (as jnp.argmax and
//       torch.argmax), so a duration head cut between two blocks, or a tie
//       across a block boundary, reduces as one.
// Every sum runs in a fixed order (no atomics in the arithmetic): the kernel
// is deterministic, and a captured CUDA graph replays it bit for bit
// (chip_smoke.py phase 2). The ticket lives in the call's scratch and is
// zeroed by the launch itself, so every launch and every replay starts from
// 0. After the barrier, what other blocks wrote is read with __ldcg, never
// through a possibly stale L1 line. With TAIL_TIMELINE defined, thread 0 of
// each block records the phases (att_variants.py --joint prints them).
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "persistent.cuh"

namespace port {

namespace cg = cooperative_groups;

constexpr int JS_RUN = 64;                // rows of K a run of the hidden product's sums

// mbarriers of the bulk copies: W_pred's slice; g's rows (reused pass by
// pass); W_out's slice
enum { JB_PRED, JB_G, JB_OUT, JB_BARS };

// A block's packed slice (pack_joint in ops/kernels/joint_step.py), byte
// offsets: W_pred's hc columns [hc][Pp] int8 or bf16 at 0; their f32 scales
// (int8 only) and biases at sp; W_out's gb groups [gb][Jp / 16][8][16] int8
// or bf16 at wo; their f32 scales (int8 only) and biases at so, [8 gb] each.
// Zero past P, J and V. wb: bytes a weight (1 int8, 2 bf16); sc: int8's
// scales.
struct JointBlob {
  size_t sp, wo, so, total;
};

__host__ __device__ inline JointBlob joint_blob(int P, int J, int hc, int gb, int wb = 1,
                                                bool sc = true) {
  JointBlob b;
  b.sp = (size_t)hc * tail_pad(P) * wb;
  b.wo = b.sp + tail_align((size_t)(sc ? 8 : 4) * hc);
  b.so = b.wo + (size_t)gb * TL_GW * tail_pad(J) * wb;
  b.total = b.so + (size_t)(sc ? 2 : 1) * gb * TL_GW * 4;
  return b;
}

// Byte offsets of the dynamic shared memory, mirrored by the wrapper's plan.
struct JointSmem {
  size_t w, gs, act, lg, red, bars, total;
};

__host__ __device__ inline JointSmem joint_smem(int P, int J, int hc, int gb, int wb = 1,
                                                bool sc = true) {
  const size_t runs = (P + JS_RUN - 1) / JS_RUN;
  const size_t red = tail_max(TL_WARPS * gb * 64, (int)(TL_MR * hc * runs));
  JointSmem s;
  size_t o = 0;
  s.w = o;    o += joint_blob(P, J, hc, gb, wb, sc).total;         // the block's slices
  s.gs = o;   o += (size_t)TL_MR * (P + 4) * 4;                    // g's rows
  s.act = o;  o += (size_t)TL_MR * (tail_pad(J) + TL_KS) * 2;      // h's rows, bf16
  s.lg = o;   o += (size_t)TL_MR * gb * TL_GW * 4;                 // a pass's logits
  s.red = o;  o += tail_align(red * 4);                            // sums
  s.bars = o; o += JB_BARS * 8;                                    // mbarriers
  s.total = o;
  return s;
}

// The sums of h's 8 rows (act, bf16, zero in [J, Jp)) with each of the
// block's gb groups of W_out (w: [gb][Jp / 16][8][16] int8 or bf16), left in red as
// [gb][kparts][8 rows x 8 columns]: warp w takes group w % gb's run w / gb
// of the K steps (kparts = 16 / gb runs a group, or one run of every 16th
// group from gb = 16 on), summed on the tensor cores by product_chunk (runs
// of four steps, their loads first). Ends with __syncthreads().
__device__ __forceinline__ int joint_kparts(int gb) { return gb < TL_WARPS ? TL_WARPS / gb : 1; }

template <typename WT>
__device__ __forceinline__ void joint_product(const bf16* act, int pitch, const WT* w, int Jp,
                                              int gb, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int steps = Jp / TL_KS, kparts = joint_kparts(gb), per = (steps + kparts - 1) / kparts;
  const bf16* arow = act + (size_t)(lane >> 2) * pitch + 4 * (lane & 3);
  for (int item = warp; item < gb * kparts; item += TL_WARPS) {
    const int g = item % gb, kp = item / gb;
    const int s0 = min(steps, kp * per), s1 = min(steps, s0 + per);
    float acc[2][1][4] = {};
    product_chunk<1>(acc, arow, w + (size_t)g * steps * TL_GW * TL_KS, steps, s0, s1, lane);
    *reinterpret_cast<float2*>(red + ((size_t)g * kparts + kp) * 64 + 2 * lane) =
        make_float2(acc[0][0][0] + acc[1][0][0], acc[0][0][1] + acc[1][0][1]);
  }
  TL_MARK(19);
  __syncthreads();
  TL_MARK(20);
}

// Row r, column col of the block's groups: the K runs' sums added in order
__device__ __forceinline__ float joint_sum(const float* red, int gb, int r, int col) {
  const int kparts = joint_kparts(gb);
  const float* v = red + (size_t)(col / TL_GW) * kparts * 64 + r * TL_GW + col % TL_GW;
  float s = 0.f;
  for (int kp = 0; kp < kparts; ++kp) s += v[kp * 64];
  return s;
}

struct JointArgs {
  const float *e, *g;
  int M, P, J, V, hc, gb;
  int ths, ndur, blank;
  float penalty;
  const void* packed;
  float* logits;
  int *tok, *dur;
  int* ticket;                            // scratch: the blocks' arrivals
  bf16* h;                                // [M, J]
  float4* pairs;                          // [M][blocks]: token (max, index), duration's
};

// Four weights of a W_pred column (k .. k + 3, 4-aligned) widened exactly to
// f32: int8 by byte permutes (i8x4_to_f32), bf16 by shifts
__device__ __forceinline__ void pred_weights(const int8_t* w, float& w0, float& w1, float& w2,
                                             float& w3) {
  i8x4_to_f32(*reinterpret_cast<const uint32_t*>(w), w0, w1, w2, w3);
}
__device__ __forceinline__ void pred_weights(const bf16* w, float& w0, float& w1, float& w2,
                                             float& w3) {
  const uint2 v = *reinterpret_cast<const uint2*>(w);
  w0 = __uint_as_float(v.x << 16);
  w1 = __uint_as_float(v.x & 0xffff0000u);
  w2 = __uint_as_float(v.y << 16);
  w3 = __uint_as_float(v.y & 0xffff0000u);
}

// The body of the persistent joint step with int8 (WT int8_t: each sum times
// its column's scale) or bf16 weights (no scales)
template <typename WT>
__device__ __forceinline__ void joint_body(const JointArgs& p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  constexpr bool SC = std::is_same_v<WT, int8_t>;
  constexpr int WB = sizeof(WT);
  const int M = p.M, P = p.P, J = p.J, V = p.V, hc = p.hc, gb = p.gb;
  const int Pp = tail_pad(P), Jp = tail_pad(J), pd = Jp + TL_KS, cols = gb * TL_GW;
  const int runs = (P + JS_RUN - 1) / JS_RUN;
  const JointSmem L = joint_smem(P, J, hc, gb, WB, SC);
  const JointBlob B = joint_blob(P, J, hc, gb, WB, SC);
  const WT* wp = reinterpret_cast<const WT*>(smem + L.w);
  float* gs = reinterpret_cast<float*>(smem + L.gs);
  const float* sp = reinterpret_cast<const float*>(smem + L.w + B.sp);     // [hc] (int8)
  const float* bpred = SC ? sp + hc : sp;                                   // [hc]
  const WT* wo = reinterpret_cast<const WT*>(smem + L.w + B.wo);
  const float* so = reinterpret_cast<const float*>(smem + L.w + B.so);     // [cols] (int8)
  const float* bout = SC ? so + cols : so;                                  // [cols]
  bf16* act = reinterpret_cast<bf16*>(smem + L.act);
  float* lg = reinterpret_cast<float*>(smem + L.lg);
  float* red = reinterpret_cast<float*>(smem + L.red);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h0 = blockIdx.x * hc, c0 = blockIdx.x * cols;
  TL_MARK(0);

  if (threadIdx.x == 0) {
    for (int i = 0; i < JB_BARS; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const unsigned char* mine = static_cast<const unsigned char*>(p.packed) + blockIdx.x * B.total;
    mbar_expect(bars + JB_PRED, (uint32_t)B.wo);
    bulk_copy(smem + L.w, mine, (uint32_t)B.wo, bars + JB_PRED);
    bulk_rows(gs, (size_t)(P + 4) * 4, p.g, (size_t)P * 4, min(TL_MR, M), P * 4, bars + JB_G);
    mbar_expect(bars + JB_OUT, (uint32_t)(B.total - B.wo));
    bulk_copy(smem + L.w + B.wo, mine + B.wo, (uint32_t)(B.total - B.wo), bars + JB_OUT);
    if (blockIdx.x == 0) *p.ticket = 0;
  }
  __syncthreads();                          // the mbarriers are ready
  TL_MARK(1);
  mbar_wait(bars + JB_PRED);
  TL_MARK(2);

  // (1) h on the block's columns: item (row, run, column) of a pass, a
  // thread each, the row fastest (g's rows a 16-byte bank offset apart, the
  // weights one broadcast), its run summed in order; then the runs added in
  // order
  int g_parity = 0;
  for (int m0 = 0; m0 < M; m0 += TL_MR) {
    const int mr = min(TL_MR, M - m0);
    if (m0 > 0 && threadIdx.x == 0) {       // the previous pass's reads of gs are done
      // ... and its rounding wrote gs with generic stores
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bulk_rows(gs, (size_t)(P + 4) * 4, p.g + (size_t)m0 * P, (size_t)P * 4, mr, P * 4,
                bars + JB_G);
    }
    // the pass's e of the (row, column) whose h this thread adds up below
    const int r_e = threadIdx.x / hc, n_e = h0 + threadIdx.x % hc;
    const float ev = threadIdx.x < mr * hc && n_e < J ? p.e[(size_t)(m0 + r_e) * J + n_e] : 0.f;
    mbar_wait(bars + JB_G, g_parity);
    g_parity ^= 1;
    TL_MARK(12);
    for (int r = 0; r < mr; ++r)            // g's rows rounded to bf16 once
      for (int k = 4 * threadIdx.x; k < P; k += 4 * TL_THREADS) {
        float4* x = reinterpret_cast<float4*>(gs + (size_t)r * (P + 4) + k);
        *x = round4(*x);
      }
    __syncthreads();
    TL_MARK(13);
    for (int it = threadIdx.x; it < mr * hc * runs; it += TL_THREADS) {
      const int r = it % mr, run = (it / mr) % runs, c = it / (mr * runs);
      if (h0 + c >= J) continue;
      const float* gr = gs + (size_t)r * (P + 4);
      const WT* wc = wp + (size_t)c * Pp;
      float acc = 0.f;
#pragma unroll 4
      for (int k = run * JS_RUN; k < min(P, (run + 1) * JS_RUN); k += 4) {
        const float4 a = *reinterpret_cast<const float4*>(gr + k);
        float w0, w1, w2, w3;
        pred_weights(wc + k, w0, w1, w2, w3);
        acc = fmaf(a.x, w0, acc);
        acc = fmaf(a.y, w1, acc);
        acc = fmaf(a.z, w2, acc);
        acc = fmaf(a.w, w3, acc);
      }
      red[it] = acc;
    }
    __syncthreads();
    TL_MARK(3);
    for (int i = threadIdx.x; i < mr * hc; i += TL_THREADS) {
      const int r = i / hc, c = i - r * hc, n = h0 + c, t = m0 + r;
      if (n >= J) continue;
      float v = 0.f;
      for (int q = 0; q < runs; ++q) v = __fadd_rn(v, red[(c * runs + q) * mr + r]);
      const float e = i == threadIdx.x ? ev : p.e[(size_t)t * J + n];
      if constexpr (SC) v = __fmul_rn(v, sp[c]);
      v = __fadd_rn(__fadd_rn(e, v), bpred[c]);
      p.h[(size_t)t * J + n] = __float2bfloat16_rn(fmaxf(v, 0.f));
    }
    __syncthreads();
  }
  TL_MARK(4);
  cg::this_grid().sync();
  TL_MARK(5);

  // (2) the block's logits, 8 rows a pass, and its argmax pairs
  mbar_wait(bars + JB_OUT);
  TL_MARK(6);
  const int j8 = J / 8;                     // 16-byte pieces of a row of h
  for (int m0 = 0; m0 < M; m0 += TL_MR) {
    const int mr = min(TL_MR, M - m0);
    for (int i = threadIdx.x; i < mr * j8; i += TL_THREADS) {
      const int r = i / j8, c = i - r * j8;
      *reinterpret_cast<uint4*>(act + (size_t)r * pd + 8 * c) =
          __ldcg(reinterpret_cast<const uint4*>(p.h + (size_t)(m0 + r) * J) + c);
    }
    zero_pad(act, pd, mr, J);
    __syncthreads();
    TL_MARK(7);
    joint_product(act, pd, wo, Jp, gb, red);
    for (int i = threadIdx.x; i < mr * cols; i += TL_THREADS) {
      const int r = i / cols, j = i - r * cols, n = c0 + j;
      float v = joint_sum(red, gb, r, j);
      if constexpr (SC) v = __fmul_rn(v, so[j]);
      v = __fadd_rn(v, bout[j]);
      lg[i] = v;
      if (n < V) p.logits[(size_t)(m0 + r) * V + n] = v;
    }
    __syncthreads();
    TL_MARK(8);
    for (int r = warp; r < mr; r += TL_WARPS) {
      float tv = -INFINITY, dv = -INFINITY;
      int ti = 0x7fffffff, di = 0x7fffffff;
      for (int j = lane; j < cols; j += 32) {
        const int n = c0 + j;
        const float v = lg[r * cols + j];
        if (n < p.ths)
          argmax_merge(tv, ti, n == p.blank ? __fsub_rn(v, p.penalty) : v, n);
        else if (n < p.ths + p.ndur)
          argmax_merge(dv, di, v, n);
      }
      warp_argmax(tv, ti);
      warp_argmax(dv, di);
      if (lane == 0)
        p.pairs[(size_t)(m0 + r) * gridDim.x + blockIdx.x] =
            make_float4(tv, __int_as_float(ti), dv, __int_as_float(di));
    }
    __syncthreads();
  }

  // (3) the last block reduces every row's pairs
  TL_MARK(9);
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(p.ticket, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  TL_MARK(10);
  if (!last) {
    TL_MARK(11);
    return;
  }
  __threadfence();
  for (int r = warp; r < M; r += TL_WARPS) {
    float tv = -INFINITY, dv = -INFINITY;
    int ti = 0x7fffffff, di = 0x7fffffff;
    for (int b0 = 0; b0 < (int)gridDim.x; b0 += 8 * 32) {   // 8 loads in flight a lane
      float4 q[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int b = b0 + 32 * u + lane;
        q[u] = b < (int)gridDim.x ? __ldcg(p.pairs + (size_t)r * gridDim.x + b)
                                  : make_float4(-INFINITY, __int_as_float(0x7fffffff),
                                                -INFINITY, __int_as_float(0x7fffffff));
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        argmax_merge(tv, ti, q[u].x, __float_as_int(q[u].y));
        argmax_merge(dv, di, q[u].z, __float_as_int(q[u].w));
      }
    }
    warp_argmax(tv, ti);
    warp_argmax(dv, di);
    if (lane == 0) {
      p.tok[r] = ti;
      p.dur[r] = di - p.ths;
    }
  }
  __syncthreads();
  TL_MARK(11);
}

}  // namespace port
