// Fused TDT joint decode step with int8 weights: one persistent cooperative
// launch.
//
// Replaces: trt_asr_tpu/ops/pallas/joint_step_kernel.py:joint_step_pallas_prepadded
// (its pallas_call at :124) with int8 weights; f32 and bf16 weights take the
// three launches of csrc/joint_step.cu. For rows = B*Tq encoder positions:
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
// Design. One cooperative launch, one block an SM, 512 threads (the
// building blocks of csrc/persistent.cuh). Block b owns `gb` 8-column
// groups of W_out (8 at full width, 129 blocks on 132 SMs; the wrapper's
// plan, ops/kernels/joint_step.py:joint_step_q8_plan) and `hc` columns of
// W_pred (5), packed contiguous once with the model's int8 weights
// (pack_joint_step). At entry thread 0 starts three bulk copies, each on its
// own mbarrier: W_pred's slice with its scales and biases, g's first 8 rows,
// then W_out's slice, so that W_out lands while the hidden phase runs.
// Phases, 8 rows a pass:
//   (1) the block's hc columns of h on the CUDA cores (g's rows from shared
//       memory, rounded to bf16 once there; int8 widened by byte permutes;
//       the pass's e loaded before the sums), in the order of the
//       plain version's product on the H100 (cuBLAS's split-K: K in runs of
//       JS_RUN rows, each summed in order, FMA by FMA, the runs added in
//       order; held by chip_smoke.py's 1e-4 and att_variants.py --orders):
//       h passes a bf16 rounding point, where one f32 ulp of the sum moves
//       it by a bf16 ulp, and a logit by ~3e-4 at full width. h is written
//       to scratch, rounded to bf16 once;
//   grid barrier (block 0 zeroes the ticket before it);
//   (2) h's rows loaded out of L2 (__ldcg); the block's logits on the
//       tensor cores (mma.sync.m16n8k16, int8 widened exactly to bf16 in
//       registers, f32 sums; the 8 live rows of a pass in the mma's 16, a
//       CUDA-core path for them not tried), a warp a group and a run of K
//       (joint_product); the logits,
//       sum s_out + b_out, written out; then, one warp a row, the (max,
//       first index) of the block's token and duration columns, written to
//       scratch (one fence, thread 0's, before the ticket: the block barrier
//       orders the other threads' writes before it);
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
#include <cooperative_groups.h>

#include "persistent.cuh"

namespace port {

namespace cg = cooperative_groups;

constexpr int JS_RUN = 64;                // rows of K a run of the hidden product's sums

// mbarriers of the bulk copies: W_pred's slice; g's rows (reused pass by
// pass); W_out's slice
enum { JB_PRED, JB_G, JB_OUT, JB_BARS };

// A block's packed slice (pack_joint in ops/kernels/joint_step.py), byte
// offsets: W_pred's hc columns [hc][Pp] int8 at 0; their f32 scales and
// biases at sp; W_out's gb groups [gb][Jp / 16][8][16] int8 at wo; their
// f32 scales and biases at so, [8 gb] each. Zero past P, J and V.
struct JointBlob {
  size_t sp, wo, so, total;
};

__host__ __device__ inline JointBlob joint_blob(int P, int J, int hc, int gb) {
  JointBlob b;
  b.sp = (size_t)hc * tail_pad(P);
  b.wo = b.sp + tail_align((size_t)8 * hc);
  b.so = b.wo + (size_t)gb * TL_GW * tail_pad(J);
  b.total = b.so + (size_t)2 * gb * TL_GW * 4;
  return b;
}

// Byte offsets of the dynamic shared memory, mirrored by the wrapper's plan.
struct JointSmem {
  size_t w, gs, act, lg, red, bars, total;
};

__host__ __device__ inline JointSmem joint_smem(int P, int J, int hc, int gb) {
  const size_t runs = (P + JS_RUN - 1) / JS_RUN;
  const size_t red = tail_max(TL_WARPS * gb * 64, (int)(TL_MR * hc * runs));
  JointSmem s;
  size_t o = 0;
  s.w = o;    o += joint_blob(P, J, hc, gb).total;                 // the block's slices
  s.gs = o;   o += (size_t)TL_MR * (P + 4) * 4;                    // g's rows
  s.act = o;  o += (size_t)TL_MR * (tail_pad(J) + TL_KS) * 2;      // h's rows, bf16
  s.lg = o;   o += (size_t)TL_MR * gb * TL_GW * 4;                 // a pass's logits
  s.red = o;  o += tail_align(red * 4);                            // sums
  s.bars = o; o += JB_BARS * 8;                                    // mbarriers
  s.total = o;
  return s;
}

// The sums of h's 8 rows (act, bf16, zero in [J, Jp)) with each of the
// block's gb groups of W_out (w: [gb][Jp / 16][8][16] int8), left in red as
// [gb][kparts][8 rows x 8 columns]: warp w takes group w % gb's run w / gb
// of the K steps (kparts = 16 / gb runs a group, or one run of every 16th
// group from gb = 16 on), summed on the tensor cores by product_chunk (runs
// of four steps, their loads first). Ends with __syncthreads().
__device__ __forceinline__ int joint_kparts(int gb) { return gb < TL_WARPS ? TL_WARPS / gb : 1; }

__device__ __forceinline__ void joint_product(const bf16* act, int pitch, const int8_t* w, int Jp,
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

__global__ void __launch_bounds__(TL_THREADS, 1) joint_step_q8_kernel(JointArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  const int M = p.M, P = p.P, J = p.J, V = p.V, hc = p.hc, gb = p.gb;
  const int Pp = tail_pad(P), Jp = tail_pad(J), pd = Jp + TL_KS, cols = gb * TL_GW;
  const int runs = (P + JS_RUN - 1) / JS_RUN;
  const JointSmem L = joint_smem(P, J, hc, gb);
  const JointBlob B = joint_blob(P, J, hc, gb);
  const int8_t* wp = reinterpret_cast<const int8_t*>(smem + L.w);
  float* gs = reinterpret_cast<float*>(smem + L.gs);
  const float* sp = reinterpret_cast<const float*>(smem + L.w + B.sp);     // [hc], then bp
  const int8_t* wo = reinterpret_cast<const int8_t*>(smem + L.w + B.wo);
  const float* so = reinterpret_cast<const float*>(smem + L.w + B.so);     // [cols], then bo
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
      const int8_t* wc = wp + (size_t)c * Pp;
      float acc = 0.f;
#pragma unroll 4
      for (int k = run * JS_RUN; k < min(P, (run + 1) * JS_RUN); k += 4) {
        const float4 a = *reinterpret_cast<const float4*>(gr + k);
        float w0, w1, w2, w3;
        i8x4_to_f32(*reinterpret_cast<const uint32_t*>(wc + k), w0, w1, w2, w3);
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
      v = __fadd_rn(__fadd_rn(e, __fmul_rn(v, sp[c])), sp[hc + c]);
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
      const float v = __fadd_rn(__fmul_rn(joint_sum(red, gb, r, j), so[j]), so[cols + j]);
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
