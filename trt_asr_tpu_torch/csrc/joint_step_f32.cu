// Fused TDT joint decode step with f32 weights: one persistent cooperative
// launch.
//
// Replaces: trt_asr_tpu/ops/pallas/joint_step_kernel.py:joint_step_pallas_prepadded
// (its pallas_call at :124) with f32 weights; int8 weights take
// csrc/joint_step_q8.cu, bf16 weights the three launches of
// csrc/joint_step.cu. For rows = B*Tq encoder positions:
//   h      = relu(e + g @ W_pred + b_pred)                          [rows, J]
//   logits = h @ W_out + b_out                                      [rows, V]
//   tok    = first argmax of logits[:, :ths] (blank column less the penalty)
//   dur    = first argmax of logits[:, ths:ths+ndur]  (index relative to ths)
// The returned logits are pre-penalty. Everything is f32: nothing is
// rounded, and the products run on the CUDA cores (FFMA, no TF32: the f32
// policy, the reference's Precision.HIGHEST).
//
// Bound on the H100: memory. At full width (P = J = 640, V = 8198, rows 8)
// a call reads 22.6 MB of f32 weights and biases: 6.9 us at 3.35 TB/s,
// against 85 MFLOP of products (1.3 us at the f32 peak).
//
// Design. As csrc/joint_step_q8.cu: one cooperative launch, one block an
// SM, 512 threads; block b owns `gb` <= 8 8-column groups of W_out (8 at
// full width, 129 blocks on 132 SMs; the wrapper's plan,
// ops/kernels/joint_step.py:joint_step_f32_plan) and `hc` columns of W_pred
// (5), packed contiguous once with the model's f32 weights
// (pack_joint_step). The block's whole f32 slice (176,928 B at full width)
// stays in shared memory, so a call of more than 8 rows reads it once: g's
// rows and h's rows share one buffer (their lives do not overlap), which
// leaves room beside the slice for the sums. At entry thread 0 issues bulk
// copies, each on its own mbarrier: W_pred's slice with both biases, g's
// first 8 rows, then the first half of W_out's slice (the K ranges of
// warps 0-7), which lands while the hidden phase runs. The second half
// (the K ranges of warps 8-15) is copied after the grid barrier, a range by
// its warp once that warp has loaded its range of h: a barrier and an L2
// read queue behind a memory system busy streaming weights (the barrier
// took until W_out had landed, ~11 us from the start, when all of W_out was
// copied at entry; att_variants.py --joint --f32), and half of W_out at
// entry is the split that read fastest (8, 10 and 12 of the 16 ranges
// alike). The weights are read once a call: their copies carry an L2
// evict-first policy, so the stream displaces its own lines rather than
// lines that must be written back (the writebacks would share the memory's
// rate with the weights).
// Phases, 8 rows a pass:
//   (1) the block's hc columns of h: item (row, run of JF_RUN rows of K,
//       column) a thread, its run summed in order (FMAs), the runs added in
//       order; h = relu((e + sum) + b_pred), f32 into scratch;
//   grid barrier (block 0 zeroes the ticket before it);
//   (2) the block's logits: warp w takes the w-th sixteenth of K, loads
//       that range of h's rows out of L2 (__ldcg) in place of g's (no
//       other warp reads it: no block barrier), copies that range of W_out
//       if it is a late warp, and, once the range has landed, sums it for
//       every column of the block, lane (n8, c) column
//       n8 of groups 2c and 2c + 1 for all 8 rows (one weight float4 feeds
//       8 rows, one float4 of h, the same for the whole warp, 2 columns);
//       then, one warp a
//       row, the warps' sums added in order, plus b_out: the logits,
//       written out, and the (max, first index) of the block's token and
//       duration columns, written to scratch;
//   (3) the last block to arrive (an atomic ticket) reduces the blocks'
//       pairs of each row, smaller index winning ties (as jnp.argmax and
//       torch.argmax), so a duration head cut between two blocks, or a tie
//       across a block boundary, reduces as one.
// The sums run in another order than the plain version's cuBLAS products
// (f32 ulps apart; h has no rounding point in f32). Every sum runs in a
// fixed order (no atomics in the arithmetic): the kernel is deterministic,
// and a captured CUDA graph replays it bit for bit (chip_smoke.py phase
// 2). The ticket lives in the call's scratch and is zeroed by the launch
// itself. After the barrier, what other blocks wrote is read with __ldcg.
// With TAIL_TIMELINE defined, thread 0 of each block records the phases
// (att_variants.py --joint --f32 prints them).
#include <cooperative_groups.h>

#include "persistent.cuh"

namespace port {

namespace cg = cooperative_groups;

constexpr int JF_RUN = 64;                // rows of K a run of the hidden product's sums
constexpr int JF_GROUPS = 8;              // W_out groups a block at most: one a lane pair
constexpr int JF_EARLY = TL_WARPS / 2;    // warps whose K ranges of W_out are copied at entry

// mbarriers of the bulk copies: W_pred's slice and the biases; g's rows
// (reused pass by pass); the early warps' K ranges of W_out's slice; then
// one a late warp's K range (JF_BARS + warp)
enum { JF_PRED, JF_G, JF_OUT, JF_BARS };

__host__ __device__ inline int jf_pad4(int n) { return (n + 3) & ~3; }

// A block's packed slice (pack_joint_f32 in ops/kernels/joint_step.py),
// offsets in floats: W_pred's hc columns [hc][P] at 0; b_pred's hc values
// at bp (zero to a multiple of 4); b_out's 8 gb values at bo; W_out's gb
// groups [J / 4][8 gb][4] at wo (a column's four consecutive K values in
// one float4, the columns side by side). Zero past J and V.
struct JfBlob {
  size_t bp, bo, wo, total;
};

__host__ __device__ inline JfBlob jf_blob(int P, int J, int hc, int gb) {
  const size_t cols = (size_t)gb * TL_GW;
  JfBlob b;
  b.bp = (size_t)hc * P;
  b.bo = b.bp + jf_pad4(hc);
  b.wo = b.bo + cols;
  b.total = b.wo + (size_t)J * cols;
  return b;
}

// Byte offsets of the dynamic shared memory, mirrored by the wrapper's plan.
struct JfSmem {
  size_t w, rows, red, bars, total;
};

__host__ __device__ inline JfSmem jf_smem(int P, int J, int hc, int gb) {
  const int runs = (P + JF_RUN - 1) / JF_RUN;
  const int red = tail_max(TL_MR * hc * runs, TL_WARPS * TL_MR * gb * TL_GW);
  JfSmem s;
  size_t o = 0;
  s.w = o;    o += jf_blob(P, J, hc, gb).total * 4;                 // the block's slice
  s.rows = o; o += (size_t)TL_MR * tail_max(P + 4, J + 4) * 4;      // g's rows, then h's
  s.red = o;  o += tail_align((size_t)red * 4);                     // sums
  s.bars = o; o += (size_t)(JF_BARS + TL_WARPS) * 8;                 // mbarriers
  s.total = o;
  return s;
}

// Warp w's sums of the block's logits over its range of K, float4 steps
// [s0, s1) (a sixteenth of J / 4): rows r < 8 of act (pitch; row r read as
// min(r, mr - 1)) times W_out's slice (wo: [J / 4][cols][4]), into red
// [warp][8][cols]. Lane (n8, c) takes column n8 of groups 2c and 2c + 1
// for all 8 rows, K in order (FMAs): a quarter warp reads 8 neighbouring
// float4s of weights, and the whole warp one float4 of a row of h (a
// broadcast), at a time.
__device__ __forceinline__ void jf_sums(const float* act, int pitch, int mr, const float* wo,
                                        int cols, int gb, int s0, int s1, float* red) {
  const int lane = threadIdx.x & 31, n8 = lane & 7, ga = 2 * (lane >> 3);
  const bool on0 = ga < gb, on1 = ga + 1 < gb;
  const float* wl = wo + (size_t)(min(ga, gb - 1) * TL_GW + n8) * 4;
  const int off1 = on1 ? TL_GW * 4 : 0;
  float acc[2][TL_MR];
#pragma unroll
  for (int r = 0; r < TL_MR; ++r) acc[0][r] = acc[1][r] = 0.f;
#pragma unroll 2
  for (int s = s0; s < s1; ++s) {
    const float4 wa = *reinterpret_cast<const float4*>(wl + (size_t)s * cols * 4);
    const float4 wb = *reinterpret_cast<const float4*>(wl + (size_t)s * cols * 4 + off1);
#pragma unroll
    for (int r = 0; r < TL_MR; ++r) {
      const float4 x =
          *reinterpret_cast<const float4*>(act + (size_t)min(r, mr - 1) * pitch + 4 * s);
      acc[0][r] = fmaf(x.w, wa.w, fmaf(x.z, wa.z, fmaf(x.y, wa.y, fmaf(x.x, wa.x, acc[0][r]))));
      acc[1][r] = fmaf(x.w, wb.w, fmaf(x.z, wb.z, fmaf(x.y, wb.y, fmaf(x.x, wb.x, acc[1][r]))));
    }
  }
  float* rw = red + (size_t)(threadIdx.x >> 5) * TL_MR * cols + ga * TL_GW + n8;
#pragma unroll
  for (int r = 0; r < TL_MR; ++r) {
    if (on0) rw[(size_t)r * cols] = acc[0][r];
    if (on1) rw[(size_t)r * cols + TL_GW] = acc[1][r];
  }
}

struct JfArgs {
  const float *e, *g;
  int M, P, J, V, hc, gb;
  int ths, ndur, blank;
  float penalty;
  const float* packed;
  float* logits;
  int *tok, *dur;
  int* ticket;                            // scratch: the blocks' arrivals
  float* h;                               // [M, J]
  float4* pairs;                          // [M][blocks]: token (max, index), duration's
};

__global__ void __launch_bounds__(TL_THREADS, 1) joint_step_f32_kernel(JfArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  const int M = p.M, P = p.P, J = p.J, V = p.V, hc = p.hc, gb = p.gb;
  const int cols = gb * TL_GW, runs = (P + JF_RUN - 1) / JF_RUN, gp = P + 4, hp = J + 4;
  const JfSmem L = jf_smem(P, J, hc, gb);
  const JfBlob B = jf_blob(P, J, hc, gb);
  const float* w = reinterpret_cast<const float*>(smem + L.w);
  const float* wp = w;                                        // [hc][P]
  const float* bp = w + B.bp;                                 // [hc]
  const float* bo = w + B.bo;                                 // [cols]
  const float* wo = w + B.wo;                                 // [J / 4][cols][4]
  float* rows = reinterpret_cast<float*>(smem + L.rows);      // g's rows [8][P + 4], h's [8][J + 4]
  float* red = reinterpret_cast<float*>(smem + L.red);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h0 = blockIdx.x * hc, c0 = blockIdx.x * cols;
  TL_MARK(0);

  if (threadIdx.x == 0) {
    for (int i = 0; i < JF_BARS + TL_WARPS; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const float* mine = p.packed + blockIdx.x * B.total;
    const uint64_t once = evict_first();
    mbar_expect(bars + JF_PRED, (uint32_t)(B.wo * 4));
    bulk_copy_hint(smem + L.w, mine, (uint32_t)(B.wo * 4), bars + JF_PRED, once);
    bulk_rows(rows, (size_t)gp * 4, p.g, (size_t)P * 4, min(TL_MR, M), P * 4, bars + JF_G);
    const int steps = J / 4, per = (steps + TL_WARPS - 1) / TL_WARPS;
    const uint32_t out_bytes = (uint32_t)((size_t)min(steps, JF_EARLY * per) * cols * 16);
    mbar_expect(bars + JF_OUT, out_bytes);
    bulk_copy_hint(smem + L.w + B.wo * 4, mine + B.wo, out_bytes, bars + JF_OUT, once);
    if (blockIdx.x == 0) *p.ticket = 0;
  }
  __syncthreads();                          // the mbarriers are ready
  TL_MARK(1);
  mbar_wait(bars + JF_PRED);
  TL_MARK(2);

  // (1) h on the block's columns: item (row, run, column) of a pass, a
  // thread each, the row fastest (g's rows a 16-byte bank offset apart, the
  // weights one broadcast), its run summed in order; then the runs added in
  // order
  int g_parity = 0;
  for (int m0 = 0; m0 < M; m0 += TL_MR) {
    const int mr = min(TL_MR, M - m0);
    if (m0 > 0 && threadIdx.x == 0) {       // the previous pass's reads of g's rows are done
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bulk_rows(rows, (size_t)gp * 4, p.g + (size_t)m0 * P, (size_t)P * 4, mr, P * 4,
                bars + JF_G);
    }
    // the pass's e of the (row, column) whose h this thread adds up below
    const int r_e = threadIdx.x / hc, n_e = h0 + threadIdx.x % hc;
    const float ev = threadIdx.x < mr * hc && n_e < J ? p.e[(size_t)(m0 + r_e) * J + n_e] : 0.f;
    mbar_wait(bars + JF_G, g_parity);
    g_parity ^= 1;
    TL_MARK(12);
    for (int it = threadIdx.x; it < mr * hc * runs; it += TL_THREADS) {
      const int r = it % mr, run = (it / mr) % runs, c = it / (mr * runs);
      if (h0 + c >= J) continue;
      const float* gr = rows + (size_t)r * gp;
      const float* wc = wp + (size_t)c * P;
      float acc = 0.f;
#pragma unroll 4
      for (int k = run * JF_RUN; k < min(P, (run + 1) * JF_RUN); k += 4) {
        const float4 a = *reinterpret_cast<const float4*>(gr + k);
        const float4 b = *reinterpret_cast<const float4*>(wc + k);
        acc = fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
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
      p.h[(size_t)t * J + n] = fmaxf(__fadd_rn(__fadd_rn(e, v), bp[c]), 0.f);
    }
    __syncthreads();
  }
  TL_MARK(4);
  cg::this_grid().sync();
  TL_MARK(5);

  // (2) the block's logits, 8 rows a pass, and its argmax pairs
  // warp w's range of K: float4 steps [k0, k1)
  const int steps = J / 4, per = (steps + TL_WARPS - 1) / TL_WARPS;
  const int k0 = min(steps, warp * per), k1 = min(steps, k0 + per), kn = k1 - k0;
  for (int m0 = 0; m0 < M; m0 += TL_MR) {
    const int mr = min(TL_MR, M - m0);
    for (int i = lane; i < mr * kn; i += 32) {      // the warp's range of h's rows
      const int r = i / kn, c = k0 + i - r * kn;
      *reinterpret_cast<float4*>(rows + (size_t)r * hp + 4 * c) =
          __ldcg(reinterpret_cast<const float4*>(p.h + (size_t)(m0 + r) * J) + c);
    }
    __syncwarp();
    if (m0 == 0 && lane == 0 && warp >= JF_EARLY && kn > 0) {   // a late warp's range of W_out
      const uint32_t bytes = (uint32_t)((size_t)kn * cols * 16);
      mbar_expect(bars + JF_BARS + warp, bytes);
      bulk_copy_hint(smem + L.w + (B.wo + (size_t)k0 * cols * 4) * 4,
                     p.packed + blockIdx.x * B.total + B.wo + (size_t)k0 * cols * 4, bytes,
                     bars + JF_BARS + warp, evict_first());
    }
    TL_MARK(7);
    if (warp < JF_EARLY)
      mbar_wait(bars + JF_OUT);
    else if (kn > 0)
      mbar_wait(bars + JF_BARS + warp);
    TL_MARK(6);
    jf_sums(rows, hp, mr, wo, cols, gb, k0, k1, red);
    TL_MARK(19);
    __syncthreads();
    TL_MARK(20);
    // one warp a row: the logits (the ranges' sums added in order, plus
    // b_out), written out, and their (max, first index) of each head
    for (int r = warp; r < mr; r += TL_WARPS) {
      float tv = -INFINITY, dv = -INFINITY;
      int ti = 0x7fffffff, di = 0x7fffffff;
      for (int j = lane; j < cols; j += 32) {
        const int n = c0 + j;
        float v = 0.f;
        for (int q = 0; q < TL_WARPS; ++q)
          v = __fadd_rn(v, red[((size_t)q * TL_MR + r) * cols + j]);
        v = __fadd_rn(v, bo[j]);
        if (n < V) p.logits[(size_t)(m0 + r) * V + n] = v;
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
    TL_MARK(8);
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

static int jf_smem_set = -1;         // the kernel's dynamic shared memory limit, as set

static cudaError_t set_jf_smem(int smem) {
  const cudaError_t err = cudaFuncSetAttribute(
      joint_step_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  jf_smem_set = err == cudaSuccess ? smem : -1;
  return err;
}

// e [rows, J] f32 (the encoder projection with its bias), g [rows, P] f32
// (16-byte aligned, P a multiple of 4; J a multiple of 8); packed: the
// joint's weight slices, [blocks][jf_blob(P, J, hc, gb).total] f32
// (ops/kernels/joint_step.py:pack_joint_step, 16-byte aligned). The launch
// plan (blocks, gb, hc, smem: dynamic shared bytes) comes from the wrapper
// and is checked against this file's layout. logits [rows, V] f32, tok and
// dur [rows] int32. scratch: the ticket (16 bytes), h [rows, J] f32
// (16-byte aligned), the pairs [rows][blocks] of float4. Returns the CUDA
// error code (cudaErrorCooperativeLaunchTooLarge when the blocks cannot all
// be resident).
extern "C" int joint_step_f32_launch(const float* e, const float* g, int rows, int P, int J,
                                     int V, const void* packed, int blocks, int gb, int hc,
                                     int smem, int ths, int ndur, int blank_id, float penalty,
                                     float* logits, int* tok, int* dur, void* scratch,
                                     void* stream_ptr) {
  const size_t groups = ((size_t)V + TL_GW - 1) / TL_GW;
  if (rows < 1 || P < 4 || P % 4 || J < TL_GW || J % TL_GW || V < 1 || ths < 1 || ndur < 1 ||
      ths + ndur > V || blank_id < 0 || blank_id >= ths || gb < 1 || gb > JF_GROUPS || blocks < 1 ||
      (size_t)blocks * gb < groups || (size_t)(blocks - 1) * gb >= groups || hc < 1 ||
      (size_t)blocks * hc < (size_t)J || jf_smem(P, J, hc, gb).total != (size_t)smem)
    return (int)cudaErrorInvalidValue;
  if (smem != jf_smem_set) {
    const cudaError_t err = set_jf_smem(smem);
    if (err != cudaSuccess) return (int)err;
  }
  unsigned char* s = static_cast<unsigned char*>(scratch);
  const size_t hb = tail_align((size_t)rows * J * 4);
  JfArgs p = {e, g, rows, P, J, V, hc, gb, ths, ndur, blank_id, penalty,
              static_cast<const float*>(packed), logits, tok, dur, reinterpret_cast<int*>(s),
              reinterpret_cast<float*>(s + 16), reinterpret_cast<float4*>(s + 16 + hb)};
  void* args[] = {&p};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)joint_step_f32_kernel, dim3(blocks), dim3(TL_THREADS), args, (size_t)smem,
      (cudaStream_t)stream_ptr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// info[0] = blocks of the kernel an SM holds with `smem` dynamic shared
// bytes (the CUDA occupancy API)
extern "C" int joint_step_f32_occupancy(int smem, int* info) {
  const cudaError_t err = set_jf_smem(smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], joint_step_f32_kernel,
                                                            TL_THREADS, (size_t)smem);
}
