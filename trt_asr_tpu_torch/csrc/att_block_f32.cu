// Fused conformer attention block with f32 weights (B=1 streaming chunks):
// one persistent cooperative launch a layer, the weights streamed through
// shared memory in runs of K.
//
// Replaces: trt_asr_tpu/ops/pallas/att_block_kernel.py:att_block_pallas (its
// pallas_call at :170) with f32 weights; int8 weights take
// csrc/att_block_q8.cu, bf16 weights the chain of csrc/att_block.cu. For
// the M (= Tq) new rows x of one layer:
//   u = LN(x); q, k_new, v_new = u @ Wq, u @ Wk, u @ Wv
//   per head: scores[t, s] = ((q+u_bias)[t] . k[s] + (q+v_bias)[t] . pos[r0[s]-t]) / sqrt(dh)
//             over the ring kv cache (C slots) ++ the current rows, masked;
//             p = softmax(scores); ctx = p @ v
//   y = x + ctx @ Wo
// and returns (y, u, k_new, v_new). Everything is f32: nothing is rounded.
//
// Bound on the H100: memory. At full width (D 1024, H 8, C 256, Tq 8) a
// layer reads 16.8 MB of f32 weights, the f32 kv cache (2.1 MB) and the
// f32 positional table (1.1 MB, R = 2 Tq + C - 1 = 271 rows): 6.0 us at
// 3.35 TB/s, against 67 MFLOP of products and 13 MFLOP of attention core.
//
// Design. As csrc/att_block_q8.cu: one cooperative launch, one block an SM,
// 512 threads; block b owns cD columns (8 at full width, 128 blocks; the
// wrapper's plan, ops/kernels/att_block.py:att_block_f32_plan) of Wq, Wk,
// Wv and Wo over the whole K, and one scores item; three grid barriers;
// phases (c) and (d) are the int8 kernel's without its rounding points
// (with csrc/att_core.cuh's helpers). What differs is the weights: a
// block's f32 slices are 128 KB at full width, too many to hold beside the
// staging, so they flow through a ring of `stages` slots of shared memory
// in runs of AF_RUN rows of K, each run one bulk copy.
//   Packed layout (pack_att_f32 in ops/kernels/att_block.py), a block's
//   slice contiguous, in the order the ring takes it: R = ceil(D / AF_RUN)
//   Q/K/V runs, each [3 (Wq, Wk, Wv)][AF_RUN / 4][cD][4] f32 (a column's
//   four consecutive K values in one float4, the columns side by side), then
//   R Wo runs, each [AF_RUN / 4][cD][4]; zero past D and K past its end.
//   Piece i of the stream (Q/K/V run i, or Wo run i - R) goes to slot i mod
//   stages and completes on mbarrier i, used once (a barrier a slot, waited
//   for by phase parity, would let a warp waiting two uses ahead through).
// At entry thread 0 issues x's rows, then the first `stages` pieces; a
// warp that has summed a piece issues piece i + stages into the slot it
// frees, so the Wo runs enter the ring as Q/K/V drains it and land during
// barriers 1-2 and the attention core. Phases:
//   (a) LN of all rows in every block in place of x's rows (one warp a
//       row; block 0 writes u);
//   (b) warp w sums Q/K/V runs w, w + 16, ... as each lands: FFMA on the
//       CUDA cores (no TF32: the f32 policy), a lane a column and two rows
//       of each group of 8, each run's K in order; the runs' sums added in
//       order (no atomics) into q, k_new, v_new; the copies of the scores
//       item's rows and of the block's columns of the cache's values start
//       once the warp's runs are summed (the weight stream no longer needs
//       the memory system);
//   grid barrier; (c) scores; grid barrier; (d) p and ctx, f32 into scratch;
//   grid barrier;
//   (e) warp w bulk-copies its runs' K range of ctx's rows, sums its Wo
//       runs as they land (each in four quarters of K), the runs added in
//       order: y = x + sum.
// The Q/K/V sums run in the order of the plain version's f32 products on
// the H100 (each run's K in order, the runs added in order: cuBLAS at M 8,
// K 1024; see att_variants.py --orders), and the scores and context sum as
// there too; LN sums otherwise than torch, so results differ by f32 ulps,
// and the Wo sums otherwise too (y is not summed again). Every sum
// runs in a fixed order: the kernel is deterministic, and a captured CUDA
// graph replays it bit for bit (chip_smoke.py phase 2).
#include "att_core.cuh"

namespace port {

constexpr int AF_RUN = 64;                // rows of K a run of the weights

// mbarriers: x's rows and the LN's norms; the item's positional band and
// key rows; each warp's K range of ctx's rows; then one a piece of the
// weight stream
enum { AF_X, AF_BAND, AF_KEYS, AF_CTX, AF_PIECE = AF_CTX + TL_WARPS };

__host__ __device__ inline int af_runs(int D) { return (D + AF_RUN - 1) / AF_RUN; }

// floats of a ring slot: one Q/K/V run of the block's columns
__host__ __device__ inline size_t af_slot(int cD) { return (size_t)AF_RUN * 3 * cD; }

// Byte offsets of the dynamic shared memory, mirrored by the wrapper's plan.
struct AfSmem {
  size_t ring, xs, qs, keys, band, am, vc, vn, sp, part, red, bars, total;
};

__host__ __device__ inline AfSmem af_smem(int M, int D, int H, int C, int cD, int slots,
                                          int stages) {
  const size_t kp = att_pitch(D / H), R = af_runs(D);
  AfSmem s;
  size_t o = 0;
  s.ring = o;  o += (size_t)stages * af_slot(cD) * 4;             // the weights' ring
  s.xs = o;    o += (size_t)M * R * AF_RUN * 4;                   // x's rows, u's, ctx's
  s.qs = o;    o += (size_t)2 * M * kp * 4;                       // q + u_bias, q + v_bias
  s.keys = o;  o += (size_t)slots * kp * 4;                       // the item's key rows
  s.band = o;  o += (size_t)(slots + M - 1) * kp * 4;             // its positional rows
  s.am = o;    o += tail_align((size_t)2 * M * slots * 4);        // its dots, both terms
  s.vc = o;    o += (size_t)C * cD * 4;                           // the cache's values
  s.vn = o;    o += tail_align((size_t)M * cD * 4);               // v_new's
  s.sp = o;    o += (size_t)M * att_s4(C + M) * 4;                // scores, then p
  s.part = o;  o += (size_t)2 * M * TL_GW * 4;                    // the context's halves
  s.red = o;   o += (size_t)tail_max((int)R * M * 3 * cD, 2 * D) * 4;   // sums; LN's norms
  s.bars = o;  o += (size_t)(AF_PIECE + 2 * R) * 8;              // mbarriers
  s.total = o;
  return s;
}

// Thread: piece i of the block's weight stream (its slice `mine`) into
// ring slot i mod stages, completing on mbarrier i of piece_bars
__device__ __forceinline__ void af_issue(int i, int R, int cD, int stages, const float* mine,
                                         float* ring, uint64_t* piece_bars) {
  const int s = i % stages;
  const size_t off = i < R ? (size_t)i * af_slot(cD)
                           : (size_t)R * af_slot(cD) + (size_t)(i - R) * AF_RUN * cD;
  const uint32_t bytes = (uint32_t)((i < R ? af_slot(cD) : (size_t)AF_RUN * cD) * 4);
  mbar_expect(piece_bars + i, bytes);
  bulk_copy(ring + (size_t)s * af_slot(cD), mine + off, bytes, piece_bars + i);
}

// A warp: once it has summed piece i, piece i + stages into the freed slot
__device__ __forceinline__ void af_refill(int i, int R, int cD, int stages, const float* mine,
                                          float* ring, uint64_t* piece_bars) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0 && i + stages < 2 * R) {
    // the warp's generic reads of the slot come before the copy's writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    af_issue(i + stages, R, cD, stages, mine, ring, piece_bars);
  }
}

// A warp's Q/K/V sums of run r: rows t < M of xs (row pitch Kp, zero in
// [D, Kp)) over the run's K with the block's cD columns of Wq, Wk, Wv (w:
// the run's slot, [3][AF_RUN / 4][cD][4]), K in order (FMAs), into red
// [M][3][cD]. Lane (n8 = lane % 8, g = lane / 8) takes column c0 + n8 of
// each group of 8 and rows m0 + g, m0 + g + 4 of each group of 8 rows: a
// quarter warp reads 8 neighbouring float4s of weights and one operand
// float4 (a broadcast) a step. Inlined: a call would take the slot and the
// rows as generic pointers, whose loads are slower; 8 rows a lane, as
// af_wo_sums, is 1.2 us slower here (att_variants.py --f32).
__device__ __forceinline__ void af_qkv_sums(const float* xs, int Kp, int M, const float* w,
                                            int cD, int r, float* red) {
  const int lane = threadIdx.x & 31, n8 = lane & 7, g = lane >> 3;
  const size_t wsz = (size_t)(AF_RUN / 4) * cD * 4;           // floats of a weight's run
  const float* xr = xs + (size_t)r * AF_RUN;
  for (int c0 = 0; c0 < cD; c0 += TL_GW) {
    const float* wc = w + (size_t)(c0 + n8) * 4;
    for (int m0 = 0; m0 < M; m0 += TL_MR) {
      const int t0 = m0 + g, t1 = m0 + g + 4;
      const float* a0 = xr + (size_t)min(t0, M - 1) * Kp;
      const float* a1 = xr + (size_t)min(t1, M - 1) * Kp;
      float acc[3][2];
#pragma unroll
      for (int q = 0; q < 3; ++q) acc[q][0] = acc[q][1] = 0.f;
#pragma unroll 4
      for (int k4 = 0; k4 < AF_RUN / 4; ++k4) {
        const float4 x0 = *reinterpret_cast<const float4*>(a0 + 4 * k4);
        const float4 x1 = *reinterpret_cast<const float4*>(a1 + 4 * k4);
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(wc + q * wsz + (size_t)k4 * cD * 4);
          acc[q][0] = fmaf(x0.w, v.w, fmaf(x0.z, v.z, fmaf(x0.y, v.y, fmaf(x0.x, v.x, acc[q][0]))));
          acc[q][1] = fmaf(x1.w, v.w, fmaf(x1.z, v.z, fmaf(x1.y, v.y, fmaf(x1.x, v.x, acc[q][1]))));
        }
      }
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        if (t0 < M) red[((size_t)t0 * 3 + q) * cD + c0 + n8] = acc[q][0];
        if (t1 < M) red[((size_t)t1 * 3 + q) * cD + c0 + n8] = acc[q][1];
      }
    }
  }
}

// A warp's Wo sums of run r: rows t < M of xs (ctx's) over the run's K with
// the block's cD columns of Wo (w: [AF_RUN / 4][cD][4]), into red [M][cD].
// Lane (n8 = lane % 8, kq = lane / 8) takes column c0 + n8 of each group of
// 8 and the kq-th quarter of the run's K, in order (FMAs), for the 8 rows of
// each group of rows (one weight float4 feeds 8 rows); the quarters' sums
// are added in a fixed order, (0 + 1) + (2 + 3), by shuffles. 0.2-0.6 us
// faster than af_qkv_sums's split for this one weight (att_variants.py
// --f32, each version in both roles of the pairs).
__device__ __forceinline__ void af_wo_sums(const float* xs, int Kp, int M, const float* w,
                                           int cD, int r, float* red) {
  constexpr int KQ = AF_RUN / 16;                              // float4 steps a quarter
  const int lane = threadIdx.x & 31, n8 = lane & 7, kq = lane >> 3;
  const float* xr = xs + (size_t)r * AF_RUN + kq * KQ * 4;
  for (int c0 = 0; c0 < cD; c0 += TL_GW) {
    const float* wc = w + ((size_t)kq * KQ * cD + c0 + n8) * 4;
    for (int m0 = 0; m0 < M; m0 += TL_MR) {
      float acc[TL_MR];
#pragma unroll
      for (int t = 0; t < TL_MR; ++t) acc[t] = 0.f;
#pragma unroll
      for (int k4 = 0; k4 < KQ; ++k4) {
        const float4 v = *reinterpret_cast<const float4*>(wc + (size_t)k4 * cD * 4);
#pragma unroll
        for (int t = 0; t < TL_MR; ++t) {
          const float4 x = *reinterpret_cast<const float4*>(
              xr + (size_t)min(m0 + t, M - 1) * Kp + 4 * k4);
          acc[t] = fmaf(x.w, v.w, fmaf(x.z, v.z, fmaf(x.y, v.y, fmaf(x.x, v.x, acc[t]))));
        }
      }
#pragma unroll
      for (int t = 0; t < TL_MR; ++t) {
        float sum = __fadd_rn(acc[t], __shfl_xor_sync(0xffffffffu, acc[t], 8));
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 16));
        if (kq == 0 && m0 + t < M) red[(size_t)(m0 + t) * cD + c0 + n8] = sum;
      }
    }
  }
}

// The block's scores item: head h, kv positions [i0, i1) of the C + M
struct AfItem {
  int h, i0, i1;
  bool on;
};

__device__ __forceinline__ AfItem af_item(const AttArgs& p) {
  const int S = p.C + p.M;
  AfItem it;
  it.h = blockIdx.x / p.ranges;
  it.i0 = (blockIdx.x % p.ranges) * p.slots;
  it.i1 = min(S, it.i0 + p.slots);
  it.on = it.h < p.H && it.i0 < S;
  return it;
}

// The copies of what the block reads after barrier 1 and no other block
// writes: warp 1 the item's positional band, warp 2 its key rows (bulk
// copies, a lane a row); every thread its share of the block's columns of
// the cache's values (cp.async, committed).
__device__ __forceinline__ void af_item_copies(const AttArgs& p, float* keys, float* band,
                                               float* vc, uint64_t* bar_band,
                                               uint64_t* bar_keys) {
  const int D = p.D, M = p.M, C = p.C, cD = p.cD, dh = D / p.H, kp = att_pitch(dh);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const AfItem it = af_item(p);
  const size_t hc = (size_t)it.h * dh;                        // the head's first column
  const uint32_t row_b = dh * 4;
  if (it.on && warp == 1) {
    // positional rows r = i0 .. i1 + M - 2, the head's columns
    const int rows = it.i1 - it.i0 + M - 1;
    if (lane == 0) mbar_expect(bar_band, rows * row_b);
    __syncwarp();
    for (int r = lane; r < rows; r += 32)
      bulk_copy(band + (size_t)r * kp, p.pos + (size_t)(it.i0 + r) * D + hc, row_b, bar_band);
  } else if (it.on && warp == 2) {
    // key rows of the item's cache positions: position i is ring slot
    // (cursor + i) mod C, the entry of age C - i
    const int cursor = p.meta[0], i_end = min(it.i1, C);
    if (lane == 0) mbar_expect(bar_keys, max(0, i_end - it.i0) * row_b);
    __syncwarp();
    for (int i = it.i0 + lane; i < i_end; i += 32)
      bulk_copy(keys + (size_t)(i - it.i0) * kp, p.kv + (size_t)((cursor + i) % C) * 2 * D + hc,
                row_b, bar_keys);
  }
  const int n0 = blockIdx.x * cD, c4 = cD / 4;
  for (int i = threadIdx.x; i < C * c4; i += TL_THREADS) {
    const int s = i / c4, j = 4 * (i - s * c4);
    const bool in = n0 + j < D;             // zero past D
    cp_async<16>(vc + (size_t)s * cD + j, p.kv + (size_t)s * 2 * D + D + (in ? n0 + j : 0),
                 in ? 16 : 0);
  }
  cp_async_commit();
}

// (c) the item's scores (as csrc/att_block_q8.cu's, without its rounding
// points): M query rows x its kv positions, in the order of their
// positional row r0 = Tq - 1 + i (the oldest cache entry first, the
// current rows last), so that the rows r = r0 - t form one band whatever
// the ring's cursor; to scratch in ring-slot order. q (all blocks'
// columns, after a grid barrier) and the current key rows come from device
// memory, the rest from the item's copies. A thread a dot: (q + u_bias) . k
// of output o, or, from the next whole warp on, (q + v_bias) . pos of
// output o; output o = (row t, position i0 + o % ni). qu, qv: [M][kp];
// keys [slots][kp]; band [slots + M - 1][kp]; am [2][M x slots].
__device__ __forceinline__ void af_scores(const AttArgs& p, float* qu, float* qv, float* keys,
                                          const float* band, float* am, uint64_t* bar_band,
                                          uint64_t* bar_keys) {
  const AfItem it = af_item(p);
  if (!it.on) return;
  const int M = p.M, D = p.D, C = p.C, dh = D / p.H, kp = att_pitch(dh);
  const int i0 = it.i0, i1 = it.i1, ni = i1 - i0, d4 = dh / 4, n_out = M * ni;
  const int S4 = att_s4(C + M);
  const size_t hc = (size_t)it.h * dh;
  const int cursor = p.meta[0], cache_len = p.meta[1], valid_tq = p.meta[2];
  for (int i = threadIdx.x; i < M * d4; i += TL_THREADS) {
    const int t = i / d4, c = 4 * (i - t * d4);
    const float4 qq = __ldcg(reinterpret_cast<const float4*>(p.q + (size_t)t * D + hc + c));
    const float4 bu = *reinterpret_cast<const float4*>(p.bias_u + hc + c);
    const float4 bv = *reinterpret_cast<const float4*>(p.bias_v + hc + c);
    *reinterpret_cast<float4*>(qu + (size_t)t * kp + c) = make_float4(
        __fadd_rn(qq.x, bu.x), __fadd_rn(qq.y, bu.y), __fadd_rn(qq.z, bu.z),
        __fadd_rn(qq.w, bu.w));
    *reinterpret_cast<float4*>(qv + (size_t)t * kp + c) = make_float4(
        __fadd_rn(qq.x, bv.x), __fadd_rn(qq.y, bv.y), __fadd_rn(qq.z, bv.z),
        __fadd_rn(qq.w, bv.w));
  }
  const int j0 = max(i0, C);                // the item's current rows: positions j0 .. i1 - 1
  for (int i = threadIdx.x; i < max(0, i1 - j0) * d4; i += TL_THREADS) {
    const int r = i / d4, c = 4 * (i - r * d4);
    *reinterpret_cast<float4*>(keys + (size_t)(j0 + r - i0) * kp + c) = __ldcg(
        reinterpret_cast<const float4*>(p.k_new + (size_t)(j0 + r - C) * D + hc + c));
  }
  mbar_wait(bar_keys);
  mbar_wait(bar_band);
  __syncthreads();
  TL_MARK(6);
  const int n_pad = (n_out + 31) & ~31;
  for (int j = threadIdx.x; j < 2 * n_pad; j += TL_THREADS) {
    const int which = j >= n_pad, o = j - which * n_pad, t = o / ni, i = i0 + o - t * ni;
    if (o >= n_out || (i < C ? i < C - cache_len : i - C >= valid_tq)) continue;  // masked
    am[which * n_out + o] =
        which ? dot_by16(qv + (size_t)t * kp, band + (size_t)(i - t + M - 1 - i0) * kp, dh)
              : dot_by16(qu + (size_t)t * kp, keys + (size_t)(i - i0) * kp, dh);
  }
  __syncthreads();
  for (int o = threadIdx.x; o < n_out; o += TL_THREADS) {
    const int t = o / ni, i = i0 + o - t * ni;
    const bool ok = i < C ? i >= C - cache_len : i - C < valid_tq;
    p.scores[((size_t)it.h * M + t) * S4 + (i < C ? (cursor + i) % C : i)] =
        ok ? __fmul_rn(__fadd_rn(am[o], am[n_out + o]), p.scale) : -1e30f;
  }
}

// (d) p and ctx on the block's columns, a group of 8 at a time: the head's
// scores of all slots (from L2), one warp a row: max, sum, p; then ctx =
// p @ v over all slots for those columns (vc: the cache's values, [C][cD];
// vn: v_new's, [M][cD], computed by the block itself), each of the sums in
// two halves of the slots, each in slot order (FMAs), the halves added;
// ctx f32 into scratch. sp: [M][S4]; part: [2][M x 8].
__device__ __forceinline__ void af_context(const AttArgs& p, const float* vc, const float* vn,
                                           float* sp, float* part) {
  const int M = p.M, D = p.D, C = p.C, cD = p.cD, S = C + M, S4 = att_s4(S), dh = D / p.H;
  const int n0 = blockIdx.x * cD, gd = cD / TL_GW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* ctx = static_cast<float*>(p.ctx);
  cp_async_wait<0>();
  __syncthreads();
  const int O = M * TL_GW;
  for (int g = 0, h_p = -1; g < gd && n0 + g * TL_GW < D; ++g) {
    const int col0 = n0 + g * TL_GW, hg = col0 / dh;
    if (hg != h_p) {
      const float4* src = reinterpret_cast<const float4*>(p.scores + (size_t)hg * M * S4);
      for (int i = threadIdx.x; i < M * S4 / 4; i += TL_THREADS)
        reinterpret_cast<float4*>(sp)[i] = __ldcg(src + i);
      __syncthreads();
      for (int t = warp; t < M; t += TL_WARPS) {
        float* row = sp + (size_t)t * S4;
        float mx = -INFINITY;
        for (int s = lane; s < S; s += 32) mx = fmaxf(mx, row[s]);
        mx = warp_max(mx);
        float sum = 0.f;
        for (int s = lane; s < S; s += 32) {
          const float e = expf(row[s] - mx);
          row[s] = e;
          sum += e;
        }
        sum = warp_sum(sum);
        for (int s = lane; s < S; s += 32) row[s] = row[s] / sum;
      }
      __syncthreads();
      h_p = hg;
      TL_MARK(9);
    }
    for (int i = threadIdx.x; i < 2 * O; i += TL_THREADS) {
      const int k = i / O, o = i - k * O, t = o / TL_GW, c = g * TL_GW + o % TL_GW;
      const float* pr = sp + (size_t)t * S4;
      const int s0 = k * (S / 2), s1 = k ? S : S / 2, sc = min(s1, C);
      float acc = 0.f;
#pragma unroll 8
      for (int s = s0; s < sc; ++s) acc = fmaf(pr[s], vc[(size_t)s * cD + c], acc);
#pragma unroll 8
      for (int s = max(s0, C); s < s1; ++s) acc = fmaf(pr[s], vn[(s - C) * cD + c], acc);
      part[i] = acc;
    }
    __syncthreads();
    for (int o = threadIdx.x; o < O; o += TL_THREADS)
      ctx[(size_t)(o / TL_GW) * D + col0 + o % TL_GW] = __fadd_rn(part[o], part[O + o]);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(TL_THREADS, 1) att_block_f32_kernel(AttArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int M = p.M, D = p.D, H = p.H, C = p.C, cD = p.cD, st = p.stages;
  const int R = af_runs(D), Kp = R * AF_RUN, kp = att_pitch(D / H);
  const AfSmem L = af_smem(M, D, H, C, cD, p.slots, st);
  float* ring = reinterpret_cast<float*>(smem + L.ring);      // [stages][af_slot]
  float* xs = reinterpret_cast<float*>(smem + L.xs);          // [M][Kp]
  float* qu = reinterpret_cast<float*>(smem + L.qs);          // [M][kp]
  float* qv = qu + (size_t)M * kp;                            // [M][kp]
  float* keys = reinterpret_cast<float*>(smem + L.keys);      // [slots][kp]
  float* band = reinterpret_cast<float*>(smem + L.band);      // [slots + M - 1][kp]
  float* am = reinterpret_cast<float*>(smem + L.am);          // [2][M x slots]
  float* vc = reinterpret_cast<float*>(smem + L.vc);          // [C][cD]
  float* vn = reinterpret_cast<float*>(smem + L.vn);          // [M][cD]
  float* sp = reinterpret_cast<float*>(smem + L.sp);          // [M][S4]
  float* part = reinterpret_cast<float*>(smem + L.part);
  float* red = reinterpret_cast<float*>(smem + L.red);        // [R][M][3][cD]
  float* norms = red;                                         // [2][D], read by (a) only
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* piece_bars = bars + AF_PIECE;
  const float* mine = static_cast<const float*>(p.packed) + (size_t)blockIdx.x * Kp * 4 * cD;
  const int n0 = blockIdx.x * cD, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const cg::grid_group grid = cg::this_grid();
  TL_MARK(0);

  // Thread 0 starts the copies of x's rows and the norms, then the weight
  // stream (x first: the LN runs while the weights land)
  if (threadIdx.x == 0) {
    for (int i = 0; i < AF_PIECE + 2 * R; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(bars + AF_X, (uint32_t)(M + 2) * D * 4);
    for (int t = 0; t < M; ++t)
      bulk_copy(xs + (size_t)t * Kp, p.x + (size_t)t * D, D * 4, bars + AF_X);
    bulk_copy(norms, p.ln_g, D * 4, bars + AF_X);
    bulk_copy(norms + D, p.ln_b, D * 4, bars + AF_X);
    for (int i = 0; i < min(st, 2 * R); ++i) af_issue(i, R, cD, st, mine, ring, piece_bars);
  }
  __syncthreads();                          // the mbarriers are ready
  // xs's columns [D, Kp) meet the weights' zero rows past K
  for (int i = threadIdx.x; i < M * (Kp - D); i += TL_THREADS)
    xs[(size_t)(i / (Kp - D)) * Kp + D + i % (Kp - D)] = 0.f;
  TL_MARK(1);
  mbar_wait(bars + AF_X);
  TL_MARK(2);

  // (a) u = LN(x), in place of x's rows (the residual is read from device
  // memory in (e))
  ln_rows_f32(xs, Kp, M, D, norms, norms + D, blockIdx.x == 0 ? p.u : nullptr);
  __syncthreads();
  TL_MARK(14);

  // (b) q, k_new, v_new on the block's columns, a run as it lands
  for (int r = warp; r < R; r += TL_WARPS) {
    mbar_wait(piece_bars + r);
    af_qkv_sums(xs, Kp, M, ring + (size_t)(r % st) * af_slot(cD), cD, r,
                red + (size_t)r * M * 3 * cD);
    af_refill(r, R, cD, st, mine, ring, piece_bars);
  }
  // the item's rows and the cache's values, read after barrier 1: issued
  // once the warp's Q/K/V runs are summed, they land during the barrier
  // instead of delaying the weights
  af_item_copies(p, keys, band, vc, bars + AF_BAND, bars + AF_KEYS);
  __syncthreads();
  TL_MARK(17);
  for (int i = threadIdx.x; i < M * 3 * cD; i += TL_THREADS) {
    const int t = i / (3 * cD), jj = i - t * 3 * cD, which = jj / cD, j = jj - which * cD;
    const int n = n0 + j;
    float v = 0.f;
    for (int r = 0; r < R; ++r) v = __fadd_rn(v, red[((size_t)r * M + t) * 3 * cD + jj]);
    if (which == 2) vn[t * cD + j] = n < D ? v : 0.f;          // the context's operand
    if (n < D) (which == 0 ? p.q : which == 1 ? p.k_new : p.v_new)[(size_t)t * D + n] = v;
  }
  __syncthreads();
  TL_MARK(4);
  grid.sync();
  TL_MARK(5);

  // (c) the item's scores: M query rows x its kv positions
  af_scores(p, qu, qv, keys, band, am, bars + AF_BAND, bars + AF_KEYS);
  TL_MARK(7);
  grid.sync();
  TL_MARK(8);

  // (d) p and ctx on the block's columns, f32 into scratch
  af_context(p, vc, vn, sp, part);
  TL_MARK(10);
  grid.sync();
  TL_MARK(11);

  // (e) y = x + ctx @ Wo on the block's columns: warp w copies the K range
  // of its runs of ctx's rows (written by every block) in place of u's
  if (lane == 0 && warp < R) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    uint32_t bytes = 0;
    for (int r = warp; r < R; r += TL_WARPS) bytes += M * min(AF_RUN, D - r * AF_RUN) * 4;
    mbar_expect(bars + AF_CTX + warp, bytes);
    const float* ctx = static_cast<const float*>(p.ctx);
    for (int r = warp; r < R; r += TL_WARPS)
      for (int t = 0; t < M; ++t)
        bulk_copy(xs + (size_t)t * Kp + r * AF_RUN, ctx + (size_t)t * D + r * AF_RUN,
                  min(AF_RUN, D - r * AF_RUN) * 4, bars + AF_CTX + warp);
  }
  if (warp < R) mbar_wait(bars + AF_CTX + warp);
  TL_MARK(12);
  for (int r = warp; r < R; r += TL_WARPS) {
    const int i = R + r;
    mbar_wait(piece_bars + i);
    af_wo_sums(xs, Kp, M, ring + (size_t)(i % st) * af_slot(cD), cD, r,
               red + (size_t)r * M * cD);
    af_refill(i, R, cD, st, mine, ring, piece_bars);
  }
  __syncthreads();
  TL_MARK(19);
  for (int i = threadIdx.x; i < M * cD; i += TL_THREADS) {
    const int t = i / cD, j = i - t * cD, n = n0 + j;
    if (n < D) {
      float v = 0.f;
      for (int r = 0; r < R; ++r) v = __fadd_rn(v, red[((size_t)r * M + t) * cD + j]);
      p.y[(size_t)t * D + n] = __fadd_rn(p.x[(size_t)t * D + n], v);
    }
  }
  TL_MARK(13);
}

}  // namespace port

using namespace port;

static int af_smem_set = -1;         // the kernel's dynamic shared memory limit, as set

static cudaError_t set_af_smem(int smem) {
  const cudaError_t err = cudaFuncSetAttribute(
      att_block_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  af_smem_set = err == cudaSuccess ? smem : -1;
  return err;
}

// x, y, u, k_new, v_new [M, D] f32; the LN's g, b [D]; bias_u, bias_v [H,
// dh]; pos [2 M + C - 1, D]; kv [C, 2 D] (the ring cache, k ++ v); meta
// int32 [3] = (cursor, cache_len, valid_tq) on the device; scale 1 /
// sqrt(dh); packed: the layer's weights, [blocks][af_runs(D) AF_RUN x 4 cD]
// f32 (ops/kernels/att_block.py:pack_att_block); D and dh multiples of 8
// and 16. The launch plan (blocks, cD, ranges, slots, stages, smem:
// dynamic shared bytes) comes from the wrapper and is checked against this
// file's layout. scratch holds q [M, D] f32, the scores [H, M, C + M] f32
// (16-byte aligned) and ctx [M, D] f32. Returns the CUDA error code
// (cudaErrorCooperativeLaunchTooLarge when the blocks cannot all be resident).
extern "C" int att_block_f32_launch(const float* x, int M, int D, int H, int C,
                                    const float* ln_g, const float* ln_b, const float* bias_u,
                                    const float* bias_v, const float* pos, const float* kv,
                                    const int* meta, float scale, const float* packed,
                                    int blocks, int cD, int ranges, int slots, int stages,
                                    int smem, float* y, float* u, float* k_new, float* v_new,
                                    void* scratch, void* stream_ptr) {
  if (M < 1 || H < 1 || C < 1 || D % TL_GW || D % H || (D / H) % 16 || cD < TL_GW ||
      cD % TL_GW || blocks < 1 || (size_t)blocks * cD < (size_t)D ||
      (size_t)(blocks - 1) * cD >= (size_t)D || ranges < 1 || slots < 1 ||
      (size_t)ranges * slots < (size_t)(C + M) || (size_t)H * ranges > (size_t)blocks ||
      stages < 1 || stages > 2 * af_runs(D) ||
      af_smem(M, D, H, C, cD, slots, stages).total != (size_t)smem)
    return (int)cudaErrorInvalidValue;
  if (smem != af_smem_set) {
    const cudaError_t err = set_af_smem(smem);
    if (err != cudaSuccess) return (int)err;
  }
  unsigned char* s = static_cast<unsigned char*>(scratch);
  const size_t qb = (size_t)M * D * 4, sb = (size_t)H * M * att_s4(C + M) * 4;
  AttArgs p = {x, M, D, H, C, cD, ranges, slots, stages, ln_g, ln_b, bias_u, bias_v, pos, kv,
               meta, scale, packed, y, u, k_new, v_new, reinterpret_cast<float*>(s),
               reinterpret_cast<float*>(s + qb), s + tail_align(qb + sb)};
  void* args[] = {&p};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)att_block_f32_kernel, dim3(blocks), dim3(TL_THREADS), args, (size_t)smem,
      (cudaStream_t)stream_ptr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// info[0] = blocks of the kernel an SM holds with `smem` dynamic shared
// bytes (the CUDA occupancy API)
extern "C" int att_block_f32_occupancy(int smem, int* info) {
  const cudaError_t err = set_af_smem(smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], att_block_f32_kernel,
                                                            TL_THREADS, (size_t)smem);
}
