// Fused conformer attention block with bf16 weights (B=1 streaming chunks):
// one persistent cooperative launch a layer.
//
// Replaces: trt_asr_tpu/ops/pallas/att_block_kernel.py:att_block_pallas (its
// pallas_call at :170) with bf16 weights (those of cast_params_for_compute);
// int8 weights take csrc/att_block_q8.cu, f32 weights csrc/att_block_f32.cu.
// It took the place of the 6-launch chain of csrc/att_block.cu, which stays
// for chip_smoke.py to time beside it. For the M (= Tq) new rows x of one
// layer:
//   u = LN(x); q, k_new, v_new = u @ Wq, u @ Wk, u @ Wv
//   per head: scores[t, s] = ((q+u_bias)[t] . k[s] + (q+v_bias)[t] . pos[r0[s]-t]) / sqrt(dh)
//             over the ring kv cache (C slots) ++ the current rows, masked;
//             p = softmax(scores); ctx = p @ v
//   y = x + ctx @ Wo
// and returns (y, u, k_new, v_new). Rounding points as in csrc/att_block.cu:
// u, q + u_bias, q + v_bias, k, v, the positional term m, p and ctx are
// rounded to bf16; every sum is f32; x, q, k_new, v_new, the scores and the
// residual stream are not rounded. The kv cache is read as it is stored,
// f32 or bf16 (a bf16 encoder state), as the TPU kernel reads it
// (att_block_kernel.py:77-83): no widened copy is made.
//
// Bound on the H100: memory. At full width (D 1024, H 8, C 256, Tq 8) a
// layer reads 8.4 MB of bf16 weights, the kv cache (2.1 MB f32, 1.05 MB
// bf16) and the f32 positional table (1.1 MB, R = 2 Tq + C - 1 = 271
// rows): 3.5 us at 3.35 TB/s with an f32 cache, against 67 MFLOP of
// products and 13 MFLOP of attention core.
//
// Design: the plan of csrc/att_block_q8.cu (its notes say more). One
// cooperative launch, one block an SM, 512 threads. Block b owns cD columns
// (8 at full width, 128 blocks; ops/kernels/att_block.py:att_block_bf16_plan)
// of Wq, Wk, Wv and Wo over the whole K, packed contiguous once with the
// model's bf16 weights (pack_att_block), 64 KB a block at full width. At
// entry the block starts bulk copies of everything it reads that no other
// block writes, each group on its own mbarrier: its Wq|Wk|Wv slice, x's rows
// and the LN's norms, its Wo slice, and the key (as stored) and positional
// rows of its scores item; all its threads copy its columns of the cache's
// values (cp.async, as stored). Phases:
//   (a) LN of all rows in every block (one warp a row; block 0 writes u)
//       into bf16 operand rows;
//   (b) q, k_new, v_new on the block's columns, on the tensor cores
//       (mma.sync.m16n8k16, bf16 operands, f32 sums; the three slices as
//       3 cD / 8 groups of one block_product);
//   grid barrier;
//   (c) scores, one item a block (a head and a run of `slots` kv positions
//       in the order of their positional row, so that the item's rows form
//       one band of slots + Tq - 1 rows), a thread a dot product; to
//       scratch in ring-slot order;
//   grid barrier;
//   (d) softmax and context on the block's own columns (the head's scores
//       from L2; p rounded to bf16, one warp a row; p @ v in two halves of
//       the slots); ctx rounded to bf16 into scratch;
//   grid barrier;
//   (e) ctx's rows bulk-copied out of L2 in four K chunks, Wo on the
//       block's columns on the tensor cores, y = x + sum.
// The tensor cores' sums of q, k_new and v_new are not the plain version's
// order (cuBLAS's f32 SIMT product), so one f32 ulp can move a rounding of
// q + bias or v by a bf16 ulp: the kernel is held to its plain version at
// the bf16 chain's 1e-3 (chip_smoke.py phase 2), as the chain was. The
// scores and the context sum in the int8 kernel's orders.
// After a barrier, what other blocks wrote is read with bulk copies or
// __ldcg, never through a possibly stale L1 line. Every sum runs in a fixed
// order (no atomics): the kernel is deterministic, and a captured CUDA graph
// replays it bit for bit (chip_smoke.py phase 2). Rows are taken 8 at a
// time in the products, all at once in the attention core, so any Tq runs
// whose staging fits shared memory (the plan checks it).
#include "att_core.cuh"

namespace port {

// mbarriers of the bulk copies: x's first rows and the LN's norms; the
// Wq|Wk|Wv slice; the Wo slice; the positional band and the key rows of the
// block's scores item; x's later rows (Tq > 8); the four K chunks of ctx's
// rows (reused pass by pass)
enum { AT_X, AT_QKV, AT_WO, AT_BAND, AT_KEYS, AT_ROWS, AT_CHUNK, AT_BARS = AT_CHUNK + 4 };

// A block's packed slice of the layer's weights (pack_att_bf16 in
// ops/kernels/att_block.py), in bf16 elements: Wq, Wk, Wv, Wo, each
// [cD / 8][Dp / 16][8][16]; zero past D and K past its end.
__host__ __device__ inline size_t atb_slice(int D, int cD) { return (size_t)tail_pad(D) * cD; }

// Byte offsets of the dynamic shared memory, mirrored by the wrapper's plan.
// The same layout takes an f32 or a bf16 cache (a bf16 cache's key rows
// land in kst, its values fill half of vc).
struct AtbSmem {
  size_t w, act, xs, norms, qs, keys, kst, band, am, vc, vn, sp, part, red, bars, total;
};

__host__ __device__ inline AtbSmem atb_smem(int M, int D, int H, int C, int cD, int slots) {
  const int dh = D / H;
  const size_t kp = att_pitch(dh);
  AtbSmem s;
  size_t o = 0;
  s.w = o;     o += 4 * atb_slice(D, cD) * 2;                     // weight slices, bf16
  s.act = o;   o += (size_t)TL_MR * (tail_pad(D) + TL_KS) * 2;    // operand rows, bf16
  s.xs = o;    o += (size_t)TL_MR * D * 4;                        // x's rows
  s.norms = o; o += (size_t)2 * D * 4;                            // LN's g, b
  s.qs = o;    o += (size_t)2 * M * kp * 4;                       // q + u_bias, q + v_bias
  s.keys = o;  o += (size_t)slots * kp * 4;                       // the item's key rows
  s.kst = o;   o += (size_t)slots * dh * 2;                       // as stored, a bf16 cache
  s.band = o;  o += (size_t)(slots + M - 1) * kp * 4;             // its positional rows
  s.am = o;    o += tail_align((size_t)2 * M * slots * 4);        // its dots, both terms
  s.vc = o;    o += (size_t)C * cD * 4;                           // the cache's values
  s.vn = o;    o += tail_align((size_t)M * cD * 4);               // v_new's
  s.sp = o;    o += (size_t)M * att_s4(C + M) * 4;                // scores, then p
  s.part = o;  o += (size_t)2 * M * TL_GW * 4;                    // the context's halves
  s.red = o;   o += (size_t)TL_WARPS * 3 * cD * TL_MR * 4;        // per-warp sums
  s.bars = o;  o += AT_BARS * 8;                                  // mbarriers
  s.total = o;
  return s;
}

// KT: the kv cache's storage type (float or bf16)
template <typename KT>
__global__ void __launch_bounds__(TL_THREADS, 1) att_block_bf16_kernel(AttArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool KBF = sizeof(KT) == 2;
  const int M = p.M, D = p.D, H = p.H, C = p.C, cD = p.cD;
  const int dh = D / H, S = C + M, Dp = tail_pad(D), pd = Dp + TL_KS, gd = cD / TL_GW;
  const KT* kv = reinterpret_cast<const KT*>(p.kv);
  bf16* ctx = static_cast<bf16*>(p.ctx);
  const AtbSmem L = atb_smem(M, D, H, C, cD, p.slots);
  const size_t wsl = atb_slice(D, cD);                        // elements of a weight's slice
  const bf16* packed = static_cast<const bf16*>(p.packed) + (size_t)blockIdx.x * 4 * wsl;
  const bf16* w_qkv = reinterpret_cast<const bf16*>(smem + L.w);
  const bf16* w_o = w_qkv + 3 * wsl;
  bf16* act = reinterpret_cast<bf16*>(smem + L.act);
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  float* norms = reinterpret_cast<float*>(smem + L.norms);
  const int kp = att_pitch(dh);
  float* qu = reinterpret_cast<float*>(smem + L.qs);          // [M][kp]
  float* qv = qu + (size_t)M * kp;                            // [M][kp]
  float* keys = reinterpret_cast<float*>(smem + L.keys);      // [slots][kp]
  bf16* kst = reinterpret_cast<bf16*>(smem + L.kst);          // [slots][dh]
  float* band = reinterpret_cast<float*>(smem + L.band);      // [slots + M - 1][kp]
  float* am = reinterpret_cast<float*>(smem + L.am);          // [2][M x slots]
  KT* vc = reinterpret_cast<KT*>(smem + L.vc);                // [C][cD]
  float* vn = reinterpret_cast<float*>(smem + L.vn);          // [M][cD]
  float* sp = reinterpret_cast<float*>(smem + L.sp);          // [M][S4]
  const int S4 = att_s4(S);
  float* part = reinterpret_cast<float*>(smem + L.part);
  float* red = reinterpret_cast<float*>(smem + L.red);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  const int n0 = blockIdx.x * cD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const cg::grid_group grid = cg::this_grid();
  // the block's scores item: head h, kv positions [i0, i1)
  const int h = blockIdx.x / p.ranges;
  const int i0 = (blockIdx.x % p.ranges) * p.slots, i1 = min(S, i0 + p.slots);
  const bool item = h < H && i0 < S;
  const size_t hc = (size_t)h * dh;                           // the head's first column
  const uint32_t pos_b = dh * 4, key_b = dh * sizeof(KT);
  TL_MARK(0);

  // Thread 0 starts the copies of the Q/K/V weight slice and of x's first
  // rows and the norms (on the path to the first barrier), then of the Wo
  // slice; once the mbarriers are ready, warp 1 those of the item's
  // positional band and warp 2 those of its key rows, a lane a row; every
  // thread copies its share of the block's columns of the cache's values.
  if (threadIdx.x == 0) {
    for (int i = 0; i < AT_BARS; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const uint32_t xb = min(TL_MR, M) * D * 4, nb = D * 4, qkv_b = (uint32_t)(3 * wsl * 2);
    mbar_expect(bars + AT_QKV, qkv_b);
    bulk_copy(smem + L.w, packed, qkv_b, bars + AT_QKV);
    mbar_expect(bars + AT_X, xb + 2 * nb);
    bulk_copy(xs, p.x, xb, bars + AT_X);
    bulk_copy(norms, p.ln_g, nb, bars + AT_X);
    bulk_copy(norms + D, p.ln_b, nb, bars + AT_X);
  }
  __syncthreads();                          // the mbarriers are ready
  if (threadIdx.x == 0) {
    mbar_expect(bars + AT_WO, (uint32_t)(wsl * 2));
    bulk_copy(smem + L.w + 3 * wsl * 2, packed + 3 * wsl, (uint32_t)(wsl * 2), bars + AT_WO);
  } else if (item && warp == 1) {
    // positional rows r = i0 .. i1 + M - 2, the head's columns
    const int rows = i1 - i0 + M - 1;
    if (lane == 0) mbar_expect(bars + AT_BAND, rows * pos_b);
    __syncwarp();
    for (int r = lane; r < rows; r += 32)
      bulk_copy(band + (size_t)r * kp, p.pos + (size_t)(i0 + r) * D + hc, pos_b,
                bars + AT_BAND);
  } else if (item && warp == 2) {
    // key rows of the item's cache positions: position i is ring slot
    // (cursor + i) mod C, the entry of age C - i; f32 rows straight into
    // the dot products' staging, bf16 rows beside it (widened in (c))
    const int cursor = p.meta[0], i_end = min(i1, C);
    if (lane == 0) mbar_expect(bars + AT_KEYS, max(0, i_end - i0) * key_b);
    __syncwarp();
    for (int i = i0 + lane; i < i_end; i += 32) {
      void* dst = KBF ? (void*)(kst + (size_t)(i - i0) * dh) : (void*)(keys + (size_t)(i - i0) * kp);
      bulk_copy(dst, kv + (size_t)((cursor + i) % C) * 2 * D + hc, key_b, bars + AT_KEYS);
    }
  }
  constexpr int VE = 16 / sizeof(KT);       // values of a 16-byte piece
  const int cq = cD / VE;
  for (int i = threadIdx.x; i < C * cq; i += TL_THREADS) {
    const int s = i / cq, j = VE * (i - s * cq);
    const bool in = n0 + j < D;             // zero past D
    cp_async<16>(vc + (size_t)s * cD + j, kv + (size_t)s * 2 * D + D + (in ? n0 + j : 0),
                 in ? 16 : 0);
  }
  cp_async_commit();
  TL_MARK(1);
  mbar_wait(bars + AT_X);
  TL_MARK(2);

  // (a, b) u = LN(x); q, k_new, v_new on the block's columns
  int rows_parity = 0, chunk_parity = 0;    // of AT_ROWS and AT_CHUNK, a phase a staging
  for (int m0 = 0; m0 < M; m0 += TL_MR) {
    const int mr = min(TL_MR, M - m0);
    if (m0 > 0) {
      if (threadIdx.x == 0) {
        // the previous pass read xs with generic loads
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bulk_rows(xs, 0, p.x + (size_t)m0 * D, 0, 1, mr * D * 4, bars + AT_ROWS);
      }
      mbar_wait(bars + AT_ROWS, rows_parity);
      rows_parity ^= 1;
    }
    ln_rows(act, pd, xs, mr, D, norms, norms + D,
            blockIdx.x == 0 ? p.u + (size_t)m0 * D : nullptr);
    TL_MARK(14);
    mbar_wait(bars + AT_QKV);
    __syncthreads();
    TL_MARK(3);
    block_product(act, pd, w_qkv, Dp, 3 * gd, red, nullptr, 0, 17);
    for (int i = threadIdx.x; i < mr * 3 * cD; i += TL_THREADS) {
      const int r = i / (3 * cD), jj = i - r * 3 * cD, which = jj / cD, j = jj - which * cD;
      const int n = n0 + j, t = m0 + r;
      const float v = n < D ? product_sum(red, 3 * gd, r, jj) : 0.f;
      if (which == 2) vn[t * cD + j] = round_bf16(v);     // the context's operand
      if (n < D) (which == 0 ? p.q : which == 1 ? p.k_new : p.v_new)[(size_t)t * D + n] = v;
    }
    __syncthreads();
  }
  TL_MARK(4);
  grid.sync();
  TL_MARK(5);

  // (c) the item's scores: M query rows x its kv positions
  if (item) {
    const int ni = i1 - i0, d4 = dh / 4, n_out = M * ni;
    const int cursor = p.meta[0], cache_len = p.meta[1], valid_tq = p.meta[2];
    for (int i = threadIdx.x; i < M * d4; i += TL_THREADS) {
      const int t = i / d4, c = 4 * (i - t * d4);
      const float4 qq = __ldcg(reinterpret_cast<const float4*>(p.q + (size_t)t * D + hc + c));
      const float4 bu = *reinterpret_cast<const float4*>(p.bias_u + hc + c);
      const float4 bv = *reinterpret_cast<const float4*>(p.bias_v + hc + c);
      *reinterpret_cast<float4*>(qu + (size_t)t * kp + c) = round4(make_float4(
          __fadd_rn(qq.x, bu.x), __fadd_rn(qq.y, bu.y), __fadd_rn(qq.z, bu.z),
          __fadd_rn(qq.w, bu.w)));
      *reinterpret_cast<float4*>(qv + (size_t)t * kp + c) = round4(make_float4(
          __fadd_rn(qq.x, bv.x), __fadd_rn(qq.y, bv.y), __fadd_rn(qq.z, bv.z),
          __fadd_rn(qq.w, bv.w)));
    }
    const int j0 = max(i0, C);              // the item's current rows: positions j0 .. i1 - 1
    for (int i = threadIdx.x; i < max(0, i1 - j0) * d4; i += TL_THREADS) {
      const int r = i / d4, c = 4 * (i - r * d4);
      *reinterpret_cast<float4*>(keys + (size_t)(j0 + r - i0) * kp + c) = __ldcg(
          reinterpret_cast<const float4*>(p.k_new + (size_t)(j0 + r - C) * D + hc + c));
    }
    mbar_wait(bars + AT_KEYS);
    __syncthreads();
    // the keys rounded to bf16 once (their products' operand); a bf16
    // cache's rows are bf16 values already, widened exactly
    for (int i = threadIdx.x; i < ni * d4; i += TL_THREADS) {
      const int r = i / d4, c = 4 * (i - r * d4);
      float4* k4 = reinterpret_cast<float4*>(keys + (size_t)r * kp + c);
      *k4 = KBF && i0 + r < C ? load4_f(kst + (size_t)r * dh + c) : round4(*k4);
    }
    mbar_wait(bars + AT_BAND);
    __syncthreads();
    TL_MARK(6);
    // a thread a dot: (q + u_bias) . k of output o, or, from the next whole
    // warp on, (q + v_bias) . pos of output o; output o = (row t, position
    // i0 + o % ni)
    const int n_pad = (n_out + 31) & ~31;
    for (int j = threadIdx.x; j < 2 * n_pad; j += TL_THREADS) {
      const int which = j >= n_pad, o = j - which * n_pad, t = o / ni, i = i0 + o - t * ni;
      if (o >= n_out || (i < C ? i < C - cache_len : i - C >= valid_tq)) continue;  // masked
      am[which * n_out + o] = which ? round_bf16(dot_by16(qv + (size_t)t * kp,
                                          band + (size_t)(i - t + M - 1 - i0) * kp, dh))
                    : dot_by16(qu + (size_t)t * kp, keys + (size_t)(i - i0) * kp, dh);
    }
    __syncthreads();
    for (int o = threadIdx.x; o < n_out; o += TL_THREADS) {
      const int t = o / ni, i = i0 + o - t * ni;
      const bool ok = i < C ? i >= C - cache_len : i - C < valid_tq;
      p.scores[((size_t)h * M + t) * S4 + (i < C ? (cursor + i) % C : i)] =
          ok ? __fmul_rn(__fadd_rn(am[o], am[n_out + o]), p.scale) : -1e30f;
    }
  }
  TL_MARK(7);
  grid.sync();
  TL_MARK(8);

  // (d) p and ctx on the block's columns, a group of 8 at a time; the
  // cache's values rounded to bf16 once (the context's operand; a bf16
  // cache's are already)
  cp_async_wait<0>();
  __syncthreads();
  if constexpr (!KBF)
    for (int i = threadIdx.x; i < C * cD; i += TL_THREADS) vc[i] = round_bf16(vc[i]);
  __syncthreads();
  const int O = M * TL_GW;
  for (int g = 0, h_p = -1; g < gd && n0 + g * TL_GW < D; ++g) {
    const int col0 = n0 + g * TL_GW, hg = col0 / dh;
    if (hg != h_p) {
      // the head's scores of every slot, one warp a row: max, sum, p
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
        for (int s = lane; s < S; s += 32) row[s] = round_bf16(row[s] / sum);
      }
      __syncthreads();
      h_p = hg;
      TL_MARK(9);
    }
    // ctx[t][col0 + c] = sum_s p[t][s] v[s][c]: each of the O sums in two
    // halves of the slots, each in slot order (FMAs), the halves added
    for (int i = threadIdx.x; i < 2 * O; i += TL_THREADS) {
      const int k = i / O, o = i - k * O, t = o / TL_GW, c = g * TL_GW + o % TL_GW;
      const float* pr = sp + (size_t)t * S4;
      const int s0 = k * (S / 2), s1 = k ? S : S / 2, sc = min(s1, C);
      float acc = 0.f;
#pragma unroll 8
      for (int s = s0; s < sc; ++s) acc = fmaf(pr[s], to_f(vc[(size_t)s * cD + c]), acc);
#pragma unroll 8
      for (int s = max(s0, C); s < s1; ++s) acc = fmaf(pr[s], vn[(s - C) * cD + c], acc);
      part[i] = acc;
    }
    __syncthreads();
    for (int o = threadIdx.x; o < O; o += TL_THREADS)
      ctx[(size_t)(o / TL_GW) * D + col0 + o % TL_GW] =
          __float2bfloat16_rn(__fadd_rn(part[o], part[O + o]));
    __syncthreads();
  }
  TL_MARK(10);
  grid.sync();
  TL_MARK(11);

  // (e) y = x + ctx @ Wo on the block's columns
  mbar_wait(bars + AT_WO);
  for (int m0 = 0; m0 < M; m0 += TL_MR) {
    const int mr = min(TL_MR, M - m0);
    bulk_chunks(act, pd, ctx, m0, mr, D, bars + AT_CHUNK);
    zero_pad(act, pd, mr, D);
    __syncthreads();
    TL_MARK(12);
    block_product(act, pd, w_o, Dp, gd, red, bars + AT_CHUNK, chunk_parity, 19);
    chunk_parity ^= 1;
    for (int i = threadIdx.x; i < mr * cD; i += TL_THREADS) {
      const int r = i / cD, j = i - r * cD, n = n0 + j, t = m0 + r;
      if (n < D)
        p.y[(size_t)t * D + n] = __fadd_rn(p.x[(size_t)t * D + n], product_sum(red, gd, r, j));
    }
    __syncthreads();
  }
  TL_MARK(13);
}

}  // namespace port

using namespace port;

// the kernel's dynamic shared memory limit as set, a cache type each
static int atb_smem_set[2] = {-1, -1};

template <typename KT>
static cudaError_t set_atb_smem(int smem) {
  const int k = sizeof(KT) == 2;
  const cudaError_t err = cudaFuncSetAttribute(
      att_block_bf16_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  atb_smem_set[k] = err == cudaSuccess ? smem : -1;
  return err;
}

template <typename KT>
static cudaError_t launch_atb(AttArgs& p, int blocks, int smem, cudaStream_t stream) {
  if (smem != atb_smem_set[sizeof(KT) == 2]) {
    const cudaError_t err = set_atb_smem<KT>(smem);
    if (err != cudaSuccess) return err;
  }
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel((const void*)att_block_bf16_kernel<KT>, dim3(blocks),
                                     dim3(TL_THREADS), args, (size_t)smem, stream);
}

// x, y, u, k_new, v_new [M, D] f32; the LN's g, b [D]; bias_u, bias_v [H,
// dh] f32; pos [2 M + C - 1, D] f32; kv [C, 2 D] (the ring cache, k ++ v),
// f32, or bf16 when kv_bf16 is set; meta int32 [3] = (cursor, cache_len,
// valid_tq) on the device; scale 1 / sqrt(dh); packed: the layer's bf16
// weight slices, [blocks][4 * atb_slice(D, cD)] bf16
// (ops/kernels/att_block.py:pack_att_block); D a multiple of 8, dh of 16.
// The launch plan (blocks, cD, ranges, slots, smem: dynamic shared bytes)
// comes from the wrapper and is checked against this file's layout.
// scratch holds q [M, D] f32, the scores [H, M, C + M] f32 (16-byte
// aligned) and ctx [M, D] bf16. Returns the CUDA error code
// (cudaErrorCooperativeLaunchTooLarge when the blocks cannot all be
// resident).
extern "C" int att_block_bf16_launch(const float* x, int M, int D, int H, int C,
                                     const float* ln_g, const float* ln_b, const float* bias_u,
                                     const float* bias_v, const float* pos, const void* kv,
                                     int kv_bf16, const int* meta, float scale,
                                     const void* packed, int blocks, int cD, int ranges,
                                     int slots, int smem, float* y, float* u, float* k_new,
                                     float* v_new, void* scratch, void* stream_ptr) {
  if (M < 1 || H < 1 || C < 1 || D % TL_GW || D % H || (D / H) % 16 || cD < TL_GW ||
      cD % TL_GW || blocks < 1 || (size_t)blocks * cD < (size_t)D ||
      (size_t)(blocks - 1) * cD >= (size_t)D || ranges < 1 || slots < 1 ||
      (size_t)ranges * slots < (size_t)(C + M) || (size_t)H * ranges > (size_t)blocks ||
      atb_smem(M, D, H, C, cD, slots).total != (size_t)smem)
    return (int)cudaErrorInvalidValue;
  unsigned char* s = static_cast<unsigned char*>(scratch);
  const size_t qb = (size_t)M * D * 4, sb = (size_t)H * M * att_s4(C + M) * 4;
  AttArgs p = {x, M, D, H, C, cD, ranges, slots, 0, ln_g, ln_b, bias_u, bias_v, pos,
               static_cast<const float*>(kv), meta, scale, packed, y, u, k_new, v_new,
               reinterpret_cast<float*>(s), reinterpret_cast<float*>(s + qb),
               reinterpret_cast<bf16*>(s + tail_align(qb + sb))};
  const cudaError_t err = kv_bf16 ? launch_atb<bf16>(p, blocks, smem, (cudaStream_t)stream_ptr)
                                  : launch_atb<float>(p, blocks, smem, (cudaStream_t)stream_ptr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// info[0] = blocks of the kernel an SM holds with `smem` dynamic shared
// bytes (the CUDA occupancy API; the f32-cache and bf16-cache kernels take
// the same layout)
extern "C" int att_block_bf16_occupancy(int smem, int* info) {
  cudaError_t err = set_atb_smem<float>(smem);
  if (err != cudaSuccess) return (int)err;
  err = set_atb_smem<bf16>(smem);
  if (err != cudaSuccess) return (int)err;
  int other = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], att_block_bf16_kernel<float>,
                                                      TL_THREADS, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&other, att_block_bf16_kernel<bf16>,
                                                      TL_THREADS, (size_t)smem);
  if (other < info[0]) info[0] = other;
  return (int)err;
}
