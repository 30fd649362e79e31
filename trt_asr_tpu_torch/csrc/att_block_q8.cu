// Fused conformer attention block with int8 weights (B=1 streaming chunks):
// one persistent cooperative launch a layer.
//
// Replaces: trt_asr_tpu/ops/pallas/att_block_kernel.py:att_block_pallas (its
// pallas_call at :170) with int8 weights; f32 weights take
// csrc/att_block_f32.cu, bf16 weights the chain of csrc/att_block.cu. For
// the M (= Tq) new rows x of one layer:
//   u = LN(x); q, k_new, v_new = (u @ Wq) sq, (u @ Wk) sk, (u @ Wv) sv
//   per head: scores[t, s] = ((q+u_bias)[t] . k[s] + (q+v_bias)[t] . pos[r0[s]-t]) / sqrt(dh)
//             over the ring kv cache (C slots) ++ the current rows, masked;
//             p = softmax(scores); ctx = p @ v
//   y = x + (ctx @ Wo) so
// and returns (y, u, k_new, v_new). Rounding points as in csrc/att_block.cu:
// u, q + u_bias, q + v_bias, k, v, the positional term m, p and ctx are
// rounded to bf16; int8 widens exactly; each scale multiplies an f32 sum;
// x, q, k_new, v_new, the scores and the residual stream are not rounded.
//
// Bound on the H100: memory. At full width (D 1024, H 8, C 256, Tq 8) a
// layer reads 4.2 MB of int8 weights, the f32 kv cache (2.1 MB) and the f32
// positional table (1.1 MB, R = 2 Tq + C - 1 = 271 rows): 2.2 us at 3.35
// TB/s, against 67 MFLOP of products and 13 MFLOP of attention core.
//
// Design. One cooperative launch, one block an SM, 512 threads (the
// building blocks of csrc/persistent.cuh, as csrc/conv_ffn_ln.cu). Block b
// owns cD columns (8 at full width, 128 blocks; the wrapper's plan,
// ops/kernels/att_block.py:att_block_q8_plan) of Wq, Wk, Wv and Wo over the
// whole K, packed contiguous once with the model's int8 weights
// (pack_att_block). At entry the block starts bulk copies of everything it
// reads that no other block writes, each group on its own mbarrier: its
// Wq|Wk|Wv slice with the scales, x's rows and the LN's norms, its Wo
// slice, and the key and positional rows of its scores item; all its
// threads copy its columns of the cache's values (cp.async). Phases:
//   (a) LN of all rows in every block (one warp a row; block 0 writes u);
//   (b) q, k_new, v_new on the block's columns, FFMA on the CUDA cores;
//   grid barrier;
//   (c) scores, one item a block: a head and a run of `slots` kv positions
//       i in the order of their positional row r0 = Tq - 1 + i (the oldest
//       cache entry first, the current rows last), so that the item's rows
//       r = r0 - t form one band of slots + Tq - 1 rows whatever the ring's
//       cursor. The item reads each key and positional row once for all Tq
//       query rows; a thread a dot product. The scores go to scratch in
//       ring-slot order;
//   grid barrier;
//   (d) softmax and context on the block's own columns: the head's scores
//       of all slots (from L2), max, sum, p rounded to bf16 (one warp a row,
//       as PyTorch's softmax), then p @ v over all slots for those columns
//       (the cache's values copied at entry, v_new's computed by the block
//       itself in (b)); ctx rounded to bf16 into scratch;
//   grid barrier;
//   (e) ctx's rows bulk-copied out of L2 in four K chunks, Wo on the
//       block's columns on the tensor cores (mma.sync.m16n8k16, int8 widened
//       exactly to bf16, f32 sums), y = x + sum * so.
// Sums in the plain version's order. Every value before the last product
// passes a bf16 rounding point, where one f32 ulp can move a value by a
// bf16 ulp: a flip in q + u_bias moves all of a head's scores, and y by
// ~1e-4 at full width. So the sums up to ctx run in the order in which the
// plain version's products run on the H100 (cuBLAS; each found by emulating
// candidate orders against its results at the full width, and held by
// chip_smoke.py's 1e-4): Q/K/V in runs of 64 rows of K, each in order, the
// runs added in order; the scores' dots in 16 interleaved partial sums,
// added in order; the context in two halves of the slots. The tensor cores'
// sums are not in any such order, so only Wo, whose sums are not rounded
// again, runs on them. At full width q, k_new, v_new, the scores, p and ctx
// equal the plain version's bit for bit.
// After a barrier, what other blocks wrote is read with bulk copies or
// __ldcg, never through a possibly stale L1 line. Every sum runs in a fixed
// order (no atomics): the kernel is deterministic, and a captured CUDA graph
// replays it bit for bit (chip_smoke.py phase 2). Rows are taken 8 at a
// time in the products, all at once in the attention core, so any Tq runs
// whose staging fits shared memory (the plan checks it).
#include "att_core.cuh"

namespace port {

// mbarriers of the bulk copies: x's first rows and the LN's norms; the
// Wq|Wk|Wv slice with the block's scale columns; the Wo slice; the
// positional band and the key rows of the block's scores item; x's later
// rows (Tq > 8); the four K chunks of ctx's rows (reused pass by pass)
enum { AB_X, AB_QKV, AB_WO, AB_BAND, AB_KEYS, AB_ROWS, AB_CHUNK, AB_BARS = AB_CHUNK + 4 };

// A block's packed slice of the layer's weights (pack_att in
// ops/kernels/att_block.py), byte offsets: Wq, Wk, Wv, Wo, each
// [cD / 8][Dp / 16][8][16] int8; then the f32 scale columns of Wq, Wk, Wv,
// Wo, each [cD]; zero past D and K past its end.
struct AttBlob {
  size_t wo, cols, total;
};

__host__ __device__ inline AttBlob att_blob(int D, int cD) {
  const size_t w = (size_t)tail_pad(D) * cD;
  AttBlob b;
  b.wo = 3 * w;
  b.cols = 4 * w;
  b.total = b.cols + (size_t)4 * cD * 4;
  return b;
}

constexpr int AB_RUN = 64;                // rows of K a run of the Q/K/V sums

__host__ __device__ inline int att_runs(int D) { return (D + AB_RUN - 1) / AB_RUN; }

// Byte offsets of the dynamic shared memory, mirrored by the wrapper's plan.
struct AttSmem {
  size_t w, act, xs, norms, qs, keys, band, am, vc, vn, sp, part, red, bars, total;
};

__host__ __device__ inline AttSmem att_smem(int M, int D, int H, int C, int cD, int slots) {
  const size_t kp = att_pitch(D / H);
  AttSmem s;
  size_t o = 0;
  s.w = o;     o += att_blob(D, cD).total;                        // weight slices, scales
  s.act = o;   o += (size_t)TL_MR * (tail_pad(D) + TL_KS) * 2;    // operand rows, bf16
  s.xs = o;    o += (size_t)TL_MR * D * 4;                        // x's rows
  s.norms = o; o += (size_t)2 * D * 4;                            // LN's g, b
  s.qs = o;    o += (size_t)2 * M * kp * 4;                       // q + u_bias, q + v_bias
  s.keys = o;  o += (size_t)slots * kp * 4;                       // the item's key rows
  s.band = o;  o += (size_t)(slots + M - 1) * kp * 4;             // its positional rows
  s.am = o;    o += tail_align((size_t)2 * M * slots * 4);        // its dots, both terms
  s.vc = o;    o += (size_t)C * cD * 4;                           // the cache's values
  s.vn = o;    o += tail_align((size_t)M * cD * 4);               // v_new's
  s.sp = o;    o += (size_t)M * att_s4(C + M) * 4;                // scores, then p
  s.part = o;  o += (size_t)2 * M * TL_GW * 4;                    // the context's halves
  s.red = o;   o += (size_t)tail_max(TL_WARPS, att_runs(D)) * 3 * cD * TL_MR * 4;   // sums
  s.bars = o;  o += AB_BARS * 8;                                  // mbarriers
  s.total = o;
  return s;
}

// The Q/K/V sums of the 8 operand rows af (f32 values of bf16, row pitch
// D; rows past the pass's zero) with the block's cD columns of Wq, Wk and
// Wv (w: each weight's slice [cD / 8][Kp / 16][8][16] int8, one after the
// other), FFMA on the CUDA cores in the order of the plain version's product
// on the H100 (cuBLAS's split-K, found by emulation at the full width): K in
// runs of AB_RUN rows, each summed in order here, the runs added in order by
// the caller (every product is exact: bf16 times int8). A thread takes one
// run, one column n and four rows, for the three weights, so each weight
// value it widens feeds four products and each operand value three; the 8
// lanes of a quarter warp share run and rows (one broadcast a 16-byte
// load). The sums of run r, row t, weight q, column n go to
// red[(r * 8 + t) * 3 cD + q cD + n].
__device__ __noinline__ void qkv_runs(const float* af, int D, const int8_t* w, int Kp, int cD,
                                      float* red) {
  const size_t wsz = (size_t)cD * Kp;       // bytes of a weight's slice
  for (int it = threadIdx.x; it < att_runs(D) * cD * 2; it += TL_THREADS) {
    const int n = it % cD, t0 = 4 * ((it / cD) & 1), r = it / (2 * cD);
    const int8_t* wc = w + (size_t)(n / TL_GW) * Kp * TL_GW + (n % TL_GW) * TL_KS;
    const float* ar = af + (size_t)t0 * D;
    float acc[3][4];
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[q][u] = 0.f;
    for (int k = r * AB_RUN; k < min(D, (r + 1) * AB_RUN); k += 4) {
      const size_t wo = (size_t)(k / TL_KS) * TL_GW * TL_KS + k % TL_KS;
      char4 wv[3];
      float4 a[4];
#pragma unroll
      for (int q = 0; q < 3; ++q) wv[q] = *reinterpret_cast<const char4*>(wc + q * wsz + wo);
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = *reinterpret_cast<const float4*>(ar + (size_t)u * D + k);
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        float w0, w1, w2, w3;
        i8x4_to_f32(*reinterpret_cast<const uint32_t*>(&wv[q]), w0, w1, w2, w3);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          acc[q][u] = fmaf(a[u].w, w3,
                           fmaf(a[u].z, w2, fmaf(a[u].y, w1, fmaf(a[u].x, w0, acc[q][u]))));
      }
    }
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        red[((size_t)r * TL_MR + t0 + u) * 3 * cD + q * cD + n] = acc[q][u];
  }
}

__global__ void __launch_bounds__(TL_THREADS, 1) att_block_q8_kernel(AttArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int M = p.M, D = p.D, H = p.H, C = p.C, cD = p.cD;
  const int dh = D / H, S = C + M, Dp = tail_pad(D), pd = Dp + TL_KS, gd = cD / TL_GW;
  bf16* ctx = static_cast<bf16*>(p.ctx);
  const AttSmem L = att_smem(M, D, H, C, cD, p.slots);
  const AttBlob B = att_blob(D, cD);
  const unsigned char* packed = static_cast<const unsigned char*>(p.packed);
  const int8_t* w_qkv = reinterpret_cast<const int8_t*>(smem + L.w);
  const int8_t* w_o = w_qkv + B.wo;
  const float* scl = reinterpret_cast<const float*>(smem + L.w + B.cols);   // [4][cD]
  bf16* act = reinterpret_cast<bf16*>(smem + L.act);
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  float* norms = reinterpret_cast<float*>(smem + L.norms);
  const int kp = att_pitch(dh);
  float* qu = reinterpret_cast<float*>(smem + L.qs);          // [M][kp]
  float* qv = qu + (size_t)M * kp;                            // [M][kp]
  float* keys = reinterpret_cast<float*>(smem + L.keys);      // [slots][kp]
  float* band = reinterpret_cast<float*>(smem + L.band);      // [slots + M - 1][kp]
  float* am = reinterpret_cast<float*>(smem + L.am);          // [2][M x slots]
  float* vc = reinterpret_cast<float*>(smem + L.vc);          // [C][cD]
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
  const uint32_t row_b = dh * 4;
  TL_MARK(0);

  // Thread 0 starts the copies of the Q/K/V weight slice and of x's first
  // rows and the norms (on the path to the first barrier), then of the Wo
  // slice; once the mbarriers are ready, warp 1 those of the item's
  // positional band and warp 2 those of its key rows, a lane a row; every
  // thread copies its share of the block's columns of the cache's values.
  // (Holding these back until x has landed was no faster.)
  if (threadIdx.x == 0) {
    for (int i = 0; i < AB_BARS; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const unsigned char* mine = packed + blockIdx.x * B.total;
    const uint32_t xb = min(TL_MR, M) * D * 4, nb = D * 4, cb = (uint32_t)(B.total - B.cols);
    mbar_expect(bars + AB_QKV, (uint32_t)B.wo + cb);
    bulk_copy(smem + L.w, mine, (uint32_t)B.wo, bars + AB_QKV);
    bulk_copy(smem + L.w + B.cols, mine + B.cols, cb, bars + AB_QKV);
    mbar_expect(bars + AB_X, xb + 2 * nb);
    bulk_copy(xs, p.x, xb, bars + AB_X);
    bulk_copy(norms, p.ln_g, nb, bars + AB_X);
    bulk_copy(norms + D, p.ln_b, nb, bars + AB_X);
  }
  __syncthreads();                          // the mbarriers are ready
  if (threadIdx.x == 0) {
    mbar_expect(bars + AB_WO, (uint32_t)(B.cols - B.wo));
    bulk_copy(smem + L.w + B.wo, packed + blockIdx.x * B.total + B.wo,
              (uint32_t)(B.cols - B.wo), bars + AB_WO);
  } else if (item && warp == 1) {
    // positional rows r = i0 .. i1 + M - 2, the head's columns
    const int rows = i1 - i0 + M - 1;
    if (lane == 0) mbar_expect(bars + AB_BAND, rows * row_b);
    __syncwarp();
    for (int r = lane; r < rows; r += 32)
      bulk_copy(band + (size_t)r * kp, p.pos + (size_t)(i0 + r) * D + hc, row_b,
                bars + AB_BAND);
  } else if (item && warp == 2) {
    // key rows of the item's cache positions: position i is ring slot
    // (cursor + i) mod C, the entry of age C - i
    const int cursor = p.meta[0], i_end = min(i1, C);
    if (lane == 0) mbar_expect(bars + AB_KEYS, max(0, i_end - i0) * row_b);
    __syncwarp();
    for (int i = i0 + lane; i < i_end; i += 32)
      bulk_copy(keys + (size_t)(i - i0) * kp, p.kv + (size_t)((cursor + i) % C) * 2 * D + hc,
                row_b, bars + AB_KEYS);
  }
  const int c4 = cD / 4;
  for (int i = threadIdx.x; i < C * c4; i += TL_THREADS) {
    const int s = i / c4, j = 4 * (i - s * c4);
    const bool in = n0 + j < D;             // zero past D
    cp_async<16>(vc + (size_t)s * cD + j, p.kv + (size_t)s * 2 * D + D + (in ? n0 + j : 0),
                 in ? 16 : 0);
  }
  cp_async_commit();
  TL_MARK(1);
  mbar_wait(bars + AB_X);
  TL_MARK(2);

  // (a, b) u = LN(x); q, k_new, v_new on the block's columns
  int rows_parity = 0, chunk_parity = 0;    // of AB_ROWS and AB_CHUNK, a phase a staging
  for (int m0 = 0; m0 < M; m0 += TL_MR) {
    const int mr = min(TL_MR, M - m0);
    if (m0 > 0) {
      if (threadIdx.x == 0) {
        // the previous pass wrote xs with generic stores
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bulk_rows(xs, 0, p.x + (size_t)m0 * D, 0, 1, mr * D * 4, bars + AB_ROWS);
      }
      mbar_wait(bars + AB_ROWS, rows_parity);
      rows_parity ^= 1;
    }
    // LN's rows, their bf16 values widened to f32 in place of x's rows
    // (the residual is read from device memory in (e)); rows past the
    // pass's zero
    ln_rows(act, pd, xs, mr, D, norms, norms + D,
            blockIdx.x == 0 ? p.u + (size_t)m0 * D : nullptr, xs);
    for (int i = mr * D + threadIdx.x; i < TL_MR * D; i += TL_THREADS) xs[i] = 0.f;
    __syncthreads();
    TL_MARK(14);
    mbar_wait(bars + AB_QKV);
    __syncthreads();
    TL_MARK(3);
    qkv_runs(xs, D, w_qkv, Dp, cD, red);
    __syncthreads();
    TL_MARK(17);
    for (int i = threadIdx.x; i < mr * 3 * cD; i += TL_THREADS) {
      const int r = i / (3 * cD), jj = i - r * 3 * cD, which = jj / cD, j = jj - which * cD;
      const int n = n0 + j, t = m0 + r;
      float v = 0.f;
      for (int q = 0; q < att_runs(D); ++q)
        v = __fadd_rn(v, red[((size_t)q * TL_MR + r) * 3 * cD + jj]);
      v = n < D ? __fmul_rn(v, scl[jj]) : 0.f;
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
    mbar_wait(bars + AB_KEYS);
    __syncthreads();
    // the keys rounded to bf16 once (their products' operand)
    for (int i = threadIdx.x; i < ni * d4; i += TL_THREADS) {
      float4* k4 = reinterpret_cast<float4*>(keys + (size_t)(i / d4) * kp) + i % d4;
      *k4 = round4(*k4);
    }
    mbar_wait(bars + AB_BAND);
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
  // cache's values rounded to bf16 once (the context's operand)
  cp_async_wait<0>();
  __syncthreads();
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
    // halves of the slots, each in slot order (FMAs), the halves added: the
    // plain version's einsum's order on the H100 (cuBLAS, as dot_by16)
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
      ctx[(size_t)(o / TL_GW) * D + col0 + o % TL_GW] =
          __float2bfloat16_rn(__fadd_rn(part[o], part[O + o]));
    __syncthreads();
  }
  TL_MARK(10);
  grid.sync();
  TL_MARK(11);

  // (e) y = x + (ctx @ Wo) so on the block's columns
  mbar_wait(bars + AB_WO);
  for (int m0 = 0; m0 < M; m0 += TL_MR) {
    const int mr = min(TL_MR, M - m0);
    bulk_chunks(act, pd, ctx, m0, mr, D, bars + AB_CHUNK);
    zero_pad(act, pd, mr, D);
    __syncthreads();
    TL_MARK(12);
    block_product(act, pd, w_o, Dp, gd, red, bars + AB_CHUNK, chunk_parity, 19);
    chunk_parity ^= 1;
    for (int i = threadIdx.x; i < mr * cD; i += TL_THREADS) {
      const int r = i / cD, j = i - r * cD, n = n0 + j, t = m0 + r;
      if (n < D) {
        p.y[(size_t)t * D + n] = __fadd_rn(
            p.x[(size_t)t * D + n], __fmul_rn(product_sum(red, gd, r, j), scl[3 * cD + j]));
      }
    }
    __syncthreads();
  }
  TL_MARK(13);
}

}  // namespace port

using namespace port;

static int att_smem_set = -1;        // the kernel's dynamic shared memory limit, as set

static cudaError_t set_att_smem(int smem) {
  const cudaError_t err = cudaFuncSetAttribute(
      att_block_q8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  att_smem_set = err == cudaSuccess ? smem : -1;
  return err;
}

// x, y, u, k_new, v_new [M, D] f32; the LN's g, b [D]; bias_u, bias_v [H,
// dh]; pos [2 M + C - 1, D]; kv [C, 2 D] (the ring cache, k ++ v); meta
// int32 [3] = (cursor, cache_len, valid_tq) on the device; scale 1 /
// sqrt(dh); packed: the layer's weight slices and scales, [blocks][att_blob
// (D, cD).total] bytes (ops/kernels/att_block.py:pack_att_block); D and dh
// multiples of 8. The launch plan (blocks, cD, ranges, slots, smem: dynamic
// shared bytes) comes from the wrapper and is checked against this file's
// layout. scratch holds q [M, D] f32, the scores [H, M, C + M] f32 (16-byte
// aligned) and ctx [M, D] bf16. Returns the CUDA error code
// (cudaErrorCooperativeLaunchTooLarge when the blocks cannot all be resident).
extern "C" int att_block_q8_launch(const float* x, int M, int D, int H, int C,
                                   const float* ln_g, const float* ln_b, const float* bias_u,
                                   const float* bias_v, const float* pos, const float* kv,
                                   const int* meta, float scale, const void* packed, int blocks,
                                   int cD, int ranges, int slots, int smem, float* y, float* u,
                                   float* k_new, float* v_new, void* scratch,
                                   void* stream_ptr) {
  if (M < 1 || H < 1 || C < 1 || D % TL_GW || D % H || (D / H) % 16 || cD < TL_GW ||
      cD % TL_GW || blocks < 1 || (size_t)blocks * cD < (size_t)D ||
      (size_t)(blocks - 1) * cD >= (size_t)D || ranges < 1 || slots < 1 ||
      (size_t)ranges * slots < (size_t)(C + M) || (size_t)H * ranges > (size_t)blocks ||
      att_smem(M, D, H, C, cD, slots).total != (size_t)smem)
    return (int)cudaErrorInvalidValue;
  if (smem != att_smem_set) {
    const cudaError_t err = set_att_smem(smem);
    if (err != cudaSuccess) return (int)err;
  }
  unsigned char* s = static_cast<unsigned char*>(scratch);
  const size_t qb = (size_t)M * D * 4, sb = (size_t)H * M * att_s4(C + M) * 4;
  AttArgs p = {x, M, D, H, C, cD, ranges, slots, 0, ln_g, ln_b, bias_u, bias_v, pos, kv, meta,
               scale, packed, y, u, k_new, v_new,
               reinterpret_cast<float*>(s), reinterpret_cast<float*>(s + qb),
               reinterpret_cast<bf16*>(s + tail_align(qb + sb))};
  void* args[] = {&p};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)att_block_q8_kernel, dim3(blocks), dim3(TL_THREADS), args, (size_t)smem,
      (cudaStream_t)stream_ptr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// info[0] = blocks of the kernel an SM holds with `smem` dynamic shared
// bytes (the CUDA occupancy API)
extern "C" int att_block_q8_occupancy(int smem, int* info) {
  const cudaError_t err = set_att_smem(smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], att_block_q8_kernel,
                                                            TL_THREADS, (size_t)smem);
}
