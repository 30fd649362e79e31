// Building blocks of the persistent kernels (csrc/conv_ffn_ln.cu,
// csrc/att_block_q8.cu, csrc/joint_step_q8.cu, csrc/ffn_q8.cu, their f32
// counterparts, csrc/att_block_bf16.cu and csrc/ffn_bf16.cu): one
// cooperative launch of TL_THREADS-thread blocks, one an SM, each owning a
// slice of every product.
//   - bulk copies (the copy engine) into shared memory, each group of copies
//     completing on its own mbarrier, optionally under an L2 evict-first
//     policy for weights read once;
//   - LayerNorm of up to TL_MR rows, one warp a row, into bf16 operand rows
//     (or in place in f32);
//   - products of TL_MR bf16 operand rows with int8 or bf16 weight groups
//     of TL_GW columns ([K / 16][8 columns][16 rows], as the packers in
//     ops/kernels/persistent.py lay them out; int8 widened exactly to bf16
//     in registers) summed on the tensor cores (mma.sync.m16n8k16, f32
//     sums); each warp sums its run of K and the warps' sums are added in a
//     fixed order (no atomics).
#pragma once

#include "common.cuh"

namespace port {

constexpr int TL_THREADS = 512;
constexpr int TL_WARPS = TL_THREADS / 32;
constexpr int TL_MR = 8;                  // rows of a product pass (the mma's 8 live rows)
constexpr int TL_GW = 8;                  // columns of a weight group (the mma's n8)
constexpr int TL_KS = 16;                 // K of an mma step
constexpr int TL_CHUNK_WARPS = TL_WARPS / 4;   // warps whose K steps a chunk holds

__host__ __device__ inline int tail_max(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int tail_pad(int k) { return (k + TL_KS - 1) / TL_KS * TL_KS; }
__host__ __device__ inline size_t tail_align(size_t v) { return (v + 15) & ~(size_t)15; }

// --- bulk copies (the copy engine, one instruction a contiguous run) ------
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory to this block's shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}
// Waits until the phase of `bar` with this parity has completed (its
// copies have landed)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity = 0) {
  asm volatile(
      "{\n .reg .pred done;\n"
      "WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT_%=;\n}\n" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}

// Thread 0: `rows` rows of `bytes` (a multiple of 16) from src (row pitch
// sp bytes) to shared memory at dst (row pitch dp bytes) on `bar`. The
// proxy fence orders these copies after the other blocks' writes to device
// memory, seen through the grid barrier. (The shared memory they overwrite
// was last read before a block barrier, by loads whose values were used.)
__device__ __forceinline__ void bulk_rows(void* dst, size_t dp, const void* src, size_t sp,
                                          int rows, uint32_t bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  mbar_expect(bar, rows * bytes);
  for (int r = 0; r < rows && bytes > 0; ++r)
    bulk_copy(static_cast<char*>(dst) + r * dp, static_cast<const char*>(src) + r * sp, bytes,
              bar);
}

// An L2 policy for data read once: its lines are evicted first, so the
// weights streamed through L2 displace one another rather than lines that
// would be written back (or read again)
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// bulk_copy under an L2 policy
__device__ __forceinline__ void bulk_copy_hint(void* dst, const void* src, uint32_t bytes,
                                               uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy) : "memory");
}

// The operand rows m0 .. m0 + mr - 1 of the bf16 matrix src [*, K] into
// act (row pitch `pitch` elements) in four K chunks, chunk c on bars[c]
// holding the steps of warps [c, c + 1) x TL_CHUNK_WARPS of block_product,
// so each warp starts once its own chunk has landed. Lane 0 of warp c
// issues chunk c: the four fences and issues run side by side.
__device__ __forceinline__ void bulk_chunks(bf16* act, int pitch, const bf16* src, int m0,
                                            int mr, int K, uint64_t* bars) {
  const int c = threadIdx.x >> 5;
  if (c >= 4 || (threadIdx.x & 31)) return;
  const int steps = tail_pad(K) / TL_KS, per = (steps + TL_WARPS - 1) / TL_WARPS;
  const int k0 = min(K, c * TL_CHUNK_WARPS * per * TL_KS);
  const int k1 = min(K, (c + 1) * TL_CHUNK_WARPS * per * TL_KS);
  bulk_rows(act + k0, (size_t)pitch * 2, src + (size_t)m0 * K + k0, (size_t)K * 2, mr,
            (k1 - k0) * 2, bars + c);
}

// act row r (pitch) = bf16(LN(xs row r)) for r < mr, one warp a row
// (eps 1e-5); columns [D, tail_pad(D)) are zeroed. With `out`, row r of
// LN(xs) is also stored there in f32 (row pitch D); with `outr`, its bf16
// values widened to f32 (row pitch D; it may be xs itself).
__device__ __forceinline__ void ln_rows(bf16* act, int pitch, const float* xs, int mr, int D,
                                        const float* g, const float* b,
                                        float* out = nullptr, float* outr = nullptr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp >= mr) return;
  const float* xr = xs + (size_t)warp * D;
  float s = 0.f;
  for (int i = 4 * lane; i < D; i += 128) {
    const float4 v = *reinterpret_cast<const float4*>(xr + i);
    s += v.x + v.y + v.z + v.w;
  }
  const float mu = warp_sum(s) / (float)D;
  float q = 0.f;
  for (int i = 4 * lane; i < D; i += 128) {
    const float4 v = *reinterpret_cast<const float4*>(xr + i);
    q = fmaf(v.x - mu, v.x - mu, q);
    q = fmaf(v.y - mu, v.y - mu, q);
    q = fmaf(v.z - mu, v.z - mu, q);
    q = fmaf(v.w - mu, v.w - mu, q);
  }
  const float inv = 1.0f / sqrtf(warp_sum(q) / (float)D + 1e-5f);
  bf16* ar = act + (size_t)warp * pitch;
  for (int i = 4 * lane; i < D; i += 128) {
    const float4 v = *reinterpret_cast<const float4*>(xr + i);
    const float4 gg = *reinterpret_cast<const float4*>(g + i);
    const float4 bb = *reinterpret_cast<const float4*>(b + i);
    const float4 o = make_float4(__fadd_rn(__fmul_rn(__fmul_rn(v.x - mu, inv), gg.x), bb.x),
                                 __fadd_rn(__fmul_rn(__fmul_rn(v.y - mu, inv), gg.y), bb.y),
                                 __fadd_rn(__fmul_rn(__fmul_rn(v.z - mu, inv), gg.z), bb.z),
                                 __fadd_rn(__fmul_rn(__fmul_rn(v.w - mu, inv), gg.w), bb.w));
    *reinterpret_cast<uint2*>(ar + i) = make_uint2(pack_bf16(o.x, o.y), pack_bf16(o.z, o.w));
    if (out) *reinterpret_cast<float4*>(out + (size_t)warp * D + i) = o;
    if (outr)
      *reinterpret_cast<float4*>(outr + (size_t)warp * D + i) =
          make_float4(round_bf16(o.x), round_bf16(o.y), round_bf16(o.z), round_bf16(o.w));
  }
  for (int i = D + 4 * lane; i < tail_pad(D); i += 128)
    *reinterpret_cast<uint2*>(ar + i) = make_uint2(0u, 0u);
}

// u = LN(x) of rows t < M of xs (row pitch `pitch`) in place, f32, one
// warp a row (eps 1e-5, the sums of ln_rows); with `out`, also stored
// there (row pitch D)
__device__ __forceinline__ void ln_rows_f32(float* xs, int pitch, int M, int D, const float* g,
                                            const float* b, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = warp; t < M; t += TL_WARPS) {
    float* xr = xs + (size_t)t * pitch;
    float s = 0.f;
    for (int i = 4 * lane; i < D; i += 128) {
      const float4 v = *reinterpret_cast<const float4*>(xr + i);
      s += v.x + v.y + v.z + v.w;
    }
    const float mu = warp_sum(s) / (float)D;
    float q = 0.f;
    for (int i = 4 * lane; i < D; i += 128) {
      const float4 v = *reinterpret_cast<const float4*>(xr + i);
      q = fmaf(v.x - mu, v.x - mu, q);
      q = fmaf(v.y - mu, v.y - mu, q);
      q = fmaf(v.z - mu, v.z - mu, q);
      q = fmaf(v.w - mu, v.w - mu, q);
    }
    const float inv = 1.0f / sqrtf(warp_sum(q) / (float)D + 1e-5f);
    for (int i = 4 * lane; i < D; i += 128) {
      const float4 v = *reinterpret_cast<const float4*>(xr + i);
      const float4 gg = *reinterpret_cast<const float4*>(g + i);
      const float4 bb = *reinterpret_cast<const float4*>(b + i);
      const float4 o = make_float4(__fadd_rn(__fmul_rn(__fmul_rn(v.x - mu, inv), gg.x), bb.x),
                                   __fadd_rn(__fmul_rn(__fmul_rn(v.y - mu, inv), gg.y), bb.y),
                                   __fadd_rn(__fmul_rn(__fmul_rn(v.z - mu, inv), gg.z), bb.z),
                                   __fadd_rn(__fmul_rn(__fmul_rn(v.w - mu, inv), gg.w), bb.w));
      *reinterpret_cast<float4*>(xr + i) = o;
      if (out) *reinterpret_cast<float4*>(out + (size_t)t * D + i) = o;
    }
  }
}

// act rows r < mr (pitch): zero in [K, tail_pad(K))
__device__ __forceinline__ void zero_pad(bf16* act, int pitch, int mr, int K) {
  const int pieces = (tail_pad(K) - K) / 8;
  for (int i = threadIdx.x; i < mr * pieces; i += TL_THREADS)
    *reinterpret_cast<uint4*>(act + (size_t)(i / pieces) * pitch + K + 8 * (i % pieces)) =
        make_uint4(0u, 0u, 0u, 0u);
}

// Four int8 values packed in v (k = 4t .. 4t + 3 of one column), widened
// exactly to bf16 pairs for the mma's B fragment: a byte v with low seven
// bits t and sign bit s is bf16(128 + t) - bf16(128 + 128 s), each term
// built by a byte permute (exponent 2^7, mantissa t; 256 for s) and their
// difference exact in bf16.
__device__ __forceinline__ void i8x4_to_bf16(uint32_t v, uint32_t& b0, uint32_t& b1) {
  const uint32_t t = v & 0x7f7f7f7fu, sign = v & 0x80808080u;
  const uint32_t m01 = __byte_perm(t, 0x43434343u, 0x4140);
  const uint32_t m23 = __byte_perm(t, 0x43434343u, 0x4342);
  const uint32_t s01 = __byte_perm(sign, 0x43434343u, 0x4140);
  const uint32_t s23 = __byte_perm(sign, 0x43434343u, 0x4342);
  const __nv_bfloat162 d01 = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&m01),
                                     *reinterpret_cast<const __nv_bfloat162*>(&s01));
  const __nv_bfloat162 d23 = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&m23),
                                     *reinterpret_cast<const __nv_bfloat162*>(&s23));
  b0 = *reinterpret_cast<const uint32_t*>(&d01);
  b1 = *reinterpret_cast<const uint32_t*>(&d23);
}

// v's four values rounded to bf16, kept in f32
__device__ __forceinline__ float4 round4(float4 v) {
  return make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z), round_bf16(v.w));
}

// Four int8 values packed in v, widened exactly to f32 with integer byte
// permutes and one f32 subtraction each (the conversion instruction runs at
// a quarter of the FMA rate): byte b + 128 under the exponent of 2^23 is
// 2^23 + 128 + b.
__device__ __forceinline__ void i8x4_to_f32(uint32_t v, float& f0, float& f1, float& f2,
                                            float& f3) {
  const uint32_t u = v ^ 0x80808080u;
  const float base = 8388736.f;             // 2^23 + 128
  f0 = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7650)) - base;
  f1 = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7651)) - base;
  f2 = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7652)) - base;
  f3 = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7653)) - base;
}

// Phase timeline for tail_variants.py: with TAIL_TIMELINE defined, thread 0
// of each block stores the global timer (ns) at each mark (17 .. 24: inside the four products, after the mma loop and after
// the block's barrier).
#ifdef TAIL_TIMELINE
constexpr int TL_MARKS = 25;
__device__ unsigned long long tail_timeline[1024][TL_MARKS];
#define TL_MARK(i)                                                              \
  if (threadIdx.x == 0) {                                                       \
    unsigned long long t_;                                                      \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                      \
    tail_timeline[blockIdx.x][i] = t_;                                          \
  }
#else
#define TL_MARK(i)
#endif

// The mma's B fragment from a lane's share of a packed weight step (k = 4t
// .. 4t + 3 of column g8, see product_chunk): four int8 values widened
// exactly to two bf16 pairs, or four bf16 values as they are
template <typename WT> struct MmaB;
template <> struct MmaB<int8_t> {
  using V = uint32_t;
  __device__ static __forceinline__ void split(V v, uint32_t& b0, uint32_t& b1) {
    i8x4_to_bf16(v, b0, b1);
  }
};
template <> struct MmaB<bf16> {
  using V = uint2;
  __device__ static __forceinline__ void split(V v, uint32_t& b0, uint32_t& b1) {
    b0 = v.x;
    b1 = v.y;
  }
};

// Sums of the steps [s0, s1) of GC weight groups (w: the first group,
// [GC][steps][8 n][16 k] int8 or bf16) into acc[parity][group]: runs of
// four steps without branches, their loads first (A's four fragments and
// the 4 GC weight words), then the widening (int8) and the mma; a tail of
// single steps. Two accumulator sets (even and odd steps) halve the mma
// chain. Lane (g8 = lane / 4, t = lane % 4) takes k = 4t .. 4t + 3 of a
// step for both operands, as the mma's k = 2t, 2t + 1 (a0, b0) and 2t + 8,
// 2t + 9 (a2, b1): the same permutation of K on both sides leaves the
// product as it is; A's rows 8 .. 15 are zero.
template <int GC, typename WT>
__device__ __forceinline__ void product_chunk(float (&acc)[2][GC][4], const bf16* arow,
                                              const WT* w, int steps, int s0, int s1,
                                              int lane) {
  using V = typename MmaB<WT>::V;
  const WT* wl = w + 4 * lane;
  int s = s0;
  for (; s + 4 <= s1; s += 4) {
    uint2 av[4];
    V wv[4][GC];
#pragma unroll
    for (int u = 0; u < 4; ++u) av[u] = *reinterpret_cast<const uint2*>(arow + (s + u) * TL_KS);
#pragma unroll
    for (int g = 0; g < GC; ++g)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        wv[u][g] = *reinterpret_cast<const V*>(wl + ((size_t)g * steps + s + u) * TL_GW * TL_KS);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint32_t a[4] = {av[u].x, 0u, av[u].y, 0u};
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        uint32_t b0, b1;
        MmaB<WT>::split(wv[u][g], b0, b1);
        mma_bf16(acc[u & 1][g], a, b0, b1);
      }
    }
  }
  for (; s < s1; ++s) {
    const uint2 av = *reinterpret_cast<const uint2*>(arow + s * TL_KS);
    const uint32_t a[4] = {av.x, 0u, av.y, 0u};
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      uint32_t b0, b1;
      MmaB<WT>::split(*reinterpret_cast<const V*>(wl + ((size_t)g * steps + s) * TL_GW * TL_KS),
                      b0, b1);
      mma_bf16(acc[0][g], a, b0, b1);
    }
  }
}

// A chunk of GC groups from group g0: its sums, each lane's two (row
// lane / 4, columns 2 (lane % 4) + {0, 1}) written to red [warp][G][64]
template <int GC, typename WT>
__device__ __forceinline__ void product_groups(const bf16* arow, const WT* w, int steps,
                                               int s0, int s1, int G, int g0, float* red,
                                               int warp, int lane) {
  float acc[2][GC][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int g = 0; g < GC; ++g) acc[i][g][0] = acc[i][g][1] = acc[i][g][2] = acc[i][g][3] = 0.f;
  product_chunk<GC>(acc, arow, w + (size_t)g0 * steps * TL_GW * TL_KS, steps, s0, s1, lane);
#pragma unroll
  for (int g = 0; g < GC; ++g)
    *reinterpret_cast<float2*>(red + ((size_t)warp * G + g0 + g) * 64 + 2 * lane) =
        make_float2(acc[0][g][0] + acc[1][g][0], acc[0][g][1] + acc[1][g][1]);
}

// The sums of act [8][pitch] (bf16, zero in [K, Kp)) times each of the G
// groups of 8 columns of w ([G][Kp / 16][8 n][16 k] int8, exact in bf16, or
// bf16),
// left in red as [warp][G][8 rows x 8 columns] for product_sum. Tensor
// cores: mma.sync.m16n8k16 with f32 sums, 8 live rows of 16. Warp w sums
// its run of the Kp / 16 steps for two groups at a time (pw1's pair: W1
// runs the same code twice, already fetched), waiting first
// for its K chunk of act when chunk_bars is given (bulk_chunks). Ends with
// __syncthreads().
template <typename WT>
__device__ __noinline__ void block_product(const bf16* act, int pitch, const WT* w, int Kp,
                                          int G, float* red, uint64_t* chunk_bars, int parity,
                                          int mark) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int steps = Kp / TL_KS, per = (steps + TL_WARPS - 1) / TL_WARPS;
  const int s0 = min(steps, warp * per), s1 = min(steps, s0 + per);
  if (chunk_bars) mbar_wait(chunk_bars + warp / TL_CHUNK_WARPS, parity);
  const bf16* arow = act + (size_t)(lane >> 2) * pitch + 4 * (lane & 3);
  for (int g0 = 0; g0 < G; g0 += 2) {
    if (G - g0 == 1)
      product_groups<1>(arow, w, steps, s0, s1, G, g0, red, warp, lane);
    else
      product_groups<2>(arow, w, steps, s0, s1, G, g0, red, warp, lane);
  }
  TL_MARK(mark);
  __syncthreads();
  TL_MARK(mark + 1);
}

// Row r, column 8g + j of a block_product: the warps' sums added in a fixed
// order (no atomics: the kernel is deterministic)
__device__ __forceinline__ float product_sum(const float* red, int G, int r, int col) {
  const int g = col / TL_GW, i = r * TL_GW + col % TL_GW;
  float v = 0.f;
#pragma unroll
  for (int wp = 0; wp < TL_WARPS; ++wp) v += red[((size_t)wp * G + g) * 64 + i];
  return v;
}

}  // namespace port
