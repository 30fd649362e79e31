// Offline attention with a relative-position bias, online softmax.
//
// Replaces: trt_asr_tpu/ops/pallas/flash_att_kernel.py:flash_bias_attention
// (its pallas_call at :116). For q_u, k, v [B, T, H, dh] and bd [B, H, T, T]
// of one type (f32 or bf16) and kv_mask [B, T]:
//   s[t, j] = (q_u[t] . k[j] (f32) + (kv_mask[j] ? bd[t, j] : neg)) * scale
// then, over key blocks of FA_BLOCK = 128 (the TPU kernel's block):
//   m' = max(m, max_j s), a = exp(m - m'), p = exp(s - m'),
//   l = l a + sum_j p, acc = acc a + sum_j round(p) v[j]        (m from -1e30)
//   out[t] = acc / max(l, 1e-30)
// with the TPU kernel's rounding points: neg is -1e9 in the operand type and
// takes the place of bd on masked columns, p is rounded to v's type before
// p . v, and everything is summed in f32. The running max moves at the same
// key positions as on the TPU, so p rounds as it does there. out is [B, T,
// H * dh] f32, before the output projection.
//
// On the TPU the K/V axis is a sequential grid dimension that carries m, l
// and the accumulator in VMEM scratch, and the mask is folded into a padded
// bias tensor because of the (8, 128) block rule. Here one block owns a tile
// of query rows of one (b, h) and walks all key blocks itself, holding m, l
// and the accumulators in registers; it reads kv_mask directly and takes bd
// with its plane and row strides, so the caller's shifted view needs no copy.
// Keys past T are left out (p = 0), which equals the TPU's -1e9 padding for
// every row with a valid key.
//
// Bound on the H100: bytes at the offline shapes (q, k, v, bd, out: ~47 MB in
// bf16 at B 8, T 368, H 8, dh 128, 14 us at 3.35 TB/s, against 4.4 GFLOP,
// 4.5 us at the bf16 tensor-core rate).
//
// bf16 (flash_att_bf16_kernel): tensor cores and asynchronous copies. A block
// owns FB_BQ = 64 query rows; warp w owns rows 16w .. 16w+15, the m16 of
// mma.sync.m16n8k16 (bf16 operands, f32 sums), so the operand types and
// rounding points above are the tensor core's own: round(p) is the conversion p
// needs to become an A operand. Q is copied once with cp.async and stays in
// shared memory for the whole key walk, read into A fragments (ldmatrix) at
// each k16 step: held in registers too, its 32 a thread beside S's 64 and O's
// 64 took the kernel to 255 registers with spills. For each 128-key block, S =
// Q K^T (K in [key][d] order is the col-major B operand: plain ldmatrix) lands
// in f32 registers, 16 x 128 a warp (the tensor cores round its f32 sums
// otherwise than a chain of FMAs or the plain version's f32 einsum, and one
// ulp of a score can flip p's bf16 rounding at a key); the bias,
// mask and scale are applied in the accumulator layout (a thread holds rows g
// and g + 8, columns 2c and 2c + 1 of each n8 tile), the row max and sum are
// reduced over the quad, and p, rounded to bf16, is packed straight into the A
// fragments of O += P V (the accumulator layout is the A layout, so p never
// passes through shared memory); V is read with ldmatrix.trans. One K tile and
// one V tile live in shared memory, each refilled as soon as the block is done
// with it: K(j+1) and bd(j+1) are in flight during the softmax and P V of block
// j, V(j+1) during S and the softmax of block j+1. At ~102 KB of shared memory
// (dh 128) two blocks share an SM, and each covers the other's waits; a
// two-stage ring of K, V and the bias needs ~187 KB and leaves one block of four
// warps an SM, which is slower on the H100, as is this kernel held to one block
// an SM (flash_variants.py at the repository root times both). Row pitches are dh + 8 (dh
// rounded up to 16) and 136 elements, an odd number of 16-byte units, so
// ldmatrix and the bias reads in the accumulator layout hit 32 distinct banks.
// A head dim that is not a multiple of 16 is zero-filled up to one in shared
// memory (zero columns add nothing to q . k; V's zero columns are not written).
// The copy widths are template parameters chosen by the wrapper from the
// alignment of the rows: 16 or 8 bytes for q, k and v, 16, 8 or 4 bytes for bd
// with cp.async, and 2 bytes (the plain shift's view, whose row stride 2T - 1
// is odd) as plain loads and stores.
// Why mma.sync and cp.async, not wgmma and TMA: the call is bound by bytes,
// and warp-level products at a fraction of the tensor-core peak keep the
// math under the bytes; and TMA cannot take bd as the plain shift passes it
// (global strides must be multiples of 16 bytes; that view's row stride is
// 2T - 1 elements, odd, at an offset of T). wgmma + TMA is the step after
// this one, if the kernel comes within 2x of its bytes bound and the math
// shows in the profile.
//
// f32 (flash_att_f32_kernel): CUDA cores, FFMA only (TF32 or 3xTF32 would
// break the port's f32 policy, which plays the reference's
// Precision.HIGHEST). Bound by operations at the offline shapes (4.4 GFLOP,
// 66 us at 67 TFLOP/s, against ~83 MB, 25 us). Register tiles: a block
// owns F_BQ = 64 query rows, 8 warps of 8 rows. For S = Q K^T over a whole
// 128-key block (one 128-row K tile), lane l of a warp owns keys l + 32j
// (j < 4) of its 8 rows: at each 4-wide step of d, 4 float4s of K (32
// consecutive rows a warp: the row pitch is an odd number of 16-byte units)
// and 8 float4s of Q (broadcast) feed 128 FFMA. A row's 128 keys lie in one
// warp, so its max and sum are warp shuffles and m, l and alpha live in
// every lane. p goes to shared memory once a block; O += P V gives lane
// (ct, kh) an 8 x 8 tile (columns 4ct and 64 + 4ct, keys 64kh .. 64kh + 63
// of the block), 256 FFMA for 8 float4s of p (broadcast) and 8 of V; the
// two key halves are summed by one shuffle at the end. K and V pass
// through a two-stage ring of 128-row tiles copied with 16-byte cp.async
// one tile ahead of the math, one __syncthreads a tile; the bias and mask
// (4-byte rows at the plain shift's odd stride, 32 lanes on 32 consecutive
// keys) are read from global memory before the products of the block.
// ~198 KB of shared memory and ~250 registers leave one block (8 warps) an
// SM. Sums of q . k run in d order and p . v in key order within each key
// half, as chains of FMAs; expf, the 128-key blocks and the rounding of
// bias, scale and the final division are the plain version's. What holds
// it back (flash_variants.py): the products run near cuBLAS's f32 GEMM
// rate, but the rest of the key walk (copies, bias loads, the softmax and
// the __syncthreads, ~45% of the time with no product at all) does not
// overlap them: every warp of the one block an SM is in the same phase.
#include "common.cuh"

namespace port {

constexpr int FA_BLOCK = 128;               // keys a softmax block (the TPU's)
constexpr int FA_DMAX = 128;                // largest head dim taken

// --- bf16: mma.sync + cp.async ----------------------------------------------

constexpr int FB_WARPS = 4;
constexpr int FB_THREADS = FB_WARPS * 32;
constexpr int FB_BQ = 16 * FB_WARPS;        // query rows a block, 16 a warp
constexpr int FB_KS = FA_DMAX / 16;         // k16 steps of q . k (and d16 pairs of p . v)
constexpr int FB_NT = FA_BLOCK / 8;         // n8 tiles of S a warp
constexpr int FB_PAD = 8;                   // row pitch of q, k, v tiles: dh16 + 8 elements
constexpr int FB_BDP = FA_BLOCK + 8;        // row pitch of the bias tile, elements
static_assert(FB_THREADS == FA_BLOCK, "one thread per key of a block reads the mask");

__host__ __device__ constexpr size_t flash_bf16_smem(int dh) {
  return ((size_t)(FB_BQ + 2 * FA_BLOCK) * (((dh + 15) & ~15) + FB_PAD) +
          (size_t)FB_BQ * FB_BDP) * sizeof(bf16) + FA_BLOCK / 8;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows row0 .. row0 + ROWS - 1 of a row-major [Tn, step] matrix, columns
// 0 .. dp - 1 of which the first dh are read (dh a multiple of BYTES / 2),
// into dst with row pitch `pitch`; rows past Tn and columns past dh are zero.
template <int BYTES, int ROWS>
__device__ __forceinline__ void load_rows(bf16* dst, int pitch, const bf16* src, size_t step,
                                          int row0, int Tn, int dh, int dp) {
  constexpr int E = BYTES / 2;
  const int cpr = dp / E;
  for (int i = threadIdx.x; i < ROWS * cpr; i += FB_THREADS) {
    const int r = i / cpr, col = (i - r * cpr) * E, t = row0 + r;
    const bool ok = t < Tn && col < dh;
    cp_async<BYTES>(dst + r * pitch + col, ok ? src + (size_t)t * step + col : src,
                    ok ? BYTES : 0);
  }
}

// The bias tile of query rows q0 .. q0 + FB_BQ - 1 and keys kb .. kb + 127;
// rows past Tn and keys past Tn are zero. Rows of 2-byte alignment have no
// cp.async: plain loads and stores.
template <int BYTES>
__device__ __forceinline__ void load_bias(bf16* dst, const bf16* bd_bh, int ld, int q0, int kb,
                                          int Tn) {
  constexpr int E = BYTES / 2, CPR = FA_BLOCK / E;
#pragma unroll 4
  for (int i = threadIdx.x; i < FB_BQ * CPR; i += FB_THREADS) {
    const int r = i / CPR, col = (i % CPR) * E, t = q0 + r, key = kb + col;
    const int n = t < Tn ? max(0, min(E, Tn - key)) : 0;
    const bf16* src = n ? bd_bh + (size_t)t * ld + key : bd_bh;
    if constexpr (BYTES >= 4)
      cp_async<BYTES>(dst + r * FB_BDP + col, src, 2 * n);
    else
      dst[r * FB_BDP + col] = n ? *src : __float2bfloat16_rn(0.f);
  }
}

template <int QB, int BB>
__global__ void __launch_bounds__(FB_THREADS, 2)
flash_att_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ bd, int bd_plane,
                      int bd_ld, const uint8_t* __restrict__ mask, int Tn, int H, int dh,
                      float scale, float neg, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dp = (dh + 15) & ~15, pitch = dp + FB_PAD, nks = dp / 16;
  bf16* q_s = reinterpret_cast<bf16*>(smem);     // [FB_BQ][pitch]
  bf16* k_s = q_s + FB_BQ * pitch;               // [FA_BLOCK][pitch]
  bf16* v_s = k_s + FA_BLOCK * pitch;            // [FA_BLOCK][pitch]
  bf16* bd_s = v_s + FA_BLOCK * pitch;           // [FB_BQ][FB_BDP]
  uint32_t* keep_s = reinterpret_cast<uint32_t*>(bd_s + FB_BQ * FB_BDP);   // 128 mask bits
  const int q0 = blockIdx.x * FB_BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, g = lane >> 2, c = lane & 3;
  const size_t step = (size_t)H * dh;                          // between time steps
  const size_t base = (size_t)b * Tn * step + (size_t)h * dh;  // (b, t = 0, h, d = 0)
  const bf16* bd_bh = bd + (size_t)(b * H + h) * bd_plane;
  const uint8_t* mask_b = mask + (size_t)b * Tn;

  // copy groups, in order: Q; K(0) + bias(0); V(0). Then each block commits
  // K(j+1) + bias(j+1) after its S and V(j+1) after its P V (empty groups
  // past the last block), so waiting until one group is pending always
  // leaves exactly the copy that was issued last in flight.
  load_rows<QB, FB_BQ>(q_s, pitch, q + base, step, q0, Tn, dh, dp);
  cp_async_commit();
  load_rows<QB, FA_BLOCK>(k_s, pitch, k + base, step, 0, Tn, dh, dp);
  load_bias<BB>(bd_s, bd_bh, bd_ld, q0, 0, Tn);
  cp_async_commit();
  load_rows<QB, FA_BLOCK>(v_s, pitch, v + base, step, 0, Tn, dh, dp);
  cp_async_commit();

  // ldmatrix row addresses of this lane: A operand (Q) and trans B (V) take
  // matrices (rows 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15);
  // the B operand (K) takes (keys 0-7, d 0-7), (0-7, 8-15), (8-15, 0-7),
  // (8-15, 8-15), i.e. two n8 tiles of one k16 step
  const int a_row = (lane & 7) + (lane & 8), a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = lane & 8;

  float o[2 * FB_KS][4];
#pragma unroll
  for (int dt = 0; dt < 2 * FB_KS; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};    // rows g and g + 8

  for (int kb = 0; kb < Tn; kb += FA_BLOCK) {
    const bool more = kb + FA_BLOCK < Tn;
    {
      const int key = kb + tid;
      const unsigned keep = __ballot_sync(0xffffffffu, key < Tn && mask_b[key]);
      if (lane == 0) keep_s[w] = keep;
    }
    cp_async_wait<1>();                  // Q, K(j) and bias(j) have landed
    __syncthreads();

    float s[FB_NT][4];
#pragma unroll
    for (int nt = 0; nt < FB_NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < FB_KS; ++ks) {
      if (ks >= nks) break;
      uint32_t qf[4];
      ldmatrix_x4(qf, q_s + (16 * w + a_row) * pitch + 16 * ks + a_col);
#pragma unroll
      for (int np = 0; np < FB_NT / 2; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, k_s + (16 * np + b_row) * pitch + 16 * ks + b_col);
        mma_bf16(s[2 * np], qf, kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf, kf[2], kf[3]);
      }
    }
    uint32_t keep[FA_BLOCK / 32];
#pragma unroll
    for (int i = 0; i < FA_BLOCK / 32; ++i) keep[i] = keep_s[i];
#pragma unroll
    for (int nt = 0; nt < FB_NT; ++nt) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {           // rows g and g + 8
        const int col = 8 * nt + 2 * c;
        const __nv_bfloat162 bias2 = *reinterpret_cast<const __nv_bfloat162*>(
            bd_s + (16 * w + g + 8 * hr) * FB_BDP + col);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kc = col + e;
          const float bias = (keep[kc >> 5] >> (kc & 31)) & 1u
                                 ? (e ? __high2float(bias2) : __low2float(bias2)) : neg;
          float& x = s[nt][2 * hr + e];
          x = kb + kc < Tn ? __fmul_rn(__fadd_rn(x, bias), scale) : -INFINITY;
        }
      }
    }
    __syncthreads();                     // every warp is done with K(j), bias(j), the mask
    if (more) {
      load_rows<QB, FA_BLOCK>(k_s, pitch, k + base, step, kb + FA_BLOCK, Tn, dh, dp);
      load_bias<BB>(bd_s, bd_bh, bd_ld, q0, kb + FA_BLOCK, Tn);
    }
    cp_async_commit();

    // online softmax over the block, rows g and g + 8
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < FB_NT; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * hr], s[nt][2 * hr + 1]));
      const float m_new = fmaxf(m[hr], quad_max(mx));
      alpha[hr] = expf(m[hr] - m_new);
      m[hr] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < FB_NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - m[e >> 1]);     // 0 for keys past T
        psum[e >> 1] += s[nt][e];
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      l[hr] = __fadd_rn(__fmul_rn(l[hr], alpha[hr]), quad_sum(psum[hr]));
#pragma unroll
    for (int dt = 0; dt < 2 * FB_KS; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }

    cp_async_wait<1>();                  // V(j) has landed
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FA_BLOCK / 16; ++kk) {
      // p of keys 16 kk .. 16 kk + 15 as the A operand: S tiles 2 kk, 2 kk + 1
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dq = 0; dq < FB_KS; ++dq) {
        if (dq >= nks) break;
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, v_s + (16 * kk + a_row) * pitch + 16 * dq + a_col);
        mma_bf16(o[2 * dq], pa, vf[0], vf[1]);
        mma_bf16(o[2 * dq + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();                     // every warp is done with V(j)
    if (more) load_rows<QB, FA_BLOCK>(v_s, pitch, v + base, step, kb + FA_BLOCK, Tn, dh, dp);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int t = q0 + 16 * w + g + 8 * hr;
    if (t >= Tn) continue;                       // rows past T are not written
    const float denom = fmaxf(l[hr], 1e-30f);    // a fully masked row still has l > 0
    float* orow = out + base + (size_t)t * step;
#pragma unroll
    for (int dt = 0; dt < 2 * FB_KS; ++dt) {
      const int col = 8 * dt + 2 * c;
      if (col < dh)
        *reinterpret_cast<float2*>(orow + col) = make_float2(
            __fdiv_rn(o[dt][2 * hr], denom), __fdiv_rn(o[dt][2 * hr + 1], denom));
    }
  }
}

template <int QB, int BB>
cudaError_t launch_flash_bf16_as(const void* q, const void* k, const void* v, const void* bd,
                                 int bd_plane, int bd_ld, const uint8_t* mask, int B, int Tn,
                                 int H, int dh, float scale, float neg, float* out,
                                 cudaStream_t stream) {
  const size_t smem = flash_bf16_smem(dh);
  cudaError_t err = cudaFuncSetAttribute(flash_att_bf16_kernel<QB, BB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tn + FB_BQ - 1) / FB_BQ, H, B);
  flash_att_bf16_kernel<QB, BB><<<grid, FB_THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)bd, bd_plane, bd_ld, mask,
      Tn, H, dh, scale, neg, out);
  return cudaGetLastError();
}

template <int QB>
cudaError_t launch_flash_bf16_q(int bd_bytes, const void* q, const void* k, const void* v,
                                const void* bd, int bd_plane, int bd_ld, const uint8_t* mask,
                                int B, int Tn, int H, int dh, float scale, float neg, float* out,
                                cudaStream_t stream) {
  switch (bd_bytes) {
    case 16: return launch_flash_bf16_as<QB, 16>(q, k, v, bd, bd_plane, bd_ld, mask, B, Tn, H,
                                                 dh, scale, neg, out, stream);
    case 8: return launch_flash_bf16_as<QB, 8>(q, k, v, bd, bd_plane, bd_ld, mask, B, Tn, H,
                                               dh, scale, neg, out, stream);
    case 4: return launch_flash_bf16_as<QB, 4>(q, k, v, bd, bd_plane, bd_ld, mask, B, Tn, H,
                                               dh, scale, neg, out, stream);
    case 2: return launch_flash_bf16_as<QB, 2>(q, k, v, bd, bd_plane, bd_ld, mask, B, Tn, H,
                                               dh, scale, neg, out, stream);
    default: return cudaErrorInvalidValue;
  }
}

// --- f32: register tiles on the CUDA cores ----------------------------------

constexpr int F_BQ = 64;                    // query rows a block, 8 a warp
constexpr int F_THREADS = 4 * F_BQ;
constexpr int F_MIN_BLOCKS = 1;             // blocks an SM (__launch_bounds__)
constexpr int F_KT = 128;                   // keys a staged K or V tile
constexpr int F_NT = FA_BLOCK / F_KT;       // K (and V) tiles a softmax block
constexpr int F_LD4 = FA_DMAX / 4 + 1;      // row pitch of Q, K, V and p tiles, float4s (odd)
static_assert(FA_BLOCK == 128 && F_LD4 * 4 >= FA_BLOCK + 4, "p rows fit the tile pitch");
static_assert(F_KT % 32 == 0 && FA_BLOCK % F_KT == 0, "whole lanes of keys a tile");

// Q tile, a two-stage ring of K/V tiles, p of one softmax block
__host__ __device__ constexpr size_t flash_f32_smem() {
  return (size_t)(2 * F_BQ + 2 * F_KT) * F_LD4 * sizeof(float4);
}

__device__ __forceinline__ void axpy4(float a, float4 x, float4& y) {
  y.x = fmaf(a, x.x, y.x);
  y.y = fmaf(a, x.y, y.y);
  y.z = fmaf(a, x.z, y.z);
  y.w = fmaf(a, x.w, y.w);
}
__device__ __forceinline__ void scale4(float a, float4& y) {
  y.x *= a;
  y.y *= a;
  y.z *= a;
  y.w *= a;
}

// Rows row0 .. row0 + ROWS - 1 of a row-major [Tn, step] f32 matrix, their
// first dh values, into dst (pitch F_LD4 float4s) with 16-byte cp.async, a
// warp a row at a time (lane c copies float4 c); rows past Tn are zero.
template <int ROWS>
__device__ __forceinline__ void stage_f32(float4* dst, const float* src, size_t step, int row0,
                                          int Tn, int nd4) {
  const int c = threadIdx.x & 31;
  if (c >= nd4) return;
  for (int r = threadIdx.x >> 5; r < ROWS; r += F_THREADS / 32) {
    const int t = row0 + r;
    const bool ok = t < Tn;
    cp_async<16>(dst + r * F_LD4 + c, ok ? src + (size_t)t * step + 4 * c : src, ok ? 16 : 0);
  }
}

// The bias and mask of key block kb for rows 8w .. 8w + 7 and keys
// kb + lane + 32j: every in-range key's bias (no load waits on the mask).
__device__ __forceinline__ void load_bias_f32(float (&bias)[8][4], bool (&keep)[4],
                                              const float* bd_bh, int bd_ld,
                                              const uint8_t* mask_b, int row0, int kb, int Tn) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int key = kb + lane + 32 * j;
    keep[j] = key < Tn && mask_b[min(key, Tn - 1)];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int t = min(row0 + r, Tn - 1);               // rows past T are not written
      bias[r][j] = key < Tn ? __ldg(bd_bh + (size_t)t * bd_ld + key) : 0.f;
    }
  }
}

__global__ void __launch_bounds__(F_THREADS, F_MIN_BLOCKS)
flash_att_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bd, int bd_plane,
                     int bd_ld, const uint8_t* __restrict__ mask, int Tn, int H, int dh,
                     float scale, float neg, float* __restrict__ out) {
  extern __shared__ __align__(16) float4 fsm[];
  float4* q_s = fsm;                                         // [F_BQ][F_LD4]
  float4* ring = q_s + F_BQ * F_LD4;                         // [2][F_KT][F_LD4]
  float* p_s = reinterpret_cast<float*>(ring + 2 * F_KT * F_LD4);   // [F_BQ][4 F_LD4]
  constexpr int PLD = 4 * F_LD4;                             // p row pitch, floats
  const int q0 = blockIdx.x * F_BQ, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  // warp w owns rows 8w .. 8w + 7. Scores: keys lane + 32j of a block. P V:
  // half kh of the keys of a V tile, columns 4ct .. 4ct + 3 and 64 + 4ct ..
  const int ct = lane & 15, kh = lane >> 4;
  const size_t step = (size_t)H * dh;                          // between time steps
  const size_t base = (size_t)b * Tn * step + (size_t)h * dh;  // (b, t = 0, h, d = 0)
  const float* bd_bh = bd + (size_t)(b * H + h) * bd_plane;
  const uint8_t* mask_b = mask + (size_t)b * Tn;
  const int nd4 = dh / 4, ntiles = 2 * F_NT * ((Tn + FA_BLOCK - 1) / FA_BLOCK);

  // tile n of key block n / (2 F_NT): its K tiles, then its V tiles
  auto issue = [&](int n) {
    if (n < ntiles) {
      const int part = n % (2 * F_NT);
      stage_f32<F_KT>(ring + (n & 1) * F_KT * F_LD4, (part < F_NT ? k : v) + base, step,
                      n / (2 * F_NT) * FA_BLOCK + part % F_NT * F_KT, Tn, nd4);
    }
    cp_async_commit();
  };
  stage_f32<F_BQ>(q_s, q + base, step, q0, Tn, nd4);
  issue(0);                                  // Q rides with K of the first block

  float m[8], l[8], alpha[8];
  float4 o[8][2];                            // [row 8w + r][columns 4ct.., 64 + 4ct..]
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    m[r] = -1e30f;
    l[r] = alpha[r] = 0.f;
    o[r][0] = o[r][1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float4* qw = q_s + 8 * w * F_LD4;
  float* pw = p_s + 8 * w * PLD;

  for (int kb = 0, n = 0; kb < Tn; kb += FA_BLOCK) {
    float s[8][4], bias[8][4];               // keys lane + 32j of the block
    bool keep[4];
#pragma unroll
    for (int part = 0; part < 2 * F_NT; ++part, ++n) {
      cp_async_wait<0>();
      __syncthreads();       // tile n has landed; every thread is done with tile n - 1
      issue(n + 1);
      const float4* tile = ring + (n & 1) * F_KT * F_LD4;
      if (part < F_NT) {
        // scores of the tile's keys part F_KT + lane + 32jj; the block's
        // bias and mask are loaded first, so that the products hide their
        // latency
        constexpr int JT = F_KT / 32;
        if (part == 0) load_bias_f32(bias, keep, bd_bh, bd_ld, mask_b, q0 + 8 * w, kb, Tn);
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int jj = 0; jj < JT; ++jj) s[r][part * JT + jj] = 0.f;
        const float4* kr = tile + lane * F_LD4;
#pragma unroll 2
        for (int d4 = 0; d4 < nd4; ++d4) {
          float4 kv[JT];
#pragma unroll
          for (int jj = 0; jj < JT; ++jj) kv[jj] = kr[32 * jj * F_LD4 + d4];
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const float4 qv = qw[r * F_LD4 + d4];
#pragma unroll
            for (int jj = 0; jj < JT; ++jj)
              s[r][part * JT + jj] = dot4(qv, kv[jj], s[r][part * JT + jj]);
          }
        }
        if (part < F_NT - 1) continue;
        // online softmax over the block: a row's 128 keys lie in one warp
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int key = kb + lane + 32 * j;
            s[r][j] = key < Tn ? __fmul_rn(__fadd_rn(s[r][j], keep[j] ? bias[r][j] : neg),
                                           scale)
                               : -INFINITY;
            mx = fmaxf(mx, s[r][j]);
          }
          const float m_new = fmaxf(m[r], warp_max(mx));
          alpha[r] = expf(m[r] - m_new);
          float psum = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float p = expf(s[r][j] - m_new);        // 0 for keys past T
            psum += p;
            pw[r * PLD + lane + 32 * j] = p;
          }
          l[r] = __fadd_rn(__fmul_rn(l[r], alpha[r]), warp_sum(psum));
          m[r] = m_new;
        }
      } else {
        // O += P V over half kh of this V tile's keys (p was written before
        // this tile's __syncthreads)
        const int hv = part - F_NT;
        if (hv == 0) {
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            scale4(alpha[r], o[r][0]);
            scale4(alpha[r], o[r][1]);
          }
        }
        const float* pk = pw + hv * F_KT + kh * (F_KT / 2);
        const float4* vk = tile + kh * (F_KT / 2) * F_LD4 + ct;
#pragma unroll 2
        for (int j = 0; j < F_KT / 2; j += 4) {
          float4 vv[4][2];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            vv[jj][0] = vk[(j + jj) * F_LD4];
            vv[jj][1] = vk[(j + jj) * F_LD4 + 16];
          }
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const float4 p4 = *reinterpret_cast<const float4*>(pk + r * PLD + j);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              axpy4(p4.x, vv[0][hh], o[r][hh]);
              axpy4(p4.y, vv[1][hh], o[r][hh]);
              axpy4(p4.z, vv[2][hh], o[r][hh]);
              axpy4(p4.w, vv[3][hh], o[r][hh]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // sum the two key halves (lanes ct and ct + 16), each lane keeping four
  // rows, and divide by l
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r + 4 * kh;
    const int t = q0 + 8 * w + row;
    const float denom = fmaxf(kh ? l[r + 4] : l[r], 1e-30f);   // a fully masked row has l > 0
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float4 mine = kh ? o[r + 4][hh] : o[r][hh];
      const float4 send = kh ? o[r][hh] : o[r + 4][hh];
      mine.x += __shfl_xor_sync(0xffffffffu, send.x, 16);
      mine.y += __shfl_xor_sync(0xffffffffu, send.y, 16);
      mine.z += __shfl_xor_sync(0xffffffffu, send.z, 16);
      mine.w += __shfl_xor_sync(0xffffffffu, send.w, 16);
      const int col = 64 * hh + 4 * ct;
      if (t < Tn && col < dh)                     // rows past T are not written
        *reinterpret_cast<float4*>(out + base + (size_t)t * step + col) =
            make_float4(__fdiv_rn(mine.x, denom), __fdiv_rn(mine.y, denom),
                        __fdiv_rn(mine.z, denom), __fdiv_rn(mine.w, denom));
    }
  }
}

cudaError_t launch_flash_f32(const void* q, const void* k, const void* v, const void* bd,
                             int bd_plane, int bd_ld, const uint8_t* mask, int B, int Tn, int H,
                             int dh, float scale, float neg, float* out, cudaStream_t stream) {
  const size_t smem = flash_f32_smem();
  cudaError_t err = cudaFuncSetAttribute(flash_att_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tn + F_BQ - 1) / F_BQ, H, B);
  flash_att_f32_kernel<<<grid, F_THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)bd, bd_plane, bd_ld,
      mask, Tn, H, dh, scale, neg, out);
  return cudaGetLastError();
}

}  // namespace port

using namespace port;

// q, k, v [B, T, H, dh] contiguous; bd [B, H, T, T] with unit column stride,
// row stride bd_ld (>= T) and (b, h) plane stride bd_plane (>= T * bd_ld);
// mask [B, T] bytes (0 = masked); out [B, T, H * dh] f32 (16-byte aligned).
// dtype 0 = f32, 1 = bf16 (q, k, v and bd); dh a multiple of 4, at most 128;
// q, k and v aligned to four elements; neg is -1e9 rounded to that type.
// bf16 only: qkv_bytes (16 or 8) and bd_bytes (16, 8, 4 or 2) are the copy
// widths of q/k/v and bd rows, each dividing the base addresses and the
// strides in bytes (ops/kernels/flash_att.py:copy_widths). Returns the CUDA
// error code.
extern "C" int flash_att_launch(const void* q, const void* k, const void* v, const void* bd,
                                int bd_plane, int bd_ld, const void* mask, int B, int T,
                                int H, int dh, int dtype, int qkv_bytes, int bd_bytes,
                                float scale, float neg, float* out, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (B < 1 || T < 1 || H < 1 || dh < 4 || dh % 4 != 0 || dh > FA_DMAX || bd_ld < T ||
      (size_t)bd_plane < (size_t)T * bd_ld)
    return (int)cudaErrorInvalidValue;
  const uint8_t* m = (const uint8_t*)mask;
  if (dtype == W_F32)
    return (int)launch_flash_f32(q, k, v, bd, bd_plane, bd_ld, m, B, T, H, dh, scale, neg, out,
                                 stream);
  if (dtype != W_BF16 || (qkv_bytes != 16 && qkv_bytes != 8) ||
      !copies_aligned(qkv_bytes, {(uintptr_t)q, (uintptr_t)k, (uintptr_t)v, 2u * (uintptr_t)dh}) ||
      !copies_aligned(bd_bytes, {(uintptr_t)bd, 2u * (uintptr_t)bd_ld,
                                 B * H > 1 ? 2u * (uintptr_t)bd_plane : 0u}))
    return (int)cudaErrorInvalidValue;
  if (qkv_bytes == 16)
    return (int)launch_flash_bf16_q<16>(bd_bytes, q, k, v, bd, bd_plane, bd_ld, m, B, T, H, dh,
                                        scale, neg, out, stream);
  return (int)launch_flash_bf16_q<8>(bd_bytes, q, k, v, bd, bd_plane, bd_ld, m, B, T, H, dh,
                                     scale, neg, out, stream);
}

// Dynamic shared memory of the bf16 kernel at head dim dh, and how many of
// its blocks an SM holds at once; both written to info[0..1].
extern "C" int flash_att_bf16_occupancy(int dh, int* info) {
  const size_t smem = flash_bf16_smem(dh);
  cudaError_t err = cudaFuncSetAttribute(flash_att_bf16_kernel<16, 16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = (int)smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &info[1], flash_att_bf16_kernel<16, 16>, FB_THREADS, smem);
}

// Dynamic shared memory of the f32 kernel, and how many of its blocks an SM
// holds at once; both written to info[0..1] (its tiles are sized for
// FA_DMAX, whatever the head dim).
extern "C" int flash_att_f32_occupancy(int* info) {
  const size_t smem = flash_f32_smem();
  cudaError_t err = cudaFuncSetAttribute(flash_att_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = (int)smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[1], flash_att_f32_kernel,
                                                            F_THREADS, smem);
}
