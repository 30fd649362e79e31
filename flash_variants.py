"""Variants of the bf16 and f32 flash-attention kernels, timed on the card
at the offline batch's shapes (B 8, T 368, H 8, dh 128; the kv lengths of
``chip_smoke.py`` phase 2), to show what their design choices buy and where
their time goes. Run from the repository root on a machine with the card:

    python3 flash_variants.py

Each variant is ``trt_asr_tpu_torch/csrc/flash_att.cu`` with a few lines
replaced (a replacement that no longer matches the source raises), built
by ``nvcc`` into ``trt_asr_tpu_torch/_build/variants/``, launched through
the same C interface as the kernel and timed with ``chip_smoke.py``'s timer
(L2 scrubbed before every launch), on the rel-shift kernel's contiguous
bias (the path at T >= 128) and on the plain shift's strided view (2-byte
bias rows). Design variants (held, as the kernel is, to the plain version
fed the tensor cores' sums of q . k, at 1e-4): ``one_block`` pads shared
memory so that one block, not two, fits an SM; ``eight_warps`` takes 128
query rows a block; ``ring`` keeps two stages of K, V and the bias at one
block an SM. Diagnostic variants (their results are wrong; their error is
printed): ``no_kv_loads`` and ``no_bias_loads`` copy K/V or the bias of
the first key block only, ``no_loads`` both, ``no_mma`` replaces both
products with a register operation, ``fast_exp`` takes ``__expf``.

f32 variants (``f32_*``; held, as the kernel is, to the plain version at
atol 2e-5 + rtol 1e-4, timed on the plain shift's strided view, the bias
the f32 path passes, and on contiguous rows, beside SDPA in f32 and a
cuBLAS f32 GEMM that calibrates the card's FFMA rate): ``f32_kt64``
stages K and V in 64-key tiles (the kernel: 128), ``f32_q32_kt64`` also
takes 32 query rows a block, so that two blocks share an SM; the
diagnostics ``f32_fast_exp`` (``__expf``), ``f32_no_kv_loads`` (K and V
of the first key block only), ``f32_no_syncs`` (no __syncthreads in the
key walk), ``f32_no_bias_loads`` (no bias read) and ``f32_no_products``
(neither q . k nor p . v) give wrong results, and their error is printed.
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs
from trt_asr_tpu_torch.ops.kernels import build as kb
from trt_asr_tpu_torch.ops.kernels.flash_att import (MASKED_BIAS, copy_widths,
                                                     flash_bias_attention,
                                                     flash_bias_attention_plain)
from trt_asr_tpu_torch.ops.kernels.rel_shift import (rel_pos_bias_shifted,
                                                     rel_pos_bias_shifted_plain)

LOOP_START, LOOP_END = "  // copy groups, in order", "  cp_async_wait<0>();"
S_START = "    float s[FB_NT][4];"
S_END = "    __syncthreads();                     // every warp is done with K(j)"
SOFTMAX_START, SOFTMAX_END = "    // online softmax over the block", "    cp_async_wait<1>();"
PV_START = "#pragma unroll\n    for (int kk = 0;"
PV_END = "    __syncthreads();                     // every warp is done with V(j)"
ONE_BLOCK = ("__launch_bounds__(FB_THREADS, 2)", "__launch_bounds__(FB_THREADS, 1)")

# The two-stage ring: block j's K, V and bias in stage j & 1, all copied in
# one group, issued two blocks ahead.
RING_HEAD = """  bf16* kv_s = q_s + FB_BQ * pitch;
  bf16* bdr_s = kv_s + 4 * FA_BLOCK * pitch;
  uint32_t* keep_s = reinterpret_cast<uint32_t*>(bdr_s + 2 * FB_BQ * FB_BDP);
  auto issue = [&](int j) {
    bf16* ks = kv_s + (j & 1) * 2 * FA_BLOCK * pitch;
    if (j * FA_BLOCK < Tn) {
      load_rows<QB, FA_BLOCK>(ks, pitch, k + base, step, j * FA_BLOCK, Tn, dh, dp);
      load_bias<BB>(bdr_s + (j & 1) * FB_BQ * FB_BDP, bd_bh, bd_ld, q0, j * FA_BLOCK, Tn);
      load_rows<QB, FA_BLOCK>(ks + FA_BLOCK * pitch, pitch, v + base, step, j * FA_BLOCK, Tn,
                              dh, dp);
    }
    cp_async_commit();
  };
  load_rows<QB, FB_BQ>(q_s, pitch, q + base, step, q0, Tn, dh, dp);
  issue(0);
  issue(1);
  const int a_row = (lane & 7) + (lane & 8), a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = lane & 8;
  float o[2 * FB_KS][4];
#pragma unroll
  for (int dt = 0; dt < 2 * FB_KS; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  for (int kb = 0, j = 0; kb < Tn; kb += FA_BLOCK, ++j) {
    const bf16* k_s = kv_s + (j & 1) * 2 * FA_BLOCK * pitch;
    const bf16* v_s = k_s + FA_BLOCK * pitch;
    const bf16* bd_s = bdr_s + (j & 1) * FB_BQ * FB_BDP;
    {
      const int key = kb + tid;
      const unsigned keep = __ballot_sync(0xffffffffu, key < Tn && mask_b[key]);
      if (lane == 0) keep_s[w] = keep;
    }
    cp_async_wait<1>();
    __syncthreads();
"""
RING_TAIL = """    __syncthreads();
    issue(j + 2);
  }
"""


def _between(src: str, start: str, end: str) -> str:
    a = src.index(start)
    return src[a:src.index(end, a)]


def ring(src: str) -> str:
    loop = _between(src, LOOP_START, LOOP_END)
    body = (RING_HEAD + _between(loop, S_START, S_END)
            + _between(loop, SOFTMAX_START, SOFTMAX_END) + _between(loop, PV_START, PV_END)
            + RING_TAIL)
    src = src.replace(loop, body)
    ptrs = _between(src, "  bf16* k_s = q_s + FB_BQ * pitch;", "  const int q0 =")
    src = src.replace(ptrs, "")
    smem = "(size_t)(FB_BQ + 2 * FA_BLOCK)"
    bias = "(size_t)FB_BQ * FB_BDP) * sizeof(bf16)"
    return src.replace(smem, "(size_t)(FB_BQ + 4 * FA_BLOCK)").replace(bias, "2 * " + bias)


LOAD_K = "      load_rows<QB, FA_BLOCK>(k_s, pitch, k + base, step, kb + FA_BLOCK, Tn, dh, dp);"
LOAD_BIAS = "      load_bias<BB>(bd_s, bd_bh, bd_ld, q0, kb + FA_BLOCK, Tn);"
NO_K_BIAS = LOAD_K + "\n" + LOAD_BIAS
NO_V = ("    if (more) load_rows<QB, FA_BLOCK>(v_s, pitch, v + base, step, kb + FA_BLOCK, "
        "Tn, dh, dp);")
S_MMA = """        mma_bf16(s[2 * np], qf, kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf, kf[2], kf[3]);"""
PV_MMA = """        mma_bf16(o[2 * dq], pa, vf[0], vf[1]);
        mma_bf16(o[2 * dq + 1], pa, vf[2], vf[3]);"""
EXP = "s[nt][e] = expf(s[nt][e] - m[e >> 1]);"

F32_ISSUE = "      issue(n + 1);"
F32_SYNC = "      __syncthreads();       // tile n has landed; every thread is done with tile n - 1"
F32_BIAS = "      bias[r][j] = key < Tn ? __ldg(bd_bh + (size_t)t * bd_ld + key) : 0.f;"
F32_S = """            for (int jj = 0; jj < JT; ++jj)
              s[r][part * JT + jj] = dot4(qv, kv[jj], s[r][part * JT + jj]);"""
F32_PV = """              axpy4(p4.x, vv[0][hh], o[r][hh]);
              axpy4(p4.y, vv[1][hh], o[r][hh]);
              axpy4(p4.z, vv[2][hh], o[r][hh]);
              axpy4(p4.w, vv[3][hh], o[r][hh]);"""
F32_EXP = "            const float p = expf(s[r][j] - m_new);        // 0 for keys past T"
F32_KT = (("constexpr int F_KT = 128;", "constexpr int F_KT = 64;"),)
F32_Q32 = (("constexpr int F_BQ = 64;", "constexpr int F_BQ = 32;"),
           ("constexpr int F_MIN_BLOCKS = 1;", "constexpr int F_MIN_BLOCKS = 2;"))

# name -> (edits: (old, new) pairs or a function of the source, results are right)
VARIANTS = {
    "kernel": ((), True),
    "one_block": ((ONE_BLOCK, ("sizeof(bf16) + FA_BLOCK / 8;",
                               "sizeof(bf16) + FA_BLOCK / 8 + 120000;")), True),
    "eight_warps": ((("constexpr int FB_WARPS = 4;", "constexpr int FB_WARPS = 8;"),
                     ("FB_THREADS == FA_BLOCK", "FB_THREADS >= FA_BLOCK"),
                     ("    {\n      const int key = kb + tid;",
                      "    if (tid < FA_BLOCK) {\n      const int key = kb + tid;"),
                     ONE_BLOCK), True),
    "ring": ((ONE_BLOCK, ring), True),
    "no_kv_loads": (((NO_K_BIAS, LOAD_BIAS), (NO_V, "")), False),
    "no_bias_loads": (((NO_K_BIAS, LOAD_K),), False),
    "no_loads": (((NO_K_BIAS, ""), (NO_V, "")), False),
    "no_mma": (((S_MMA, "        s[2 * np][0] += __uint_as_float(kf[0] ^ qf[0]);"),
                (PV_MMA, "        o[2 * dq][0] += __uint_as_float(vf[0] ^ pa[0]);")), False),
    "fast_exp": (((EXP, EXP.replace("expf", "__expf")),), False),
    "f32_kernel": ((), True),
    "f32_kt64": (F32_KT, True),
    "f32_q32_kt64": (F32_KT + F32_Q32, True),
    "f32_fast_exp": (((F32_EXP, F32_EXP.replace("expf", "__expf")),), False),
    "f32_no_kv_loads": (((F32_ISSUE, "      issue(n + 1 < 2 ? n + 1 : 1 << 30);"),), False),
    "f32_no_syncs": (((F32_SYNC, ""),), False),
    "f32_no_bias_loads": (((F32_BIAS, F32_BIAS.replace(
        "__ldg(bd_bh + (size_t)t * bd_ld + key)", "1.f")),), False),
    "f32_no_products": (((F32_PV, ""), (F32_S, "")), False),
}


def variant_source(edits) -> str:
    src = (kb.CSRC_DIR / "flash_att.cu").read_text()
    for edit in edits:
        if callable(edit):
            src = edit(src)
            continue
        old, new = edit
        if src.count(old) != 1:
            raise ValueError(f"variant edit does not match csrc/flash_att.cu once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build_variants(names):
    out_dir = kb.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = out_dir / f"{name}.cu"
        cu.write_text(variant_source(VARIANTS[name][0]))
        cmd = [kb.nvcc_path(), *kb.NVCC_FLAGS, "-I", str(kb.CSRC_DIR), "-o",
               str(out_dir / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        for fn, argtypes in kb._SIGNATURES["flash_att"].items():
            getattr(lib, fn).argtypes = argtypes
        lib.port_error_string.argtypes = [ctypes.c_int]
        lib.port_error_string.restype = ctypes.c_char_p
        libs[name] = (lib, log)
    return libs


def bf16_variants(libs, timer, dev) -> None:
    info = (ctypes.c_int * 2)()
    for name, (lib, log) in libs.items():
        kb.check(lib, lib.flash_att_bf16_occupancy(128, ctypes.addressof(info)), name)
        regs = [r for r in cs.ptxas_kernels(log) if "bf16_kernelILi16ELi16" in r[0]][0]
        print(f"{name}: {regs[1]} registers, spills {regs[2]}/{regs[3]} B, {info[0]} B of "
              f"shared memory, {info[1]} blocks an SM")
    rng = np.random.default_rng(4321)
    b, t_len, h, dh = 8, 368, 8, 128
    lens = [355, 314, 268, 232, 188, 138, 95, 0]
    r = lambda *s: torch.as_tensor(rng.standard_normal(s).astype(np.float32),  # noqa: E731
                                   device=dev)
    q, k, v, qv = (r(b, t_len, h, dh).to(torch.bfloat16) for _ in range(4))
    pos = r(2 * t_len - 1, h, dh).to(torch.bfloat16)
    mask = torch.arange(t_len, device=dev)[None, :] < torch.as_tensor(lens, device=dev)[:, None]
    neg = float(torch.tensor(MASKED_BIAS, dtype=torch.bfloat16))
    out = torch.empty((b, t_len, h * dh), dtype=torch.float32, device=dev)
    for label, bd in (("contiguous", rel_pos_bias_shifted(qv, pos, tkv=t_len)),
                      ("strided", rel_pos_bias_shifted_plain(qv, pos, tkv=t_len))):
        want = flash_bias_attention_plain(q, k, v, bd, mask, qk=cs.tensor_core_qk(torch, q, k))
        qb, bb = copy_widths(q, k, v, bd)
        print(f"[{label} bias, copy widths {qb}/{bb} B] wrapper "
              f"{timer(lambda: flash_bias_attention(q, k, v, bd, mask)):.4f} ms")
        for name, (lib, _) in libs.items():
            def launch(lib=lib):
                kb.check(lib, lib.flash_att_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), bd.data_ptr(), bd.stride(1),
                    bd.stride(2), mask.data_ptr(), b, t_len, h, dh, 1, qb, bb,
                    1.0 / math.sqrt(dh), neg, out.data_ptr(), kb.stream_ptr(dev)), name)
            launch()
            err = float((out - want).abs().max())
            right = VARIANTS[name][1]
            assert err <= cs.FLASH_SAME_SUMS_ATOL or not right, \
                f"variant {name} disagrees with the plain version"
            print(f"[{label} bias] {name}: {timer(launch):.4f} ms, max |variant - plain| "
                  f"{err:.3g}{'' if right else ' (diagnostic)'}", flush=True)


def f32_variants(libs, timer, dev) -> None:
    """The f32 kernel's variants beside SDPA in f32 (TF32 off), on the bias
    as the f32 path passes it (the plain shift's strided view) and on
    contiguous rows."""
    info = (ctypes.c_int * 2)()
    for name, (lib, log) in libs.items():
        kb.check(lib, lib.flash_att_f32_occupancy(ctypes.addressof(info)), name)
        regs = [r for r in cs.ptxas_kernels(log) if "flash_att_f32_kernel" in r[0]][0]
        print(f"{name}: {regs[0][-40:]}: {regs[1]} registers, spills {regs[2]}/{regs[3]} B, "
              f"{info[0]} B of shared memory (the shipped tile), {info[1]} blocks an SM")
    rng = np.random.default_rng(4321)
    b, t_len, h, dh = 8, 368, 8, 128
    lens = [355, 314, 268, 232, 188, 138, 95, 0]
    r = lambda *s: torch.as_tensor(rng.standard_normal(s).astype(np.float32),  # noqa: E731
                                   device=dev)
    q, k, v, qv = (r(b, t_len, h, dh) for _ in range(4))
    pos = r(2 * t_len - 1, h, dh)
    mask = torch.arange(t_len, device=dev)[None, :] < torch.as_tensor(lens, device=dev)[:, None]
    out = torch.empty((b, t_len, h * dh), dtype=torch.float32, device=dev)
    big = r(4096, 4096)
    ms = timer(lambda: big @ big)
    print(f"[f32] calibration: cuBLAS f32 GEMM 4096^3 (TF32 off) {ms:.4f} ms, "
          f"{2 * 4096 ** 3 / ms / 1e9:.1f} TFLOP/s")
    strided = rel_pos_bias_shifted_plain(qv, pos, tkv=t_len)
    for label, bd in (("strided", strided), ("contiguous", strided.contiguous())):
        want = flash_bias_attention_plain(q, k, v, bd, mask)
        sdpa_mask = torch.where(mask[:, None, None, :], bd,
                                torch.full((), MASKED_BIAS, device=dev)) / math.sqrt(dh)
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        print(f"[f32, {label} bias] wrapper "
              f"{timer(lambda: flash_bias_attention(q, k, v, bd, mask)):.4f} ms, SDPA "
              f"{timer(lambda: sdpa(qh, kh, vh, attn_mask=sdpa_mask)):.4f} ms")
        for name, (lib, _) in libs.items():
            def launch(lib=lib):
                kb.check(lib, lib.flash_att_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), bd.data_ptr(), bd.stride(1),
                    bd.stride(2), mask.data_ptr(), b, t_len, h, dh, 0, 0, 0,
                    1.0 / math.sqrt(dh), MASKED_BIAS, out.data_ptr(), kb.stream_ptr(dev)), name)
            launch()
            err = float((out - want).abs().max())
            excess = float(((out - want).abs() - 1e-4 * want.abs()).max())
            right = VARIANTS[name][1]
            assert excess <= 2e-5 or not right, f"variant {name} disagrees with the plain version"
            print(f"[f32, {label} bias] {name}: {timer(launch):.4f} ms, max |variant - plain| "
                  f"{err:.3g}{'' if right else ' (diagnostic)'}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device", file=sys.stderr)
        return 1
    print(cs.smi_line())
    dev = torch.device("cuda")
    timer = cs.Timer(torch, dev)
    libs = build_variants(VARIANTS)
    bf16_variants({n: lib for n, lib in libs.items() if not n.startswith("f32_")}, timer, dev)
    f32_variants({n: lib for n, lib in libs.items() if n.startswith("f32_")}, timer, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
