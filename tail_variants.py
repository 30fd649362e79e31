"""Variants of the fused conv + FFN2 + out-LN kernel (``csrc/conv_ffn_ln.cu``,
one cooperative launch a layer), timed on the card at the main path's
full-width shapes (a steady chunk: Tq 8 with 6 valid steps, D 1024, E
4096, a 9-tap conv, int8 weights), to show where its time goes. Run from
the repository root on a machine with the card:

    python3 tail_variants.py

Each variant is the source with a few lines replaced (a replacement that
no longer matches the source raises), built by ``nvcc`` into
``trt_asr_tpu_torch/_build/variants/``, called through the wrapper
``conv_ffn_ln`` with the variant's library in place of the kernel's, and
timed with ``chip_smoke.py``'s timer (L2 scrubbed before every launch)
and with L2 left warm. ``kernel`` is the source as it is, held to the
plain version at ``chip_smoke.py``'s 1e-4, timed first and again last
(``kernel_again``). Variants that keep the results: ``products_twice``
(each product run twice: what a product costs run a second time),
``weight_pieces`` (the bulk copies of pw2, W1 and W2 in 4 KB pieces),
``flip_barrier`` (the grid barriers on a counter of the kernel's own,
release add and acquire polls). Diagnostic variants give wrong results
(their error is printed): ``no_products`` skips the four products (no
weight reads from shared memory, no widening, no mma),
``block_barriers`` turns each grid barrier into a block barrier,
``weights_only`` returns once every bulk copy of the prologue has landed
(x, norms, columns, the weight slices), ``empty`` returns at once (the
launch alone; ``empty_no_smem`` asks for no dynamic shared memory,
``empty_not_cooperative`` launches it as a plain kernel), ``no_convert``
feeds the mma the int8 bytes as they are (no widening to bf16) and
``no_mma`` replaces each mma with one addition (both in the runs of four
steps, which make up every full-width product). ``timeline`` is the kernel built with ``TAIL_TIMELINE``:
thread 0 of each block stores the global timer at each phase mark, read
after one more launch on a scrubbed L2 and after one on a warm L2, and
printed as the median and the latest block's time since the first block
began, in us.

    python3 tail_variants.py --against OTHER.cu [--pairs 10]

times the source against another version of it (built as variant
``against``) in alternating pairs, kernel first, on one card: each pair's
two medians (L2 scrubbed) and, at the end, the median of each side and of
the per-pair differences.

    python3 tail_variants.py --ffn [--f32 | --bf16 [--w2-late]] [--against OTHER.cu] [--pairs 10]

does the same for the persistent FFN (``csrc/ffn_q8.cu``; with ``--f32``
``csrc/ffn_f32.cu``, with ``--bf16`` ``csrc/ffn_bf16.cu``) at a steady
chunk's shapes (8 rows, D 1024, E 4096), held to its plain version at
``chip_smoke.py``'s tolerance (int8 1e-4, f32 2e-4, bf16 1e-3): the plain
version and the five launches of ``csrc/ffn.cu`` beside it, the kernel,
and its timeline (``att_variants.py``'s, a median over the blocks and the
last block); with ``--f32``, the kernel at each ring stage count of
``--stages`` too. ``--bf16 --w2-late`` times the source against itself
with W2's copy issued once phase (b) has read W1, the order a layout that
copies W2 into W1's room must take, in alternating pairs.

    python3 tail_variants.py --conv [--f32] [--against OTHER.cu] [--pairs 10]

does the same for the persistent conv module (``csrc/conv_block_q8.cu``;
with ``--f32`` ``csrc/conv_block_f32.cu``) at a steady chunk's shapes (Tq 8
with 6 valid steps, D 1024, a 9-tap conv): the plain version and the five
launches of ``csrc/conv_block.cu`` beside it, the kernel and its timeline.

The fused tail's variants edit ``csrc/conv_ffn_ln.cu`` with
``csrc/conv_tail.cuh`` and ``csrc/persistent.cuh`` inlined where they are
included.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs
from trt_asr_tpu_torch.ops.kernels import build as kb
from trt_asr_tpu_torch.ops.kernels.conv_block import (conv_ffn_ln, conv_ffn_ln_plain,
                                                      pack_conv_ffn_ln)
from trt_asr_tpu_torch.ops.quant import quantize_tensor

PRODUCT_LOOP = "  for (int g0 = 0; g0 < G; g0 += 2) {"
STAGED = "    TL_MARK(3);\n"
ENTRY = "  TL_MARK(0);\n"
TIMELINE_READ = """
extern "C" int conv_ffn_ln_timeline(unsigned long long* out, int blocks) {
  return (int)cudaMemcpyFromSymbol(out, tail_timeline,
                                   sizeof(unsigned long long) * blocks * TL_MARKS);
}
"""
MARKS = ("entry", "bulk copies issued", "x, norms, columns in", "LN_conv, pw1 in", "pw1 product",
         "GLU, conv (barrier 1)", "after barrier 1", "a staged, pw2 in",
         "pw2 + residual (barrier 2)", "after barrier 2", "y1 staged, LN_ff",
         "W1 + SiLU (barrier 3)", "after barrier 3", "h staged", "W2 + residual (barrier 4)",
         "after barrier 4", "LN_out", "pw1: mma loop", "pw1: block synced", "pw2: mma loop",
         "pw2: block synced", "W1: mma loop", "W1: block synced", "W2: mma loop",
         "W2: block synced")


def timeline(src: str) -> str:
    return "#define TAIL_TIMELINE\n" + src + TIMELINE_READ


def block_barriers(src: str) -> str:
    """Every grid barrier a block barrier (wrong results: the barriers' cost)."""
    return src.replace("  grid.sync();", "  __syncthreads();")


FLIP = """__device__ unsigned int tail_grid_bar;
__device__ __forceinline__ unsigned int flip_arrive() {
  __syncthreads();
  unsigned int old = 0;
  if (threadIdx.x == 0) {
    const unsigned int add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    asm volatile("atom.add.release.gpu.global.u32 %0, [%1], %2;"
                 : "=r"(old) : "l"(&tail_grid_bar), "r"(add) : "memory");
  }
  return old;
}
__device__ __forceinline__ void flip_wait(unsigned int old) {
  if (threadIdx.x == 0) {
    unsigned int now;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(now) : "l"(&tail_grid_bar)
                   : "memory");
    } while (((now ^ old) & 0x80000000u) == 0);
  }
  __syncthreads();
}

"""
KERNEL = "template <typename WT, bool FFN>\n__device__ __forceinline__ void conv_tail("


def flip_barrier(src: str) -> str:
    """The grid barriers on one never-reset counter whose top bit flips once
    every block has arrived (cooperative_groups' scheme), with a release
    add and acquire polls in place of its fences."""
    return src.replace(KERNEL, FLIP + KERNEL).replace("grid.sync()", "flip_wait(flip_arrive())")


def product_twice(src: str) -> str:
    """Every block_product call made twice in a row (the same sums)."""
    out = []
    for line in src.splitlines(keepends=True):
        out.append(line)
        if line.strip().startswith("block_product(act,"):
            out.append(line)
    return "".join(out)


# name -> (edits: (old, new, count) or a function of the source, right);
# the source as it is is timed first and again last (``kernel_again``)
VARIANTS = {
    "kernel": ((), True),
    "no_products": (((PRODUCT_LOOP, PRODUCT_LOOP.replace("g0 = 0", "g0 = G"), 1),), False),
    "block_barriers": ((block_barriers,), False),
    "weights_only": (((STAGED, STAGED + "    for (int i = BAR_PW2; i <= BAR_NORMS; ++i) "
                                "mbar_wait(bars + i);\n    return;\n", 1),), False),
    "empty": (((ENTRY, ENTRY + "  if (p.M > 0) return;\n", 1),), False),
    "no_convert": ((("        i8x4_to_bf16(wv[u][g], b0, b1);",
                     "        b0 = wv[u][g];\n        b1 = b0 ^ 1u;", 1),), False),
    "no_mma": ((("        mma_bf16(acc[u & 1][g], a, b0, b1);",
                 "        acc[u & 1][g][0] += __uint_as_float(a[0] ^ b0 ^ b1);", 1),), False),
    "empty_no_smem": (((ENTRY, ENTRY + "  if (p.M > 0) return;\n", 1),
                       ("args, (size_t)smem,", "args, (size_t)0,", 1)), False),
    "empty_not_cooperative": (((ENTRY, ENTRY + "  if (p.M > 0) return;\n", 1),
                               ("cudaLaunchCooperativeKernel(", "cudaLaunchKernel(", 1)), False),
    "products_twice": ((product_twice,), True),
    "weight_pieces": ((("        bulk_copy(smem + L.w + wo[i], mine + wo[i], (uint32_t)(wo[i + 1] - wo[i]),\n                  bars + BAR_PW2 + i);",
                        "        for (size_t o = wo[i]; o < wo[i + 1]; o += 4096)\n          bulk_copy(smem + L.w + o, mine + o, (uint32_t)min((size_t)4096, wo[i + 1] - o),\n                    bars + BAR_PW2 + i);", 1),), True),
    "flip_barrier": ((flip_barrier,), True),
    "timeline": ((timeline,), True),
    "kernel_again": ((), True),
}


def variant_source(edits, path=None) -> str:
    """The source with ``csrc/conv_tail.cuh`` (the kernel's body) and
    ``csrc/persistent.cuh`` (its products, copies and timeline) inlined
    where they are included, then each edit applied."""
    src = (path or kb.CSRC_DIR / "conv_ffn_ln.cu").read_text()
    for header in ("conv_tail.cuh", "persistent.cuh"):
        src = src.replace(f'#include "{header}"\n',
                          (kb.CSRC_DIR / header).read_text().replace("#pragma once\n", ""), 1)
    for edit in edits:
        if callable(edit):
            src = edit(src)
            continue
        old, new, count = edit
        if src.count(old) != count:
            raise ValueError(f"variant edit does not match csrc/conv_ffn_ln.cu {count}x: "
                             f"{old[:60]!r}")
        src = src.replace(old, new)
    return src


def build_variants(names, sources=None):
    """Builds each named variant, or the given {name: source text}."""
    out_dir = kb.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = sources or {name: variant_source(VARIANTS[name][0]) for name in names}
    procs = {}
    for name, text in sources.items():
        cu = out_dir / f"tail_{name}.cu"
        cu.write_text(text)
        cmd = [kb.nvcc_path(), *kb.NVCC_FLAGS, "-I", str(kb.CSRC_DIR), "-o",
               str(out_dir / f"tail_{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"tail_{name}.so"))
        sigs = dict(kb._SIGNATURES["conv_ffn_ln"])
        if name == "timeline":
            sigs["conv_ffn_ln_timeline"] = [ctypes.c_void_p, ctypes.c_int]
        for fn, argtypes in sigs.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.port_error_string.argtypes = [ctypes.c_int]
        lib.port_error_string.restype = ctypes.c_char_p
        libs[name] = (lib, log)
    return libs


def tail_inputs(dev, seed: int = 1234, tq: int = 8, valid: int = 6, d: int = 1024,
                e: int = 4096, kk: int = 9):
    rng = np.random.default_rng(seed)
    t = lambda *s, sc=1.0: torch.as_tensor(  # noqa: E731
        (rng.standard_normal(s) * sc).astype(np.float32), device=dev)
    norm = lambda: (1.0 + t(d, sc=0.1), t(d, sc=0.1))  # noqa: E731
    mask = (torch.arange(tq, device=dev) < valid).float()[:, None]
    return (t(tq, d), *norm(), quantize_tensor(t(d, 2 * d, sc=1 / math.sqrt(d))),
            t(kk, d, sc=1 / math.sqrt(kk)), 1.0 + t(d, sc=0.1), t(d, sc=0.1), t(d, sc=0.1),
            1.0 + t(d, sc=0.1).abs(), quantize_tensor(t(d, d, sc=1 / math.sqrt(d))),
            t((kk - 1) // 2, d), mask, *norm(), quantize_tensor(t(d, e, sc=1 / math.sqrt(d))),
            quantize_tensor(t(e, d, sc=1 / math.sqrt(e))), *norm())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", help="another version of csrc/conv_ffn_ln.cu to time "
                                      "against the source in alternating pairs")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--ffn", action="store_true", help="the int8 FFN, csrc/ffn_q8.cu")
    ap.add_argument("--conv", action="store_true", help="the int8 conv module, "
                                                      "csrc/conv_block_q8.cu")
    ap.add_argument("--f32", action="store_true", help="with --ffn: csrc/ffn_f32.cu; with "
                                                     "--conv: csrc/conv_block_f32.cu")
    ap.add_argument("--bf16", action="store_true", help="with --ffn: csrc/ffn_bf16.cu")
    ap.add_argument("--w2-late", action="store_true",
                    help="with --ffn --bf16: against the source with W2's copy issued once "
                         "W1's product is done")
    ap.add_argument("--stages", default="8,16,22", help="--ffn --f32: ring stage counts to time")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("tail_variants: no CUDA device", file=sys.stderr)
        return 1
    print(cs.smi_line())
    dev = torch.device("cuda")
    timer = cs.Timer(torch, dev)
    if opts.conv:
        return conv_variants(timer, dev, opts.f32, opts.against, opts.pairs)
    if opts.ffn:
        kind = "f32" if opts.f32 else "bf16" if opts.bf16 else "int8"
        return ffn_variants(timer, dev, kind, opts.against, opts.pairs,
                            [int(v) for v in opts.stages.split(",")], opts.w2_late)
    if opts.against:
        return compare(timer, dev, opts.against, opts.pairs)
    warm = cs.Timer(torch, dev)
    warm.scrub = torch.empty(16, dtype=torch.uint8, device=dev)    # L2 left as it is
    libs = build_variants(VARIANTS)
    args = tail_inputs(dev)
    packed = pack_conv_ffn_ln(*args[3:10], *args[14:16])       # as the model packs them

    def run():
        return conv_ffn_ln(*args, packed=packed)

    want = conv_ffn_ln_plain(*args)
    print(f"plain version {timer(lambda: conv_ffn_ln_plain(*args)):.4f} ms")
    info = (ctypes.c_int * 1)()
    for name, (lib, log) in libs.items():
        regs = [r for r in cs.ptxas_kernels(log) if "conv_ffn_ln_kernel" in r[0]][0]
        kb._libs["conv_ffn_ln"] = lib            # the wrapper launches the variant
        got = run()
        torch.cuda.synchronize()
        err = cs.max_err(got, want)
        right = VARIANTS[name][1]
        assert err <= 1e-4 or not right, f"variant {name} disagrees with the plain version"
        ms = timer(run)
        host_us = timer.host_us
        warm_ms = warm(run)
        kb.check(lib, lib.conv_ffn_ln_occupancy(_plan(args).smem, ctypes.addressof(info)), name)
        print(f"{name}: {ms:.4f} ms, L2 warm {warm_ms:.4f} ms (host enqueue {host_us:.1f} "
              f"us/call), max |variant - plain| "
              f"{err:.3g}{'' if right else ' (diagnostic)'}; {regs[1]} registers, spills "
              f"{regs[2]}/{regs[3]} B, {info[0]} blocks an SM", flush=True)
        if name == "timeline":
            print_timeline(lib, timer, args, run)
    kb._libs.pop("conv_ffn_ln")
    return 0


def compare(timer, dev, path: str, pairs: int) -> int:
    """The source and ``path`` timed in alternating pairs, each held to the
    plain version at 1e-4 first."""
    import pathlib

    libs = build_variants(("kernel", "against"), {
        "kernel": variant_source(()), "against": variant_source((), pathlib.Path(path))})
    args = tail_inputs(dev)
    packed = pack_conv_ffn_ln(*args[3:10], *args[14:16])
    want = conv_ffn_ln_plain(*args)
    run = lambda: conv_ffn_ln(*args, packed=packed)  # noqa: E731
    for name, (lib, _) in libs.items():
        kb._libs["conv_ffn_ln"] = lib
        err = cs.max_err(run(), want)
        assert err <= 1e-4, f"{name} disagrees with the plain version ({err:.3g})"
    ms = {name: [] for name in libs}
    for i in range(pairs):
        for name, (lib, _) in libs.items():
            kb._libs["conv_ffn_ln"] = lib
            ms[name].append(timer(run))
        print(f"pair {i}: kernel {ms['kernel'][-1]:.4f} ms, against {ms['against'][-1]:.4f} ms",
              flush=True)
    kb._libs.pop("conv_ffn_ln")
    diff = np.subtract(ms["against"], ms["kernel"])
    print(f"median of {pairs} pairs: kernel {np.median(ms['kernel']):.4f} ms, against "
          f"{np.median(ms['against']):.4f} ms; against - kernel: median {np.median(diff):.4f} "
          f"ms, range {diff.min():.4f} .. {diff.max():.4f} ms")
    return 0


def print_timeline(lib, timer, args, run) -> None:
    """The marks of one launch on a scrubbed L2 (cold: weights and the
    kernel's code come from device memory) and of the launch right after
    it (warm: both in L2), side by side."""
    blocks, rows = _plan(args).blocks, args[0].shape[0]
    times = []
    timer.scrub.zero_()
    for _ in range(2):
        marks = np.zeros((blocks, len(MARKS)), dtype=np.uint64)
        run()
        torch.cuda.synchronize()
        kb.check(lib, lib.conv_ffn_ln_timeline(marks.ctypes.data, blocks), "timeline")
        ns = marks.astype(np.int64)
        times.append((ns - int(ns[:, 0].min())) / 1e3)
    print("  timeline (us since the first block began: median, latest block), cold | warm")
    for i, name in enumerate(MARKS):
        cols = [t[:rows, i] if i == 16 else t[:, i] for t in times]   # LN_out: a row a block
        print(f"  {i:2d} {name:28s} " + " | ".join(
            f"{np.median(c):7.3f} {c.max():7.3f}" for c in cols))


# the FFN kernels' TL_MARKs, in order: what has happened by then
MARKS_FFN_F32 = {0: "entry", 1: "copies issued", 2: "x, norms in", 3: "LN",
                 17: "W1 sums (warp 0's)", 4: "W1 block synced", 5: "h", 6: "W2 partial (warp 0's)",
                 7: "after the barrier", 8: "end"}
MARKS_FFN_Q8 = {0: "entry", 1: "copies issued", 2: "x, norms in", 3: "LN, W1 in",
                17: "W1 mma loop", 18: "W1 block synced", 4: "h written", 5: "after the barrier",
                6: "h's copies issued, W2 in", 19: "W2 mma loop", 20: "W2 block synced",
                7: "end"}


def w2_after_w1(src: str) -> str:
    """csrc/ffn_bf16.cu with W2's bulk copy issued once phase (b)'s product
    has read W1 (after its block barrier) rather than once W1 has landed:
    the copy order of a layout that puts W2 in W1's room."""
    issue = (
        "    if (threadIdx.x == 0 && pass == 0) {\n"
        "      mbar_expect(bars + FB_W2, (uint32_t)((B.total - B.w2) * 2));\n"
        "      bulk_copy_hint(smem + L.w + B.w2 * 2, mine + B.w2, (uint32_t)((B.total - B.w2) * 2),\n"
        "                     bars + FB_W2, evict_first());\n"
        "    }\n")
    product = "    block_product(act, pd, w1, Dp, ge, red, nullptr, 0, 17);\n"
    if src.count(issue) != 1 or src.count(product) != 1:
        raise ValueError("w2_after_w1 does not match csrc/ffn_bf16.cu")
    return src.replace(issue, "").replace(product, product + issue)


def ffn_variants(timer, dev, kind: str, against, pairs: int, stage_counts,
                 w2_late: bool = False) -> int:
    """The int8, f32 or bf16 FFN beside its plain version and the five
    launches it replaced, and its timeline; or against another version of
    its source (bf16 with ``w2_late``: :func:`w2_after_w1`)."""
    import pathlib

    import att_variants as av
    from trt_asr_tpu_torch.ops.kernels import ffn as kf

    rng = np.random.default_rng(1234)
    t = lambda *s, sc=1.0: torch.as_tensor(  # noqa: E731
        (rng.standard_normal(s) * sc).astype(np.float32), device=dev)
    d, e = 1024, 4096
    f32 = kind == "f32"
    weight = {"f32": lambda w: w, "bf16": lambda w: w.to(torch.bfloat16),
              "int8": quantize_tensor}[kind]
    args = (t(8, d), 1.0 + t(d, sc=0.1), t(d, sc=0.1), weight(t(d, e, sc=d ** -0.5)),
            weight(t(e, d, sc=e ** -0.5)))
    name, tol = {"f32": ("ffn_f32", 2e-4), "int8": ("ffn_q8", 1e-4),
                 "bf16": ("ffn_bf16", 1e-3)}[kind]
    packed = kf.pack_ffn(*args[3:])                                 # as the model packs them
    run = lambda: kf.fused_ffn(*args, packed=packed)  # noqa: E731
    want = kf.fused_ffn_plain(*args)
    src = (kb.CSRC_DIR / f"{name}.cu").read_text()
    if w2_late and kind != "bf16":
        raise ValueError("--w2-late takes the bf16 FFN (--bf16)")
    other = w2_after_w1(src) if w2_late else pathlib.Path(against).read_text() if against else None
    if other is not None:
        return av.compare(timer, run, (want,), src, other, pairs, name, tol, out=lambda r: (r,))
    warm = cs.Timer(torch, dev)
    warm.scrub = torch.empty(16, dtype=torch.uint8, device=dev)      # L2 left as it is
    libs = av.build({"kernel": src,
                     "timeline": "#define TAIL_TIMELINE\n" + src + av.TIMELINE_READ}, name)
    chain = lambda: kf.fused_ffn_chain(*args)  # noqa: E731
    print(f"plain version {timer(lambda: kf.fused_ffn_plain(*args)):.4f} ms")
    print(f"five launches (csrc/ffn.cu): {timer(chain):.4f} ms, L2 warm {warm(chain):.4f} ms, "
          f"max |chain - plain| {cs.max_err((chain(),), (want,)):.3g}")
    plan = kf.ffn_f32_plan
    default = plan(d, e, torch.cuda.get_device_properties(0).multi_processor_count).stages
    for variant, (lib, log) in libs.items():
        regs = [r for r in cs.ptxas_kernels(log) if f"{name}_kernel" in r[0]][0]
        kb._libs[name] = lib                     # the wrapper launches the variant
        for stages in stage_counts if f32 and variant == "kernel" else [default]:
            kf.ffn_f32_plan = lambda *a, _s=stages, **k: plan(*a, stages=_s, **k)
            try:
                err = cs.max_err((run(),), (want,))
                assert err <= tol, f"variant {variant} disagrees with the plain version ({err:.3g})"
                ring = f", {stages} stages" + (" (the plan's default)" if stages == default
                                               else "") if f32 else ""
                print(f"{variant}{ring}: {timer(run):.4f} ms, L2 warm {warm(run):.4f} ms, max "
                      f"|variant - plain| {err:.3g}; {regs[1]} registers, spills "
                      f"{regs[2]}/{regs[3]} B", flush=True)
            finally:
                kf.ffn_f32_plan = plan
    av.print_timeline(libs["timeline"][0], timer, run, packed.shape[0],
                      MARKS_FFN_F32 if f32 else MARKS_FFN_Q8)
    kb._libs.pop(name)
    return 0


# the conv modules' TL_MARKs, in order: what has happened by then
MARKS_CONV_F32 = {0: "entry", 1: "copies issued", 2: "x, norms, taps in", 3: "LN",
                  17: "pw1 sums (warp 0's)", 4: "pw1 block synced", 5: "GLU, conv, a written",
                  6: "after the barrier", 19: "pw2 sums (warp 0's)", 7: "pw2 block synced",
                  8: "end"}
MARKS_CONV_Q8 = {0: "entry", 1: "copies issued", 2: "x, norms, columns in", 3: "LN, pw1 in",
                 17: "pw1 mma loop", 18: "pw1 block synced", 4: "pw1 product",
                 5: "GLU, conv, a written", 6: "after the barrier", 7: "a's copies issued, pw2 in",
                 19: "pw2 mma loop", 20: "pw2 block synced", 8: "end"}


def conv_variants(timer, dev, f32: bool, against, pairs: int) -> int:
    """The int8 (or f32) conv module beside its plain version and the five
    launches it replaced, and its timeline; or against another version of
    its source."""
    import pathlib

    import att_variants as av
    from trt_asr_tpu_torch.ops.kernels import conv_block as cb

    rng = np.random.default_rng(1234)
    t = lambda *s, sc=1.0: torch.as_tensor(  # noqa: E731
        (rng.standard_normal(s) * sc).astype(np.float32), device=dev)
    d, kk, tq = 1024, 9, 8
    weight = (lambda w: w) if f32 else quantize_tensor
    args = (t(tq, d), 1.0 + t(d, sc=0.1), t(d, sc=0.1), weight(t(d, 2 * d, sc=d ** -0.5)),
            t(kk, d, sc=kk ** -0.5), 1.0 + t(d, sc=0.1), t(d, sc=0.1), t(d, sc=0.1),
            1.0 + t(d, sc=0.1).abs(), weight(t(d, d, sc=d ** -0.5)), t((kk - 1) // 2, d),
            (torch.arange(tq, device=dev) < 6).float()[:, None])
    name, tol = ("conv_block_f32", 2e-4) if f32 else ("conv_block_q8", 1e-4)
    packed = cb.pack_conv_block(*args[3:10])                       # as the model packs them
    run = lambda: cb.conv_block(*args, packed=packed)  # noqa: E731
    want = cb.conv_block_plain(*args)
    src = (kb.CSRC_DIR / f"{name}.cu").read_text()
    if against:
        return av.compare(timer, run, want, src, pathlib.Path(against).read_text(), pairs,
                          name, tol)
    warm = cs.Timer(torch, dev)
    warm.scrub = torch.empty(16, dtype=torch.uint8, device=dev)      # L2 left as it is
    libs = av.build({"kernel": src,
                     "timeline": "#define TAIL_TIMELINE\n" + src + av.TIMELINE_READ}, name)
    chain = lambda: cb.conv_block_chain(*args)  # noqa: E731
    print(f"plain version {timer(lambda: cb.conv_block_plain(*args)):.4f} ms")
    print(f"five launches (csrc/conv_block.cu): {timer(chain):.4f} ms, L2 warm "
          f"{warm(chain):.4f} ms, max |chain - plain| {cs.max_err(chain(), want):.3g}")
    for variant, (lib, log) in libs.items():
        regs = [r for r in cs.ptxas_kernels(log) if f"{name}_kernel" in r[0]][0]
        kb._libs[name] = lib                     # the wrapper launches the variant
        err = cs.max_err(run(), want)
        assert err <= tol, f"variant {variant} disagrees with the plain version ({err:.3g})"
        print(f"{variant}: {timer(run):.4f} ms, L2 warm {warm(run):.4f} ms, max |variant - "
              f"plain| {err:.3g}; {regs[1]} registers, spills {regs[2]}/{regs[3]} B", flush=True)
    av.print_timeline(libs["timeline"][0], timer, run, packed.shape[0],
                      MARKS_CONV_F32 if f32 else MARKS_CONV_Q8)
    kb._libs.pop(name)
    return 0


def _plan(args):
    from trt_asr_tpu_torch.ops.kernels.conv_block import conv_ffn_ln_plan

    x, dw, w1 = args[0], args[4], args[14]
    return conv_ffn_ln_plan(x.shape[0], x.shape[1], w1.q.shape[1], dw.shape[0],
                            torch.cuda.get_device_properties(0).multi_processor_count)


if __name__ == "__main__":
    sys.exit(main())
