"""The int8 attention-block kernel (``csrc/att_block_q8.cu``, one cooperative
launch a layer) timed on the card at the main path's full-width shapes (a
steady chunk: Tq 8 with 6 valid steps, D 1024, H 8, a full ring of C 256,
int8 weights), beside the int8 chain of ``csrc/att_block.cu`` that it
replaced (called through its C interface), to show where its time goes. Run
from the repository root on a machine with the card:

    python3 att_variants.py

Each version is held to the plain version at ``chip_smoke.py``'s 1e-4 and
timed with ``chip_smoke.py``'s timer, L2 scrubbed before every launch
(cold) and left warm. ``kernel`` is the source as it is; ``timeline`` is it
built with ``TAIL_TIMELINE``: thread 0 of each block stores the global
timer at each phase mark, read after one launch on a scrubbed L2 and after
one on a warm L2, and printed as the median over the blocks of the time
since the first block began, in us.

    python3 att_variants.py --against OTHER.cu [--pairs 10]

times the source against another version of it in alternating pairs,
kernel first: each pair's two medians (L2 scrubbed) and the median of each
side and of the per-pair differences.

    python3 att_variants.py --orders

finds the summation orders that the kernel copies: it emulates candidate
orders of the plain version's three f32 products (Q = bf16(u) @ Wq, the
scores' dot (q + u_bias) . k, the context p @ v) on the host, FMA by FMA,
and prints how many of the card's results (cuBLAS) each misses; the kernel
sums in the order that misses none. It does the same for the int8 joint
step's hidden product (bf16(g) @ W_pred, ``csrc/joint_step_q8.cu``) at each
rows count of the card tests and the main path, at the card-test, gate_r3
and full widths.

    python3 att_variants.py --joint [--f32] [--against OTHER.cu]

does the same for the int8 joint step (``csrc/joint_step_q8.cu``; with
``--f32`` the f32 one, ``csrc/joint_step_f32.cu``) at the main path's
shapes (8 rows, P = J = 640, V 8198), held to its plain version at
``chip_smoke.py``'s 1e-4 (logits) with equal tokens and durations: the
three launches of ``csrc/joint_step.cu`` beside it, and the timeline.

    python3 att_variants.py --f32 [--stages 4,8,12,16,22] [--against OTHER.cu]

does the same for the f32 kernel (``csrc/att_block_f32.cu``) at the same
shapes with f32 weights, held to the plain version at ``chip_smoke.py``'s
2e-4: the f32 chain of ``csrc/att_block.cu`` beside it, the kernel with its
weights' ring at each stage count (the plan's default marked), and the
timeline at the default; with ``--against``, the source against another
version of it in alternating pairs, as above. On the f32 kernel the pairs
favour the other version: the source against an identical copy of itself
read 1.1 us slower (twice, on the H100), so time each version in both
roles (as the source, with the other one against it, and the other way).
"""

from __future__ import annotations

import argparse
import ctypes
import math
import pathlib
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs
from trt_asr_tpu_torch.ops.kernels import build as kb
from trt_asr_tpu_torch.ops.kernels.att_block import att_block, att_block_plain, pack_att_block
from trt_asr_tpu_torch.ops.quant import quantize_tensor

TIMELINE_READ = """
extern "C" int att_timeline(unsigned long long* out, int blocks) {
  return (int)cudaMemcpyFromSymbol(out, tail_timeline,
                                   sizeof(unsigned long long) * blocks * TL_MARKS);
}
"""
# mark -> what has happened by then (the kernels' TL_MARKs, in order)
MARKS_F32 = {0: "entry", 1: "copies issued", 2: "x, norms in", 14: "LN", 17: "Q/K/V sums",
             4: "q, k_new, v_new written", 5: "after barrier 1", 6: "q, keys staged",
             7: "scores written", 8: "after barrier 2", 9: "softmax", 10: "ctx written",
             11: "after barrier 3", 12: "ctx staged", 19: "Wo sums", 13: "end"}
MARKS_JOINT = {0: "entry", 1: "copies issued", 2: "W_pred in", 12: "g in", 13: "g rounded",
               3: "h sums",
               4: "h written", 5: "after the barrier", 6: "W_out in", 7: "h staged",
               19: "logits mma loop", 20: "logits block synced", 8: "logits written",
               9: "pairs written", 10: "ticket taken", 11: "end"}
MARKS_JOINT_F32 = {0: "entry", 1: "copies issued", 2: "W_pred in", 12: "g in", 3: "h sums",
                   4: "h written", 5: "after the barrier", 7: "h range staged (warp 0's)",
                   6: "W_out in", 19: "logits sums (warp 0's)", 20: "logits block synced",
                   8: "logits and pairs written", 9: "pass done", 10: "ticket taken",
                   11: "end"}
MARKS = {0: "entry", 1: "copies issued", 2: "x, norms in", 14: "LN", 3: "Q/K/V weights in",
         17: "Q/K/V sums", 4: "q, k_new, v_new written", 5: "after barrier 1",
         6: "q, keys staged", 7: "scores written", 8: "after barrier 2", 9: "softmax",
         10: "ctx written", 11: "after barrier 3", 12: "ctx staged", 19: "Wo mma loop",
         20: "Wo block synced", 13: "end"}


def att_inputs(dev, seed: int = 1234, tq: int = 8, valid: int = 6, d: int = 1024, h: int = 8,
               c: int = 256, int8: bool = True):
    """chip_smoke.py phase 2's inputs: the same draws in the same order."""
    rng = np.random.default_rng(seed)
    t = lambda *s, sc=1.0: torch.as_tensor(  # noqa: E731
        (rng.standard_normal(s) * sc).astype(np.float32), device=dev)
    x, ln_g, ln_b = t(tq, d), 1.0 + t(d, sc=0.1), t(d, sc=0.1)
    ws = [t(d, d, sc=1 / math.sqrt(d)) for _ in range(4)]
    ws = [quantize_tensor(w) for w in ws] if int8 else ws
    bu, bv = t(h, d // h, sc=0.3), t(h, d // h, sc=0.3)
    pos, kv = t(2 * tq + c - 1, d), t(c, 2 * d)
    meta = torch.tensor([100, c, valid], dtype=torch.int32, device=dev)
    return (x, ln_g, ln_b, *ws, bu, bv, pos, kv, meta), h


def build(sources: dict, lib_name: str = "att_block_q8") -> dict:
    """{name: source text} -> {name: (loaded library, nvcc log)}, built in
    parallel into trt_asr_tpu_torch/_build/variants/ with the bindings of
    csrc/<lib_name>.cu."""
    out = kb.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        (out / f"att_{name}.cu").write_text(text)
        cmd = [kb.nvcc_path(), *kb.NVCC_FLAGS, "-I", str(kb.CSRC_DIR), "-o",
               str(out / f"att_{name}.so"), str(out / f"att_{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lib = ctypes.CDLL(str(out / f"att_{name}.so"))
        sigs = dict(kb._SIGNATURES[lib_name])
        if name == "timeline":
            sigs["att_timeline"] = [ctypes.c_void_p, ctypes.c_int]
        for fn, argtypes in sigs.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.port_error_string.argtypes = [ctypes.c_int]
        lib.port_error_string.restype = ctypes.c_char_p
        libs[name] = (lib, log)
    return libs


def chain_call(args, h):
    """The int8 chain of csrc/att_block.cu (LN, split-K Q/K/V, the attention
    core, split-K Wo: six launches), called through its C interface."""
    x, ln_g, ln_b, *ws = args[:7]
    bu, bv, pos, kv, meta = args[7:]
    tq, d = x.shape
    lib = kb.load("att_block")
    y, u, q, kn, vn, ctx = (torch.empty_like(x) for _ in range(6))
    ks = kb.gemm_splits(d)
    part = torch.empty((3, ks, tq, d), dtype=torch.float32, device=x.device)
    rc = lib.att_block_launch(
        x.data_ptr(), tq, d, h, ln_g.data_ptr(), ln_b.data_ptr(), *[w.q.data_ptr() for w in ws],
        *[w.s.data_ptr() for w in ws], 2, bu.data_ptr(), bv.data_ptr(), pos.data_ptr(),
        kv.data_ptr(), kv.shape[0], meta.data_ptr(), 1 / math.sqrt(d // h), ks, y.data_ptr(),
        u.data_ptr(), q.data_ptr(), kn.data_ptr(), vn.data_ptr(), ctx.data_ptr(),
        part.data_ptr(), kb.stream_ptr(x.device))
    kb.check(lib, rc, "att_block chain")
    return y, u, kn, vn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", help="another version of csrc/att_block_q8.cu to time "
                                      "against the source in alternating pairs")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--orders", action="store_true",
                    help="emulate candidate summation orders of the plain version's products")
    ap.add_argument("--f32", action="store_true", help="the f32 kernel, csrc/att_block_f32.cu "
                                                       "(with --joint: csrc/joint_step_f32.cu)")
    ap.add_argument("--joint", action="store_true",
                    help="the int8 joint step, csrc/joint_step_q8.cu")
    ap.add_argument("--stages", default="4,8,12,16,22",
                    help="--f32: ring stage counts to time")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("att_variants: no CUDA device", file=sys.stderr)
        return 1
    print(cs.smi_line())
    dev = torch.device("cuda")
    timer = cs.Timer(torch, dev)
    warm = cs.Timer(torch, dev)
    warm.scrub = torch.empty(16, dtype=torch.uint8, device=dev)      # L2 left as it is
    if opts.joint:
        return joint_variants(timer, warm, opts.against, opts.pairs, opts.f32)
    if opts.f32:
        return f32_variants(timer, warm, [int(v) for v in opts.stages.split(",")],
                            opts.against, opts.pairs)
    args, h = att_inputs(dev)
    packed = pack_att_block(*args[3:7])                              # as the model packs them
    run = lambda: att_block(*args, n_heads=h, packed=packed)  # noqa: E731
    want = att_block_plain(*args, n_heads=h)
    if opts.orders:
        return orders(args, h) or joint_orders(dev)
    src = (kb.CSRC_DIR / "att_block_q8.cu").read_text()
    if opts.against:
        return compare(timer, run, want, src, pathlib.Path(opts.against).read_text(),
                       opts.pairs)
    libs = build({"kernel": src, "timeline": "#define TAIL_TIMELINE\n" + src + TIMELINE_READ})
    print(f"plain version {timer(lambda: att_block_plain(*args, n_heads=h)):.4f} ms")
    err = cs.max_err(chain_call(args, h), want)
    print(f"chain (csrc/att_block.cu, int8): {timer(lambda: chain_call(args, h)):.4f} ms, "
          f"L2 warm {warm(lambda: chain_call(args, h)):.4f} ms, max |chain - plain| {err:.3g}")
    for name, (lib, log) in libs.items():
        regs = [r for r in cs.ptxas_kernels(log) if "att_block_q8_kernel" in r[0]][0]
        kb._libs["att_block_q8"] = lib           # the wrapper launches the variant
        err = cs.max_err(run(), want)
        assert err <= 1e-4, f"variant {name} disagrees with the plain version ({err:.3g})"
        print(f"{name}: {timer(run):.4f} ms, L2 warm {warm(run):.4f} ms, max |variant - plain| "
              f"{err:.3g}; {regs[1]} registers, spills {regs[2]}/{regs[3]} B", flush=True)
    print_timeline(libs["timeline"][0], timer, run, packed.shape[0])
    kb._libs.pop("att_block_q8")
    return 0


def f32_variants(timer, warm, stage_counts, against, pairs) -> int:
    """The f32 kernel beside the f32 chain and at each ring stage count, or
    against another version of its source."""
    from trt_asr_tpu_torch.ops.kernels import att_block as ab

    args, h = att_inputs(torch.device("cuda"), int8=False)
    packed = pack_att_block(*args[3:7])                              # as the model packs them
    run = lambda: att_block(*args, n_heads=h, packed=packed)  # noqa: E731
    chain = lambda: ab.att_block_chain(*args, n_heads=h)  # noqa: E731
    want = att_block_plain(*args, n_heads=h)
    src = (kb.CSRC_DIR / "att_block_f32.cu").read_text()
    if against:
        return compare(timer, run, want, src, pathlib.Path(against).read_text(), pairs,
                       "att_block_f32", 2e-4)
    libs = build({"kernel": src, "timeline": "#define TAIL_TIMELINE\n" + src + TIMELINE_READ},
                 "att_block_f32")
    print(f"plain version {timer(lambda: att_block_plain(*args, n_heads=h)):.4f} ms")
    print(f"chain (csrc/att_block.cu, f32): {timer(chain):.4f} ms, L2 warm {warm(chain):.4f} ms, "
          f"max |chain - plain| {cs.max_err(chain(), want):.3g}")
    plan = ab.att_block_f32_plan
    tq, d = args[0].shape
    default = plan(tq, d, h, args[10].shape[0],
                   torch.cuda.get_device_properties(0).multi_processor_count).stages
    for name, (lib, log) in libs.items():
        regs = [r for r in cs.ptxas_kernels(log) if "att_block_f32_kernel" in r[0]][0]
        kb._libs["att_block_f32"] = lib          # the wrapper launches the variant
        counts = stage_counts if name == "kernel" else [default]
        for stages in counts:
            ab.att_block_f32_plan = lambda *a, _s=stages, **k: plan(*a, stages=_s, **k)
            try:
                err = cs.max_err(run(), want)
                assert err <= 2e-4, f"{name} at {stages} stages disagrees ({err:.3g})"
                mark = " (the plan's default)" if stages == default else ""
                print(f"{name}, {stages} stages{mark}: {timer(run):.4f} ms, L2 warm "
                      f"{warm(run):.4f} ms, max |variant - plain| {err:.3g}; {regs[1]} "
                      f"registers, spills {regs[2]}/{regs[3]} B", flush=True)
            except ValueError as e:                                  # does not fit
                print(f"{name}, {stages} stages: {e}")
            finally:
                ab.att_block_f32_plan = plan
    print_timeline(libs["timeline"][0], timer, run, packed.shape[0], MARKS_F32)
    kb._libs.pop("att_block_f32")
    return 0


def joint_variants(timer, warm, against, pairs, f32: bool = False) -> int:
    """The int8 (or f32) joint step beside its three launches, and its
    timeline; or against another version of its source."""
    from trt_asr_tpu_torch.ops.kernels import joint_step as js

    rng = np.random.default_rng(1234)
    t = lambda *s, sc=1.0: torch.as_tensor(  # noqa: E731
        (rng.standard_normal(s) * sc).astype(np.float32), device="cuda")
    p, j, v, rows = 640, 640, 8198, 8
    weight = (lambda w: w) if f32 else quantize_tensor
    args = (t(rows, j), t(rows, p, sc=0.5), weight(t(p, j, sc=p ** -0.5)),
            t(j, sc=0.1), weight(t(j, v, sc=j ** -0.5)), t(v, sc=0.1))
    name, kind = ("joint_step_f32", "f32") if f32 else ("joint_step_q8", "int8")
    kw = dict(ths=8193, ndur=5, blank_id=8192, blank_penalty=0.5)
    packed = js.pack_joint_step(*args[2:])                          # as the model packs them
    run = lambda: js.joint_step(*args, **kw, packed=packed)  # noqa: E731
    want = js.joint_step_plain(*args, **kw)

    def check(got) -> float:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        return float((got[2] - want[2]).abs().max())

    src = (kb.CSRC_DIR / f"{name}.cu").read_text()
    if against:
        return compare(timer, run, want[2:], src, pathlib.Path(against).read_text(), pairs,
                       name, out=lambda r: r[2:])
    libs = build({"kernel": src, "timeline": "#define TAIL_TIMELINE\n" + src + TIMELINE_READ},
                 name)
    chain = lambda: js.joint_step_chain(*args, **kw)  # noqa: E731
    print(f"plain version {timer(lambda: js.joint_step_plain(*args, **kw)):.4f} ms")
    print(f"three launches (csrc/joint_step.cu, {kind}): {timer(chain):.4f} ms, L2 warm "
          f"{warm(chain):.4f} ms, max |logits - plain| {check(chain()):.3g}")
    for variant, (lib, log) in libs.items():
        regs = [r for r in cs.ptxas_kernels(log) if f"{name}_kernel" in r[0]][0]
        kb._libs[name] = lib                     # the wrapper launches the variant
        err = check(run())
        assert err <= 1e-4, f"variant {variant} disagrees with the plain version ({err:.3g})"
        print(f"{variant}: {timer(run):.4f} ms, L2 warm {warm(run):.4f} ms, max |logits - plain| "
              f"{err:.3g}; {regs[1]} registers, spills {regs[2]}/{regs[3]} B", flush=True)
    print_timeline(libs["timeline"][0], timer, run, packed.shape[0],
                   MARKS_JOINT_F32 if f32 else MARKS_JOINT)
    kb._libs.pop(name)
    return 0


def print_timeline(lib, timer, run, blocks: int, names=MARKS) -> None:
    """The marks of one launch on a scrubbed L2 and of the launch right
    after it (warm), side by side: the median over the blocks and the
    latest block."""
    cols = []
    timer.scrub.zero_()
    for _ in range(2):
        marks = np.zeros((blocks, 25), dtype=np.uint64)
        run()
        torch.cuda.synchronize()
        kb.check(lib, lib.att_timeline(marks.ctypes.data, blocks), "timeline")
        ns = marks.astype(np.int64)
        cols.append((ns - int(ns[:, 0].min())) / 1e3)
    print("  timeline (us since the first block began, median over blocks, then the last "
          "block's): cold | warm | cold last | warm last")
    for i, name in names.items():
        print(f"  {i:2d} {name:26s} {np.median(cols[0][:, i]):7.3f} | "
              f"{np.median(cols[1][:, i]):7.3f} | {cols[0][:, i].max():7.3f} | "
              f"{cols[1][:, i].max():7.3f}")


def compare(timer, run, want, src: str, other: str, pairs: int, lib_name: str = "att_block_q8",
            tol: float = 1e-4, out=lambda r: r) -> int:
    libs = build({"kernel": src, "against": other}, lib_name)
    for name, (lib, log) in libs.items():
        kb._libs[lib_name] = lib
        err = cs.max_err(out(run()), want)
        assert err <= tol, f"{name} disagrees with the plain version ({err:.3g})"
        regs = [r for r in cs.ptxas_kernels(log) if f"{lib_name}_kernel" in r[0]][0]
        print(f"{name}: max |variant - plain| {err:.3g}; {regs[1]} registers, spills "
              f"{regs[2]}/{regs[3]} B")
    ms = {name: [] for name in libs}
    for i in range(pairs):
        for name, (lib, _) in libs.items():
            kb._libs[lib_name] = lib
            ms[name].append(timer(run))
        print(f"pair {i}: kernel {ms['kernel'][-1]:.4f} ms, against {ms['against'][-1]:.4f} ms",
              flush=True)
    kb._libs.pop(lib_name)
    diff = np.subtract(ms["against"], ms["kernel"])
    print(f"median of {pairs} pairs: kernel {np.median(ms['kernel']):.4f} ms, against "
          f"{np.median(ms['against']):.4f} ms; against - kernel: median {np.median(diff):.4f} "
          f"ms, range {diff.min():.4f} .. {diff.max():.4f} ms")
    return 0


def fma_sum(a, b, ks) -> np.ndarray:
    """sum_k a[..., k] * b[..., k] over ks in order, one f32 FMA a step
    (emulated in f64: each product of two f32 values is exact there)."""
    acc = np.zeros(np.broadcast_shapes(a.shape, b.shape)[:-1], dtype=np.float32)
    for k in ks:
        acc = (a[..., k] * b[..., k] + acc.astype(np.float64)).astype(np.float32)
    return acc


def in_order(parts) -> np.ndarray:
    tot = parts[0]
    for v in parts[1:]:
        tot = (tot + v).astype(np.float32)
    return tot


def orders(args, h) -> int:
    """Candidate orders of K: `runs` contiguous runs, each summed in `inter`
    interleaved partial sums (partial i over k = i, i + inter, ...), the
    partials and then the runs added in order."""
    from trt_asr_tpu_torch.ops.kernels.ffn import layer_norm_plain
    from trt_asr_tpu_torch.ops.quant import round_bf16

    x, ln_g, ln_b, wq, wk, wv = args[:6]
    bu, pos, kv = args[7], args[9], args[10]
    tq, d = x.shape
    dh, c = d // h, kv.shape[0]
    f64 = lambda t: t.double().cpu().numpy()  # noqa: E731
    a = round_bf16(layer_norm_plain(x, ln_g, ln_b))
    q = torch.matmul(a, wq.q.float())                   # the plain version's products
    k_all = round_bf16(torch.cat([kv[:, :d], torch.matmul(a, wk.q.float()) * wk.s]))
    qu = round_bf16(q * wq.s + bu.reshape(-1)).view(tq, h, dh)
    ac = torch.einsum("thd,shd->hts", qu, k_all.view(-1, h, dh))
    p = round_bf16(torch.softmax(ac, dim=-1))
    v = round_bf16(torch.cat([kv[:, d:], pos[:tq]])).view(-1, h, dh)   # any f32 rows
    ctx = torch.einsum("hts,shd->thd", p, v)
    cases = {   # name: (a [..., K], b [..., K], the card's sums)
        "Q": (f64(a)[:, None, :], f64(wq.q.float().t())[None], q.cpu().numpy()),
        "scores": (f64(qu.permute(1, 0, 2))[:, :, None], f64(k_all.view(-1, h, dh).permute(1, 0, 2))
                   [:, None], ac.cpu().numpy()),
        "context": (f64(p)[:, :, None], f64(v.permute(1, 2, 0))[:, None],
                    ctx.permute(1, 0, 2).cpu().numpy()),
    }
    for name, (u, w, want) in cases.items():
        kk = u.shape[-1]
        res = {}
        for runs in (1, 2, 4, 8, 16, 32):
            for inter in (1, 2, 4, 8, 16, 32):
                bounds = [kk * r // runs for r in range(runs + 1)]
                got = in_order([in_order([fma_sum(u, w, range(lo + i, hi, inter))
                                          for i in range(inter)])
                                for lo, hi in zip(bounds, bounds[1:])])
                res[(runs, inter)] = int((got != want).sum())
        best = sorted(res.items(), key=lambda kv_: kv_[1])[:4]
        print(f"{name} (K {kk}, {want.size} sums): (runs, interleaved partials) -> sums missed: "
              + ", ".join(f"{r}: {n}" for r, n in best), flush=True)
    return 0


def joint_orders(dev) -> int:
    """Candidate orders of the joint's hidden product g @ W_pred (K = P):
    runs of `run` rows of K, each summed in `inter` interleaved partials,
    the partials and then the runs added in order; and the order of the
    three-launch route (csrc/joint_step.cu: runs of 64, each 8 chains of 8
    added in order)."""
    from trt_asr_tpu_torch.ops.quant import round_bf16

    rng = np.random.default_rng(7)
    for rows, p, j in [(1, 32, 48), (8, 32, 48), (16, 32, 48), (37, 32, 48), (128, 32, 48),
                       (8, 32, 32), (8, 32, 64), (1, 640, 640), (8, 640, 640), (16, 640, 640),
                       (128, 640, 640)]:
        g = torch.as_tensor((rng.standard_normal((rows, p)) * 0.5).astype(np.float32), device=dev)
        wp = quantize_tensor(torch.as_tensor(
            (rng.standard_normal((p, j)) / math.sqrt(p)).astype(np.float32), device=dev))
        a = round_bf16(g)
        want = torch.matmul(a, wp.q.float()).cpu().numpy()      # the plain version's product
        u = a.double().cpu().numpy()[:, None, :]
        w = wp.q.double().t().cpu().numpy()[None]
        res = {}
        for run in (8, 16, 32, 64, 128, p):
            for inter in (1, 2, 4, 8):
                got = in_order([in_order([fma_sum(u, w, range(lo + i, min(p, lo + run), inter))
                                          for i in range(inter)])
                                for lo in range(0, p, run)])
                res[(run, inter)] = int((got != want).sum())
        res["route"] = int((in_order([in_order([fma_sum(u, w, range(c, min(p, c + 8)))
                                                  for c in range(lo, min(p, lo + 64), 8)])
                                         for lo in range(0, p, 64)]) != want).sum())
        best = sorted(res.items(), key=lambda kv_: kv_[1])[:5]
        print(f"joint hidden (rows {rows}, K {p}, {want.size} sums): (run, interleaved "
              f"partials) -> sums missed: " + ", ".join(f"{r}: {n}" for r, n in best)
              + f"; run 64 in order: {res[(64, 1)]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
