#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``trt_asr_tpu_torch``) on one
NVIDIA H100. Run from the repository root:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches its own failure):

1. device, ``nvidia-smi`` name and power limit; build the CUDA kernels
   from ``trt_asr_tpu_torch/csrc`` (one nvcc per source, in parallel).
2. each kernel against its plain PyTorch version on the card at the
   full-size main-path shapes (f32 and int8 weights for the attention
   block and the joint step, f32 for the log-mel), with each one's median
   time, the plain version's time and the bound (bytes or operations).
   The int8 tolerance is shown to fail a kernel without the bf16 rounding
   points (the plain version on the dequantized weights).
3. full-width session (``ModelConfig()``, seeded random weights from the
   port's ``init_params``): a seeded synthetic utterance of 12 words
   (~6 s) pushed in 0.5 s pieces, with a blank bias set so the plain f32
   path emits about one token a word. Arm (a): f32 with the three kernels
   on, token-exact against the same session with the kernels off. Arm (b),
   the fast arm: int8 ``quant="all"`` with the kernels on. Launch counts
   are reset just before each kernel arm and read just after.
4. the trained ``artifacts/models/gate_r3`` on the card with the kernels
   on, f32 and int8, each token-exact against the port's CPU plain path.
5. neither ``jax`` nor ``trt_asr_tpu`` was imported.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the card's name and power limit; before that one JSON line lists the
kernels with their launches, errors and times.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS = {"f32": 67e12,          # f32 outside the tensor cores
            "bf16": 989e12}        # dense bf16 tensor-core rate


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True)
    return out.stdout.strip().splitlines()[0]


# --- timing ----------------------------------------------------------------


class Timer:
    """Median device time of one call, L2 scrubbed before every launch so
    weights come from HBM as they do on the main path (24 layers of
    weights do not fit the 50 MB L2).

    A spin kernel holds the device while a batch of calls is enqueued, so
    the events around each call bracket its device work only, not the
    host's enqueue (a wrapper's Python work is longer than its kernels).
    The spin is checked to outlast the enqueue, and doubled if it did
    not. ``host_us`` keeps the last batch's host enqueue time per call."""

    MAX_SPIN_CYCLES = 640_000_000     # ~0.3 s at the H100's clock

    def __init__(self, torch, dev, reps: int = 30, batch: int = 10):
        self.torch, self.dev, self.reps, self.batch = torch, dev, reps, batch
        self.scrub = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
        self.spin_cycles = 20_000_000
        self.host_us = 0.0

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        while len(times) < self.reps:
            ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(self.batch)]
            spun = torch.cuda.Event()
            torch.cuda._sleep(self.spin_cycles)
            spun.record()
            t0 = time.perf_counter()
            for a, b in ev:
                self.scrub.zero_()
                a.record()
                fn()
                b.record()
            self.host_us = (time.perf_counter() - t0) * 1e6 / self.batch
            held = not spun.query()
            torch.cuda.synchronize()
            if not held and self.spin_cycles < self.MAX_SPIN_CYCLES:
                self.spin_cycles *= 2
                continue
            assert held, "timed call waits on the device: its time would hold host work"
            times += [a.elapsed_time(b) for a, b in ev]
        return float(np.median(times))


def bound(nbytes: float, ops: float, op_type: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[op_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def wbytes(w) -> int:
    from trt_asr_tpu_torch.ops.quant import QuantTensor

    if isinstance(w, QuantTensor):
        return w.q.numel() + 4 * w.s.numel()
    return w.numel() * w.element_size()


def max_err(got, want) -> float:
    return max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))


def measure(name, timer, err, kernel_fn, plain_fn, nbytes, ops, op_type):
    """Time a kernel and its plain version (device ms) beside their bound."""
    b_ms, b_by = bound(nbytes, ops, op_type)
    ms = timer(kernel_fn)
    host_us = timer.host_us
    plain_ms = timer(plain_fn)
    log(f"  {name} kernel {ms:.4f} ms (host enqueue {host_us:.1f} us/call), plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


# --- phase 2: kernels against their plain versions ---------------------------


def check_rounding_points(name, tol, got, unrounded) -> None:
    """The int8 tolerance must tell the kernel from one that skips the bf16
    rounding points: the plain version on the dequantized f32 weights has
    none, and the kernel must sit farther than the tolerance from it."""
    gap = max_err(got, unrounded)
    log(f"  {name}[int8]: max |kernel - plain without bf16 rounding points| = {gap:.3g}")
    assert gap > tol, f"{name}[int8] tolerance {tol:g} cannot see the rounding points"


def check_kernels(torch, dev, timer, cfg):
    from trt_asr_tpu_torch.ops.kernels.att_block import att_block, att_block_plain
    from trt_asr_tpu_torch.ops.kernels.joint_step import joint_step, joint_step_plain
    from trt_asr_tpu_torch.ops.kernels.mel import logmel, logmel_plain
    from trt_asr_tpu_torch.ops.quant import QuantTensor, dequantize, quantize_tensor
    from trt_asr_tpu_torch.frontend.logmel import LogMelFrontend
    from trt_asr_tpu_torch.contract import FrontendSpec

    rng = np.random.default_rng(1234)
    t = lambda *s, sc=1.0: torch.as_tensor(  # noqa: E731
        (rng.standard_normal(s) * sc).astype(np.float32), device=dev)
    d, h, c = cfg.d_model, cfg.n_heads, cfg.att_cache_size
    tq, valid_tq = 8, 6                       # steady chunk: 6 steps padded to 8
    r = 2 * tq + c - 1
    records = {}

    # attention block, steady state: full ring cache, cursor mid-ring
    x = t(tq, d)
    ln_g, ln_b = 1.0 + t(d, sc=0.1), t(d, sc=0.1)
    ws = [t(d, d, sc=1 / math.sqrt(d)) for _ in range(4)]
    bu, bv = t(h, d // h, sc=0.3), t(h, d // h, sc=0.3)
    pos = t(r, d)
    kv = t(c, 2 * d)
    meta = torch.tensor([100, c, valid_tq], dtype=torch.int32, device=dev)
    for arm, wts, tol in (("f32", ws, 2e-4), ("int8", [quantize_tensor(w) for w in ws], 1e-4)):
        args = (x, ln_g, ln_b, *wts, bu, bv, pos, kv, meta)
        got = att_block(*args, n_heads=h)
        want = att_block_plain(*args, n_heads=h)
        torch.cuda.synchronize()
        err = max_err(got, want)
        log(f"att_block[{arm}]: max |kernel - plain| over (y, u, k_new, v_new) = {err:.3g} "
            f"(tolerance {tol:g})")
        assert err <= tol, f"att_block[{arm}] disagrees with its plain version"
        if arm == "int8":
            check_rounding_points("att_block", tol, got, att_block_plain(
                x, ln_g, ln_b, *[dequantize(w) for w in wts], bu, bv, pos, kv, meta,
                n_heads=h))
        s_valid = c + valid_tq
        nbytes = (x.numel() * 4 * 5 + 4 * d * 4 + sum(wbytes(w) for w in wts)
                  + 2 * d * 4 + pos.numel() * 4 + kv.numel() * 4 + 12)
        ops = 2 * tq * d * d * 4 + 6 * tq * s_valid * d
        records[arm + "_att"] = measure(
            f"att_block[{arm}]", timer, err, lambda: att_block(*args, n_heads=h),
            lambda: att_block_plain(*args, n_heads=h), nbytes, ops,
            "f32" if arm == "f32" else "bf16")

    # joint step: rows = one padded steady chunk (B=1, Tq=8)
    rows, j, p, v = tq, cfg.joint_hidden, cfg.pred_hidden, cfg.joint_vocab_size
    e, g = t(rows, j), t(rows, p, sc=0.5)
    wp, wo = t(p, j, sc=1 / math.sqrt(p)), t(j, v, sc=1 / math.sqrt(j))
    bp, bo = t(j, sc=0.1), t(v, sc=0.1)
    kw = dict(ths=cfg.token_head_size, ndur=cfg.num_duration_bins, blank_id=cfg.blank_id,
              blank_penalty=0.5)
    for arm, (wpp, woo), tol in (("f32", (wp, wo), 1e-4),
                                 ("int8", (quantize_tensor(wp), quantize_tensor(wo)), 1e-4)):
        args = (e, g, wpp, bp, woo, bo)
        tok, dur, logits = joint_step(*args, **kw)
        tok_p, dur_p, logits_p = joint_step_plain(*args, **kw)
        torch.cuda.synchronize()
        err = float((logits - logits_p).abs().max())
        log(f"joint_step[{arm}]: max |logits kernel - plain| = {err:.3g} (tolerance {tol:g})")
        assert err <= tol, f"joint_step[{arm}] logits disagree"
        if isinstance(woo, QuantTensor):
            check_rounding_points("joint_step", tol, (logits,), joint_step_plain(
                e, g, dequantize(wpp), bp, dequantize(woo), bo, **kw)[2:])
        # argmaxes must agree wherever the plain top-2 margin exceeds the tolerance
        tl = logits_p[:, :kw["ths"]].clone()
        tl[:, kw["blank_id"]] -= kw["blank_penalty"]
        for name, lg, a, b in (("token", tl, tok, tok_p),
                               ("duration", logits_p[:, kw["ths"]:kw["ths"] + kw["ndur"]], dur, dur_p)):
            top2 = torch.topk(lg, 2, dim=1).values
            clear = (top2[:, 0] - top2[:, 1]) > 2 * tol
            assert bool(((a == b) | ~clear).all()), f"joint_step[{arm}] {name} argmax disagrees"
        log(f"  tokens equal: {bool((tok == tok_p).all())}, durations equal: "
            f"{bool((dur == dur_p).all())}")
        nbytes = (e.numel() + g.numel() + j + v) * 4 + wbytes(wpp) + wbytes(woo) + rows * v * 4 + rows * 8
        ops = 2 * rows * (p * j + j * v)
        records[arm + "_joint"] = measure(
            f"joint_step[{arm}]", timer, err, lambda: joint_step(*args, **kw),
            lambda: joint_step_plain(*args, **kw), nbytes, ops,
            "f32" if arm == "f32" else "bf16")

    # log-mel: one 0.5 s push = 50 frames of 400 samples
    fe = LogMelFrontend(FrontendSpec(n_mels=cfg.feat_in), device=dev)
    frames = t(50, 400, sc=0.3)
    margs = (frames, fe._wcos, fe._wsin, fe._mel, fe.spec.log_floor)
    got, want = logmel(*margs), logmel_plain(*margs)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tol = 1e-3
    log(f"logmel[f32]: max |kernel - plain| = {err:.3g} (tolerance {tol:g})")
    assert err <= tol, "logmel disagrees with its plain version"
    nb, nm = fe._mel.shape
    nbytes = (frames.numel() + 2 * fe._wcos.numel() + fe._mel.numel() + 50 * nm) * 4
    ops = 2 * 50 * 400 * nb * 2 + 2 * 50 * nb * nm + 3 * 50 * nb
    records["f32_mel"] = measure("logmel[f32]", timer, err, lambda: logmel(*margs),
                                 lambda: logmel_plain(*margs), nbytes, ops, "f32")
    return records


# --- phases 3 and 4: sessions ----------------------------------------------


def synth_module():
    spec = importlib.util.spec_from_file_location(
        "train_synthetic_e2e", os.path.join(ROOT, "tools", "train_synthetic_e2e.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reset_counts():
    from trt_asr_tpu_torch.ops.kernels.att_block import att_block
    from trt_asr_tpu_torch.ops.kernels.joint_step import joint_step
    from trt_asr_tpu_torch.ops.kernels.mel import logmel

    for fn in (att_block, joint_step, logmel):
        fn.launches = 0


def read_counts():
    from trt_asr_tpu_torch.ops.kernels.att_block import att_block
    from trt_asr_tpu_torch.ops.kernels.joint_step import joint_step
    from trt_asr_tpu_torch.ops.kernels.mel import logmel

    return {"att_block": att_block.launches, "joint_step": joint_step.launches,
            "logmel": logmel.launches}


def run_session(torch, model, rt, audio, piece: int):
    from trt_asr_tpu_torch.streaming.session import StreamingSession

    sess = StreamingSession(model, rt)
    for i in range(0, len(audio), piece):
        sess.push_audio(audio[i:i + piece])
    sess.finalize()
    torch.cuda.synchronize()
    return sess


def make_model(torch, cfg, params, tok, rt, dev, mel_kernel: bool):
    from trt_asr_tpu_torch.contract import FrontendSpec
    from trt_asr_tpu_torch.frontend.logmel import LogMelFrontend
    from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT

    fe = LogMelFrontend(FrontendSpec(n_mels=cfg.feat_in), use_kernel=mel_kernel, device=dev)
    return ParakeetTDT(cfg, params, tok, frontend=fe, runtime=rt, device=dev)


def profile_session(torch, model, rt, audio, piece: int) -> None:
    """Device busy share and kernel time by name over one session
    (torch.profiler): where a steady chunk's time goes."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sess = run_session(torch, model, rt, audio, piece)
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies): the CPU ops that launched
    # them carry the same device time again
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count) for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and ev.self_device_time_total > 0), reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    n = len(sess.chunk_latencies_ms)
    log(f"profile[{rt.quant}, kernels {rt.use_pallas_att}]: {n} chunks, wall {wall_ms:.1f} ms, "
        f"device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}% busy, "
        f"{100 - 100 * busy_ms / wall_ms:.1f}% idle)")
    for dev_us, key, count in rows[:12]:
        log(f"  {dev_us / 1e3:9.3f} ms {count:6d}x  {key[:90]}")
    for dev_us, key, count in rows:
        if key.startswith(("port::", "void port::")):
            log(f"  kernel {key.split('(')[0][:60]}: {dev_us / count:.2f} us a launch, "
                f"{count}x")


def decode_and_sync_counts(torch, model, rt, audio, piece: int):
    """Decode-loop iterations and host syncs per chunk over one session. A
    host sync is a synchronizing CUDA call that torch's sync debug mode
    reports (copies to the host, blocking copies to the card)."""
    import warnings

    from trt_asr_tpu_torch.decode.batched import tdt_greedy_decode_batch as dec
    from trt_asr_tpu_torch.streaming.session import StreamingSession

    it0 = dec.iterations
    sess = StreamingSession(model, rt)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for i in range(0, len(audio), piece):
                sess.push_audio(audio[i:i + piece])
            sess.finalize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    n = len(sess.chunk_latencies_ms)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    return (dec.iterations - it0) / n, syncs / n


def calibrate_blank_bias(torch, model, rt, audio, piece: int, n_words: int) -> float:
    """Bisect a bias on the joint's blank logit (plain f32 model) toward one
    token per spoken word of the utterance, the rate a trained model emits
    on these utterances (gate_r3, phase 4: one token a word). Random weights
    otherwise emit on almost every step, and their token count jumps with
    the bias, so the search keeps the bias whose count is closest to the
    target from above (at least one token a word: the f32 exactness check
    needs tokens). The bias lives in the shared joint bias tensor, so every
    arm decodes with it."""
    b = model.params["joint"]["out"]["b"]
    blank = model.cfg.blank_id
    base = float(b[blank])
    lo, hi = 0.0, 4.0
    tried = {}
    t0 = time.perf_counter()
    for _ in range(10):
        mid = 0.5 * (lo + hi)
        b[blank] = base + mid
        tried[mid] = n_tok = len(run_session(torch, model, rt, audio, piece).tokens)
        if n_words <= n_tok <= 2 * n_words:
            break
        lo, hi = (mid, hi) if n_tok > n_words else (lo, mid)
    bias = min(tried, key=lambda m: (tried[m] < n_words, abs(tried[m] - n_words)))
    b[blank] = base + bias
    log(f"emission profile: blank bias {bias:.5f} -> {tried[bias]} tokens (target {n_words}, "
        f"one a word of the utterance, on the plain f32 path); tried "
        f"{ {round(m, 5): n for m, n in tried.items()} } in {time.perf_counter() - t0:.1f} s")
    return bias


def full_width_session(torch, dev, n_words: int, seed: int):
    from trt_asr_tpu_torch.config import ModelConfig, RuntimeConfig
    from trt_asr_tpu_torch.models.parakeet.params import init_params_numpy
    from trt_asr_tpu_torch.tokenizer import Tokenizer, make_synthetic_vocab

    cfg = ModelConfig()
    t0 = time.perf_counter()
    params = init_params_numpy(cfg, seed=seed)
    tok = Tokenizer(make_synthetic_vocab(cfg.vocab_size), blank_id=cfg.blank_id)
    log(f"full-width weights (seed {seed}) made in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(seed)
    synth = synth_module()
    audio = synth.synth_utterance(list(rng.integers(0, 1120, size=n_words)), rng)
    warm = audio[:16000]
    piece = 8000
    arms = {
        "f32_off": (RuntimeConfig(), False),
        "f32_on": (RuntimeConfig(use_pallas_att=True, use_pallas_joint=True), True),
        "int8_on": (RuntimeConfig(use_pallas_att=True, use_pallas_joint=True, quant="all"), True),
    }
    results = {}
    model_f32 = None
    for name, (rt, mel_k) in arms.items():
        model = make_model(torch, cfg, params if model_f32 is None else model_f32.params,
                           tok, rt, dev, mel_k)
        if model_f32 is None:
            model_f32 = model
            calibrate_blank_bias(torch, model, rt, audio, piece, n_words)
        run_session(torch, model, rt, warm, piece)            # warm-up utterance
        reset_counts()
        sess = run_session(torch, model, rt, audio, piece)
        counts = read_counts()
        lat = np.asarray(sess.chunk_latencies_ms)
        steady = lat[1:-1]
        n_chunks = len(lat)
        results[name] = dict(tokens=sess.tokens, counts=counts, n_chunks=n_chunks,
                             median_ms=float(np.median(steady)),
                             p90_ms=float(np.percentile(steady, 90)))
        iters, syncs = decode_and_sync_counts(torch, model, rt, audio, piece)
        profile_session(torch, model, rt, audio[: len(audio) // 3], piece)
        log(f"session[{name}]: {len(audio) / 16000:.2f} s audio, {n_chunks} chunks, "
            f"{len(sess.tokens)} tokens ({len(sess.tokens) / n_chunks:.2f}/chunk), steady "
            f"chunk median {results[name]['median_ms']:.3f} ms p90 {results[name]['p90_ms']:.3f} ms, "
            f"launches {counts} ({ {k: round(v / n_chunks, 2) for k, v in counts.items()} }/chunk), "
            f"decode iterations {iters:.2f}/chunk, host syncs {syncs:.2f}/chunk")
        del model, sess
    a_on, a_off, b = results["f32_on"], results["f32_off"], results["int8_on"]
    assert a_off["counts"] == {"att_block": 0, "joint_step": 0, "logmel": 0}
    assert len(a_off["tokens"]) >= n_words, "f32 session emitted too few tokens to compare"
    assert a_on["tokens"] == a_off["tokens"], (
        "f32 session with kernels on is not token-exact with kernels off")
    for name in ("f32_on", "int8_on"):
        assert all(v > 0 for v in results[name]["counts"].values()), (
            f"session[{name}] did not launch every kernel: {results[name]['counts']}")
    assert len(b["tokens"]) > 0 or len(a_on["tokens"]) == 0
    same = sum(x == y for x, y in zip(a_on["tokens"], b["tokens"]))
    log(f"f32 kernels on == kernels off: token-exact ({len(a_on['tokens'])} tokens); "
        f"fast arm agreement with f32: {same}/{max(len(a_on['tokens']), len(b['tokens']))} "
        f"positions, exact={a_on['tokens'] == b['tokens']}")
    return results


def gate_r3_session(torch, dev):
    """gate_r3 on the card with the kernels on, in f32 and int8 (``quant="all"``),
    each token-exact against the port's CPU plain path with the same runtime
    flags (on CPU tensors every kernel wrapper runs its plain version)."""
    from trt_asr_tpu_torch.config import RuntimeConfig
    from trt_asr_tpu_torch.contract import FrontendSpec
    from trt_asr_tpu_torch.frontend.logmel import LogMelFrontend
    from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT

    md = os.path.join(ROOT, "artifacts", "models", "gate_r3")
    rng = np.random.default_rng(7)
    synth = synth_module()
    words = list(rng.integers(0, 1120, size=8))
    audio = synth.synth_utterance(words, rng)
    for quant in ("none", "all"):
        rt = RuntimeConfig(use_pallas_att=True, use_pallas_joint=True, quant=quant)
        out = {}
        for d in (dev, "cpu"):
            model = ParakeetTDT.from_model_dir(md, runtime=rt, device=d)
            model.frontend = LogMelFrontend(FrontendSpec(n_mels=model.cfg.feat_in),
                                            use_kernel=True, device=d)
            reset_counts()
            out[str(d)] = (run_session(torch, model, rt, audio, 8000), read_counts())
        (s_gpu, counts), (s_cpu, cpu_counts) = out[str(dev)], out["cpu"]
        log(f"gate_r3[{quant}] on the card (kernels on, launches {counts}): {s_gpu.text!r}")
        log(f"gate_r3[{quant}] on the CPU (plain path):               {s_cpu.text!r}")
        assert all(v > 0 for v in counts.values()), f"gate_r3[{quant}] missed a kernel: {counts}"
        assert not any(cpu_counts.values()), f"gate_r3[{quant}] CPU run launched {cpu_counts}"
        assert s_gpu.tokens == s_cpu.tokens, (
            f"gate_r3[{quant}] card tokens differ from the CPU plain path")
        assert len(s_gpu.tokens) == len(words), (
            f"gate_r3[{quant}] emitted {len(s_gpu.tokens)} tokens for {len(words)} words")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--words", type=int, default=12,
                    help="words in the full-width session's utterance (12: about 6 s)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "trt_asr_tpu_torch")):
        print("chip_smoke: trt_asr_tpu_torch package not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from trt_asr_tpu_torch.config import ModelConfig
    from trt_asr_tpu_torch.ops.kernels import build

    dev = torch.device("cuda")
    smi = smi_line()
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; nvidia-smi: {smi}")
    secs = build.build()
    log(f"kernel build: {secs:.1f} s ({', '.join(build.SOURCES)})")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}]: {line.strip()}")

    timer = Timer(torch, dev)
    cfg = ModelConfig()
    rec = check_kernels(torch, dev, timer, cfg)
    sess = full_width_session(torch, dev, args.words, args.seed)
    gate_r3_session(torch, dev)

    bad = [m for m in ("jax", "trt_asr_tpu") if m in sys.modules]
    assert not bad, f"imported {bad}"

    srcs = {"att": ("att_block", "trt_asr_tpu_torch/csrc/att_block.cu",
                    "trt_asr_tpu/ops/pallas/att_block_kernel.py:170"),
            "joint": ("joint_step", "trt_asr_tpu_torch/csrc/joint_step.cu",
                      "trt_asr_tpu/ops/pallas/joint_step_kernel.py:124"),
            "mel": ("logmel", "trt_asr_tpu_torch/csrc/mel.cu",
                    "trt_asr_tpu/ops/pallas/mel_kernel.py:65")}
    kernels = []
    for key, r in rec.items():
        arm, short = key.split("_")
        name, src, rep = srcs[short]
        kernels.append({"name": f"{name}[{arm}]", "route": "cuda", "source": src,
                        "replaces": rep,
                        "launches": sess[f"{arm}_on"]["counts"][name],
                        "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
