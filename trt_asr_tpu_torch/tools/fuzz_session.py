"""Randomized property fuzz over the streaming surfaces, as
``tools/fuzz_session.py``: per seed, one random utterance (random length,
push plan and snapshot point) is decoded through every surface, and each
must be token-exact with the canonical single-push session:

  single    one push + finalize (the canonical transcript)
  shreds    random push granularity (1-sample to multi-second pushes)
  snapshot  snapshot at a random push boundary -> restore into a fresh
            session -> continue
  engine    a ``BatchStreamingEngine`` slot (a decoy stream alongside),
            random per-step feed sizes
  beam1     the streaming beam session at beam=1 (anchors beam to greedy)
  batchbeam an engine slot at beam=4 (decoy alongside, random per-step
            feeds) against a standalone device-beam session: the batched
            beam's reference is the beam transcript, not greedy's

The JAX tool's opt-in ``onnx`` surface (the exported-ONNX pipeline) is not
ported: it raises. The draws are the JAX tool's, in its order, so each
seed's ``samples`` equals its artifact's. The model is
``ParakeetTDT.random(ModelConfig.tiny(), seed=7)``; kernel flags come from
the environment.

    python -m trt_asr_tpu_torch.tools.fuzz_session --seeds 50 --out F [--device cpu]

Any divergence prints the seed, surface and first differing token index and
exits 1; replay a failure with ``--seeds 1 --seed-base <seed>``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from trt_asr_tpu_torch.tools import add_device_args, tool_device


def random_audio(rng: np.random.Generator, n: int) -> np.ndarray:
    """Band-limited noise with amplitude modulation: enough spectral
    structure that random-weight models emit non-trivial token streams."""
    t = np.arange(n, dtype=np.float32)
    sig = np.zeros(n, np.float32)
    for _ in range(4):
        f = rng.uniform(0.005, 0.6)
        sig += rng.uniform(0.1, 0.5) * np.sin(f * t + rng.uniform(0, 6.28)).astype(np.float32)
    env = 0.5 + 0.5 * np.sin(rng.uniform(0.0005, 0.005) * t)
    return (sig * env * 0.2 + 0.02 * rng.standard_normal(n)).astype(np.float32)


def random_pushes(rng: np.random.Generator, n: int) -> list:
    """Cut [0, n) into random push sizes spanning 4 orders of magnitude."""
    cuts, i = [], 0
    while i < n:
        step = int(rng.choice([1, 7, 160, 1600, 4000, 16000, 48000]))
        cuts.append((i, min(i + step, n)))
        i += step
    return cuts


def _drive_engine(eng, audio, decoy_audio, n: int, rng) -> list:
    """One slot fed random step sizes from ``rng`` beside a decoy fed 0.5 s
    a step; -> the slot's tokens once drained."""
    sid = eng.open_stream()
    decoy = eng.open_stream()
    i = j = 0
    while i < n or j < n:
        if i < n:
            step = int(rng.choice([1600, 4000, 16000]))
            eng.push_audio(sid, audio[i:i + step])
            i += step
        if j < n:
            eng.push_audio(decoy, decoy_audio[j:j + 8000])
            j += 8000
        eng.step()
    eng.finalize_stream(sid)
    eng.finalize_stream(decoy)
    eng.run_until_drained()
    return list(eng._tokens[sid])


def run_seed(model, seed: int, surfaces, tokens_out: dict = None) -> dict:
    """The JAX tool's record for ``seed``; with ``tokens_out`` each
    surface's token list (and ``batchbeam_ref``'s) is stored there too."""
    from trt_asr_tpu_torch.streaming.batch_engine import BatchStreamingEngine
    from trt_asr_tpu_torch.streaming.beam_session import BeamStreamingSession
    from trt_asr_tpu_torch.streaming.session import StreamingSession

    if "onnx" in surfaces:
        raise NotImplementedError(
            "the onnx surface drives the JAX-only tools/onnx_pipeline.py, which has no "
            "port yet (ROADMAP.md Queue 1 item 15, the ONNX-pipeline surfaces)")
    rng = np.random.default_rng(seed)
    n = int(rng.integers(int(0.3 * 16000), 8 * 16000))
    audio = random_audio(rng, n)

    ref = StreamingSession(model)
    ref.push_audio(audio)
    ref.finalize()
    want = list(ref._tokens)
    got = {"single": want}

    if "shreds" in surfaces:
        s = StreamingSession(model)
        for a, b in random_pushes(rng, n):
            s.push_audio(audio[a:b])
        s.finalize()
        got["shreds"] = list(s._tokens)

    if "snapshot" in surfaces:
        cuts = random_pushes(rng, n)
        k = int(rng.integers(0, len(cuts)))
        s = StreamingSession(model)
        for a, b in cuts[:k]:
            s.push_audio(audio[a:b])
        snap = s.snapshot()
        s2 = StreamingSession(model)
        s2.restore(snap)
        for a, b in cuts[k:]:
            s2.push_audio(audio[a:b])
        s2.finalize()
        got["snapshot"] = list(s2._tokens)

    if "engine" in surfaces:
        eng = BatchStreamingEngine(model, batch_size=2)
        decoy_audio = random_audio(np.random.default_rng(seed + 1), n)
        got["engine"] = _drive_engine(eng, audio, decoy_audio, n, rng)

    if "beam1" in surfaces:
        s = BeamStreamingSession(model, beam=1)
        for a, b in random_pushes(rng, n):
            s.push_audio(audio[a:b])
        s.finalize()
        got["beam1"] = list(s._tokens)

    wants = {name: want for name in got}
    if "batchbeam" in surfaces:
        from trt_asr_tpu_torch.streaming.schedule import ChunkScheduler

        ref_b = BeamStreamingSession(model, beam=4, device=True)
        ref_b._sched = ChunkScheduler(model.cfg, unified=True)
        ref_b.push_audio(audio)
        ref_b.finalize()
        eng = BatchStreamingEngine(model, batch_size=2, beam=4)
        decoy_audio = random_audio(np.random.default_rng(seed + 3), n)
        got["batchbeam"] = _drive_engine(eng, audio, decoy_audio, n,
                                         np.random.default_rng(seed + 2))
        wants["batchbeam"] = list(ref_b._tokens)

    if tokens_out is not None:
        tokens_out.update(got)
        if "batchbeam" in wants:
            tokens_out["batchbeam_ref"] = wants["batchbeam"]
    fails = {}
    for name, toks in got.items():
        w = wants[name]
        if toks != w:
            div = next((i for i, (x, y) in enumerate(zip(toks, w)) if x != y),
                       min(len(toks), len(w)))
            fails[name] = {"len": len(toks), "want_len": len(w), "first_divergence": div}
    return {"seed": seed, "samples": n, "tokens": len(want),
            "surfaces": sorted(got), "fails": fails}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m trt_asr_tpu_torch.tools.fuzz_session",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=20)
    ap.add_argument("--seed-base", type=int, default=0)
    ap.add_argument("--surfaces", default="shreds,snapshot,engine,beam1,batchbeam")
    ap.add_argument("--out", default="")
    add_device_args(ap)
    args = ap.parse_args(argv)
    device = tool_device(args)
    surfaces = [s for s in args.surfaces.split(",") if s]

    from trt_asr_tpu_torch.config import ModelConfig
    from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT

    model = ParakeetTDT.random(ModelConfig.tiny(), seed=7, device=device)
    results, n_fail = [], 0
    t0 = time.perf_counter()
    for seed in range(args.seed_base, args.seed_base + args.seeds):
        r = run_seed(model, seed, surfaces)
        results.append(r)
        status = "FAIL " + json.dumps(r["fails"]) if r["fails"] else "ok"
        n_fail += bool(r["fails"])
        print(f"seed {seed:4d}: {r['samples']:6d} smp {r['tokens']:4d} tok  {status}",
              flush=True)
    summary = {"seeds": args.seeds, "failures": n_fail, "surfaces": surfaces,
               "wall_s": round(time.perf_counter() - t0, 1), "results": results}
    print(f"{args.seeds - n_fail}/{args.seeds} seeds token-exact across "
          f"{len(surfaces) + 1} surfaces ({summary['wall_s']}s)")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
