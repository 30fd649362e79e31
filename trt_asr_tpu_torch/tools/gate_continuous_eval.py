"""Continuous-mode WER gate, as ``tools/gate_continuous_eval.py``: the gate
model's held-out utterances (each ending in its 0.6 s silence tail), joined
with ``--gap-s`` of silence into one stream, go through a
``ContinuousTranscriber`` over a ``StreamingSession`` in ``--chunk-samples``
pushes; the endpointer must recover every utterance boundary and the
segments' transcripts must score within ``--gate-wer`` (``eval/wer.py``
``score_corpus``):

    python -m trt_asr_tpu_torch.tools.gate_continuous_eval \\
        [--model-dir artifacts/models/gate_r3] [--eval-utts 50] \\
        [--silence-s 0.7] [--gate-wer 0.05] [--artifact F] [--device cpu]

Kernel flags come from the environment (``RuntimeConfig.from_env``), off
by default as in JAX. Exit 0 when the segments match the utterances and the
WER passes, else 1. ``evaluate`` returns the transcriber's segments beside
the artifact's payload.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from trt_asr_tpu_torch.tools import add_device_args, tool_device


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m trt_asr_tpu_torch.tools.gate_continuous_eval",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--model-dir", default="artifacts/models/gate_r3")
    ap.add_argument("--eval-utts", type=int, default=50)
    ap.add_argument("--vocab-size", type=int, default=1120)
    ap.add_argument("--words-per-utt", default="8,13")
    ap.add_argument("--silence-s", type=float, default=0.7,
                    help="endpoint threshold; also the trailing silence a segment "
                         "keeps: this model family needs a >= 0.6 s tail so that the "
                         "finalize flush lands in silence")
    ap.add_argument("--gap-s", type=float, default=0.6,
                    help="extra inter-utterance silence in the stream (the "
                         "utterances' own 0.6 s tails alone sit below silence-s)")
    ap.add_argument("--preroll-s", type=float, default=0.1,
                    help="leading context per segment; matches the training "
                         "utterances' 0.08 s leading gap")
    ap.add_argument("--chunk-samples", type=int, default=8000)
    ap.add_argument("--gate-wer", type=float, default=0.05)
    ap.add_argument("--artifact", default="")
    add_device_args(ap)
    return ap.parse_args(argv)


def evaluate(args: argparse.Namespace):
    """-> (artifact payload, segments); prints the JAX tool's lines."""
    from trt_asr_tpu_torch.config import RuntimeConfig
    from trt_asr_tpu_torch.eval.synthetic import make_set, make_words
    from trt_asr_tpu_torch.eval.wer import score_corpus
    from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT
    from trt_asr_tpu_torch.streaming.continuous import ContinuousTranscriber
    from trt_asr_tpu_torch.streaming.session import StreamingSession

    device = tool_device(args)
    words = make_words(args.vocab_size)
    w_lo, w_hi = (int(x) for x in args.words_per_utt.split(","))
    evals = make_set(args.eval_utts, 2, words, w_lo, w_hi)  # gate held-out
    refs = [" ".join(words[k] for k in ids) for ids, _ in evals]
    gap = np.zeros(int(args.gap_s * 16000), np.float32)
    parts = []
    for _, a in evals:
        parts += [a, gap]
    stream = np.concatenate(parts)
    print(f"stream: {len(stream)/16000:.1f}s audio, "
          f"{len(evals)} utterances", flush=True)

    rt = RuntimeConfig.from_env()
    model = ParakeetTDT.from_model_dir(args.model_dir, runtime=rt, device=device)
    ct = ContinuousTranscriber(StreamingSession(model, rt), silence_s=args.silence_s,
                               preroll_s=args.preroll_s)
    t0 = time.time()
    for s in range(0, len(stream), args.chunk_samples):
        ct.push_audio(stream[s: s + args.chunk_samples])
    ct.flush()
    wall = time.time() - t0

    segs = ct.segments
    print(f"{len(segs)} segments in {wall:.1f}s "
          f"(RTFx {len(stream)/16000/wall:.1f})", flush=True)
    seg_ok = len(segs) == len(evals)
    hyps = [s["text"] for s in segs]
    wer = score_corpus(zip(refs, (hyps + [""] * len(refs))[: len(refs)]))
    wer_row = {k: wer[k] for k in ("wer", "substitutions", "insertions",
                                   "deletions", "ref_words", "empty_hypotheses")}
    print(f"segments == utterances: {seg_ok}")
    print(f"WER {wer['wer']*100:.2f}% (S={wer['substitutions']} "
          f"I={wer['insertions']} D={wer['deletions']} "
          f"N={wer['ref_words']})")
    ok = seg_ok and wer["wer"] <= args.gate_wer
    print(f"GATE {'PASS' if ok else 'FAIL'}")
    payload = {
        "config": vars(args),
        "n_utterances": len(evals),
        "n_segments": len(segs),
        "segments_match_utterances": seg_ok,
        "wer": wer_row,
        "wall_sec": round(wall, 1),
        "rtfx": round(len(stream) / 16000 / wall, 1),
        "boundaries": [{"start_s": round(s["start_s"], 2), "end_s": round(s["end_s"], 2)}
                       for s in segs],
        "pass": ok,
    }
    return payload, segs


def main(argv=None) -> int:
    args = parse_args(argv)
    payload, _ = evaluate(args)
    if args.artifact:
        with open(args.artifact, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"wrote {args.artifact}")
    return 0 if payload["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
