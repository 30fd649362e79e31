"""Beam-decode WER gate, as ``tools/gate_beam_eval.py``: the committed
trained gate model (``artifacts/models/gate_r3``) through the streaming
beam decoder on the held-out set the greedy gate uses
(``eval/synthetic.py`` ``make_set(n, 2, make_words(1120), 8, 13)``).

beam=1 must reproduce greedy's transcripts, and each decoder's WER must be
at most ``--gate-wer``; each row is one ``eval.suite.run_suite`` call
(python engine, ``feature_norm="none"``):

    python -m trt_asr_tpu_torch.tools.gate_beam_eval \\
        [--model-dir artifacts/models/gate_r3] [--eval-utts 50] \\
        [--beams 1,2,4] [--gate-wer 0.05] [--artifact F] [--device cpu]

Exit 0 when every row passes and beam 1 equals greedy, else 1.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from trt_asr_tpu_torch.eval.gate import write_held_out
from trt_asr_tpu_torch.tools import add_device_args, default_out_dir, tool_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m trt_asr_tpu_torch.tools.gate_beam_eval",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--model-dir", default="artifacts/models/gate_r3")
    ap.add_argument("--out-dir", default=default_out_dir("gate_beam"))
    ap.add_argument("--eval-utts", type=int, default=50)
    ap.add_argument("--vocab-size", type=int, default=1120)
    ap.add_argument("--words-per-utt", default="8,13")
    ap.add_argument("--beams", default="1,2,4")
    ap.add_argument("--stream-sim", type=float, default=0.5)
    ap.add_argument("--gate-wer", type=float, default=0.05)
    ap.add_argument("--artifact", default="")
    add_device_args(ap)
    args = ap.parse_args(argv)
    device = str(tool_device(args))

    from trt_asr_tpu_torch.eval.suite import SuiteConfig, run_suite
    from trt_asr_tpu_torch.eval.synthetic import make_set, make_words

    words = make_words(args.vocab_size)
    w_lo, w_hi = (int(x) for x in args.words_per_utt.split(","))
    evals = make_set(args.eval_utts, 2, words, w_lo, w_hi)  # gate held-out
    man = write_held_out(args.out_dir, words, evals)

    rows = {}
    for label, beam in [("greedy", 0)] + [
            (f"beam{b}", int(b)) for b in args.beams.split(",")]:
        t0 = time.time()
        res = run_suite(SuiteConfig(
            manifest_path=man,
            out_dir=os.path.join(args.out_dir, f"suite_{label}"),
            model_dir=args.model_dir, engine="python",
            variants=["base"], rounds=1, stream_sim=args.stream_sim,
            feature_norm="none", beam=beam, device=device))
        wer = res["variants"]["base"][0]["wer"]
        rows[label] = {k: wer[k] for k in
                       ("wer", "substitutions", "insertions", "deletions",
                        "ref_words", "empty_hypotheses")}
        rows[label]["wall_sec"] = round(time.time() - t0, 1)
        rows[label]["transcripts"] = [
            u["transcript"] for u in res["variants"]["base"][0]["utterances"]]
        print(f"{label:7s}: WER {wer['wer']*100:6.2f}% "
              f"(S={wer['substitutions']} I={wer['insertions']} "
              f"D={wer['deletions']} N={wer['ref_words']}) "
              f"{rows[label]['wall_sec']}s", flush=True)

    beam1_exact = (rows.get("beam1", {}).get("transcripts")
                   == rows["greedy"]["transcripts"])
    verdict = {
        "beam1_matches_greedy_transcripts": beam1_exact,
        "gate_wer": args.gate_wer,
        "pass_per_decoder": {k: rows[k]["wer"] <= args.gate_wer for k in rows},
    }
    print(f"beam1 transcripts == greedy: {beam1_exact}")
    print("gate verdicts:", verdict["pass_per_decoder"])
    for r in rows.values():
        r.pop("transcripts")   # keep the artifact small
    if args.artifact:
        with open(args.artifact, "w") as f:
            json.dump({"config": vars(args), "rows": rows, "verdict": verdict}, f, indent=1)
        print(f"wrote {args.artifact}")
    ok = all(verdict["pass_per_decoder"].values()) and beam1_exact
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
