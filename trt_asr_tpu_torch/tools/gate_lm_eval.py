"""LM-fusion WER measurement on the trained gate model under noise, as
``tools/gate_lm_eval.py``.

The clean gate is 0% WER, so fusion has nothing to fix there; under
additive noise (``add_noise`` at ``--snr-db``, rng 99) the gate model
degrades, which is where an external LM earns its keep. A token n-gram LM
is fitted on the training distribution's texts (``default_rng(1)``, the
geometry of ``make_set(seed=1)``, no audio; ``decode/ngram_lm.py``) and
``lm_weight`` is swept over the noisy held-out set at a fixed beam:

    python -m trt_asr_tpu_torch.tools.gate_lm_eval \\
        [--model-dir artifacts/models/gate_r3] [--snr-db 15] [--beam 4] \\
        [--lm-weights 0,0.2,0.4] [--artifact F] [--device cpu]

Verdict: the best fused row (w > 0 only, so that the verdict can fail) must
be at most the unfused beam row. Exit 0 when it is, 1 when it is not, 2
when no fused row was asked for.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from trt_asr_tpu_torch.eval.gate import write_held_out
from trt_asr_tpu_torch.tools import add_device_args, default_out_dir, tool_device


def lm_corpus(n: int, words, w_lo: int, w_hi: int) -> list:
    """The LM's ``n`` training sentences: the training text distribution,
    drawn text-only from ``default_rng(1)`` with the geometry of
    ``make_set(seed=1)`` (sentence i opens with word ``3 i mod |words|``)."""
    import numpy as np

    r = np.random.default_rng(1)
    corpus = []
    for i in range(n):
        k = int(r.integers(w_lo, w_hi))
        ids = [(i * 3) % len(words)] + list(r.integers(0, len(words), size=k - 1))
        corpus.append(" ".join(words[j] for j in ids))
    return corpus


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m trt_asr_tpu_torch.tools.gate_lm_eval",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--model-dir", default="artifacts/models/gate_r3")
    ap.add_argument("--out-dir", default=default_out_dir("gate_lm"))
    ap.add_argument("--eval-utts", type=int, default=30)
    ap.add_argument("--lm-train-utts", type=int, default=2000,
                    help="text-only sentences for LM fitting (the training "
                         "distribution, seed=1; no audio synthesized)")
    ap.add_argument("--vocab-size", type=int, default=1120)
    ap.add_argument("--words-per-utt", default="8,13")
    ap.add_argument("--snr-db", type=float, default=15.0)
    ap.add_argument("--beam", type=int, default=4)
    ap.add_argument("--order", type=int, default=3)
    ap.add_argument("--lm-weights", default="0,0.2,0.4")
    ap.add_argument("--stream-sim", type=float, default=0.5)
    ap.add_argument("--artifact", default="")
    add_device_args(ap)
    args = ap.parse_args(argv)
    device = str(tool_device(args))

    import numpy as np

    from trt_asr_tpu_torch.decode.ngram_lm import fit_from_text
    from trt_asr_tpu_torch.eval.suite import SuiteConfig, run_suite
    from trt_asr_tpu_torch.eval.synthetic import add_noise, make_set, make_words
    from trt_asr_tpu_torch.tokenizer import Tokenizer

    words = make_words(args.vocab_size)
    w_lo, w_hi = (int(x) for x in args.words_per_utt.split(","))

    corpus = lm_corpus(args.lm_train_utts, words, w_lo, w_hi)
    tok = Tokenizer.from_file(os.path.join(args.model_dir, "vocab.txt"))
    t0 = time.time()
    lm = fit_from_text(corpus, tok, order=args.order)
    lm_path = os.path.join(args.out_dir, "lm.json")
    os.makedirs(args.out_dir, exist_ok=True)
    lm.save(lm_path)
    print(f"LM: order-{args.order}, {len(lm.counts)} contexts from "
          f"{len(corpus)} sentences ({time.time()-t0:.1f}s)", flush=True)

    # noisy held-out set (the gate's seed=2 utterances + additive noise)
    evals = make_set(args.eval_utts, 2, words, w_lo, w_hi)
    nrng = np.random.default_rng(99)
    man = write_held_out(args.out_dir, words, evals,
                         noise=lambda a: add_noise(a, args.snr_db, nrng))

    rows = {}
    weights = [float(x) for x in args.lm_weights.split(",")]
    if 0.0 not in weights:
        # the unfused baseline anchors the verdict: run it even if the
        # caller listed only fused weights
        weights.insert(0, 0.0)
    for w in weights:
        label = f"beam{args.beam}_lm{w:g}"
        t0 = time.time()
        res = run_suite(SuiteConfig(
            manifest_path=man,
            out_dir=os.path.join(args.out_dir, f"suite_{label}"),
            model_dir=args.model_dir, engine="python",
            variants=["base"], rounds=1, stream_sim=args.stream_sim,
            feature_norm="none", beam=args.beam,
            lm_path=lm_path if w > 0 else "", lm_weight=w, device=device))
        wer = res["variants"]["base"][0]["wer"]
        rows[label] = {**{k: wer[k] for k in
                          ("wer", "substitutions", "insertions", "deletions",
                           "ref_words")},
                       "lm_weight": w,
                       "wall_sec": round(time.time() - t0, 1)}
        print(f"{label:16s}: WER {wer['wer']*100:6.2f}% "
              f"(S={wer['substitutions']} I={wer['insertions']} "
              f"D={wer['deletions']}) {rows[label]['wall_sec']}s", flush=True)

    base = rows[f"beam{args.beam}_lm0"]["wer"]
    # best over the fused rows only (w > 0): with the unfused row included,
    # "best <= base" would hold by construction
    fused = {k: v for k, v in rows.items() if v["lm_weight"] > 0}
    if not fused:
        print("no fused (w>0) rows — nothing to verdict", file=sys.stderr)
        return 2
    best_label = min(fused, key=lambda k: fused[k]["wer"])
    verdict = {
        "unfused_wer": base,
        "best_fused": {"label": best_label, "wer": rows[best_label]["wer"]},
        "fusion_never_hurts_at_best": rows[best_label]["wer"] <= base,
        "abs_improvement": base - rows[best_label]["wer"],
    }
    print(f"unfused {base*100:.2f}% -> best {best_label} "
          f"{rows[best_label]['wer']*100:.2f}%")
    if args.artifact:
        with open(args.artifact, "w") as f:
            json.dump({"config": vars(args), "snr_db": args.snr_db,
                       "rows": rows, "verdict": verdict}, f, indent=1)
        print(f"wrote {args.artifact}")
    return 0 if verdict["fusion_never_hurts_at_best"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
