"""The WER gate on the synthetic spoken-words task, for a trained model dir
(the evaluation half of ``tools/train_synthetic_e2e.py --skip-train``):

    python -m trt_asr_tpu_torch.eval.gate --model-dir artifacts/models/gate_r3 \\
        --surfaces python,batch,cli [--out-dir DIR] [--sabotage drop_time_carry] \\
        [--artifact gate.json] [--device cpu]

It synthesizes the held-out set (``make_set(eval_utts, 2, ...)``), writes
the clean wavs and manifest and a noisy copy (``add_noise`` at
``--noise-snr-db``, rng 99), and runs the eval suite over the matrix
surface x condition x variant x push granularity: the python surface
(``StreamingSession``) over every condition, variant and granularity; the
batch (``BatchStreamingEngine``, staggered attach and finalize) and cli
(``python -m trt_asr_tpu_torch.cli`` subprocesses) surfaces on the clean
set at the first granularity, the cli surface on the first
``--cli-eval-utts`` utterances and in fast mode (``TRT_ASR_QUANT=all
TRT_ASR_PALLAS_ATT=1``, as the JAX tool always runs its native surface).
The artifact (``--artifact``) has the JAX tool's keys: ``config``,
``vocab_size``, ``matrix`` (``surface/condition/variant/simX`` -> WER
counts) and ``gate_per_surface``. Exit 1 when a surface's clean gate row is
over ``--gate-wer`` or the python surface's transcript depends on the push
granularity, else 0. Training is not part of this module: the model dir is
evaluated as it is (the JAX tool's ``--skip-train`` mode, the only one
here; the flag is accepted and changes nothing, so that the tool's command
line runs unchanged). Runs on the CUDA device unless ``--device`` names
another.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import List

import numpy as np

from trt_asr_tpu_torch.config import env_overrides

FAST_ENV = {"TRT_ASR_QUANT": "all", "TRT_ASR_PALLAS_ATT": "1"}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m trt_asr_tpu_torch.eval.gate",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--model-dir", required=True, help="the trained model dir to gate")
    ap.add_argument("--out-dir", default="",
                    help="wavs, manifests and suite results (default: a new temporary dir)")
    ap.add_argument("--skip-train", action="store_true",
                    help="accepted for the JAX tool's command line: this module never "
                         "trains, it evaluates --model-dir as it is")
    ap.add_argument("--eval-utts", type=int, default=50)
    ap.add_argument("--vocab-size", type=int, default=0,
                    help="synthetic vocabulary size (0: the model's vocab_size)")
    ap.add_argument("--words-per-utt", default="8,13",
                    help="lo,hi(exclusive) words per utterance (gate_r3's profile: 8,13)")
    ap.add_argument("--gate-wer", type=float, default=0.05)
    ap.add_argument("--noise-snr-db", type=float, default=15.0,
                    help="also evaluate a noisy copy of the held-out set at this SNR "
                         "(<=0 disables)")
    ap.add_argument("--stream-sims", default="0.3,0.5,1.0",
                    help="comma list of push granularities (s); the transcript must "
                         "not depend on them")
    ap.add_argument("--surfaces", default="python",
                    help="comma list of python, batch, cli")
    ap.add_argument("--variants", default="base,nopunct,nocache,nocache_nopunct")
    ap.add_argument("--batch-size", type=int, default=4, help="slots for the batch surface")
    ap.add_argument("--cli-eval-utts", type=int, default=12,
                    help="the cli surface starts a process per utterance: gate it on the "
                         "first N held-out utterances")
    ap.add_argument("--cli-variants", default="base")
    ap.add_argument("--sabotage", default="",
                    help="fault injection (drop_time_carry): the gate must fail under it")
    ap.add_argument("--artifact", default="", help="write the suite-matrix JSON here")
    ap.add_argument("--device", default="",
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)
    for s in args.surfaces.split(","):
        if s.strip() not in ("", "python", "batch", "cli"):
            ap.error(f"unknown surface {s.strip()!r} (python, batch, cli)")
    return args


def _vocab_size(model_dir: str) -> int:
    with open(os.path.join(model_dir, "config.json")) as f:
        return int(json.load(f)["vocab_size"])


def write_eval_sets(out_dir: str, words: List[str], evals, noise_snr_db: float) -> dict:
    """The held-out wavs and manifests: ``eval_clean.tsv`` and, when
    ``noise_snr_db`` > 0, ``eval_noisy.tsv`` (noise from rng 99)."""
    from trt_asr_tpu_torch.eval.manifest import ManifestEntry, write_manifest
    from trt_asr_tpu_torch.eval.synthetic import add_noise
    from trt_asr_tpu_torch.io.wav import save_wav

    manifests = {}
    for tag, snr in (("clean", None), ("noisy", noise_snr_db)):
        if tag == "noisy" and (snr is None or snr <= 0):
            continue
        entries = []
        wav_dir = os.path.join(out_dir, f"wavs_{tag}")
        os.makedirs(wav_dir, exist_ok=True)
        nrng = np.random.default_rng(99)
        for i, (ids, audio) in enumerate(evals):
            a = add_noise(audio, snr, nrng) if snr else audio
            p = os.path.join(wav_dir, f"utt{i}.wav")
            save_wav(p, a)
            entries.append(ManifestEntry(p, " ".join(words[k] for k in ids)))
        man = os.path.join(out_dir, f"eval_{tag}.tsv")
        write_manifest(man, entries)
        manifests[tag] = man
    return manifests


def evaluate(args: argparse.Namespace) -> int:
    from trt_asr_tpu_torch.eval.manifest import read_manifest, write_manifest
    from trt_asr_tpu_torch.eval.suite import SuiteConfig, run_suite
    from trt_asr_tpu_torch.eval.synthetic import make_set, make_words

    out_dir = args.out_dir or tempfile.mkdtemp(prefix="wer_gate_")
    os.makedirs(out_dir, exist_ok=True)
    words = make_words(args.vocab_size or _vocab_size(args.model_dir))
    w_lo, w_hi = (int(x) for x in args.words_per_utt.split(","))
    evals = make_set(args.eval_utts, 2, words, w_lo, w_hi)
    manifests = write_eval_sets(out_dir, words, evals, args.noise_snr_db)

    variants = [v.strip() for v in args.variants.split(",") if v.strip()]
    sims = [float(s) for s in args.stream_sims.split(",") if s.strip()]
    surfaces = [s.strip() for s in args.surfaces.split(",") if s.strip()]
    matrix = {}
    # per-surface gate row: "base" when run, else the surface's first variant
    gate_variants = {}
    for surface in surfaces:
        surf_tags = manifests if surface == "python" else {"clean": manifests["clean"]}
        surf_sims = sims if surface == "python" else sims[:1]
        surf_variants = variants
        surf_env = {}
        if surface == "cli":
            surf_env = FAST_ENV
            surf_variants = [v.strip() for v in args.cli_variants.split(",") if v.strip()]
            if args.cli_eval_utts < len(evals):
                sub = read_manifest(manifests["clean"])[: args.cli_eval_utts]
                man_n = os.path.join(out_dir, "eval_clean_cli.tsv")
                write_manifest(man_n, sub)
                surf_tags = {"clean": man_n}
        gate_variants[surface] = "base" if "base" in surf_variants else surf_variants[0]
        with env_overrides(surf_env):
            for tag, man in surf_tags.items():
                for sim in surf_sims:
                    res = run_suite(SuiteConfig(
                        manifest_path=man,
                        out_dir=os.path.join(out_dir, f"suite_{surface}_{tag}_s{sim}"),
                        model_dir=args.model_dir, engine=surface,
                        batch_size=args.batch_size, variants=surf_variants, rounds=1,
                        stream_sim=sim, feature_norm="none", device=args.device))
                    for v in surf_variants:
                        wer = res["variants"][v][0]["wer"]
                        matrix[f"{surface}/{tag}/{v}/sim{sim}"] = wer
                        print(f"  {surface:6s} {tag:5s} {v:16s} sim={sim:.1f}: "
                              f"WER {wer['wer']*100:6.2f}% "
                              f"(S={wer['substitutions']} I={wer['insertions']} "
                              f"D={wer['deletions']} N={wer['ref_words']} "
                              f"empty={wer['empty_hypotheses']})", flush=True)

    gates = {s: matrix[f"{s}/clean/{gate_variants[s]}/sim{sims[0]}"] for s in surfaces}
    # streaming-granularity invariance across sims (python surface)
    sim_wers = ([matrix[f"python/clean/{gate_variants['python']}/sim{s}"]["wer"]
                 for s in sims] if "python" in surfaces else [])
    if args.artifact:
        with open(args.artifact, "w") as f:
            json.dump({"config": {**vars(args), "out_dir": out_dir},
                       "vocab_size": len(words), "matrix": matrix,
                       "gate_per_surface": {
                           s: {"wer": g["wer"], "variant": gate_variants[s],
                               "pass": g["wer"] <= args.gate_wer}
                           for s, g in gates.items()}}, f, indent=1)
        print(f"wrote {args.artifact}")
    for s, g in gates.items():
        print(f"HELD-OUT WER ({s}/clean/{gate_variants[s]}): {g['wer']*100:.2f}%")
    if sim_wers:
        print(f"granularity sweep: {[f'{w*100:.2f}%' for w in sim_wers]}")
    fails = {s: g["wer"] for s, g in gates.items() if g["wer"] > args.gate_wer}
    if fails:
        print(f"WER GATE FAIL ({fails} > {args.gate_wer})")
        return 1
    if sim_wers and max(sim_wers) - min(sim_wers) > 1e-9:
        print("WER GATE FAIL (transcript depends on push granularity)")
        return 1
    print("WER GATE PASS "
          + " ".join(f"{s}={g['wer']*100:.2f}%" for s, g in gates.items())
          + f" (<= {args.gate_wer*100:.0f}%)")
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    # --sabotage holds for the run only
    with env_overrides({"TRT_ASR_SABOTAGE": args.sabotage} if args.sabotage else {}):
        return evaluate(args)


if __name__ == "__main__":
    raise SystemExit(main())
