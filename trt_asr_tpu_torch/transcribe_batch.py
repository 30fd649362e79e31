"""Batch offline transcription over ``ParakeetTDT.transcribe_batch``:

    python -m trt_asr_tpu_torch.transcribe_batch a.wav b.wav ... \
        [--model-dir DIR | --synthetic-model tiny|full] \
        [--norm none|per_feature] [--batch 32] [--json] [--device cpu]

One padded feature batch per ``--batch`` group: one batched encoder pass
and a lockstep batched TDT greedy decode; rows are token-exact with
per-utterance decoding. Runs on the CUDA device unless ``--device`` names
another. Prints ``path<TAB>text`` (or one JSON object) per utterance and a
throughput line on stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("wavs", nargs="+")
    ap.add_argument("--model-dir", default="")
    ap.add_argument("--synthetic-model", default="", choices=["", "tiny", "full"],
                    help="random weights (seed 0) at ModelConfig.tiny() or ModelConfig()")
    ap.add_argument("--norm", default="per_feature", choices=["none", "per_feature"])
    ap.add_argument("--batch", type=int, default=32, help="utterances per padded batch")
    ap.add_argument("--json", action="store_true",
                    help="one JSON object per line instead of TSV")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from trt_asr_tpu_torch.config import ModelConfig, RuntimeConfig
    from trt_asr_tpu_torch.io.wav import load_wav
    from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT

    rt = RuntimeConfig.from_env()
    if args.model_dir:
        model = ParakeetTDT.from_model_dir(args.model_dir, runtime=rt, device=args.device)
    elif args.synthetic_model:
        cfg = ModelConfig.tiny() if args.synthetic_model == "tiny" else ModelConfig()
        model = ParakeetTDT.random(cfg, runtime=rt, device=args.device)
    else:
        ap.error("provide --model-dir or --synthetic-model")

    t0 = time.perf_counter()
    audio_sec = 0.0
    for g0 in range(0, len(args.wavs), args.batch):
        paths = args.wavs[g0:g0 + args.batch]
        audios = [load_wav(p) for p in paths]
        audio_sec += sum(len(a) for a in audios) / 16000.0
        for path, (text, ids) in zip(paths, model.transcribe_batch(audios, norm=args.norm)):
            if args.json:
                print(json.dumps({"audio": path, "text": text, "tokens": ids}), flush=True)
            else:
                print(f"{path}\t{text}", flush=True)
    wall = time.perf_counter() - t0
    rtfx = audio_sec / wall if wall > 0 else float("inf")
    print(f"# {len(args.wavs)} utterances, {audio_sec:.1f}s audio, {wall:.2f}s wall, "
          f"RTFx={rtfx:.1f} on {model.device}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
