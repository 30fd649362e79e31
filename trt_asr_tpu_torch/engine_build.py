"""Engine set build and inspection, the port's counterpart of
``tools/engine_build.py``: every chunk program a streaming session runs
(and one lockstep program per ``--batch`` size, the daemon's), with the
kernel libraries they launch, into an engine directory:

    python -m trt_asr_tpu_torch.engine_build --model-dir artifacts/models/gate_r3 \\
        --outdir ENGINES [--batch 4] [--cache-dir CACHE] [--no-smoke] [--device cpu]
    python -m trt_asr_tpu_torch.engine_build --inspect ENGINES

Numerics and kernel flags come from the runtime knobs the server reads
(``TRT_ASR_PALLAS_*``, ``TRT_ASR_QUANT``, ``TRT_ASR_COMPUTE_DTYPE`` ...).
``--cache-dir`` builds the libraries into that compile cache first
(``apply_compile_cache``), so a later process pointed at it finds them
built. Runs on the card unless ``--device`` names another; built without a
card, the set holds no library (a serving process builds its own).
"""

from __future__ import annotations

import argparse
import json
import os
import time


def inspect(engine_dir: str) -> int:
    from trt_asr_tpu_torch.runtime.engine import EngineSet

    with open(os.path.join(engine_dir, "manifest.json")) as f:
        manifest = json.load(f)
    b = manifest["build"]
    print(f"build: torch {b['torch']} cuda {b['cuda']} | {b['platform']} ({b['device']}) | "
          f"{b['num_programs']} programs | quant {b['quant']} | weights "
          f"{','.join(b['weights_dtype'])} | kernels "
          + " ".join(k for k, v in b["kernel_flags"].items() if v))
    es = EngineSet.load(engine_dir)          # verifies every sha256 and source hash
    libs = manifest["libraries"]
    print(f"loaded + sha256-verified {len(es)} programs, {len(libs)} kernel libraries "
          f"({sum(e['bytes'] for e in libs.values())} bytes)")
    for name, e in manifest["engines"].items():
        rec = es.get(e["key"])
        print(f"\n[{name}] {e['file']}  {e['bytes']} bytes  key={e['key']}")
        print(f"  feats {e['feats_shape']}  statics "
              + " ".join(f"{k}={v}" for k, v in sorted(e["statics"].items())))
        print(f"  inputs:  {len(rec['inputs'])} tensors")
        outs = [f"{o[0]} {' '.join(map(str, o[1:]))}" for o in rec["outputs"]]
        print(f"  outputs: {len(outs)}: " + ", ".join(outs[:4])
              + (" ..." if len(outs) > 4 else ""))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model-dir", help="ParakeetTDT model dir (config.json + params)")
    ap.add_argument("--config", default="tiny", choices=["tiny", "full"],
                    help="random-weights config when no --model-dir")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--outdir", help="engine output directory")
    ap.add_argument("--cache-dir", default="",
                    help="build the kernel libraries into this compile cache too")
    ap.add_argument("--batch", default="",
                    help="comma-separated batch sizes: also build the lockstep program per "
                         "size (the serving daemon's engine; serve --engines)")
    ap.add_argument("--no-smoke", action="store_true",
                    help="skip each program's run through the loaded set")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--inspect", metavar="DIR",
                    help="inspect an existing engine dir instead of building")
    args = ap.parse_args(argv)

    if args.inspect:
        return inspect(args.inspect)
    if not args.outdir:
        ap.error("--outdir is required to build")

    from trt_asr_tpu_torch.config import ModelConfig
    from trt_asr_tpu_torch.device import resolve_device
    from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT
    from trt_asr_tpu_torch.runtime.engine import apply_compile_cache, build_engines

    dev = resolve_device(args.device)
    if args.cache_dir:
        apply_compile_cache(args.cache_dir)
    t0 = time.perf_counter()
    if args.model_dir:
        model = ParakeetTDT.from_model_dir(args.model_dir, device=dev)
    else:
        cfg = ModelConfig.tiny() if args.config == "tiny" else ModelConfig()
        model = ParakeetTDT.random(cfg, seed=args.seed, device=dev)
    batch_sizes = tuple(int(x) for x in args.batch.split(",") if x)
    manifest = build_engines(model, args.outdir, smoke=not args.no_smoke,
                             batch_sizes=batch_sizes)
    if args.cache_dir:
        manifest["build"]["compile_cache"] = {
            "dir": args.cache_dir,
            "entries": sorted(p for p in os.listdir(args.cache_dir) if p.endswith(".so"))}
        with open(os.path.join(args.outdir, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
    wall = time.perf_counter() - t0
    files = list(manifest["engines"].values()) + list(manifest["libraries"].values())
    print(f"built {len(manifest['engines'])} programs and {len(manifest['libraries'])} "
          f"kernel libraries ({sum(e['bytes'] for e in files)} bytes) in {wall:.1f}s "
          f"-> {args.outdir}")
    for name, e in manifest["engines"].items():
        smoke = e.get("smoke", {}).get("ok", "skipped")
        print(f"  {name:8s} {e['bytes']:8d} B  run {e['run_s']:6.2f}s  smoke={smoke}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
