"""STT eval suite runner of the port, as the JAX package's ``eval/suite.py``:
a matrix of env-variant configurations x N rounds over a manifest, driving
an engine, collecting transcripts, partial counts and latencies, then WER
scoring per variant into ``suite_results.json`` (the same JSON).

Variants:
  base            — defaults
  nopunct         — leading-punct suppression off (TRT_ASR_ALLOW_LEADING_PUNCT=0)
  nocache         — streaming cache disabled
  nocache_nopunct — both

Engines: "python" (in-process ``StreamingSession``, or
``BeamStreamingSession`` when ``beam > 0``), "batch" (in-process
``BatchStreamingEngine``: utterances served concurrently in lockstep slots
with staggered attach and finalize), "cli" (``python -m
trt_asr_tpu_torch.cli`` as a subprocess, its ``Partial:``/``Final:``/
``Transcript:`` lines parsed), "native" (the port's C++ CLI,
``native/cli/main.cpp``, as a subprocess: its embedded interpreter drives
this package through ``runtime/capi_bridge.py``; the same lines parsed).

Runs on the CUDA device unless ``SuiteConfig.device`` names another; the
cli engine's subprocess picks its device as the CLI does (``--device`` is
passed only when one is named), the native engine's as the bridge does
(``JAX_PLATFORMS=cpu`` is set only when the CPU is named, ``cuda`` when
another device is). Run it as ``python -m trt_asr_tpu_torch.eval.suite
--manifest m.tsv --out-dir o ...`` (the flags of
``tools/stt_suite/run_suite.py``; ``--gate-wer`` exits 1 above the bar).
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from trt_asr_tpu_torch.config import RuntimeConfig, env_overrides
from trt_asr_tpu_torch.eval.manifest import ManifestEntry, read_manifest
from trt_asr_tpu_torch.eval.wer import score_corpus

VARIANTS: Dict[str, Dict[str, str]] = {
    "base": {},
    "nopunct": {"TRT_ASR_ALLOW_LEADING_PUNCT": "0"},
    "nocache": {"TRT_ASR_DISABLE_CACHE": "1"},
    "nocache_nopunct": {"TRT_ASR_DISABLE_CACHE": "1", "TRT_ASR_ALLOW_LEADING_PUNCT": "0"},
}


@dataclass
class SuiteConfig:
    manifest_path: str
    out_dir: str
    model_dir: str = ""
    engine: str = "python"            # python | cli | batch | native
    native_cli: str = ""              # engine="native": "" = the port's CLI,
                                      # built at first use (native/build.py)
    batch_size: int = 4               # engine="batch": concurrent slots
    variants: List[str] = field(default_factory=lambda: ["base"])
    rounds: int = 1
    stream_sim: float = 0.5
    feature_norm: str = "per_feature"
    verify_sha: bool = False
    synthetic_model: str = ""         # tiny|full for asset-free runs
    beam: int = 0                     # >0: the streaming beam session's 1-best
                                      # on the python/cli engines
    lm_path: str = ""                 # n-gram LM (ngram-lm/v1 JSON) for
                                      # shallow fusion; needs beam
    lm_weight: float = 0.6
    device: str = ""                  # "" = the CUDA device (raises without one)


def _parse_cli_stdout(stdout: str) -> Dict[str, object]:
    transcript, partials, finals = "", [], []
    for line in stdout.splitlines():
        if line.startswith("Partial: "):
            partials.append(line[len("Partial: "):])
        elif line.startswith("Final: "):
            finals.append(line[len("Final: "):])
        elif line.startswith("Transcript: "):
            transcript = line[len("Transcript: "):]
    return {"transcript": transcript, "num_partials": len(partials),
            "num_finals": len(finals)}


def _load_lm_cached(path: str):
    """Per-(path, mtime) memo: the python engine runs once per utterance
    per round, and an LM is parsed once."""
    return _load_lm_mtime(path, os.path.getmtime(path))


@functools.lru_cache(maxsize=4)
def _load_lm_mtime(path: str, _mtime: float):
    from trt_asr_tpu_torch.decode.ngram_lm import NGramLM

    return NGramLM.load(path)


def _run_python_engine(entry: ManifestEntry, model, variant_env: Dict[str, str],
                       cfg: SuiteConfig) -> Dict[str, object]:
    from trt_asr_tpu_torch.frontend.normalize import compute_per_feature_stats
    from trt_asr_tpu_torch.io.wav import load_wav
    from trt_asr_tpu_torch.streaming.session import StreamingSession

    with env_overrides(variant_env):
        rt = RuntimeConfig.from_env()
        audio = load_wav(entry.audio_path)
        norm_stats = None
        if cfg.feature_norm == "per_feature":
            full = model.frontend(audio)
            if full.shape[0] > 1:
                norm_stats = tuple(s.cpu().numpy() for s in compute_per_feature_stats(full))
        feature_norm = cfg.feature_norm if norm_stats is not None else "none"
        if cfg.beam > 0:
            from trt_asr_tpu_torch.streaming.beam_session import BeamStreamingSession

            lm_kw = {}
            if cfg.lm_path:
                lm_kw = dict(lm_fn=_load_lm_cached(cfg.lm_path), lm_weight=cfg.lm_weight)
            sess = BeamStreamingSession(model, beam=cfg.beam, runtime=rt,
                                        feature_norm=feature_norm, norm_stats=norm_stats,
                                        **lm_kw)
        else:
            sess = StreamingSession(model, rt, feature_norm=feature_norm,
                                    norm_stats=norm_stats)
        hop = max(int(cfg.stream_sim * 16000), 1600)
        n_partials = 0
        for s in range(0, len(audio), hop):
            sess.push_audio(audio[s: s + hop])
            while (ev := sess.poll_event()) is not None:
                n_partials += ev.type == 0
        sess.finalize()
        transcript = ""
        while (ev := sess.poll_event()) is not None:
            if ev.type == 1:
                transcript = ev.text
        return {"transcript": transcript, "num_partials": n_partials,
                "latency_ms": sess.chunk_latencies_ms}


def _run_batch_engine(entries: List[ManifestEntry], model, variant_env: Dict[str, str],
                      cfg: SuiteConfig) -> List[Dict[str, object]]:
    """Serve the whole manifest through a ``BatchStreamingEngine``: groups
    of ``batch_size`` utterances share lockstep steps, each stream attaching
    staggered (slot k starts k steps late) and finalizing independently as
    its audio drains: mid-flight attach and a flush beside steady chunks,
    the serving pattern."""
    from trt_asr_tpu_torch.io.wav import load_wav
    from trt_asr_tpu_torch.streaming.batch_engine import BatchStreamingEngine

    with env_overrides(variant_env):
        rt = RuntimeConfig.from_env()
        eng = BatchStreamingEngine(model, batch_size=cfg.batch_size, runtime=rt)
        out: List[Dict[str, object]] = []
        for g0 in range(0, len(entries), cfg.batch_size):
            group = entries[g0: g0 + cfg.batch_size]
            audios = [load_wav(e.audio_path) for e in group]
            hop = max(int(cfg.stream_sim * 16000), 1600)
            sids = [None] * len(group)
            offs = [0] * len(group)
            fin = [False] * len(group)
            steps = 0
            while not all(fin):
                for k in range(len(group)):
                    if sids[k] is None:
                        if steps >= k:          # staggered attach
                            sids[k] = eng.open_stream()
                        else:
                            continue
                    if offs[k] < len(audios[k]):
                        eng.push_audio(sids[k], audios[k][offs[k]: offs[k] + hop])
                        offs[k] += hop
                    elif not fin[k]:
                        eng.finalize_stream(sids[k])
                        fin[k] = True
                eng.step()
                steps += 1
                if steps > 100000:
                    raise RuntimeError("batch suite drive did not drain")
            eng.run_until_drained()
            for k, e in enumerate(group):
                transcript, n_partials = "", 0
                while (ev := eng.poll_event(sids[k])) is not None:
                    if ev.type == 0:
                        n_partials += 1
                    elif ev.type == 1:
                        transcript = ev.text
                out.append({"transcript": transcript, "num_partials": n_partials,
                            "audio_path": e.audio_path, "reference": e.transcript})
                eng.close_stream(sids[k])
        # batch step latencies are engine-global, not per-utterance
        if eng.step_latencies_ms:
            out[0]["latency_ms"] = list(eng.step_latencies_ms)
        return out


def _run_subprocess_engine(entry: ManifestEntry, variant_env: Dict[str, str],
                           cfg: SuiteConfig) -> Dict[str, object]:
    env = dict(os.environ)
    env.update(variant_env)
    if cfg.engine == "native":
        from trt_asr_tpu_torch.native.build import build, embed_env

        # the embedded interpreter imports this package and torch from its
        # PYTHONPATH: the repository root and this interpreter's packages
        env = embed_env(env)
        if cfg.device:
            env["JAX_PLATFORMS"] = "cpu" if cfg.device == "cpu" else "cuda"
        cmd = [cfg.native_cli or str(build().cli), entry.audio_path,
               "--model-dir", cfg.model_dir, "--stream-sim", str(cfg.stream_sim),
               "--no-sleep", "--feature-norm", cfg.feature_norm]
    else:
        # `python -m trt_asr_tpu_torch.cli` runs cwd-free with the repository
        # root on PYTHONPATH (prepended, existing entries kept)
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = (repo_root + os.pathsep + env["PYTHONPATH"]
                             if env.get("PYTHONPATH") else repo_root)
        cmd = [sys.executable, "-m", "trt_asr_tpu_torch.cli", entry.audio_path,
               "--stream-sim", str(cfg.stream_sim), "--no-sleep",
               "--feature-norm", cfg.feature_norm]
        if cfg.beam > 0:
            cmd += ["--beam", str(cfg.beam)]
            if cfg.lm_path:
                cmd += ["--lm", cfg.lm_path, "--lm-weight", str(cfg.lm_weight)]
        if cfg.model_dir:
            cmd += ["--model-dir", cfg.model_dir]
        elif cfg.synthetic_model:
            cmd += ["--synthetic-model", cfg.synthetic_model]
        if cfg.device:
            cmd += ["--device", cfg.device]
    out = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=1200)
    r = _parse_cli_stdout(out.stdout)
    r["returncode"] = out.returncode
    if out.returncode != 0:
        r["stderr_tail"] = out.stderr[-1000:]
    return r


def run_suite(cfg: SuiteConfig) -> Dict[str, object]:
    os.makedirs(cfg.out_dir, exist_ok=True)
    entries = read_manifest(cfg.manifest_path, verify_sha=cfg.verify_sha)

    if cfg.engine == "batch" and cfg.feature_norm != "none":
        raise ValueError("engine='batch' streams raw audio per slot; "
                         "per-utterance feature_norm is a session-surface "
                         "feature — use feature_norm='none'")
    if cfg.beam > 0 and cfg.engine in ("batch", "native"):
        raise ValueError("beam decoding is a python-session surface "
                         "(streaming/beam_session.py); engines 'batch' "
                         "(lockstep greedy program) and 'native' (no --beam "
                         "flag) decode greedy-only")
    if cfg.engine not in ("python", "batch", "cli", "native"):
        raise ValueError(f"unknown engine {cfg.engine!r}")
    model = None
    if cfg.engine in ("python", "batch"):
        from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT

        device = cfg.device or None
        if cfg.model_dir:
            model = ParakeetTDT.from_model_dir(cfg.model_dir, device=device)
        else:
            from trt_asr_tpu_torch.config import ModelConfig
            mc = ModelConfig.tiny() if cfg.synthetic_model != "full" else ModelConfig()
            model = ParakeetTDT.random(mc, device=device)

    results: Dict[str, object] = {"config": {
        "manifest": cfg.manifest_path, "engine": cfg.engine,
        "variants": cfg.variants, "rounds": cfg.rounds,
        "stream_sim": cfg.stream_sim, "feature_norm": cfg.feature_norm,
        "beam": cfg.beam, "num_utterances": len(entries)}, "variants": {}}

    for variant in cfg.variants:
        venv = VARIANTS[variant]
        rounds_out = []
        for rnd in range(cfg.rounds):
            utts = []
            t0 = time.time()
            if cfg.engine == "batch":
                utts = _run_batch_engine(entries, model, venv, cfg)
            else:
                for entry in entries:
                    if cfg.engine == "python":
                        r = _run_python_engine(entry, model, venv, cfg)
                    else:
                        r = _run_subprocess_engine(entry, venv, cfg)
                    r["audio_path"] = entry.audio_path
                    r["reference"] = entry.transcript
                    utts.append(r)
            wall = time.time() - t0
            wer = score_corpus((u["reference"], u["transcript"]) for u in utts)
            lat_all = [x for u in utts for x in u.get("latency_ms", [])]
            audio_sec = sum(e.duration_sec for e in entries)
            rounds_out.append({
                "round": rnd, "wer": {k: v for k, v in wer.items() if k != "per_utterance"},
                "wall_sec": wall,
                "rtfx": (audio_sec / wall) if wall > 0 and audio_sec > 0 else None,
                "latency_ms": ({
                    "p50": float(np.percentile(lat_all, 50)),
                    "p95": float(np.percentile(lat_all, 95)),
                    "mean": float(np.mean(lat_all)),
                } if lat_all else None),
                "utterances": utts,
            })
        results["variants"][variant] = rounds_out

    out_path = os.path.join(cfg.out_dir, "suite_results.json")
    with open(out_path, "w") as f:
        json.dump(results, f, indent=1)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m trt_asr_tpu_torch.eval.suite",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--manifest", required=True)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--model-dir", default="")
    ap.add_argument("--synthetic-model", default="", choices=["", "tiny", "full"])
    ap.add_argument("--engine", default="python", choices=["python", "cli", "native", "batch"])
    ap.add_argument("--native-cli", default="",
                    help="engine=native's binary (default: the port's trt_asr_cli, "
                         "built at first use)")
    ap.add_argument("--batch-size", type=int, default=4,
                    help="engine=batch: concurrent lockstep slots")
    ap.add_argument("--beam", type=int, default=0,
                    help=">0: streaming beam decoding (python/cli engines)")
    ap.add_argument("--variants", default="base")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--stream-sim", type=float, default=0.5)
    ap.add_argument("--feature-norm", default="per_feature", choices=["none", "per_feature"])
    ap.add_argument("--verify-sha", action="store_true")
    ap.add_argument("--gate-wer", type=float, default=None,
                    help="exit 1 if base-variant WER exceeds this fraction")
    ap.add_argument("--device", default="",
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)

    cfg = SuiteConfig(
        manifest_path=args.manifest, out_dir=args.out_dir,
        model_dir=args.model_dir, engine=args.engine,
        variants=args.variants.split(","), rounds=args.rounds,
        stream_sim=args.stream_sim, feature_norm=args.feature_norm,
        verify_sha=args.verify_sha, synthetic_model=args.synthetic_model,
        native_cli=args.native_cli, batch_size=args.batch_size, beam=args.beam,
        device=args.device)
    results = run_suite(cfg)

    worst = 0.0
    for variant, rounds in results["variants"].items():
        for r in rounds:
            w = r["wer"]["wer"]
            lat = r.get("latency_ms") or {}
            print(f"{variant} round {r['round']}: WER={w*100:.2f}% "
                  f"empty={r['wer']['empty_hypotheses']} "
                  f"rtfx={r['rtfx'] if r['rtfx'] is None else round(r['rtfx'], 1)} "
                  f"lat_p50={lat.get('p50')}")
            if variant == "base":
                worst = max(worst, w)
    if args.gate_wer is not None and worst > args.gate_wer:
        print(f"WER GATE FAIL: {worst:.4f} > {args.gate_wer}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
