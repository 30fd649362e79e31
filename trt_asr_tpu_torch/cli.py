"""Replay CLI of the port, as the JAX package's ``cli.py`` on its greedy path:

    python -m trt_asr_tpu_torch.cli <input> --model-dir DIR [--stream-sim S]
        [--raw-pcm] [--features-input] [--feature-norm none|per_feature]
        [--dump-features PATH] [--no-sleep] [--synthetic-model tiny|full]
        [--timestamps] [--continuous] [--srt PATH] [--vtt PATH]
        [--beam N [--beam-device] [--bias P1,P2 [--bias-bonus B] | --lm F
        [--lm-weight W]]] [--compile-cache DIR] [--device cuda|cpu]

Prints ``Partial:`` / ``Final:`` / ``Transcript:`` lines (``Word:`` with
--timestamps, ``Segment:`` with --continuous, ``NBest: <score> <text>``
after the transcript with --beam) and ``ChunkLatencyMs:`` on stderr. Runs
on the CUDA device unless ``--device`` names another; without a card it
raises. Kernel flags come from the environment (``TRT_ASR_PALLAS_ATT=1``
and the like, ``RuntimeConfig.from_env``); the beam width also from
``TRT_ASR_BEAM``. ``--compile-cache DIR`` (over ``TRT_ASR_COMPILE_CACHE``)
builds the kernel libraries into DIR and loads them from there, so a later
run finds them built (``runtime/engine.py`` ``apply_compile_cache``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import wave

import numpy as np

from trt_asr_tpu_torch.config import ModelConfig, RuntimeConfig
from trt_asr_tpu_torch.device import resolve_device
from trt_asr_tpu_torch.frontend.normalize import compute_per_feature_stats
from trt_asr_tpu_torch.io.resample import load_audio
from trt_asr_tpu_torch.io.subtitles import (cues_from_segments, format_srt, format_vtt,
                                            pack_cues)
from trt_asr_tpu_torch.io.wav import load_raw_pcm_f32, load_wav
from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT
from trt_asr_tpu_torch.streaming.continuous import ContinuousTranscriber
from trt_asr_tpu_torch.streaming.beam_session import BeamStreamingSession
from trt_asr_tpu_torch.streaming.session import EventType, StreamingSession


def _load_features_replay(path: str, n_mels: int) -> np.ndarray:
    """Raw f32 features and their JSON sidecar: layout bins_major [C,T] or
    frames_major [T,C]."""
    layout, frames, bins = "frames_major", None, n_mels
    try:
        with open(path + ".json") as f:
            meta = json.load(f)
        layout = meta.get("layout", layout)
        frames = meta.get("frames")
        bins = meta.get("bins", bins)
    except FileNotFoundError:
        pass
    raw = np.fromfile(path, dtype="<f4")
    if frames is None:
        frames = raw.size // bins
    a = raw[:frames * bins]
    return a.reshape(bins, frames).T if layout == "bins_major" else a.reshape(frames, bins)


def _drain(sess: StreamingSession) -> None:
    while (ev := sess.poll_event()) is not None:
        if ev.type == EventType.PARTIAL_TEXT:
            print(f"Partial: {ev.text}", flush=True)
        elif ev.type == EventType.FINAL_TEXT:
            print(f"Final: {ev.text}", flush=True)
        elif ev.type == EventType.ERROR:
            print(f"Error: {ev.error_message}", file=sys.stderr, flush=True)


def _print_timestamps(sess: StreamingSession, args) -> None:
    if not args.timestamps:
        return
    for w in sess.word_timestamps():
        print(f"Word: [{w['start_s']:.2f} {w['end_s']:.2f}] {w['word']}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="trt-asr-tpu-torch-cli",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("input")
    ap.add_argument("--model-dir", default="")
    ap.add_argument("--synthetic-model", choices=["tiny", "full"], default="",
                    help="random weights (seed 0) at ModelConfig.tiny() or ModelConfig()")
    ap.add_argument("--stream-sim", type=float, default=0.0,
                    help="chunk size in seconds; 0 = offline one-shot")
    ap.add_argument("--raw-pcm", action="store_true")
    ap.add_argument("--features-input", action="store_true")
    ap.add_argument("--feature-norm", choices=["none", "per_feature"],
                    default=os.environ.get("TRT_ASR_FEATURE_NORM",
                                           os.environ.get("PARAKEET_FEATURE_NORM",
                                                          "per_feature")),
                    help="overrides the TRT_ASR_FEATURE_NORM / PARAKEET_FEATURE_NORM default")
    ap.add_argument("--dump-features", default="")
    ap.add_argument("--no-sleep", action="store_true",
                    help="stream-sim without real-time pacing")
    ap.add_argument("--timestamps", action="store_true",
                    help="print word [start end] timings after the transcript")
    ap.add_argument("--srt", default="", help="write SRT subtitles from the word timestamps")
    ap.add_argument("--vtt", default="", help="write WebVTT subtitles (see --srt)")
    ap.add_argument("--continuous", action="store_true",
                    help="energy-endpointed continuous mode: one 'Segment: [start end] "
                         "text' line per utterance (forces --feature-norm none)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--beam", type=int, default=0,
                    help="beam width; 0 (default) decodes greedy, > 0 with the streaming "
                         "beam session and prints NBest lines")
    ap.add_argument("--beam-device", action="store_true",
                    help="run the beam search on the device (decode/beam_device.py); "
                         "--lm/--bias compile to device tables")
    ap.add_argument("--bias", default="",
                    help="comma-separated hotword phrases boosted during beam decoding "
                         "(requires --beam N)")
    ap.add_argument("--bias-bonus", type=float, default=3.0,
                    help="log-prob reward per matched token for --bias")
    ap.add_argument("--lm", default="",
                    help="n-gram LM file (ngram-lm/v1 JSON) for shallow fusion; "
                         "requires --beam N")
    ap.add_argument("--lm-weight", type=float, default=0.6, help="fusion weight for --lm")
    ap.add_argument("--compile-cache", default="",
                    help="kernel library directory (over TRT_ASR_COMPILE_CACHE): built "
                         "there once, loaded from there after")
    args = ap.parse_args(argv)

    if args.feature_norm not in ("none", "per_feature"):
        # argparse checks a flag's value against choices, but not a default
        # taken from the environment
        ap.error(f"invalid feature norm {args.feature_norm!r} "
                 f"(TRT_ASR_FEATURE_NORM/PARAKEET_FEATURE_NORM env?)")
    rt = RuntimeConfig.from_env()
    if args.compile_cache:
        rt.compile_cache_dir = args.compile_cache   # the flag over the environment
    beam = args.beam if args.beam > 0 else rt.beam_width   # the flag over the environment
    # beam 1 is exact greedy (one argmax successor a step): an LM or bias
    # score could never change a token there
    if args.bias and beam <= 1:
        ap.error("--bias requires beam decoding with --beam >= 2 "
                 "(beam 1 is exact greedy; fusion cannot apply)")
    if args.lm and beam <= 1:
        ap.error("--lm requires beam decoding with --beam >= 2 "
                 "(beam 1 is exact greedy; fusion cannot apply)")
    if args.lm and args.bias:
        ap.error("--lm and --bias both supply the fusion lm_fn; pick one")
    if args.beam_device and beam <= 0:
        ap.error("--beam-device requires --beam N")
    device = resolve_device(args.device)
    if args.model_dir:
        model = ParakeetTDT.from_model_dir(args.model_dir, runtime=rt, device=device)
    elif args.synthetic_model:
        cfg = ModelConfig.tiny() if args.synthetic_model == "tiny" else ModelConfig()
        model = ParakeetTDT.random(cfg, runtime=rt, device=device)
    else:
        ap.error("provide --model-dir or --synthetic-model")

    def make_session(**kw) -> StreamingSession:
        if beam <= 0:
            return StreamingSession(model, **kw)
        lm_kw = {}
        if args.bias:
            from trt_asr_tpu_torch.decode.biasing import make_biasing_lm

            lm_kw = dict(lm_fn=make_biasing_lm(args.bias.split(","), model.tokenizer,
                                               bonus=args.bias_bonus), lm_weight=1.0)
        elif args.lm:
            from trt_asr_tpu_torch.decode.ngram_lm import NGramLM

            lm_kw = dict(lm_fn=NGramLM.load(args.lm), lm_weight=args.lm_weight)
        return BeamStreamingSession(model, beam=beam, device=args.beam_device, **lm_kw, **kw)

    def write_subs(cues) -> None:
        if args.srt:
            with open(args.srt, "w") as fh:
                fh.write(format_srt(cues))
        if args.vtt:
            with open(args.vtt, "w") as fh:
                fh.write(format_vtt(cues))

    def finish(sess: StreamingSession) -> None:
        print(f"Transcript: {sess.text}", flush=True)
        if beam > 0:
            for text, _ids, score in sess.nbest():
                print(f"NBest: {score:.4f} {text}", flush=True)
        _print_timestamps(sess, args)
        if args.srt or args.vtt:
            write_subs(pack_cues(sess.word_timestamps()))

    # ---- feature replay ----
    if args.features_input:
        feats = _load_features_replay(args.input, model.cfg.feat_in)
        sess = make_session(runtime=rt, feature_norm="none")
        for start in range(0, feats.shape[0], 256):
            sess.push_features(feats[start:start + 256])
            _drain(sess)
        sess.finalize()
        _drain(sess)
        finish(sess)
        return 0

    # ---- audio ----
    if args.raw_pcm:
        audio = load_raw_pcm_f32(args.input)
    else:
        with wave.open(args.input, "rb") as w:
            in_rate = w.getframerate()
        if in_rate != 16000:
            print(f"note: resampling {in_rate} Hz -> 16000 Hz", file=sys.stderr)
            audio = load_audio(args.input)
        else:
            audio = load_wav(args.input)

    if args.continuous:
        ct = ContinuousTranscriber(make_session(runtime=rt, feature_norm="none"))
        hop = (max(int(args.stream_sim * 16000), 1) if args.stream_sim > 0
               else max(len(audio), 1))
        for start in range(0, len(audio), hop):
            ct.push_audio(audio[start:start + hop])
        ct.flush()
        for seg in ct.segments:
            print(f"Segment: [{seg['start_s']:.2f} {seg['end_s']:.2f}] {seg['text']}",
                  flush=True)
        print(f"Transcript: {' '.join(s['text'] for s in ct.segments if s['text'])}",
              flush=True)
        if args.srt or args.vtt:
            write_subs(cues_from_segments(ct.segments))
        return 0

    if args.dump_features:
        feats = model.features(audio, norm=args.feature_norm).cpu().numpy()
        feats.astype("<f4").tofile(args.dump_features)
        with open(args.dump_features + ".json", "w") as f:
            json.dump({"layout": "frames_major", "frames": int(feats.shape[0]),
                       "bins": int(feats.shape[1])}, f)

    norm_stats = None
    if args.feature_norm == "per_feature":
        # statistics over the whole utterance, applied chunk by chunk (not
        # streaming-safe, as in the reference CLI)
        full = model.frontend(audio)
        if full.shape[0] > 1:
            norm_stats = tuple(s.cpu().numpy() for s in compute_per_feature_stats(full))
    feature_norm = args.feature_norm if norm_stats is not None else "none"
    sess = make_session(runtime=rt, feature_norm=feature_norm, norm_stats=norm_stats)

    if args.stream_sim > 0:
        hop = int(args.stream_sim * 16000)
        t_wall = time.monotonic()
        for i, start in enumerate(range(0, len(audio), hop)):
            sess.push_audio(audio[start:start + hop])
            _drain(sess)
            if not args.no_sleep:
                next_t = t_wall + (i + 1) * args.stream_sim
                time.sleep(max(0.0, next_t - time.monotonic()))
    else:
        sess.push_audio(audio)
        _drain(sess)
    sess.finalize()
    _drain(sess)
    finish(sess)
    lat = sess.chunk_latencies_ms
    if lat:
        print(f"ChunkLatencyMs: p50={np.percentile(lat, 50):.2f} "
              f"p95={np.percentile(lat, 95):.2f} n={len(lat)}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
