"""Golden checks of this package against the repository's committed goldens
(``artifacts/goldens/``): the streaming encoder against
``streaming_encoder_reference.jsonl`` and the TDT decode trace against
``tdt_trace.jsonl``.

    python -m trt_asr_tpu_torch.parity \\
        --goldens artifacts/goldens/streaming_encoder_reference.jsonl \\
        --mode closedloop|functional [--config tiny --seed 1 | --model-dir DIR] \\
        [--kernels] [--dtype f32|bf16] [--atol A] [--cache-atol A] \\
        [--max-chunks N] [--summary out.json] [--device cpu]
    python -m trt_asr_tpu_torch.parity --mode trace \\
        [--goldens artifacts/goldens/tdt_trace.jsonl] [--out trace.jsonl] \\
        [--config tiny --seed 1] [--frames 300] [--feats-seed 0]

The encoder modes are those of the JAX package's
``tools/parity/streaming_parity.py``: ``functional`` starts every chunk
from the golden's cache inputs (per-chunk numerics), ``closedloop`` feeds
the package's own caches forward from the first chunk's (drift). Each
chunk is held to the contract's checks (encoded lengths, cache length in
bounds and equal to the golden's) and to ``--atol`` on the encoder output
and the channel cache and ``--cache-atol`` on the time cache; the summary
reports the contract's tolerance ladder (``rung_verdicts``, ``best_rung``)
under the JAX tool's keys. ``--kernels`` runs the attention-block kernel
on the steady chunks and the FFN and conv-module kernels on every chunk,
as the session does. Exit 0 iff every chunk passes.

``--mode trace`` is the counterpart of ``tools/parity/jax_tdt_trace.py``
and of the trace half of ``gen_goldens.py``: seeded features (``--frames``,
``--feats-seed``) through ``offline_encode`` and the host reference decode
(``decode/host_decode.py``) with this package's joint and predictor; the
trace is written in the golden's format (``--out``) and, with
``--goldens``, compared by first divergence (``debug/tdt_trace.py``).
Exit 0 iff it is IDENTICAL (or, without goldens, written).

Runs on the card unless ``--device`` names another device; without a
card it raises, and never carries on on the CPU by itself.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from trt_asr_tpu_torch.config import ModelConfig, RuntimeConfig
from trt_asr_tpu_torch.contract import load_contract
from trt_asr_tpu_torch.debug.tdt_trace import compare_traces, write_ndjson
from trt_asr_tpu_torch.decode.host_decode import tdt_greedy_decode_host
from trt_asr_tpu_torch.device import resolve_device
from trt_asr_tpu_torch.io.fixtures import read_jsonl
from trt_asr_tpu_torch.models.parakeet.encoder import (encode, offline_encode,
                                                       precompute_pos_proj,
                                                       state_from_contract, state_to_contract)
from trt_asr_tpu_torch.models.parakeet.joint import joint_single_step
from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT
from trt_asr_tpu_torch.models.parakeet.params import init_params_numpy
from trt_asr_tpu_torch.models.parakeet.predictor import predictor_step
from trt_asr_tpu_torch.ops.conv import subsampled_length
from trt_asr_tpu_torch.streaming.session import _round_up
from trt_asr_tpu_torch.tokenizer import Tokenizer, make_synthetic_vocab


def load_model(device, *, model_dir: str = "", config: str = "tiny", seed: int = 1,
               kernels: bool = False, dtype: str = "f32") -> ParakeetTDT:
    """The model under test: a model dir, or seeded weights at the tiny or
    full config (the JAX package's ``init_params(cfg, seed)`` weights);
    ``kernels`` packs the layers for the attention, FFN and conv kernels;
    ``dtype="bf16"`` casts as ``cast_params_for_compute`` does."""
    rt = RuntimeConfig(use_pallas_att=kernels, use_pallas_ffn=kernels,
                       use_pallas_conv=kernels)
    wdt = torch.bfloat16 if dtype == "bf16" else None
    if model_dir:
        return ParakeetTDT.from_model_dir(model_dir, runtime=rt, device=device,
                                          weights_dtype=wdt)
    cfg = ModelConfig.tiny() if config == "tiny" else ModelConfig()
    tok = Tokenizer(make_synthetic_vocab(cfg.vocab_size), blank_id=cfg.blank_id)
    return ParakeetTDT(cfg, init_params_numpy(cfg, seed=seed), tok, runtime=rt, device=device,
                       weights_dtype=wdt)


def encoder_parity(model: ParakeetTDT, records: List[Dict], *, mode: str, atol: float,
                   cache_atol: float, kernels: bool = False, dtype: str = "f32") -> Dict:
    """Run every golden chunk record through the streaming encoder; returns
    the summary (the JAX tool's keys; ``per_chunk`` holds each chunk's
    errors, contract errors and host ms)."""
    cfg, dev = model.cfg, model.device
    cdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    frames = cfg.chunk_size_frames[1] + cfg.pre_encode_cache_size[1]
    tq_steady = subsampled_length(frames, cfg.stride_stages) - cfg.drop_extra_pre_encoded
    tq_pad = _round_up(tq_steady, 8)
    pos_kernel = (precompute_pos_proj(model.params, cfg, tq_pad, cfg.att_cache_size,
                                      compute_dtype=cdt) if kernels else None)
    state, results = None, []
    for rec in records:
        ins, outs = rec["inputs"], rec["outputs"]
        x = ins["audio_features"]
        x = x[None] if x.ndim == 2 else x
        if mode == "functional" or state is None:
            state = state_from_contract({
                "cache_last_channel": torch.as_tensor(ins["cache_last_channel"], device=dev).to(cdt),
                "cache_last_time": torch.as_tensor(ins["cache_last_time"], device=dev).to(cdt),
                "cache_last_channel_len": torch.as_tensor(
                    ins["cache_last_channel_len"].astype(np.int32), device=dev),
            }, model.params)
        tq = subsampled_length(x.shape[1], cfg.stride_stages) - rec["drop_extra"]
        kernel_att = kernels and tq == tq_steady
        t0 = time.perf_counter()
        enc, out_len, state = encode(
            model.params, cfg, torch.as_tensor(x, device=dev),
            torch.tensor([rec["valid_frames"]], dtype=torch.int32, device=dev), state,
            drop_extra=rec["drop_extra"], cache_drop=0 if rec["is_last"] else cfg.cache_drop_size,
            compute_dtype=cdt, pad_steps=tq_pad - tq if kernel_att else 0,
            use_pallas_att=kernel_att, use_pallas_ffn=kernels, use_pallas_conv=kernels,
            pos_proj=pos_kernel if kernel_att else None, layers=model.layers)
        cstate = state_to_contract(state)
        enc = enc.float().cpu().numpy()
        ms = (time.perf_counter() - t0) * 1e3
        out_len_v = int(out_len[0])
        got_lc = cstate["cache_last_channel"].float().cpu().numpy()
        got_lt = cstate["cache_last_time"].float().cpu().numpy()
        got_cl = int(cstate["cache_last_channel_len"][0])

        want_enc = outs["encoder_output"]
        want_len = int(outs["encoded_lengths"][0])
        want_cl = int(outs["cache_last_channel_len_out"][0])
        contract_errs = []
        if out_len_v != want_len:
            contract_errs.append(f"encoded_lengths {out_len_v} != {want_len}")
        if not (0 <= got_cl <= cfg.att_cache_size):
            contract_errs.append(f"cache_len {got_cl} out of bounds")
        if got_cl != want_cl:
            contract_errs.append(f"cache_len {got_cl} != golden {want_cl}")
        enc_err = (float(np.abs(enc[0, :want_len] - want_enc[0, :want_len]).max())
                   if want_len else 0.0)
        ml = min(got_cl, want_cl)
        lc_err = (float(np.abs(got_lc[0, :, :ml] - outs["cache_last_channel_out"][0, :, :ml]).max())
                  if ml else 0.0)
        lt_err = float(np.abs(got_lt[0] - outs["cache_last_time_out"][0]).max())
        ok = not contract_errs and enc_err <= atol and lc_err <= atol and lt_err <= cache_atol
        results.append({"chunk_idx": rec["chunk_idx"], "pass": ok,
                        "encoder_output_max_abs": enc_err,
                        "cache_last_channel_max_abs": lc_err,
                        "cache_last_time_max_abs": lt_err,
                        "contract_errors": contract_errs, "timing_ms": ms})
    n_pass = sum(r["pass"] for r in results)
    errs = np.array([r["encoder_output_max_abs"] for r in results])
    times = np.array([r["timing_ms"] for r in results])
    ladder = load_contract().tolerances.rung_verdicts(errs)
    return {
        "mode": mode, "dtype": dtype, "engine": "torch", "kernels": kernels,
        "platform": dev.type,
        "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "atol": atol, "cache_atol": cache_atol,
        "num_chunks": len(results), "num_pass": int(n_pass),
        "pass_rate": n_pass / max(len(results), 1),
        "rung_verdicts": ladder["rungs"], "best_rung": ladder["best_rung"],
        "encoder_output_error_distribution": {
            "max": float(errs.max()), "mean": float(errs.mean()),
            "p95": float(np.percentile(errs, 95)), "p99": float(np.percentile(errs, 99)),
        },
        "timing_ms": {"p50": float(np.percentile(times, 50)),
                      "p95": float(np.percentile(times, 95))},
        "per_chunk": results,
    }


def tdt_trace(model: ParakeetTDT, frames: int = 300, feats_seed: int = 0
              ) -> Tuple[Dict, List[Dict]]:
    """(meta, steps) of the host reference decode over ``offline_encode`` of
    seeded features (``0.5 * default_rng(feats_seed).standard_normal``),
    the predictor primed with blank: the golden trace's recipe."""
    cfg, dev, p = model.cfg, model.device, model.params
    rng = np.random.default_rng(feats_seed)
    feats = (0.5 * rng.standard_normal((1, frames, cfg.feat_in))).astype(np.float32)
    enc, enc_len = offline_encode(p, cfg, torch.as_tensor(feats, device=dev),
                                  torch.tensor([frames], dtype=torch.int32, device=dev))
    t = int(enc_len[0])
    h0 = torch.zeros((cfg.pred_rnn_layers, 1, cfg.pred_hidden), device=dev)
    blank = torch.tensor([cfg.blank_id], device=dev)
    g, h, c = predictor_step(p["predictor"], blank, h0, h0.clone())

    def joint_fn(enc_t, gg):
        return joint_single_step(p["joint"], enc_t[None], gg[None])[0].float().cpu().numpy()

    def pred_fn(tok, st):
        gg, h2, c2 = predictor_step(p["predictor"], torch.tensor([tok], device=dev), *st)
        return gg[0], (h2, c2)

    trace: List[Dict] = []
    toks, _, _, _ = tdt_greedy_decode_host(
        enc[0, :t], joint_fn, pred_fn, (h, c), g[0], cfg.blank_id, blank_id=cfg.blank_id,
        token_head_size=cfg.token_head_size, duration_values=cfg.duration_values,
        max_symbols=cfg.max_symbols_per_timestep, trace=trace)
    meta = {"type": "meta", "blank_id": cfg.blank_id, "t_enc": t, "emitted": toks,
            "duration_values": list(cfg.duration_values)}
    return meta, trace


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--goldens", default="",
                    help="golden JSONL (the encoder records; with --mode trace, a trace)")
    ap.add_argument("--mode", default="closedloop", choices=["functional", "closedloop", "trace"])
    ap.add_argument("--model-dir", default="")
    ap.add_argument("--config", default="tiny", choices=["tiny", "full"])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--dtype", default="f32", choices=["f32", "bf16"])
    ap.add_argument("--kernels", action="store_true",
                    help="attention kernel on the steady chunks, FFN and conv kernels on all")
    ap.add_argument("--atol", type=float, default=None, help="default: the contract's")
    ap.add_argument("--cache-atol", type=float, default=None)
    ap.add_argument("--max-chunks", type=int, default=0)
    ap.add_argument("--frames", type=int, default=300, help="--mode trace: feature frames")
    ap.add_argument("--feats-seed", type=int, default=0, help="--mode trace: feature seed")
    ap.add_argument("--out", default="", help="--mode trace: write the trace here")
    ap.add_argument("--summary", default="")
    ap.add_argument("--device", default=None, help="default: cuda (raises without one)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    model = load_model(device, model_dir=args.model_dir, config=args.config, seed=args.seed,
                       kernels=args.kernels, dtype=args.dtype)
    if args.mode == "trace":
        meta, steps = tdt_trace(model, args.frames, args.feats_seed)
        if args.out:
            write_ndjson(args.out, steps, meta)
        ok, verdict = (compare_traces(args.goldens, (meta, steps)) if args.goldens
                       else (True, f"trace: {len(steps)} steps, {len(meta['emitted'])} tokens"))
        print(verdict)
        summary = {"mode": "trace", "platform": device.type, "steps": len(steps),
                   "emitted": meta["emitted"], "identical": ok, "verdict": verdict}
    else:
        if not args.goldens:
            ap.error("--goldens is required for the encoder modes")
        tol = load_contract().tolerances
        atol = args.atol if args.atol is not None else (
            tol.tpu_bf16_p95 * 10 if args.dtype == "bf16" else tol.cpu_f32_atol)
        cache_atol = args.cache_atol if args.cache_atol is not None else tol.cache_last_time_atol
        records = list(read_jsonl(args.goldens))[1:]
        if args.max_chunks:
            records = records[: args.max_chunks]
        summary = encoder_parity(model, records, mode=args.mode, atol=atol,
                                 cache_atol=cache_atol, kernels=args.kernels, dtype=args.dtype)
        summary["goldens"] = args.goldens
        dist = summary["encoder_output_error_distribution"]
        print(f"{args.mode} parity ({device.type}{', kernels' if args.kernels else ''}): "
              f"{summary['num_pass']}/{summary['num_chunks']} PASS at atol {atol:g} "
              f"(enc max_abs {dist['max']:.3e}, p95 {dist['p95']:.3e})")
        for name, r in summary["rung_verdicts"].items():
            print(f"  rung {name:9s} [{r['criterion']}]: {'PASS' if r['pass'] else 'FAIL'}")
        print(f"  best rung: {summary['best_rung'] or 'NONE (fails every rung)'}")
        ok = summary["num_pass"] == summary["num_chunks"]
    if args.summary:
        os.makedirs(os.path.dirname(args.summary) or ".", exist_ok=True)
        with open(args.summary, "w") as f:
            json.dump(summary, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
