#!/usr/bin/env python3
"""Phase 3g of ``chip_smoke.py`` (the runtime layer) alone, on one NVIDIA
H100, with its prerequisites made here at the same sizes: phase 3's
full-width weights and blank bias, its ``f32_all`` arm (tokens and
launches), phase 3b's f32 engine tokens and phase 4's gate_r3 entry
points. Run from the repository root:

    python3 runtime_phase.py

About 3 minutes on the card; the last line is ``RUN_3G OK``.
"""
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    from trt_asr_tpu_torch.config import ModelConfig, RuntimeConfig
    from trt_asr_tpu_torch.models.parakeet.params import init_params_numpy
    from trt_asr_tpu_torch.ops.kernels import build
    from trt_asr_tpu_torch.streaming.batch_engine import BatchStreamingEngine
    from trt_asr_tpu_torch.tokenizer import Tokenizer, make_synthetic_vocab

    if not torch.cuda.is_available():
        print("runtime_phase: no CUDA device", file=sys.stderr)
        return 1
    t00 = time.perf_counter()
    dev = torch.device("cuda")
    cs.log(cs.smi_line())
    cs.log(f"build {build.build():.1f} s")
    cfg = ModelConfig()
    params = init_params_numpy(cfg, seed=0)
    tok = Tokenizer(make_synthetic_vocab(cfg.vocab_size), blank_id=cfg.blank_id)
    rng = np.random.default_rng(0)           # phase 3's utterance at 8 words, seed 0
    audio = cs.synth_module().synth_utterance(list(rng.integers(0, 1120, size=8)), rng)
    off = cs.make_model(torch, cfg, params, tok, RuntimeConfig(), dev, False)
    cs.calibrate_blank_bias(off, 8, lambda: len(cs.run_session(torch, off, RuntimeConfig(),
                                                                audio, 8000).tokens), "utt")
    params = off.params
    every = RuntimeConfig(use_pallas_att=True, use_pallas_joint=True, use_pallas_ffn=True,
                          use_pallas_conv=True)
    m = cs.make_model(torch, cfg, params, tok, every, dev, True)
    cs.run_session(torch, m, every, audio[:16000], 8000)
    cs.reset_counts()
    s = cs.run_session(torch, m, every, audio, 8000)
    f32_all = dict(tokens=s.tokens, counts=cs.read_counts(), n_chunks=len(s.chunk_latencies_ms))
    del m
    rt = RuntimeConfig(use_pallas_joint=True)
    mj = cs.make_model(torch, cfg, params, tok, rt, dev, False)
    eng = BatchStreamingEngine(mj, batch_size=8, runtime=rt)
    # each stream alone equals its lockstep run (phase 3b holds that)
    engine_f32 = {k: cs.direct_engine_stream(eng, a)[0] for k, a in enumerate(cs.engine_audios())}
    del mj, eng
    cs.log(f"prerequisites {time.perf_counter() - t00:.1f} s; f32_all {f32_all}")
    md = os.path.join(ROOT, "artifacts", "models", "gate_r3")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        p4 = cs.gate_r3_entry_points(torch, dev, md, cs.synth_module(), tmp)
        cs.log(f"phase 4 {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        cs.runtime_phase(torch, dev, cfg, params, tok, 8, 0, f32_all, engine_f32, md, p4, tmp)
        cs.log(f"phase 3g {time.perf_counter() - t0:.1f} s")
    cs.log("RUN_3G OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
