"""One-command import of the port: a reference-layout ONNX export directory
({encoder[_streaming],predictor,joint}.onnx + model_meta.json + vocab.txt)
-> a model directory every entry point of the port (and of the JAX package)
takes with ``--model-dir``, as ``tools/import_onnx_model.py`` writes it:

    python -m trt_asr_tpu_torch.import_onnx <export_dir> --out <model_dir> \\
        [--contract C.json] [--vocab vocab.txt] [--name-map map.json] \\
        [--nemo-compat-chunk0] [--verify] [--device cpu]

The initializers go through the strict name-mapped loader
(``io/onnx_weights.py``: torch layouts transposed to the tree's at load);
model_meta is cross-checked against the architecture, which comes from the
meta's config block when the export has one, else from the contract
(default: the in-tree parakeet-tdt-0.6b-v3). The model dir holds
config.json, params.npz, a per-tensor sha256 manifest and vocab.txt.
``--verify`` pushes one deterministic utterance through a
``StreamingSession`` of the imported model, on the CUDA device unless
``--device`` names another, and prints the transcript and the chunk count
(a live smoke, not a parity claim).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m trt_asr_tpu_torch.import_onnx",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("onnx_dir", help="reference-layout ONNX export directory")
    ap.add_argument("--out", required=True, help="model directory to write")
    ap.add_argument("--contract", default="",
                    help="contract JSON deriving the architecture "
                         "(default: the in-tree parakeet-tdt-0.6b-v3)")
    ap.add_argument("--vocab", default="", help="vocab.txt path when the export dir lacks one")
    ap.add_argument("--name-map", default="",
                    help="optional {pytree_path: onnx_name} override JSON for foreign "
                         "naming schemes")
    ap.add_argument("--nemo-compat-chunk0", action="store_true",
                    help="bit-faithful real-export chunk-0 semantics (drop_extra applied "
                         "on chunk 0; required when validating against goldens from the "
                         "real export)")
    ap.add_argument("--verify", action="store_true",
                    help="decode one deterministic utterance through a streaming session "
                         "of the imported model")
    ap.add_argument("--device", default=None,
                    help="torch device of --verify (default: cuda; raises without one)")
    args = ap.parse_args(argv)

    from trt_asr_tpu_torch.config import ModelConfig
    from trt_asr_tpu_torch.contract import load_contract
    from trt_asr_tpu_torch.io.onnx_weights import load_params_from_onnx, read_model_meta
    from trt_asr_tpu_torch.models.parakeet.model import write_model_dir
    from trt_asr_tpu_torch.models.parakeet.params import num_params
    from trt_asr_tpu_torch.tokenizer import Tokenizer

    meta = read_model_meta(args.onnx_dir)   # validates cross-field arithmetic
    if meta.get("config"):
        # self-describing export (legacy v1 or reference meta with a config
        # block): the architecture comes from the artifact itself; the block
        # may carry derived fields (conv_context_size, ...): keep init args
        fields = {f.name for f in dataclasses.fields(ModelConfig) if f.init}
        raw = {k: tuple(v) if isinstance(v, list) else v
               for k, v in meta["config"].items() if k in fields}
        cfg = ModelConfig(**raw)
        src = "model_meta config block"
    else:
        contract = load_contract(args.contract or None)
        cfg = ModelConfig.from_contract(contract)
        src = args.contract or "contracts/parakeet-tdt-0.6b-v3.json"
    if args.nemo_compat_chunk0:
        cfg = dataclasses.replace(cfg, nemo_compat_chunk0=True)

    for field, want, got in (("vocab_size", cfg.vocab_size, meta["vocab_size"]),
                             ("n_mels", cfg.feat_in, meta["n_mels"])):
        if got is not None and got != want:
            raise SystemExit(f"model_meta {field}={got} contradicts the config's {want} "
                             f"({src}) — wrong contract or wrong export")

    params = load_params_from_onnx(cfg, args.onnx_dir,
                                   name_map_override=args.name_map or None)
    n_params = num_params(params)
    vocab_path = args.vocab or os.path.join(args.onnx_dir, "vocab.txt")
    if not os.path.exists(vocab_path):
        raise SystemExit(f"no vocab.txt in {args.onnx_dir} — pass --vocab (the reference "
                         f"export writes it next to the components)")
    tok = Tokenizer.from_file(vocab_path, blank_id=cfg.blank_id)
    write_model_dir(args.out, cfg, params, tok.vocab)
    with open(os.path.join(args.out, "manifest.json")) as f:
        n_hashes = len(json.load(f)["tensors"])     # one a leaf
    print(f"imported {n_hashes} tensors ({n_params/1e6:.1f}M params, "
          f"architecture from {src}) -> {args.out} "
          f"({n_hashes} sha256-manifested tensors)", flush=True)

    if args.verify:
        import numpy as np

        from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT
        from trt_asr_tpu_torch.streaming.session import StreamingSession

        model = ParakeetTDT(cfg, params, tok, device=args.device)
        sess = StreamingSession(model)
        t = np.arange(16000 * 2, dtype=np.float32)
        audio = (0.2 * np.sin(0.04 * t) * (0.5 + 0.5 * np.sin(0.001 * t))).astype(np.float32)
        sess.push_audio(audio)
        sess.finalize()
        print(f"verify: {len(sess.chunk_latencies_ms)} chunks decoded on {model.device}; "
              f"transcript: {sess.text[:120]!r}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
