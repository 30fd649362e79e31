"""End-to-end training demonstration: overfit a tiny model on a fixed
random batch, checkpoint, reload, decode each utterance greedily. Drives
the whole training path (TDT loss -> gradients -> optimizer -> checkpoint
round trip -> greedy decode), on the card unless ``--device`` names
another.

    python -m trt_asr_tpu_torch.train.toy --steps 200 --out /tmp/toy_ckpt [--device cpu] [--mesh]

``--mesh`` places the weights and the batch on a dp x tp mesh of the run's
devices (``parallel/mesh.py``), as the JAX tool shards its step: on one
card or the CPU a 1 x 1 mesh, which trains as without it; more cards raise.

Prints a line every tenth of the steps (loss, gradient norm), the
training seconds, and ``recovered k/4 training utterances``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--out", default="", help="save, then reload, the trained weights here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises without one)")
    ap.add_argument("--mesh", action="store_true",
                    help="place the step on a mesh of all devices (dp x tp)")
    args = ap.parse_args(argv)

    import torch

    from trt_asr_tpu_torch.config import ModelConfig
    from trt_asr_tpu_torch.decode.tdt_greedy import (init_decode_state, prime_decode_state,
                                                     tdt_greedy_decode_chunk)
    from trt_asr_tpu_torch.device import resolve_device
    from trt_asr_tpu_torch.models.parakeet.encoder import offline_encode
    from trt_asr_tpu_torch.models.parakeet.params import (init_params, load_checkpoint,
                                                          save_checkpoint)
    from trt_asr_tpu_torch.train import make_train_step, optim
    from trt_asr_tpu_torch.train.train_step import Batch

    dev = resolve_device(args.device)
    cfg = ModelConfig.tiny(num_layers=2, d_model=64, n_heads=4,
                           subsampling_conv_channels=16, vocab_size=32,
                           pred_hidden=32, joint_hidden=32, feat_in=16)
    params = init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    b, t, u = 4, 57, 4
    batch = Batch(
        feats=torch.from_numpy(rng.standard_normal((b, t, cfg.feat_in)).astype(np.float32)).to(dev),
        feat_len=torch.full((b,), t, dtype=torch.int32, device=dev),
        labels=torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(b, u)).astype(np.int32)
                                ).to(dev),
        label_len=torch.full((b,), u, dtype=torch.int32, device=dev),
    )
    print(f"device: {dev}")
    if args.mesh:
        from trt_asr_tpu_torch.parallel import make_mesh, shard_batch, shard_params

        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   if dev.type == "cuda" else [dev])
        n = len(devices)
        tp = 2 if n % 2 == 0 and n > 1 else 1
        mesh = make_mesh(dp=n // tp, tp=tp, devices=devices)
        print(f"mesh: dp={n // tp} tp={tp}")
        params = shard_params(params, mesh)
        batch = shard_batch(batch, mesh)

    init_opt, step = make_train_step(cfg, optim.adam(args.lr))
    opt_state = init_opt(params)
    t0 = time.time()
    for i in range(args.steps):
        params, opt_state, m = step(params, opt_state, batch)
        if i % max(args.steps // 10, 1) == 0 or i == args.steps - 1:
            print(f"step {i:4d}: loss {float(m['loss']):8.4f} "
                  f"gnorm {float(m['grad_norm']):7.3f}", flush=True)
    print(f"trained {args.steps} steps in {time.time() - t0:.1f}s")

    if args.out:
        save_checkpoint(args.out, params, {"toy": True})
        params = load_checkpoint(args.out, device=dev)
        print(f"checkpoint round-trip: {args.out}")

    with torch.no_grad():
        enc, enc_len = offline_encode(params, cfg, batch.feats, batch.feat_len)
        correct = 0
        for i in range(b):
            ds = prime_decode_state(params, cfg, init_decode_state(cfg, 1, device=dev), [])
            toks, n, _ = tdt_greedy_decode_chunk(params, cfg, enc[i], enc_len[i], ds,
                                                 max_tokens=32)
            got = [int(x) for x in toks[:int(n)]]
            want = [int(x) for x in batch.labels[i]]
            correct += got == want
            print(f"{'OK ' if got == want else '   '}utt {i}: want {want} got {got}")
    print(f"recovered {correct}/{b} training utterances")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
