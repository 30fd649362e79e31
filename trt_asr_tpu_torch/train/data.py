"""Manifest-driven training data: the TSV manifests of ``eval/manifest.py``
become padded training batches (wav -> log-mel, per-feature normalized
unless ``feature_norm="none"`` -> ``Tokenizer.encode`` labels), in the
order the JAX package's ``train/data.py`` yields them.

- Each round shuffles the entries, sorts them by duration inside
  super-batches of 8 batches, cuts the batches, then shuffles the batch
  order (sort-shard-shuffle): every batch pads to its own bucket. The
  numpy RNG is drawn in the same order as in JAX, so a seed gives the same
  batches.
- The feature axis pads up to a multiple of ``bucket_multiple``.
- Batches are numpy arrays; ``training_forward`` moves them to the card.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from trt_asr_tpu_torch.train.train_step import Batch


def batches_from_manifest(
    manifest_path: str,
    model,
    batch_size: int,
    *,
    rounds: int = 1,
    seed: int = 0,
    bucket_multiple: int = 128,
    feature_norm: str = "per_feature",
    max_label_len: Optional[int] = None,
    verify_sha: bool = False,
) -> Iterator[Batch]:
    """Yield padded :class:`Batch` es of numpy arrays over ``rounds``
    shuffled epochs; ``model`` is a ``ParakeetTDT`` (its frontend and
    tokenizer)."""
    from trt_asr_tpu_torch.eval.manifest import read_manifest
    from trt_asr_tpu_torch.io.wav import load_wav

    entries = read_manifest(manifest_path, verify_sha=verify_sha)
    if not entries:
        return
    rng = np.random.default_rng(seed)
    for _ in range(rounds):
        order = rng.permutation(len(entries))
        span = max(batch_size * 8, batch_size)
        batches_idx: List[np.ndarray] = []
        for g0 in range(0, len(order), span):
            chunk = order[g0:g0 + span]
            durs = np.array([entries[i].duration_sec for i in chunk])
            chunk = chunk[np.argsort(durs, kind="stable")]
            batches_idx.extend(chunk[b0:b0 + batch_size]
                               for b0 in range(0, len(chunk), batch_size))
        for bi in rng.permutation(len(batches_idx)):
            idx = batches_idx[bi]
            feats, labels = [], []
            for i in idx:
                e = entries[i]
                feats.append(model.features(load_wav(e.audio_path), norm=feature_norm)
                             .cpu().numpy())
                ids = model.tokenizer.encode(e.transcript)
                if max_label_len:
                    ids = ids[:max_label_len]
                labels.append(ids)
            t_max = max(f.shape[0] for f in feats)
            t_pad = max(-(-t_max // bucket_multiple) * bucket_multiple, bucket_multiple)
            u_max = max(1, max(len(lb) for lb in labels))
            bsz = len(idx)
            x = np.zeros((bsz, t_pad, model.cfg.feat_in), np.float32)
            y = np.zeros((bsz, u_max), np.int32)
            fl = np.zeros((bsz,), np.int32)
            ll = np.zeros((bsz,), np.int32)
            for k, (f, lb) in enumerate(zip(feats, labels)):
                x[k, :f.shape[0]] = f
                y[k, :len(lb)] = lb
                fl[k] = f.shape[0]
                ll[k] = len(lb)
            yield Batch(feats=x, feat_len=fl, labels=y, label_len=ll)
