"""Model bundle: config + params + frontend + tokenizer, loaded from the
JAX package's model-dir format (config.json, params.npz, manifest.json,
vocab.txt)."""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np
import torch

from trt_asr_tpu_torch.config import ModelConfig, RuntimeConfig
from trt_asr_tpu_torch.contract import FrontendSpec
from trt_asr_tpu_torch.device import resolve_device
from trt_asr_tpu_torch.frontend.logmel import LogMelFrontend
from trt_asr_tpu_torch.models.parakeet.encoder import layer_params
from trt_asr_tpu_torch.models.parakeet.params import (
    init_params_numpy,
    load_checkpoint_numpy,
    params_from_numpy,
    params_to,
)
from trt_asr_tpu_torch.tokenizer import Tokenizer, make_synthetic_vocab


class ParakeetTDT:
    """``params``: a torch parameter tree (any device; moved to ``device``)
    or a numpy tree (bridged). ``device`` defaults to ``cuda`` and raises
    without one; tests pass ``device="cpu"``."""

    def __init__(self, cfg: ModelConfig, params, tokenizer: Tokenizer,
                 frontend: Optional[LogMelFrontend] = None,
                 runtime: Optional[RuntimeConfig] = None, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.runtime = runtime or RuntimeConfig.from_env()
        self.frontend = frontend or LogMelFrontend(FrontendSpec(n_mels=cfg.feat_in),
                                                   device=self.device)
        params = params_from_numpy(params, "cpu") if _is_numpy_tree(params) else params
        self._punct_mask = None
        if self.runtime.joint_dur_first:
            # export head order [durations, tokens] becomes the internal
            # [tokens, durations] by permuting the out projection's columns
            # once at load (exact)
            nd = self.cfg.num_duration_bins
            ths = self.cfg.token_head_size
            perm = torch.as_tensor(np.concatenate([np.arange(nd, nd + ths), np.arange(nd)]))
            out = params["joint"]["out"]
            params = {**params, "joint": {
                **params["joint"],
                "out": {"w": out["w"][:, perm].contiguous(), "b": out["b"][perm].contiguous()}}}
        params = params_to(params, self.device)
        if self.runtime.quant != "none":
            from trt_asr_tpu_torch.models.parakeet.quant import quantize_params

            params = quantize_params(params, self.runtime.quant)
        self.params = params
        self.layers = layer_params(params, cfg.num_layers)

    @classmethod
    def from_model_dir(cls, model_dir: str, runtime: Optional[RuntimeConfig] = None,
                       device=None) -> "ParakeetTDT":
        with open(os.path.join(model_dir, "config.json")) as f:
            raw = json.load(f)
        raw = {k: tuple(v) if isinstance(v, list) else v for k, v in raw.items()}
        cfg = ModelConfig(**raw)
        params = load_checkpoint_numpy(model_dir)
        tok = Tokenizer.from_file(os.path.join(model_dir, "vocab.txt"), blank_id=cfg.blank_id)
        return cls(cfg, params, tok, runtime=runtime, device=device)

    @classmethod
    def random(cls, cfg: Optional[ModelConfig] = None, seed: int = 0,
               runtime: Optional[RuntimeConfig] = None, device=None) -> "ParakeetTDT":
        cfg = cfg or ModelConfig.tiny()
        tok = Tokenizer(make_synthetic_vocab(cfg.vocab_size), blank_id=cfg.blank_id)
        return cls(cfg, init_params_numpy(cfg, seed=seed), tok, runtime=runtime, device=device)

    @property
    def prompt_ids(self) -> List[int]:
        if self.runtime.y0_override >= 0:
            return [self.runtime.y0_override]
        ids = []
        lang = f"<|{self.runtime.language}|>"
        extra = tuple(t.strip() for t in self.runtime.extra_prompt.split(",")
                      if t.strip())
        for t in ("<|startoftranscript|>", lang) + extra:
            i = self.tokenizer.token_id(t)
            if i >= 0:
                ids.append(i)
        return ids

    @property
    def punct_mask(self) -> np.ndarray:
        if self._punct_mask is None:
            m = np.zeros(self.cfg.token_head_size, bool)
            for i, t in enumerate(self.tokenizer.vocab):
                m[i] = Tokenizer.is_punct_only(t)
            self._punct_mask = m
        return self._punct_mask


def _is_numpy_tree(tree) -> bool:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    while isinstance(tree, (list, tuple)) and not hasattr(tree, "q"):
        tree = tree[0]
    if hasattr(tree, "q"):
        tree = tree.q
    return isinstance(tree, np.ndarray)
