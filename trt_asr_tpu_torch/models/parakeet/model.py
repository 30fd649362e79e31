"""Model bundle: config + params + frontend + tokenizer, loaded from the
JAX package's model-dir format (config.json, params.npz, manifest.json,
vocab.txt), and offline transcription: wav -> log-mel -> per-feature norm
-> offline encoder -> TDT greedy decode -> text, one utterance
(``transcribe_offline``) or a padded batch (``transcribe_batch``), and the
n-best of the host beam (``transcribe_offline_beam``)."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from trt_asr_tpu_torch.config import ModelConfig, RuntimeConfig
from trt_asr_tpu_torch.contract import FrontendSpec
from trt_asr_tpu_torch.decode.batched import tdt_greedy_decode_batch
from trt_asr_tpu_torch.decode.tdt_greedy import (init_decode_state, prime_decode_state,
                                                 tdt_greedy_decode_chunk)
from trt_asr_tpu_torch.device import resolve_device
from trt_asr_tpu_torch.frontend.logmel import LogMelFrontend
from trt_asr_tpu_torch.frontend.normalize import (apply_per_feature_norm,
                                                  compute_per_feature_stats)
from trt_asr_tpu_torch.models.parakeet.encoder import layer_params, offline_encode
from trt_asr_tpu_torch.models.parakeet.params import (
    cast_params_for_compute,
    init_params_numpy,
    load_checkpoint_numpy,
    params_from_numpy,
    params_to,
    save_checkpoint,
)
from trt_asr_tpu_torch.ops.kernels import build
from trt_asr_tpu_torch.ops.kernels.joint_step import pack_joint_step
from trt_asr_tpu_torch.ops.quant import QuantTensor, keep_f32_copy
from trt_asr_tpu_torch.tokenizer import Tokenizer, make_synthetic_vocab, write_vocab


class ParakeetTDT:
    """``params``: a torch parameter tree (any device; moved to ``device``)
    or a numpy tree (bridged). ``device`` defaults to ``cuda`` and raises
    without one; tests pass ``device="cpu"``. ``weights_dtype=torch.bfloat16``
    casts the float tree as ``cast_params_for_compute`` does (the JAX
    package's bf16 configuration; norm parameters stay f32) before
    ``runtime.quant`` quantizes it, as ``bench.py`` orders the two."""

    def __init__(self, cfg: ModelConfig, params, tokenizer: Tokenizer,
                 frontend: Optional[LogMelFrontend] = None,
                 runtime: Optional[RuntimeConfig] = None, device=None,
                 weights_dtype: Optional[torch.dtype] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.runtime = runtime or RuntimeConfig.from_env()
        if self.runtime.compile_cache_dir:
            # the kernel libraries' directory (TRT_ASR_COMPILE_CACHE): a
            # fresh process that finds them built there runs no nvcc
            build.apply_compile_cache(self.runtime.compile_cache_dir)
        self.frontend = frontend or LogMelFrontend(FrontendSpec(n_mels=cfg.feat_in),
                                                   device=self.device)
        params = params_from_numpy(params, "cpu") if _is_numpy_tree(params) else params
        if weights_dtype is not None:
            params = cast_params_for_compute(params, weights_dtype)
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
        # bytes of the bf16 copies of the int8 weights kept on the card
        self.bf16_copy_bytes = 0
        if self.runtime.quant != "none":
            from trt_asr_tpu_torch.models.parakeet.quant import keep_bf16_copies, quantize_params

            params = quantize_params(params, self.runtime.quant)
            self.bf16_copy_bytes = keep_bf16_copies(params)
        self.params = params
        self.layers = layer_params(
            params, cfg.num_layers,
            pack_tail=self.runtime.use_pallas_conv and self.runtime.use_pallas_ffn,
            pack_att=self.runtime.use_pallas_att, pack_ffn=self.runtime.use_pallas_ffn,
            pack_conv=self.runtime.use_pallas_conv)
        # the persistent joint step's int8, bf16 or f32 weights packed once
        # (ops/kernels/joint_step.py), with f32 copies of bf16 biases kept
        # for the kernels' other reads
        jp, wo = params["joint"], params["joint"]["out"]["w"]
        for b in (jp["pred"]["b"], jp["out"]["b"]):
            keep_f32_copy(b)
        wo_t = wo.q if isinstance(wo, QuantTensor) else wo
        self.joint_packed = (
            pack_joint_step(jp["pred"]["w"], jp["pred"]["b"], wo, jp["out"]["b"])
            if self.runtime.use_pallas_joint and wo_t.is_cuda
            and wo_t.dtype in (torch.int8, torch.bfloat16, torch.float32)
            else None)

    @classmethod
    def from_model_dir(cls, model_dir: str, runtime: Optional[RuntimeConfig] = None,
                       device=None, weights_dtype: Optional[torch.dtype] = None
                       ) -> "ParakeetTDT":
        with open(os.path.join(model_dir, "config.json")) as f:
            raw = json.load(f)
        raw = {k: tuple(v) if isinstance(v, list) else v for k, v in raw.items()}
        cfg = ModelConfig(**raw)
        params = load_checkpoint_numpy(model_dir)
        tok = Tokenizer.from_file(os.path.join(model_dir, "vocab.txt"), blank_id=cfg.blank_id)
        return cls(cfg, params, tok, runtime=runtime, device=device, weights_dtype=weights_dtype)

    def save_model_dir(self, model_dir: str) -> None:
        """Write the model dir of this model (:func:`write_model_dir`)."""
        write_model_dir(model_dir, self.cfg, self.params, self.tokenizer.vocab)

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

    def _decode_kwargs(self, t_enc_static: int) -> dict:
        rt = self.runtime
        return dict(max_tokens=self.cfg.max_symbols_per_timestep * t_enc_static,
                    blank_penalty=rt.blank_penalty,
                    punct_mask=self.punct_mask if rt.suppress_leading_punct else None,
                    use_punct_mask=rt.suppress_leading_punct)

    def features(self, audio: np.ndarray, norm: str = "per_feature") -> torch.Tensor:
        """Log-mel features [T, feat_in] on the model's device, per-feature
        normalized over the utterance unless ``norm="none"``."""
        feats = self.frontend(audio)
        if norm == "per_feature" and feats.shape[0] > 0:
            mean, std = compute_per_feature_stats(feats)
            feats = apply_per_feature_norm(feats, mean, std)
        return feats

    def batch_features(self, audios: Sequence[np.ndarray], norm: str = "per_feature",
                       pad_multiple: int = 128) -> Tuple[torch.Tensor, np.ndarray]:
        """The padded feature batch of :meth:`transcribe_batch`: (x [B, T_pad,
        feat_in] zero-padded, T_pad the longest length rounded up to
        ``pad_multiple`` (at least one multiple), lengths [B] int32)."""
        feats = [self.features(np.asarray(a), norm=norm) for a in audios]
        lens = np.array([f.shape[0] for f in feats], np.int32)
        longest = int(lens.max()) if len(lens) else 0
        t_pad = max((max(longest, 1) + pad_multiple - 1) // pad_multiple * pad_multiple,
                    pad_multiple)
        x = torch.zeros((len(feats), t_pad, self.cfg.feat_in), dtype=torch.float32,
                        device=self.device)
        for i, f in enumerate(feats):
            x[i, :f.shape[0]] = f
        return x, lens

    def transcribe_offline(self, audio: np.ndarray, norm: str = "per_feature",
                           max_frames: int = 2048) -> Tuple[str, List[int]]:
        """wav samples -> (text, token_ids). Long audio is encoded in
        <= max_frames feature windows with the decode state carried across
        them (chunked decode equals whole-utterance decode)."""
        feats = self.features(audio, norm=norm)
        if feats.shape[0] == 0:
            return "", []
        dec = prime_decode_state(self.params, self.cfg,
                                 init_decode_state(self.cfg, 1, device=self.device),
                                 self.prompt_ids)
        ids: List[int] = []
        for start in range(0, feats.shape[0], max_frames):
            chunk = feats[start:start + max_frames]
            enc, enc_len = offline_encode(self.params, self.cfg, chunk[None],
                                          torch.tensor([chunk.shape[0]]), layers=self.layers)
            toks, n, dec = tdt_greedy_decode_chunk(
                self.params, self.cfg, enc[0], enc_len[0], dec, emitted_so_far=len(ids),
                joint_packed=self.joint_packed, **self._decode_kwargs(enc.shape[1]))
            ids.extend(toks[:int(n)].tolist())
        return self.tokenizer.decode(ids), ids

    def transcribe_batch(self, audios: Sequence[np.ndarray], norm: str = "per_feature",
                         mesh=None, max_frames: int = 2048, pad_multiple: int = 128
                         ) -> List[Tuple[str, List[int]]]:
        """Batched offline transcription: one padded [B, T, C] feature batch
        (T bucketed to ``pad_multiple``), one batched encoder pass per
        <= max_frames window with the padded tails masked between subsampler
        stages, and one lockstep batched TDT greedy decode per window with
        carried per-row decode state. Token-exact with per-utterance
        :meth:`transcribe_offline`. Returns [(text, token_ids)] in input
        order. ``mesh`` (``parallel/mesh.py``): the batch is padded to a dp
        multiple with zero-length rows, as in JAX; a one-device mesh is the
        model's device, so the result equals ``mesh=None``'s; a larger mesh
        raises."""
        if len(audios) == 0:
            return []
        x, lens = self.batch_features(audios, norm=norm, pad_multiple=pad_multiple)
        b = x.shape[0]
        if mesh is not None:
            from trt_asr_tpu_torch.parallel.mesh import same_device

            dp = int(mesh.shape["dp"])
            b_pad = (b + dp - 1) // dp * dp
            x = torch.cat([x, x.new_zeros((b_pad - b,) + tuple(x.shape[1:]))])
            lens = np.concatenate([lens, np.zeros(b_pad - b, np.int32)])
            # a one-device mesh is the model's device, where the batch lies;
            # mesh.device() raises for a larger one
            if not same_device(mesh.device(), self.device):
                raise ValueError(f"the mesh's device {mesh.device()} is not the model's "
                                 f"({self.device})")
        b_all, t_pad = x.shape[0], x.shape[1]
        dec = prime_decode_state(self.params, self.cfg,
                                 init_decode_state(self.cfg, b_all, device=self.device),
                                 self.prompt_ids)
        ids: List[List[int]] = [[] for _ in range(b_all)]
        emitted = np.zeros(b_all, np.int64)
        for start in range(0, t_pad, max_frames):
            w = min(max_frames, t_pad - start)
            valid = torch.as_tensor(np.clip(lens - start, 0, w), device=self.device)
            enc, enc_len = offline_encode(self.params, self.cfg, x[:, start:start + w], valid,
                                          mask_pad_subsample=True, layers=self.layers)
            toks, n, dec = tdt_greedy_decode_batch(
                self.params, self.cfg, enc, enc_len, dec, emitted_so_far=emitted,
                joint_packed=self.joint_packed, **self._decode_kwargs(enc.shape[1]))
            emitted = emitted + n.numpy()
            for i in range(b_all):
                ids[i].extend(toks[i, :int(n[i])].tolist())
        return [(self.tokenizer.decode(r), r) for r in ids[:b]]


    def transcribe_offline_beam(self, audio: np.ndarray, beam: int = 4,
                                norm: str = "per_feature", length_norm: float = 0.0,
                                expansion_k: int = 4, lm_fn=None, lm_weight: float = 0.0
                                ) -> List[Tuple[str, List[int], float]]:
        """n-best offline transcription by the host TDT beam
        (``decode/beam.py``): the encoder runs once on the device, the search
        on the host over the joint and predictor on the device. Returns
        [(text, token_ids, score)], best first. ``lm_fn``/``lm_weight``
        enable shallow fusion. The kernels stay off, as on every beam path."""
        from trt_asr_tpu_torch.decode.beam import make_host_fns, tdt_beam_decode_host

        feats = self.features(audio, norm=norm)
        if feats.shape[0] == 0:
            return [("", [], 0.0)]
        enc, enc_len = offline_encode(self.params, self.cfg, feats[None],
                                      torch.tensor([feats.shape[0]]), layers=self.layers)
        t = int(enc_len[0])
        j_fn, p_fn, j_batch = make_host_fns(
            self.params, self.device, joint_rows=beam,
            pred_rows=beam * (expansion_k if beam > 1 else 1))
        ds = prime_decode_state(self.params, self.cfg,
                                init_decode_state(self.cfg, 1, device=self.device),
                                self.prompt_ids)
        rt = self.runtime
        punct_ids = (set(np.flatnonzero(self.punct_mask).tolist())
                     if rt.suppress_leading_punct else None)
        hyps = tdt_beam_decode_host(
            enc[0, :t].cpu().numpy(), j_fn, p_fn, (ds.h, ds.c), ds.g[0].cpu().numpy(),
            int(ds.y_id[0]), blank_id=self.cfg.blank_id,
            token_head_size=self.cfg.token_head_size,
            duration_values=self.cfg.duration_values, beam=beam, expansion_k=expansion_k,
            max_symbols=self.cfg.max_symbols_per_timestep, length_norm=length_norm,
            blank_penalty=rt.blank_penalty, punct_token_ids=punct_ids,
            lm_fn=lm_fn, lm_weight=lm_weight, joint_batch_fn=j_batch)
        return [(self.tokenizer.decode(h.tokens), list(h.tokens), h.score) for h in hyps]


def write_model_dir(model_dir: str, cfg: ModelConfig, params, vocab: Sequence[str]) -> None:
    """Write the model-dir format :meth:`ParakeetTDT.from_model_dir` and the
    JAX package's ``ParakeetTDT.from_model_dir`` read: ``config.json``, the
    checkpoint of a torch or numpy tree (``params.npz`` + ``manifest.json``)
    and ``vocab.txt``."""
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=1)
    save_checkpoint(model_dir, params, meta={"model": "parakeet-tdt"})
    write_vocab(os.path.join(model_dir, "vocab.txt"), vocab)


def _is_numpy_tree(tree) -> bool:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    while isinstance(tree, (list, tuple)) and not hasattr(tree, "q"):
        tree = tree[0]
    if hasattr(tree, "q"):
        tree = tree.q
    return isinstance(tree, np.ndarray)
