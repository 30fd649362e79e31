"""Training step: the TDT loss over the whole model, with the optimizers of
``optim.py``, as the JAX package's ``train/train_step.py`` trains.

Inference-mode normalization (frozen BatchNorm statistics, no dropout),
as in JAX: a fine-tuning / continued-training configuration. Training runs
in f32 with the kernels off (the JAX package trains with its Pallas
switches off): the encoder builds its streaming caches out of place under
autograd (``encoder.encode``). The step is functional: it takes a
parameter tree and an optimizer state and returns new ones.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from trt_asr_tpu_torch.config import ModelConfig
from trt_asr_tpu_torch.models.parakeet.encoder import (EncoderState, encode, init_encoder_state,
                                                       layer_params, precompute_pos_proj)
from trt_asr_tpu_torch.models.parakeet.joint import joint_apply
from trt_asr_tpu_torch.models.parakeet.predictor import init_predictor_state, predictor_sequence
from trt_asr_tpu_torch.ops.quant import QuantTensor
from trt_asr_tpu_torch.train import optim
from trt_asr_tpu_torch.train.tdt_loss import tdt_loss


class Batch(NamedTuple):
    feats: Any      # [B, T, F]
    feat_len: Any   # [B]
    labels: Any     # [B, U]
    label_len: Any  # [B]


def _device_of(params) -> torch.device:
    return params["joint"]["out"]["w"].device


def _as_tensor(x, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(x, device=device, dtype=dtype)


def _check_trainable(params, compute_dtype) -> None:
    if compute_dtype != torch.float32:
        raise ValueError(f"training runs in float32 in this port, not {compute_dtype}")

    def walk(node, path):
        if isinstance(node, QuantTensor):
            raise TypeError(f"cannot train an int8-quantized leaf ({path}): train the float tree")
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")
    walk(params, "")


def streaming_encode_train(params: Dict[str, Any], cfg: ModelConfig, feats: torch.Tensor,
                           feat_len: torch.Tensor, compute_dtype=torch.float32,
                           remat: bool = False):
    """The encoder for training through the serving chunk schedule: a loop
    over chunks of the steady-chunk program the serving session runs
    (``drop_extra``, ``cache_drop``, ``valid_cap=valid_out_len``), threading
    the encoder state from chunk to chunk (built out of place under
    autograd). Chunk k's window covers feature frames [k*shift - lead,
    k*shift - lead + window), window = steady + pre_encode and lead =
    window - first_chunk; its first ``drop_extra`` steps are dropped and the
    next ``valid_out_len`` emitted, so the emissions tile the stream and
    their count is the subsampled length. With ``remat`` each chunk is
    checkpointed as well as each layer. Returns (enc [B, n_chunks *
    valid_out_len, D], enc_len [B])."""
    from trt_asr_tpu_torch.streaming.schedule import StreamingRegime

    b, t, f = feats.shape
    regime = StreamingRegime.from_config(cfg)
    first_chunk, steady = regime.chunk_sizes
    pre = regime.pre_encode[1]
    shift = regime.shift_sizes[1]
    window = steady + pre
    lead = window - first_chunk
    drop = regime.drop_extra
    v = regime.valid_out_len
    # the constant shift reproduces serving's unified schedule only when the
    # chunk windows tile: reject any other regime rather than train a
    # schedule serving does not run
    if regime.nemo_chunk0_drop:
        raise ValueError(
            "streaming_encode_train emulates the unified (tiling) chunk-0 "
            "semantics; nemo_compat_chunk0 regimes need the two-program "
            "schedule (same restriction as ChunkScheduler(unified=True))")
    if regime.shift_sizes[0] != first_chunk + shift - steady or lead < 0:
        raise ValueError(
            f"streaming regime {regime} does not tile under a constant "
            f"shift: need shift0 == first_chunk + shift1 - steady "
            f"(got {regime.shift_sizes[0]} != {first_chunk + shift - steady})")
    n_chunks = max(1, -(-(t + lead) // shift))
    pad_r = max(0, shift * (n_chunks - 1) + window - (t + lead))
    xpad = F.pad(feats.to(compute_dtype), (0, 0, lead, pad_r))
    tqw = regime.sub_len(window) - drop
    pos_proj = precompute_pos_proj(params, cfg, tqw, cfg.att_cache_size, compute_dtype)
    layers = layer_params(params, cfg.num_layers)
    state = init_encoder_state(cfg, b, device=feats.device, dtype=compute_dtype)
    feat_len = feat_len.to(torch.int32)

    def chunk(k, win, *state_tensors):
        valid = torch.clamp(feat_len + lead - k * shift, 0, window)
        enc, out_len, st = encode(
            params, cfg, win, valid, EncoderState(*state_tensors), drop_extra=drop,
            cache_drop=cfg.cache_drop_size, valid_cap=v, pos_proj=pos_proj,
            compute_dtype=compute_dtype, layers=layers, remat=remat)
        return (enc[:, :v], out_len) + tuple(st)

    encs, lens = [], []
    for k in range(n_chunks):
        win = xpad[:, k * shift:k * shift + window]
        if remat:
            # checkpoint the chunk axis too: two nested recomputation levels
            enc, out_len, *st = checkpoint(chunk, k, win, *state, use_reentrant=False)
        else:
            enc, out_len, *st = chunk(k, win, *state)
        state = EncoderState(*st)
        encs.append(enc)
        lens.append(out_len)
    return torch.cat(encs, dim=1), torch.stack(lens).sum(dim=0)


def training_forward(params: Dict[str, Any], cfg: ModelConfig, batch: Batch,
                     compute_dtype=torch.float32, streaming: bool = False,
                     remat: bool = False) -> torch.Tensor:
    """feats + labels -> per-example TDT NLL [B], on the parameters' device.
    ``streaming`` trains through the serving chunk schedule
    (:func:`streaming_encode_train`) instead of the offline encoder;
    ``remat`` recomputes each layer's (and, streaming, each chunk's)
    activations in backward: the same gradients, less activation memory,
    one more forward. Float32 only; int8-quantized leaves raise."""
    _check_trainable(params, compute_dtype)
    dev = _device_of(params)
    feats = _as_tensor(batch.feats, dev, torch.float32)
    feat_len = _as_tensor(batch.feat_len, dev, torch.int32)
    labels = _as_tensor(batch.labels, dev, torch.long)
    label_len = _as_tensor(batch.label_len, dev, torch.long)
    if streaming:
        enc, t_len = streaming_encode_train(params, cfg, feats, feat_len, compute_dtype,
                                            remat=remat)
    else:
        enc, t_len, _ = encode(params, cfg, feats, feat_len, None,
                               compute_dtype=compute_dtype, remat=remat)
    b = labels.shape[0]
    # decoder input: [SOS (= blank, a zero embedding row)] ++ labels
    y_in = torch.cat([torch.full((b, 1), cfg.blank_id, dtype=torch.long, device=dev), labels],
                     dim=1)
    h0, c0 = init_predictor_state(cfg, b, device=dev, dtype=compute_dtype)
    g, _, _ = predictor_sequence(params["predictor"], y_in, h0, c0)        # [B, U+1, P]
    logits = joint_apply(params["joint"], enc.float(), g.float())
    return tdt_loss(logits, labels, t_len, label_len, duration_values=cfg.duration_values,
                    token_head_size=cfg.token_head_size, blank_id=cfg.blank_id)


def make_optimizer(peak_lr: float = 1e-3, *, schedule: str = "cosine_warmup",
                   warmup_steps: int = 1000, total_steps: int = 100_000,
                   min_lr_ratio: float = 0.01, weight_decay: float = 1e-3,
                   grad_clip: float = 1.0, accum_steps: int = 1):
    """Global-norm clipping + AdamW under a schedule. Returns (optimizer,
    schedule_fn), schedule_fn mapping a step count tensor to the lr.
    schedules: "noam" (inverse-sqrt with linear warmup), "cosine_warmup"
    (from 0 to ``peak_lr`` and down to ``peak_lr * min_lr_ratio``),
    "constant". ``accum_steps`` > 1 averages the gradients of that many
    calls before one real update (:func:`optim.multi_steps`)."""
    if schedule == "noam":
        def schedule_fn(step):
            s = torch.clamp_min(step, 1).float()
            return peak_lr * torch.minimum(s ** -0.5, s * warmup_steps ** -1.5) \
                * warmup_steps ** 0.5
    elif schedule == "cosine_warmup":
        schedule_fn = optim.warmup_cosine_decay_schedule(
            0.0, peak_lr, warmup_steps, total_steps, end_value=peak_lr * min_lr_ratio)
    elif schedule == "constant":
        schedule_fn = optim.constant_schedule(peak_lr)
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    tx = optim.chain(optim.clip_by_global_norm(grad_clip) if grad_clip else optim.identity(),
                     optim.adamw(schedule_fn, weight_decay=weight_decay))
    if accum_steps > 1:
        tx = optim.multi_steps(tx, accum_steps)
    return tx, schedule_fn


def make_train_step(cfg: ModelConfig, optimizer: Optional[optim.GradientTransformation] = None,
                    compute_dtype=torch.float32, streaming: bool = False,
                    augment: Optional[dict] = None, remat: bool = False):
    """Returns (init_opt_state, train_step); ``train_step(params, opt_state,
    batch)`` returns (params, opt_state, {"loss", "grad_norm"}), the
    parameters and state new trees, the metrics 0-d tensors on the device.
    The default optimizer is ``adamw(1e-4)`` (weight decay 1e-4).
    ``augment``: keyword arguments of ``augment.spec_augment``; the step
    then takes a ``torch.Generator`` after the batch, draws the masks with
    it and masks the features before the forward pass."""
    optimizer = optimizer or optim.adamw(1e-4)

    def update(params, opt_state, batch: Batch):
        leaves = optim.tree_leaves(params)
        live = [x.detach().requires_grad_(True) for x in leaves]
        p = optim.tree_unflatten(params, live)
        loss = torch.mean(training_forward(p, cfg, batch, compute_dtype, streaming=streaming,
                                           remat=remat))
        grads = optim.tree_unflatten(params, torch.autograd.grad(loss, live))
        detached = optim.tree_unflatten(params, [x.detach() for x in leaves])
        updates, opt_state = optimizer.update(grads, opt_state, detached)
        new_params = optim.apply_updates(detached, updates)
        return new_params, opt_state, {"loss": loss.detach(),
                                       "grad_norm": optim.global_norm(grads)}

    if augment is not None:
        from trt_asr_tpu_torch.train.augment import spec_augment

        aug_kw = dict(augment)

        def train_step(params, opt_state, batch: Batch, generator: torch.Generator):
            dev = _device_of(params)
            feats = spec_augment(generator, _as_tensor(batch.feats, dev, torch.float32),
                                 _as_tensor(batch.feat_len, dev, torch.int32), **aug_kw)
            return update(params, opt_state, batch._replace(feats=feats))

        return optimizer.init, train_step
    return optimizer.init, update
