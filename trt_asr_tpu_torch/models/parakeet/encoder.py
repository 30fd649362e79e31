"""Fast Conformer encoder, offline and cache-aware streaming.

Same semantics as the JAX package's ``models/parakeet/encoder.py``:
dw_striding 8x subsampling, then N conformer layers (0.5*FF -> rel-pos MHA
-> conv module -> 0.5*FF -> LayerNorm). Streaming (``encode`` with a state)
attends over a ring kv cache and convolves over a time cache; offline
(``state=None``, :func:`offline_encode`) attends over the utterance's own
steps, with the static relative shift, zero conv context and no caches. A
Python loop over layers takes the place of ``lax.scan``.

State: ring-buffered caches ``[L, B, C, D]`` (``att_cache``: raw attention
inputs, ``kv_cache``: projected k ++ v), ``time_cache [L, B, K, D]``,
``cache_len``/``cursor [B]`` int32. Serving (no tensor that requires grad,
no ``remat``): ``encode`` updates the three caches IN PLACE and returns a
state holding the same cache tensors; callers that need the old state keep
a copy (the session's ``snapshot`` copies), and the persistent kernels and
their captured graphs rely on the tensors staying put. Training (autograd
recording a parameter or the input, or ``remat``): the caches are built
out of place and returned in a fresh state, as the JAX package returns
them, so that backward (and a layer recomputed under ``remat``) reads the
caches a chunk was given; the state passed in is left as it was.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from trt_asr_tpu_torch.config import ModelConfig
from trt_asr_tpu_torch.ops.attention import rel_pos_attention_kv, sinusoidal_pos_table
from trt_asr_tpu_torch.ops.common import (batch_norm_inference, glu, layer_norm,
                                          matmul, silu)
from trt_asr_tpu_torch.ops.conv import (depthwise_conv1d, dw_striding_subsample,
                                        subsampled_length)
from trt_asr_tpu_torch.ops.kernels.att_block import att_block, pack_att_block
from trt_asr_tpu_torch.ops.kernels.conv_block import (conv_block, conv_ffn_ln,
                                                      pack_conv_block, pack_conv_ffn_ln)
from trt_asr_tpu_torch.ops.kernels import ffn as kernel_ffn
from trt_asr_tpu_torch.ops.kernels.ffn import fused_ffn
from trt_asr_tpu_torch.ops.quant import (QuantTensor, bf16_copy, dequantize, keep_bf16_copy,
                                         keep_f32_copy)


class EncoderState(NamedTuple):
    """Streaming caches as RING BUFFERS along the cache axis: ``cursor[b]``
    is the next write slot; slot j holds the entry of age
    ((cursor-1-j) mod C) + 1 encoder steps, valid while age <= cache_len."""

    att_cache: torch.Tensor   # [L, B, C, D]
    time_cache: torch.Tensor  # [L, B, K, D]
    kv_cache: torch.Tensor    # [L, B, C, 2D]
    cache_len: torch.Tensor   # [B] int32
    cursor: torch.Tensor      # [B] int32


def init_encoder_state(cfg: ModelConfig, batch: int, device="cpu",
                       dtype=torch.float32) -> EncoderState:
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)  # noqa: E731
    return EncoderState(
        att_cache=z(cfg.num_layers, batch, cfg.att_cache_size, cfg.d_model),
        time_cache=z(cfg.num_layers, batch, cfg.conv_context_size, cfg.d_model),
        kv_cache=z(cfg.num_layers, batch, cfg.att_cache_size, 2 * cfg.d_model),
        cache_len=torch.zeros(batch, dtype=torch.int32, device=device),
        cursor=torch.zeros(batch, dtype=torch.int32, device=device),
    )


def reset_encoder_state_rows(state: EncoderState, row_mask: torch.Tensor) -> EncoderState:
    """Zero the state of streams where row_mask[b] is True (a new state)."""
    m_b = row_mask.reshape(1, -1, 1, 1)
    zero = lambda t: torch.where(m_b, torch.zeros((), dtype=t.dtype, device=t.device), t)  # noqa: E731
    zi = torch.zeros((), dtype=torch.int32, device=row_mask.device)
    return EncoderState(zero(state.att_cache), zero(state.time_cache), zero(state.kv_cache),
                        torch.where(row_mask, zi, state.cache_len),
                        torch.where(row_mask, zi, state.cursor))


def _ring_write(cache: torch.Tensor, block: torch.Tensor, cursor: torch.Tensor,
                appended: torch.Tensor, inplace: bool = True) -> torch.Tensor:
    """Write block[b, :appended[b]] into ring slots (cursor[b] + i) mod C, in
    place, or into a new tensor that is returned (``inplace=False``).
    cache [B, C, D], block [B, S, D] with S <= C. Rows past ``appended``
    rewrite the slot's old value (the JAX version drops them with an
    out-of-range index, which torch indexing rejects)."""
    b, c, _ = cache.shape
    s = block.shape[1]
    if s == 0:
        return cache
    assert s <= c, "ring write longer than the cache"
    ar = torch.arange(s, device=cache.device)
    pos = (cursor.long()[:, None] + ar[None, :]) % c                   # [B, S]
    keep = ar[None, :] < appended[:, None]                             # [B, S]
    bidx = torch.arange(b, device=cache.device)[:, None].expand(b, s)
    vals = torch.where(keep[..., None], block.to(cache.dtype), cache[bidx, pos])
    if not inplace:
        return cache.index_put((bidx, pos), vals)
    cache[bidx, pos] = vals
    return cache


def _append_cache(cache: torch.Tensor, block: torch.Tensor,
                  appended: torch.Tensor) -> torch.Tensor:
    """Right-aligned cache update with a per-row valid count: the last C
    entries of (cache ++ block[:appended]). cache [B, C, D], block [B, S, D]."""
    c = cache.shape[1]
    full = torch.cat([cache, block.to(cache.dtype)], dim=1)
    idx = appended.long()[:, None] + torch.arange(c, device=cache.device)[None, :]
    return torch.gather(full, 1, idx[:, :, None].expand(-1, -1, full.shape[2]))


def layer_params(params: Dict[str, Any], num_layers: int, pack_tail: bool = False,
                 pack_att: bool = False, pack_ffn: bool = False,
                 pack_conv: bool = False) -> List[Dict[str, Any]]:
    """Per-layer views of the stacked [L, ...] layer parameters (compute
    once per model and pass to :func:`encode` as ``layers``); an int8
    weight's view carries its layer of the bf16 copy the model keeps on the
    card (``keep_bf16_copies``), and a bf16 attention bias or conv taps
    view (the weights of ``cast_params_for_compute``) an f32 copy for the
    kernels, which read them in f32 (``keep_f32_copy``). With
    ``pack_tail``, a layer whose conv and FFN2 weights are int8 on the card
    also holds them, with their scales, taps and BN, packed once for the
    fused tail kernel (``conv_ffn_ln_packed``, :func:`pack_conv_ffn_ln`);
    with ``pack_att``, one whose attention weights are int8, bf16 or f32 on
    the card holds them packed once for the attention-block kernel of that
    type (``att_block_packed``, :func:`pack_att_block`); with ``pack_ffn``,
    each FFN whose weights are int8, bf16 or f32 on the card holds them
    packed once for the FFN kernel of that type (``ff1_packed``, ``ff2_packed``,
    :func:`~trt_asr_tpu_torch.ops.kernels.ffn.pack_ffn`), FFN2 only where the
    fused tail does not take it; with ``pack_conv``, one whose conv weights
    are int8, bf16 or f32 on the card holds them, with their taps and BN,
    packed once for the conv-module kernel of that type
    (``conv_block_packed``, :func:`pack_conv_block`), except where the fused
    tail takes the conv."""
    stacked = params["encoder"]["layers"]
    # float leaves split with one unbind each: under autograd its backward
    # stacks the layers' gradients into one tensor, where a view per layer
    # would add a zero-filled [L, ...] tensor per layer and leaf
    unbound = {k: v.unbind(0) for k, v in stacked.items() if not isinstance(v, QuantTensor)}
    out = []
    for li in range(num_layers):
        lp = {}
        for k, v in stacked.items():
            lp[k] = _layer_weight(v, li) if isinstance(v, QuantTensor) else unbound[k][li]
        for k in _F32_FOR_KERNELS:
            keep_f32_copy(lp[k])
        conv = [lp[k] for k in ("conv_pw1", "conv_dw", "conv_bn_g", "conv_bn_b", "conv_bn_m",
                                "conv_bn_v", "conv_pw2")]
        tail = pack_tail and _int8_tail(lp)
        if tail and lp["conv_pw1"].q.is_cuda:
            lp["conv_ffn_ln_packed"] = pack_conv_ffn_ln(*conv, lp["ff2_w1"], lp["ff2_w2"])
        if pack_conv and not tail and (_persistent_weights([conv[0], conv[6]])
                                       or _bf16_weights([conv[0], conv[6]])):
            lp["conv_block_packed"] = pack_conv_block(*conv)
        att = [lp[k] for k in ("att_wq", "att_wk", "att_wv", "att_wo")]
        if pack_att and (_persistent_weights(att) or _bf16_weights(att)):
            lp["att_block_packed"] = pack_att_block(*att)
        for f in ("ff1", "ff2"):
            ws = lp[f"{f}_w1"], lp[f"{f}_w2"]
            if pack_ffn and not (f == "ff2" and tail) and (_persistent_weights(ws)
                                                            or _bf16_weights(ws)):
                lp[f"{f}_packed"] = kernel_ffn.pack_ffn(*ws)
        out.append(lp)
    return out


# small layer parameters that the kernels read in f32, whatever their storage
_F32_FOR_KERNELS = ("att_bias_u", "att_bias_v", "conv_dw")


def _layer_weight(v: QuantTensor, li: int) -> QuantTensor:
    """Layer ``li`` of a stacked int8 weight, with its layer of the stacked
    bf16 copy where the model keeps one."""
    q = v.q[li]
    copy = bf16_copy(v.q)
    if copy is not None:
        keep_bf16_copy(q, copy[li])
    return QuantTensor(q, v.s[li])


def _persistent_weights(ws) -> bool:
    """Whether a module's weights on the card take a persistent kernel of
    every module (the attention block's, the FFN's, the conv module's): all
    int8 or all f32 (bf16 weights: :func:`_bf16_weights`)."""
    if all(isinstance(w, QuantTensor) for w in ws):
        return ws[0].q.is_cuda
    return all(isinstance(w, torch.Tensor) and w.dtype == torch.float32 and w.is_cuda
               for w in ws)


def _bf16_weights(ws) -> bool:
    """Whether a module's weights are all bf16 on the card (the weights of
    ``cast_params_for_compute``): every module takes a persistent kernel for
    them too."""
    return all(isinstance(w, torch.Tensor) and w.dtype == torch.bfloat16 and w.is_cuda
               for w in ws)


def _int8_tail(lp) -> bool:
    """Whether the layer's conv and FFN2 weights take the fused int8 tail."""
    return isinstance(lp["conv_pw1"], QuantTensor) and isinstance(lp["ff2_w1"], QuantTensor)


def _conformer_layer(lp, x, att_cache, time_cache, kv_cache, pos_proj, kv_mask,
                     rel_idx, time_mask, cursor, n_heads: int, cache_keep: int,
                     appended, att_meta: Optional[torch.Tensor] = None,
                     use_pallas_ffn: bool = False, use_pallas_conv: bool = False,
                     use_flash_att: bool = False, fresh: bool = False):
    """One conformer layer over a streaming chunk. Returns (y, att_cache,
    time_cache, kv_cache): the layer's cache views updated in place, or with
    ``fresh`` new cache tensors built out of place (training). ``att_meta``
    (int32 [3] = cursor, cache_len, valid_tq) selects the fused
    attention-block kernel (B=1); ``use_pallas_ffn`` the
    fused FFN kernel for both FFNs; ``use_pallas_conv`` the fused conv
    module (B=1), which with int8 ``conv_pw1`` and ``ff2_w1`` and
    ``use_pallas_ffn`` also runs FFN2 and the output LayerNorm. Offline,
    ``att_cache`` and ``kv_cache`` are None: nothing is cached, the layer
    attends over its own steps (``use_flash_att``: the flash kernel) and
    ``time_cache`` is the zero conv context, left as it is (and returned
    with None for the other two)."""
    b, tq, d = x.shape
    k = time_cache.shape[1]
    dh = d // n_heads
    streaming = att_cache is not None

    def ffn(xx, f):
        ln_g, ln_b, w1, w2 = (lp[f"{f}_{k}"] for k in ("ln_g", "ln_b", "w1", "w2"))
        if use_pallas_ffn:
            return fused_ffn(xx, ln_g, ln_b, w1, w2, scale=0.5, packed=lp.get(f"{f}_packed"))
        hh = layer_norm(xx, ln_g, ln_b)
        return xx + 0.5 * matmul(silu(matmul(hh, w1)), w2)

    x = ffn(x, "ff1")

    if att_meta is not None:
        y1, u1, kn1, vn1 = att_block(
            x[0], lp["att_ln_g"], lp["att_ln_b"], lp["att_wq"], lp["att_wk"],
            lp["att_wv"], lp["att_wo"], lp["att_bias_u"], lp["att_bias_v"],
            pos_proj, kv_cache[0], att_meta, n_heads=n_heads, packed=lp.get("att_block_packed"))
        u, k_new, v_new, x = u1[None], kn1[None], vn1[None], y1[None]
    else:
        u = layer_norm(x, lp["att_ln_g"], lp["att_ln_b"])
        q = matmul(u, lp["att_wq"]).reshape(b, tq, n_heads, dh)
        k_new = matmul(u, lp["att_wk"])
        v_new = matmul(u, lp["att_wv"])
        if streaming:
            k_full = torch.cat([kv_cache[..., :d].to(u.dtype), k_new], dim=1)
            v_full = torch.cat([kv_cache[..., d:].to(u.dtype), v_new], dim=1)
        else:
            k_full, v_full = k_new, v_new
        tkv = k_full.shape[1]
        y = rel_pos_attention_kv(
            q, k_full.reshape(b, tkv, n_heads, dh), v_full.reshape(b, tkv, n_heads, dh),
            pos_proj.reshape(-1, n_heads, dh),
            lp["att_bias_u"], lp["att_bias_v"], lp["att_wo"],
            kv_mask=kv_mask, rel_idx=rel_idx, use_flash=use_flash_att)
        x = x + y
    if streaming:
        inplace = not fresh
        att_cache = _ring_write(att_cache, u[:, :cache_keep], cursor, appended, inplace)
        kv_cache = _ring_write(kv_cache, torch.cat([k_new, v_new], dim=-1)[:, :cache_keep],
                               cursor, appended, inplace)

    def time_write(block):
        new = _append_cache(time_cache, block, appended)
        return new if fresh else time_cache.copy_(new)

    # convolution module; with int8 weights and both flags, conv + FFN2 +
    # out-LN in one kernel
    fused_tail = use_pallas_conv and use_pallas_ffn and _int8_tail(lp)
    if use_pallas_conv:
        conv = (x[0], lp["conv_ln_g"], lp["conv_ln_b"], lp["conv_pw1"], lp["conv_dw"],
                lp["conv_bn_g"], lp["conv_bn_b"], lp["conv_bn_m"], lp["conv_bn_v"],
                lp["conv_pw2"], time_cache[0], time_mask[0][:, None].float())
        if fused_tail:
            y2, c1 = conv_ffn_ln(*conv, lp["ff2_ln_g"], lp["ff2_ln_b"], lp["ff2_w1"],
                                 lp["ff2_w2"], lp["out_ln_g"], lp["out_ln_b"],
                                 packed=lp.get("conv_ffn_ln_packed"))
            if streaming:
                time_cache = time_write(c1[None, :cache_keep])
            return y2[None], att_cache, time_cache, kv_cache
        y2, c1 = conv_block(*conv, packed=lp.get("conv_block_packed"))
        c, x = c1[None], y2[None]
    else:
        c = layer_norm(x, lp["conv_ln_g"], lp["conv_ln_b"])
        c = glu(matmul(c, lp["conv_pw1"]), dim=-1)
        c = torch.where(time_mask[:, :, None], c,
                        torch.zeros((), dtype=c.dtype, device=c.device))
        c_ext = torch.cat([time_cache.to(c.dtype), c, c.new_zeros((b, k, d))], dim=1)
        cv = depthwise_conv1d(c_ext, lp["conv_dw"])
        cv = batch_norm_inference(cv, lp["conv_bn_g"], lp["conv_bn_b"],
                                  lp["conv_bn_m"], lp["conv_bn_v"])
        x = x + matmul(silu(cv), lp["conv_pw2"])
    if streaming:
        time_cache = time_write(c[:, :cache_keep])

    x = ffn(x, "ff2")
    return layer_norm(x, lp["out_ln_g"], lp["out_ln_b"]), att_cache, time_cache, kv_cache


def encode(
    params: Dict[str, Any],
    cfg: ModelConfig,
    feats: torch.Tensor,            # [B, T, feat_in]
    lengths: torch.Tensor,          # [B] int (valid feature frames)
    state: Optional[EncoderState] = None,
    *,
    drop_extra: int = 0,            # pre-encoded steps to drop
    cache_drop: int = 0,            # trailing lookahead steps kept out of caches
    valid_cap: Optional[int] = None,  # emission cap; None = Tq - cache_drop
    cache_drop_vec: Optional[torch.Tensor] = None,  # [B] per-row cache_drop (overrides
                                    # cache_drop): steady and flush rows in one step
    valid_cap_vec: Optional[torch.Tensor] = None,   # [B] per-row emission cap
    pad_steps: int = 0,             # zero rows appended after drop_extra (masked)
    use_pallas_att: bool = False,   # fused attention-block kernel (B=1 streaming)
    use_pallas_ffn: bool = False,   # fused FFN kernel
    use_pallas_conv: bool = False,  # fused conv-module kernel (B=1)
    compute_dtype: torch.dtype = torch.float32,
    use_flash_att: bool = False,    # offline: flash attention kernel
    mask_pad_subsample: bool = False,  # zero padded tails between subsampler
                                    # stages (a padded batch row then equals
                                    # its exact-length run)
    pos_proj: Optional[torch.Tensor] = None,  # [L, R, D] for this chunk's Tq
    layers: Optional[List[Dict[str, Any]]] = None,  # layer_params(params, L)
    remat: bool = False,            # recompute each layer's activations in backward
) -> Tuple[torch.Tensor, torch.Tensor, Optional[EncoderState]]:
    """One streaming chunk, or with ``state=None`` a whole utterance
    offline. Returns (enc_out [B, Tq, D] in ``compute_dtype``, out_lengths
    [B], new_state); enc_out has the full Tq step axis, out_lengths the
    valid count. Serving, the caches of ``state`` are updated in place and
    the new state holds the same tensors; when autograd records the input
    or a parameter, or with ``remat``, the new caches are built out of
    place and returned in a fresh state (``state`` is left as it was), and
    the kernel flags raise (the kernels have no backward). Offline the new
    state is None. ``remat`` checkpoints each layer
    (``torch.utils.checkpoint``, non-reentrant): backward recomputes its
    activations, the JAX package's ``jax.checkpoint``. With
    ``cache_drop_vec`` each row keeps its own count out of the caches, and
    emits up to its ``valid_cap_vec`` entry (by default Tq - its
    cache_drop), as the JAX package's lockstep batch step does."""
    enc_p = params["encoder"]
    b = feats.shape[0]
    if use_pallas_conv and b != 1:
        raise ValueError(f"use_pallas_conv requires B=1, got B={b}")
    streaming = state is not None
    if use_pallas_att and not (streaming and b == 1):
        raise ValueError("use_pallas_att requires B=1 streaming")
    dev = feats.device
    lengths = torch.as_tensor(lengths, device=dev).reshape(b).to(torch.int32)
    x = dw_striding_subsample(enc_p["pre_encode"], feats.to(compute_dtype),
                              lengths=lengths if mask_pad_subsample else None)
    sub_len = subsampled_length(lengths, cfg.stride_stages)
    if drop_extra:
        x = x[:, drop_extra:]
        sub_len = torch.clamp_min(sub_len - drop_extra, 0)
    if pad_steps:
        x = F.pad(x, (0, 0, 0, pad_steps))
    tq = x.shape[1]
    tq_real = tq - pad_steps
    c_size = state.att_cache.shape[2] if streaming else 0
    keep_vec = None
    if cache_drop_vec is not None:
        # per-row keep: the whole block is offered to the caches, each row's
        # write count bounded by its own keep
        cache_keep = tq_real
        keep_vec = torch.clamp_min(tq_real - torch.as_tensor(cache_drop_vec, device=dev)
                                   .reshape(b).to(torch.int32), 0)
        appended = torch.minimum(sub_len, keep_vec).to(torch.int32)
    else:
        cache_keep = max(tq_real - cache_drop, 0)
        appended = torch.clamp_max(sub_len, cache_keep).to(torch.int32)
    if pos_proj is None:
        pos_proj = precompute_pos_proj(params, cfg, tq, c_size, compute_dtype)

    ar_t = torch.arange(tq, device=dev)
    time_mask = ar_t[None, :] < sub_len[:, None]                       # [B, Tq]
    att_meta = kv_mask = rel_idx = None
    cache_len, cursor = (state.cache_len, state.cursor) if streaming else (None, None)
    if not streaming:
        # static relative indices (rel_idx None): the attention's shift
        kv_mask = time_mask
        zero_context = torch.zeros((b, cfg.conv_context_size, cfg.d_model),
                                   dtype=compute_dtype, device=dev)
    elif use_pallas_att:
        att_meta = torch.stack([cursor[0], cache_len[0],
                                torch.clamp_max(sub_len[0], tq)]).to(torch.int32)
    else:
        # ring-slot ages and relative-position indices, shared by all layers
        age = torch.remainder(cursor[:, None].long() - 1
                              - torch.arange(c_size, device=dev)[None, :], c_size) + 1
        cache_mask = age <= cache_len[:, None]
        idx_cache = (c_size + tq - 1) - (age[:, None, :] + ar_t[None, :, None])
        idx_cur = ((c_size + tq - 1) - (ar_t[:, None] - ar_t[None, :]))[None].expand(b, tq, tq)
        rel_idx = torch.cat([idx_cache, idx_cur], dim=2)
        kv_mask = torch.cat([cache_mask, time_mask], dim=1)

    x = torch.where(time_mask[:, :, None], x, torch.zeros((), dtype=x.dtype, device=dev))
    # training (autograd recording, or remat) builds the caches out of place
    fresh = remat or (torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, pos_proj, *enc_p["layers"].values())
        if isinstance(t, torch.Tensor)))
    if fresh and (use_pallas_att or use_pallas_ffn or use_pallas_conv or use_flash_att):
        raise ValueError("the encoder kernels have no backward: train with their flags off")
    if layers is None:
        layers = layer_params(params, cfg.num_layers)
    new_caches = []
    for li, lp in enumerate(layers):
        caches = ((state.att_cache[li], state.time_cache[li], state.kv_cache[li])
                  if streaming else (None, zero_context, None))
        layer = functools.partial(
            _conformer_layer, lp, pos_proj=pos_proj[li], kv_mask=kv_mask, rel_idx=rel_idx,
            time_mask=time_mask, cursor=cursor, n_heads=cfg.n_heads, cache_keep=cache_keep,
            appended=appended, att_meta=att_meta, use_pallas_ffn=use_pallas_ffn,
            use_pallas_conv=use_pallas_conv, use_flash_att=use_flash_att, fresh=fresh)
        if remat:
            x, *caches = checkpoint(layer, x, *caches, use_reentrant=False)
        else:
            x, *caches = layer(x, *caches)
        new_caches.append(caches)

    out_len = torch.clamp_max(sub_len, tq)
    if not streaming:
        return x, out_len, None
    cache_len = torch.clamp_max(cache_len + appended, c_size).to(torch.int32)
    cursor = ((cursor + appended) % max(c_size, 1)).to(torch.int32)
    if fresh:
        new_state = EncoderState(*(torch.stack(c) for c in zip(*new_caches)), cache_len, cursor)
    else:
        new_state = EncoderState(state.att_cache, state.time_cache, state.kv_cache,
                                 cache_len, cursor)
    if keep_vec is not None:
        cap = (keep_vec if valid_cap_vec is None
               else torch.as_tensor(valid_cap_vec, device=dev).reshape(b).to(torch.int32))
        return x, torch.minimum(out_len, cap), new_state
    cap = valid_cap if valid_cap is not None else cache_keep
    return x, torch.clamp_max(out_len, cap), new_state


def precompute_pos_proj(params, cfg: ModelConfig, tq: int, c_size: int,
                        compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Per-layer positional projections for a fixed chunk shape,
    [L, Tq + C + Tq - 1, D] in ``compute_dtype`` (input-independent: compute
    once per session). In bf16 the table and W_pos are rounded to bf16 and
    multiplied with f32 sums, as the JAX package's einsum does."""
    wpos = params["encoder"]["layers"]["att_wpos"]
    table = sinusoidal_pos_table(tq, c_size + tq, cfg.d_model, dtype=compute_dtype,
                                 device=wpos.device)
    out = torch.matmul(table.float()[None], wpos.to(compute_dtype).float())
    return out.to(compute_dtype)


def offline_encode(params, cfg: ModelConfig, feats: torch.Tensor, lengths,
                   compute_dtype: torch.dtype = torch.float32, use_flash_att: bool = False,
                   mask_pad_subsample: bool = False,
                   layers: Optional[List[Dict[str, Any]]] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-utterance encoding. Returns (enc_out [B, T, D] in
    ``compute_dtype``, out_lengths [B]). ``mask_pad_subsample`` makes a
    padded mixed-length batch equal its per-utterance runs."""
    enc, out_len, _ = encode(params, cfg, feats, lengths, None, compute_dtype=compute_dtype,
                             use_flash_att=use_flash_att,
                             mask_pad_subsample=mask_pad_subsample, layers=layers)
    return enc, out_len


# --- contract-layout state conversion (left-aligned valid prefix) ----------


def state_to_contract(state: EncoderState) -> Dict[str, torch.Tensor]:
    """Ring-ordered [L,B,C,D] -> contract layouts: cache_last_channel
    [B, L, C, D] (chronological valid prefix), cache_last_time [B, L, D, K],
    cache_last_channel_len [B]. Returns new tensors."""
    l, b, c, d = state.att_cache.shape
    dev = state.att_cache.device
    start = (state.cursor.long() - state.cache_len.long()) % max(c, 1)      # [B]
    idx = (start[:, None] + torch.arange(c, device=dev)[None, :]) % max(c, 1)
    att = state.att_cache.permute(1, 0, 2, 3)                                # [B, L, C, D]
    att = torch.gather(att, 2, idx[:, None, :, None].expand(b, l, c, d))
    valid = torch.arange(c, device=dev)[None, None, :, None] < state.cache_len[:, None, None, None]
    att = torch.where(valid, att, torch.zeros((), dtype=att.dtype, device=dev))
    time = state.time_cache.permute(1, 0, 3, 2).clone()                      # [B, L, D, K]
    return {"cache_last_channel": att, "cache_last_time": time,
            "cache_last_channel_len": state.cache_len.clone()}


def state_from_contract(d: Dict[str, torch.Tensor], params=None) -> EncoderState:
    """Contract layout -> ring state. The projected kv cache is rebuilt
    exactly from the raw cache when ``params`` is given (kv = raw @
    [W_k ++ W_v]); without params it is zeroed and not usable for further
    streaming."""
    att = d["cache_last_channel"].permute(1, 0, 2, 3)                        # [L, B, C, D]
    c = att.shape[2]
    cache_len = d["cache_last_channel_len"].to(torch.int32)
    valid = (torch.arange(c, device=att.device)[None, None, :, None]
             < cache_len[None, :, None, None])
    att = torch.where(valid, att, torch.zeros((), dtype=att.dtype, device=att.device)).contiguous()
    time = d["cache_last_time"].permute(1, 0, 3, 2).contiguous()
    if params is not None:
        layers = params["encoder"]["layers"]
        wk, wv = layers["att_wk"], layers["att_wv"]
        if isinstance(wk, QuantTensor):
            wk, wv = dequantize(wk), dequantize(wv)
        wk, wv = wk.to(att.dtype), wv.to(att.dtype)
        kv = torch.cat([torch.einsum("lbcd,lde->lbce", att, wk),
                        torch.einsum("lbcd,lde->lbce", att, wv)], dim=-1).contiguous()
    else:
        kv = att.new_zeros(att.shape[:-1] + (2 * att.shape[-1],))
    return EncoderState(att, time, kv, cache_len, cache_len % max(c, 1))
