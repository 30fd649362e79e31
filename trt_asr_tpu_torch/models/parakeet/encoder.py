"""Fast Conformer encoder, cache-aware streaming.

Same semantics as the JAX package's ``models/parakeet/encoder.py``
(streaming branch): dw_striding 8x subsampling, then N conformer layers
(0.5*FF -> rel-pos MHA over a ring kv cache -> conv module over a time
cache -> 0.5*FF -> LayerNorm). A Python loop over layers takes the place of
``lax.scan``.

State: ring-buffered caches ``[L, B, C, D]`` (``att_cache``: raw attention
inputs, ``kv_cache``: projected k ++ v), ``time_cache [L, B, K, D]``,
``cache_len``/``cursor [B]`` int32. ``encode`` updates the three caches IN
PLACE and returns a state holding the same cache tensors; callers that need
the old state keep a copy (the session's ``snapshot`` copies).
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from trt_asr_tpu_torch.config import ModelConfig
from trt_asr_tpu_torch.ops.attention import rel_pos_attention_kv, sinusoidal_pos_table
from trt_asr_tpu_torch.ops.common import (batch_norm_inference, glu, layer_norm,
                                          matmul, silu)
from trt_asr_tpu_torch.ops.conv import (depthwise_conv1d, dw_striding_subsample,
                                        subsampled_length)
from trt_asr_tpu_torch.ops.kernels.att_block import att_block
from trt_asr_tpu_torch.ops.quant import QuantTensor, dequantize


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
                appended: torch.Tensor) -> torch.Tensor:
    """Write block[b, :appended[b]] into ring slots (cursor[b] + i) mod C, in
    place. cache [B, C, D], block [B, S, D] with S <= C. Rows past
    ``appended`` rewrite the slot's old value (the JAX version drops them
    with an out-of-range index, which torch indexing rejects)."""
    b, c, _ = cache.shape
    s = block.shape[1]
    if s == 0:
        return cache
    assert s <= c, "ring write longer than the cache"
    ar = torch.arange(s, device=cache.device)
    pos = (cursor.long()[:, None] + ar[None, :]) % c                   # [B, S]
    keep = ar[None, :] < appended[:, None]                             # [B, S]
    bidx = torch.arange(b, device=cache.device)[:, None].expand(b, s)
    cache[bidx, pos] = torch.where(keep[..., None], block.to(cache.dtype), cache[bidx, pos])
    return cache


def _append_cache(cache: torch.Tensor, block: torch.Tensor,
                  appended: torch.Tensor) -> torch.Tensor:
    """Right-aligned cache update with a per-row valid count: the last C
    entries of (cache ++ block[:appended]). cache [B, C, D], block [B, S, D]."""
    c = cache.shape[1]
    full = torch.cat([cache, block.to(cache.dtype)], dim=1)
    idx = appended.long()[:, None] + torch.arange(c, device=cache.device)[None, :]
    return torch.gather(full, 1, idx[:, :, None].expand(-1, -1, full.shape[2]))


def layer_params(params: Dict[str, Any], num_layers: int) -> List[Dict[str, Any]]:
    """Per-layer views of the stacked [L, ...] layer parameters (compute
    once per model and pass to :func:`encode` as ``layers``)."""
    stacked = params["encoder"]["layers"]
    out = []
    for li in range(num_layers):
        lp = {}
        for k, v in stacked.items():
            lp[k] = QuantTensor(v.q[li], v.s[li]) if isinstance(v, QuantTensor) else v[li]
        out.append(lp)
    return out


def _conformer_layer(lp, x, att_cache, time_cache, kv_cache, pos_proj, kv_mask,
                     rel_idx, time_mask, cursor, n_heads: int, cache_keep: int,
                     appended, att_meta: Optional[torch.Tensor] = None):
    """One conformer layer over a streaming chunk; updates the layer's cache
    views in place. ``att_meta`` (int32 [3] = cursor, cache_len, valid_tq)
    selects the fused attention-block kernel (B=1)."""
    b, tq, d = x.shape
    k = time_cache.shape[1]
    dh = d // n_heads

    def ffn(xx, ln_g, ln_b, w1, w2):
        hh = layer_norm(xx, ln_g, ln_b)
        return xx + 0.5 * matmul(silu(matmul(hh, w1)), w2)

    x = ffn(x, lp["ff1_ln_g"], lp["ff1_ln_b"], lp["ff1_w1"], lp["ff1_w2"])

    if att_meta is not None:
        y1, u1, kn1, vn1 = att_block(
            x[0], lp["att_ln_g"], lp["att_ln_b"], lp["att_wq"], lp["att_wk"],
            lp["att_wv"], lp["att_wo"], lp["att_bias_u"], lp["att_bias_v"],
            pos_proj, kv_cache[0], att_meta, n_heads=n_heads)
        u, k_new, v_new, x = u1[None], kn1[None], vn1[None], y1[None]
    else:
        u = layer_norm(x, lp["att_ln_g"], lp["att_ln_b"])
        q = matmul(u, lp["att_wq"]).reshape(b, tq, n_heads, dh)
        k_new = matmul(u, lp["att_wk"])
        v_new = matmul(u, lp["att_wv"])
        c_size = kv_cache.shape[1]
        k_full = torch.cat([kv_cache[..., :d].to(u.dtype), k_new], dim=1)
        v_full = torch.cat([kv_cache[..., d:].to(u.dtype), v_new], dim=1)
        y = rel_pos_attention_kv(
            q, k_full.reshape(b, c_size + tq, n_heads, dh),
            v_full.reshape(b, c_size + tq, n_heads, dh),
            pos_proj.reshape(-1, n_heads, dh),
            lp["att_bias_u"], lp["att_bias_v"], lp["att_wo"],
            kv_mask=kv_mask, rel_idx=rel_idx)
        x = x + y
    _ring_write(att_cache, u[:, :cache_keep], cursor, appended)
    _ring_write(kv_cache, torch.cat([k_new, v_new], dim=-1)[:, :cache_keep], cursor, appended)

    # convolution module
    c = layer_norm(x, lp["conv_ln_g"], lp["conv_ln_b"])
    c = glu(matmul(c, lp["conv_pw1"]), dim=-1)
    c = torch.where(time_mask[:, :, None], c, torch.zeros((), dtype=c.dtype, device=c.device))
    c_ext = torch.cat([time_cache.to(c.dtype), c, c.new_zeros((b, k, d))], dim=1)
    cv = depthwise_conv1d(c_ext, lp["conv_dw"])
    cv = batch_norm_inference(cv, lp["conv_bn_g"], lp["conv_bn_b"],
                              lp["conv_bn_m"], lp["conv_bn_v"])
    x = x + matmul(silu(cv), lp["conv_pw2"])
    time_cache.copy_(_append_cache(time_cache, c[:, :cache_keep], appended))

    x = ffn(x, lp["ff2_ln_g"], lp["ff2_ln_b"], lp["ff2_w1"], lp["ff2_w2"])
    return layer_norm(x, lp["out_ln_g"], lp["out_ln_b"])


def encode(
    params: Dict[str, Any],
    cfg: ModelConfig,
    feats: torch.Tensor,            # [B, T, feat_in]
    lengths: torch.Tensor,          # [B] int (valid feature frames)
    state: EncoderState,
    *,
    drop_extra: int = 0,            # pre-encoded steps to drop
    cache_drop: int = 0,            # trailing lookahead steps kept out of caches
    valid_cap: Optional[int] = None,  # emission cap; None = Tq - cache_drop
    pad_steps: int = 0,             # zero rows appended after drop_extra (masked)
    use_pallas_att: bool = False,   # fused attention-block kernel (B=1)
    pos_proj: Optional[torch.Tensor] = None,  # [L, R, D] for this chunk's Tq
    layers: Optional[List[Dict[str, Any]]] = None,  # layer_params(params, L)
) -> Tuple[torch.Tensor, torch.Tensor, EncoderState]:
    """One streaming chunk. Returns (enc_out [B, Tq, D], out_lengths [B],
    new_state); enc_out has the full Tq step axis, out_lengths the valid
    count. The caches of ``state`` are updated in place."""
    if state is None:
        raise NotImplementedError("offline encode is not ported yet; pass a state")
    enc_p = params["encoder"]
    b = feats.shape[0]
    dev = feats.device
    lengths = torch.as_tensor(lengths, device=dev).reshape(b).to(torch.int32)
    x = dw_striding_subsample(enc_p["pre_encode"], feats.float())
    sub_len = subsampled_length(lengths, cfg.stride_stages)
    if drop_extra:
        x = x[:, drop_extra:]
        sub_len = torch.clamp_min(sub_len - drop_extra, 0)
    if pad_steps:
        x = F.pad(x, (0, 0, 0, pad_steps))
    tq = x.shape[1]
    tq_real = tq - pad_steps
    c_size = state.att_cache.shape[2]
    cache_len, cursor = state.cache_len, state.cursor
    cache_keep = max(tq_real - cache_drop, 0)
    appended = torch.clamp_max(sub_len, cache_keep).to(torch.int32)
    if pos_proj is None:
        pos_proj = precompute_pos_proj(params, cfg, tq, c_size)

    ar_t = torch.arange(tq, device=dev)
    time_mask = ar_t[None, :] < sub_len[:, None]                       # [B, Tq]
    att_meta = kv_mask = rel_idx = None
    if use_pallas_att:
        assert b == 1, "use_pallas_att requires B=1 streaming"
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
    if layers is None:
        layers = layer_params(params, cfg.num_layers)
    for li, lp in enumerate(layers):
        x = _conformer_layer(lp, x, state.att_cache[li], state.time_cache[li],
                             state.kv_cache[li], pos_proj[li], kv_mask, rel_idx,
                             time_mask, cursor, cfg.n_heads, cache_keep, appended,
                             att_meta=att_meta)

    cap = valid_cap if valid_cap is not None else cache_keep
    out_len = torch.clamp_max(torch.clamp_max(sub_len, tq), cap)
    new_state = EncoderState(
        state.att_cache, state.time_cache, state.kv_cache,
        torch.clamp_max(cache_len + appended, c_size).to(torch.int32),
        ((cursor + appended) % max(c_size, 1)).to(torch.int32))
    return x, out_len, new_state


def precompute_pos_proj(params, cfg: ModelConfig, tq: int, c_size: int) -> torch.Tensor:
    """Per-layer positional projections for a fixed chunk shape,
    [L, Tq + C + Tq - 1, D] (input-independent: compute once per session)."""
    wpos = params["encoder"]["layers"]["att_wpos"]
    table = sinusoidal_pos_table(tq, c_size + tq, cfg.d_model, device=wpos.device)
    return torch.matmul(table[None], wpos.float())


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
