"""Scoped int8 weight-only quantization of the Parakeet parameter tree.

Scopes (RuntimeConfig.quant / TRT_ASR_QUANT): "joint" (the joint enc/pred/out
projections), "encoder" (the ten large per-layer linears), "all" (both),
"none". LN/BN/bias/depthwise/positional weights, the predictor LSTM and the
pre-encode convs stay float, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict

from trt_asr_tpu_torch.ops.quant import quantize_tensor

_ENC_LINEARS = ("ff1_w1", "ff1_w2", "ff2_w1", "ff2_w2",
                "att_wq", "att_wk", "att_wv", "att_wo",
                "conv_pw1", "conv_pw2")

SCOPES = ("none", "joint", "encoder", "all")


def quantize_params(params: Dict[str, Any], scope: str = "all") -> Dict[str, Any]:
    """A new tree with the scoped weight leaves int8-quantized; unmodified
    leaves are shared with the input tree."""
    if scope not in SCOPES:
        raise ValueError(f"quant scope {scope!r} is not one of {SCOPES}")
    if scope == "none":
        return params
    p = dict(params)
    if scope in ("joint", "all"):
        p["joint"] = {
            k: {**params["joint"][k], "w": quantize_tensor(params["joint"][k]["w"])}
            for k in ("enc", "pred", "out")
        }
    if scope in ("encoder", "all"):
        layers = dict(params["encoder"]["layers"])
        for k in _ENC_LINEARS:
            layers[k] = quantize_tensor(layers[k])
        p["encoder"] = {**params["encoder"], "layers": layers}
    return p

