"""The PyTorch port's hand-written CUDA kernels against their plain PyTorch
versions on a CUDA device: the fused attention block, the fused joint step
and the fused log-mel, with f32, bf16 and int8 weights where the kernel
takes them, and the gate_r3 streaming session with every kernel on against
the same session on the CPU.

Every test here needs the card and skips without one. This file imports
nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

Tolerances: attention block 1e-4 (f32) and 2e-3 (bf16 operands: an f32
value that differs in its last bit can round to a neighbouring bf16 value);
joint logits 1e-4 with tokens and durations exact; log-mel 1e-3 absolute
(log of sums that reach ~1e4, summed in another order); session tokens
exact."""

import math

import numpy as np
import pytest
import torch

from torch_port_helpers import GATE_R3, require_cuda, synth_audio

from trt_asr_tpu_torch.config import RuntimeConfig
from trt_asr_tpu_torch.contract import FrontendSpec
from trt_asr_tpu_torch.frontend.logmel import LogMelFrontend
from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT
from trt_asr_tpu_torch.ops.kernels.att_block import att_block, att_block_plain
from trt_asr_tpu_torch.ops.kernels.joint_step import joint_step, joint_step_plain
from trt_asr_tpu_torch.ops.kernels.mel import logmel, logmel_plain
from trt_asr_tpu_torch.ops.quant import quantize_tensor
from trt_asr_tpu_torch.streaming.session import StreamingSession

WEIGHTS = ["f32", "bf16", "int8"]


def as_weight(w: torch.Tensor, kind: str):
    if kind == "int8":
        return quantize_tensor(w)
    return w.to(torch.bfloat16) if kind == "bf16" else w


@pytest.mark.cuda
@pytest.mark.parametrize("kind", WEIGHTS)
def test_att_block_kernel_matches_plain(kind):
    dev = require_cuda()
    d, h, c, tq = 64, 4, 32, 8
    rng = np.random.default_rng(5)
    r = lambda *s, sc=0.3: torch.as_tensor(  # noqa: E731
        (rng.standard_normal(s) * sc).astype(np.float32), device=dev)
    x, ln_g, ln_b = r(tq, d, sc=1.0), 1.0 + r(d, sc=0.2), r(d, sc=0.1)
    ws = [as_weight(r(d, d), kind) for _ in range(4)]
    rest = (r(h, d // h), r(h, d // h), r(2 * tq + c - 1, d), r(c, 2 * d))
    for cursor, cache_len, valid_tq in [(7, 19, 6), (0, 0, 6), (5, 32, 8), (31, 32, 1)]:
        meta = torch.tensor([cursor, cache_len, valid_tq], dtype=torch.int32, device=dev)
        args = (x, ln_g, ln_b, *ws, *rest, meta)
        before = att_block.launches
        got = att_block(*args, n_heads=h)
        assert att_block.launches == before + 1
        want = att_block_plain(*args, n_heads=h)
        torch.cuda.synchronize()
        atol = 1e-4 if kind == "f32" else 2e-3
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=atol, rtol=1e-4)
    assert math.isfinite(float(got[0].sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", WEIGHTS)
def test_joint_step_kernel_matches_plain(kind):
    dev = require_cuda()
    p, j, vocab, ndur = 32, 48, 64, 5
    ths = vocab + 1
    v = ths + ndur
    for rows in (1, 8, 37):                       # one and several 8-row passes
        rng = np.random.default_rng(rows)
        r = lambda *s, sc=1.0: torch.as_tensor(  # noqa: E731
            (rng.standard_normal(s) * sc).astype(np.float32), device=dev)
        wp, wo = as_weight(r(p, j, sc=0.3), kind), as_weight(r(j, v, sc=0.3), kind)
        args = (r(rows, j), r(rows, p, sc=0.5), wp, r(j, sc=0.1), wo, r(v, sc=0.1))
        kw = dict(ths=ths, ndur=ndur, blank_id=vocab, blank_penalty=0.7)
        tok, dur, lg = joint_step(*args, **kw)
        tok_p, dur_p, lg_p = joint_step_plain(*args, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(lg, lg_p, atol=1e-4, rtol=1e-4)
        assert torch.equal(tok, tok_p) and torch.equal(dur, dur_p)


@pytest.mark.cuda
def test_joint_step_kernel_tie_picks_first_index():
    dev = require_cuda()
    j, v, ths = 16, 12, 8
    e = torch.zeros((2, j), device=dev)
    g = torch.zeros((2, 4), device=dev)
    wp = torch.zeros((4, j), device=dev)
    wo = torch.zeros((j, v), device=dev)
    bo = torch.zeros(v, device=dev)
    bo[[2, 5]] = 1.0                              # token tie between 2 and 5
    bo[[ths + 1, ths + 3]] = 2.0                  # duration tie between 1 and 3
    tok, dur, _ = joint_step(e, g, wp, torch.zeros(j, device=dev), wo, bo,
                             ths=ths, ndur=v - ths, blank_id=ths - 1)
    assert tok.tolist() == [2, 2] and dur.tolist() == [1, 1]


@pytest.mark.cuda
def test_logmel_kernel_matches_plain():
    dev = require_cuda()
    fe = LogMelFrontend(FrontendSpec(n_mels=128), device=dev)
    frames = torch.as_tensor(
        (np.random.default_rng(5).standard_normal((53, 400)) * 0.3).astype(np.float32), device=dev)
    args = (frames, fe._wcos, fe._wsin, fe._mel, fe.spec.log_floor)
    before = logmel.launches
    got = logmel(*args)
    assert logmel.launches == before + 1
    torch.testing.assert_close(got, logmel_plain(*args), atol=1e-3, rtol=1e-5)


@pytest.mark.cuda
def test_gate_r3_session_with_kernels_matches_cpu():
    dev = require_cuda()
    rt = RuntimeConfig(use_pallas_att=True, use_pallas_joint=True)
    gpu = ParakeetTDT.from_model_dir(GATE_R3, runtime=rt, device=dev)
    gpu.frontend = LogMelFrontend(FrontendSpec(n_mels=gpu.cfg.feat_in), use_kernel=True,
                                  device=dev)
    cpu = ParakeetTDT.from_model_dir(GATE_R3, runtime=RuntimeConfig(), device="cpu")
    audio = synth_audio(seed=21, words=6)
    counts = (att_block.launches, joint_step.launches, logmel.launches)
    sessions = []
    for model in (gpu, cpu):
        sess = StreamingSession(model, model.runtime)
        for i in range(0, len(audio), 8000):
            sess.push_audio(audio[i:i + 8000])
        sess.finalize()
        sessions.append(sess)
    after = (att_block.launches, joint_step.launches, logmel.launches)
    assert all(a > b for a, b in zip(after, counts))
    assert sessions[0].tokens == sessions[1].tokens
    assert len(sessions[0].tokens) > 0
