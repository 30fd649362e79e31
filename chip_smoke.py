#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``trt_asr_tpu_torch``) on one
NVIDIA H100. Run from the repository root:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches its own failure):

1. device, ``nvidia-smi`` name and power limit; build the CUDA kernels
   from ``trt_asr_tpu_torch/csrc`` (one nvcc per source, in parallel);
   each kernel's registers, spills and static shared memory (ptxas), and
   the dynamic shared memory and blocks an SM of the flash kernels (bf16
   and f32), of the bf16 rel-shift kernel, of the fused conv + FFN2 +
   out-LN tail, of the int8, bf16 and f32 attention blocks, joint steps,
   FFNs and conv modules (each one cooperative launch: its grid at full width
   must be resident at once), and the log-mel kernel's grid at a 0.5 s
   push.
2. each kernel against its plain PyTorch version on the card at the
   full-size main-path shapes (a steady chunk: 8 rows, 6 valid; f32 and
   int8 weights for the attention block, the joint step, the FFN and the
   conv module, int8 for the fused conv + FFN2 + out-LN tail, f32 for the
   log-mel), with each one's median time, the plain version's time and
   the bound (bytes or operations) and the host's enqueue time a call.
   Each int8 tolerance, and bf16 flash
   attention's, is shown to fail a kernel without the bf16 rounding points
   (the plain version on the dequantized weights, or on the bf16 operands
   widened to f32, where p is not rounded). The tail and the int8 and f32
   attention blocks (``csrc/att_block_q8.cu``, ``csrc/att_block_f32.cu``)
   run on constants packed once beforehand, as the model packs them; each
   one's cooperative launch is captured into a CUDA graph and replayed, and
   the replay must equal the direct call bit for bit. The f32 attention
   block is timed beside the chain of ``csrc/att_block.cu`` that it
   replaced (as the bf16 kernel is, below). The int8 and f32 joint steps
   (``csrc/joint_step_q8.cu``, ``csrc/joint_step_f32.cu``) run on their
   weights packed once, as the model packs them, are captured and replayed,
   and are timed beside the three launches of ``csrc/joint_step.cu`` that
   they replaced (as the bf16 joint step is, below). The int8 and f32 FFNs
   (``csrc/ffn_q8.cu``, ``csrc/ffn_f32.cu``) run on their weights packed
   once, as the model packs them, are captured and replayed, and are timed
   beside the five launches of ``csrc/ffn.cu`` that they replaced (as
   the bf16 FFN is, below). The int8 and f32 conv modules
   (``csrc/conv_block_q8.cu``, ``csrc/conv_block_f32.cu``) run on their
   constants packed once, as the model packs them, are captured and
   replayed, and are timed beside the five launches of
   ``csrc/conv_block.cu`` that they replaced (as the bf16 conv module is).
   The log-mel kernel runs at T 1,
   50 (a 0.5 s push, the kernels line's reading), 51 and 300 (a flush),
   each held at 1e-3, timed beside its plain version and replayed from a
   captured graph. Then the bf16 weights of ``cast_params_for_compute``
   (bf16 biases and taps, their f32 copies kept once): the bf16 attention
   block (``csrc/att_block_bf16.cu``, over an f32 and a bf16 kv cache read
   as stored), joint step (``csrc/joint_step_bf16.cu``; tokens and
   durations equal wherever the top-2 margin is clear), FFN
   (``csrc/ffn_bf16.cu``) and conv module (``csrc/conv_block_bf16.cu``,
   over an f32 and a bf16 time cache read as stored), each one cooperative
   launch on its weights packed once, as the model packs them, and timed
   beside the chain it replaced (``csrc/att_block.cu``,
   ``csrc/joint_step.cu``, ``csrc/ffn.cu``, ``csrc/conv_block.cu``) in the
   same run, and faster than it; all at 1e-3, a tolerance shown to fail
   the plain version without the bf16 rounding points; and the int8
   attention block and
   joint step with bf16 biases (the fast arm) at 1e-4, each timed beside
   its plain version and its bound and replayed from a captured graph.
3. full-width session (``ModelConfig()``, seeded random weights from the
   port's ``init_params``): a seeded synthetic utterance of 8 words
   (~4 s) pushed in 0.5 s pieces, with a blank bias set so the plain f32
   path emits about one token a word. Arms: f32 with the attention,
   joint and log-mel kernels on (``f32_on``) and with the FFN and conv
   kernels on too (``f32_all``), each token-exact against the same session
   with the kernels off; int8 ``quant="all"`` with the first three kernels
   (``int8_on``), with every kernel (``int8_all``: FFN1 through the FFN
   kernel, the conv module, FFN2 and the out-LN through the fused tail),
   and with the conv kernel and no FFN kernel (``int8_conv``: the conv
   module alone). Each arm logs its first chunk, that of the warm-up
   utterance and the time to make the model (int8: quantizing and packing
   the tail's constants). The JAX package's bf16 configurations: the bf16
   weights of ``cast_params_for_compute`` with an f32 state, the attention,
   joint and log-mel kernels (``bf16_on``) and every kernel (``bf16_all``),
   (the bf16 attention block, joint, FFN and conv kernels);
   the fast arm's weights, bf16 then ``quant="all"``, attention and joint,
   over the session's f32 state (``fast_on``) and over a bf16 state as
   the JAX bench's fast arm runs (``fast_step``: its int8 attention kernel
   reads an f32 copy of each layer's bf16 kv cache, made at the call; the
   copies a chunk, their bytes and their device ms are logged); the graft
   entry's bf16 encoder state through ``_session_step``, attention and
   joint (``bf16_step``: the bf16 kernel reads the bf16 cache as stored,
   no copy). Each bf16 arm logs its f32 x bf16 widenings a chunk, makes no
   f32 copy of a bias or taps at a call (nor, but in ``fast_step``, of a
   cache), and lies within twice its plain version's own
   noise floor (the same arm with the wrappers swapped for their plain
   versions on the card, against that arm with its features moved by
   1e-6); tokens side by side.
   Launch counts are reset just before each kernel arm and read just after.
   In each arm's profile every wrapper call of the fused tail is one kernel
   (``conv_ffn_ln_kernel``), and no conv module kernel runs beside it; every
   call of the attention block, the joint step, the FFN and the conv module
   is one persistent kernel of its weights' type, and no kernel of a chain
   runs; each kernel's us a launch is logged. The bytes of each arm's
   packed FFN,
   attention, conv and tail copies are logged. No int8 arm widens an
   int8 weight at a call (``q8_matmul.widened`` stays 0: the model's bf16
   copies feed the tensor cores), here and in phase 4; the memory the
   copies take is logged. Each int8 arm's tokens are set beside those of
   its session on the port's previous int8 routes (q widened to f32 at
   each call, the three-launch joint step, the five-launch conv module).
   Phase 2 also holds the offline kernels, rel shift (f32, bf16) and
   flash attention (f32, bf16), at the offline batch's shapes (B 8, T 368,
   H 8, dh 128; a short row and a zero-length row in the mask). bf16 rel
   shift (tensor cores) is held to its plain version within one bf16 ulp,
   floored near zero at twice the f32 sums' distance from the f64 sums,
   with at most 1e-4 of the values past one ulp, and to the plain version
   fed tensor-core sums with at most 5e-5 of the values differing (none by
   more than one ulp or that floor); the time of cuBLAS's bf16 tensor-core
   ``bmm`` of q_v against the whole table (a superset of bd, unshifted)
   stands beside it as a yardstick.
   The time of ``scaled_dot_product_attention`` on the same inputs stands
   beside flash, with flash's share of its bound and its ratio to that
   time. flash takes bd as the path passes it at T 368: the rel-shift
   kernel's contiguous output in bf16, the plain shift's strided view in
   f32 (bf16 on that view, the path below T 128, is checked and timed
   beside it). bf16 flash is held to its
   plain version (f32-einsum sums of q . k) at 1.5e-3 and to the plain
   version fed the tensor cores' sums at 1e-4, with the p roundings the
   two sums flip counted and held under a limit; f32 flash (register
   tiles of FFMAs on the CUDA cores) at atol 2e-5 + rtol 1e-4. Then the
   bf16 x bf16 ``matmul`` route of the bf16 weights configuration (the
   tensor cores, at the offline FFN's shape), within one bf16 ulp of the
   f32 product rounded once, timed beside the f32 SIMT product.
3b. the lockstep engine (``streaming/batch_engine.py``) at full width: 8
   streams of different lengths, one attached after three steps, the
   shortest finalized while the others stream (its flush inside a lockstep
   step), joint kernel on at 8 rows a step, each joint call one launch of
   the persistent kernel of the weights' type and no chain's kernel
   (profiler); f32: each stream token-exact with its own session on the
   card; bf16 weights: each stream's encoder output within twice its
   session's noise floor. Step ms (median, p90) and joint launches a step.
3c. the serving daemon (``serve.AsrServer``, B = 8) at full width over
   127.0.0.1, f32 weights, joint kernel on: eight client threads push 3b's
   utterances as base64 f32le PCM in 0.5 s pieces without sleeping, then
   finalize; each final's tokens and words equal the engine driven directly
   on that audio alone. A continuous client pushes two utterances 1.0 s of
   zeros apart and gets exactly two segment events, each token-exact with a
   direct engine stream fed its samples; over that window (profiler) each
   joint call is one persistent-kernel launch and no chain kernel runs.
   Served step ms (median, p90), each client's wall seconds and the joint
   launches a step. An error event or a ``step error`` fails it.
3d. beam search at full width (the phase-3 weights and blank bias, f32,
   TF32 off, kernels off as on every beam path; the utterance phase 3
   makes at 12 words, ~6 s, in 0.5 s pushes, whatever ``--words`` is;
   every check below runs on all of it): ``BeamStreamingSession(beam=4)`` on the host and on the
   device give the same n-best (tokens, ranking and stamps exact, scores
   within 2e-3); device beam 1 equals the greedy session; the device beam
   with an n-gram LM (weight 0.6, fitted from seeded token sentences) and
   with a biasing LM (phrases from the runner-up hypotheses) equals the host beam with the same lm_fn;
   ``token_cap=8`` raises the saturation ERROR event once;
   ``transcribe_offline_beam`` equals the device beam over the same
   offline encoder rows; the engine (B = 8, beam 4) on 3b's utterances, one
   slot attached late and one finalized early, gives the late slot, the
   early one and the longest the n-best of a standalone device session,
   without and with the LM. Host ms a
   steady chunk (greedy, host beam, device beam), device ms and launches a
   chunk (a profiled window of its own, the utterance's first third: the
   profiler's post-processing grows with its ~7,000 events a chunk), the
   engine's beam step ms and the seconds of each of these steps. No
   kernel wrapper launches here.
3e. the contract, the goldens and the debug surface. (a) before phase 3:
   ``ModelConfig.from_contract(load_contract())`` validates and equals
   ``ModelConfig()``, and phase 3's model is built from it. (b) phase 3's
   weights, blank bias and utterance with ``batched_decode=False`` and
   ``debug_tdt_steps`` on (JAX's per-step route; the same blank-run loop
   in the port, here with its trace): ``step_f32_off``, ``step_f32_on``
   (attention, joint, log-mel kernels), ``step_int8_on``; tokens and
   stamps equal phase 3's arm of the same weights, non-blank trace
   records equal the tokens, ``step_f32_on``'s trace equals
   ``step_f32_off``'s, the kernels launch; host ms a steady chunk and
   joint launches a chunk beside phase 3's arm. (c) the committed goldens through ``trt_asr_tpu_torch.parity``
   (tiny, seed 1, f32, TF32 off): the closed loop over all 50 chunks with
   the kernels off (``ort_f32``) and with the attention, FFN and conv
   kernels (at least ``trt_fp32``), the functional mode (``ort_f32``), and
   ``python -m trt_asr_tpu_torch.parity --mode trace`` as a subprocess,
   IDENTICAL to ``tdt_trace.jsonl``. (d) one gate_r3 utterance with taps,
   snapshots, the halting NaN guard, stage markers, emitted-token lines
   and the trace on, joint and attention kernels: tokens equal the
   toggles-off session's; snapshots within 1e-4 and the trace IDENTICAL to
   the port's CPU run; ``save_model_dir`` -> ``from_model_dir`` gives the
   same tokens. (e) ``python -m trt_asr_tpu_torch.cli`` on gate_r3 as a
   subprocess with ``TRT_ASR_PROFILE_DIR``, ``TRT_ASR_DEBUG_TDT_STEPS``,
   ``TRT_ASR_TDT_TRACE_PATH``, ``TRT_ASR_TAP_ENABLE`` and ``TRT_ASR_TAP_DIR``:
   its transcript equals the plain CLI's, the trace and taps parse, the
   profiler's Chrome trace holds joint-step kernel events. Seconds by part.
3f. the ONNX import path at full width: phase 3's weights (f32, the
   calibrated blank bias in the joint's out bias) exported by
   ``export_params_to_onnx`` (external data for large tensors) and imported
   by ``python -m trt_asr_tpu_torch.import_onnx --verify`` as a subprocess
   on the card (``-X importtime``: no JAX); the imported ``params.npz``
   equals the source leaf for leaf, bit for bit; ``run_suite`` on the
   imported model dir over phase 3's utterance and three more, 0.5 s
   pieces: the python surface (attention and joint kernels) transcribes
   phase 3's utterance as phase 3's ``f32_on`` arm does on the same audio,
   and the batch surface (B = 4, joint kernel) equals the python surface.
   Bytes written and the seconds of export, import and suite.
4. the trained ``artifacts/models/gate_r3`` on the card with the kernels
   on, each token-exact against the port's CPU plain path: attention,
   joint and log-mel kernels in f32, int8 and bf16; every kernel in f32,
   int8 (the fused tail) and bf16; int8 with the conv kernel and no FFN
   kernel; the fast arm's weights over the session's f32 state and over a
   bf16 state (``fast_step``); the engine at B = 4 in f32 and bf16.
   Offline: ``transcribe_batch`` on 24- and 28-word utterances (T >= 128),
   and ``offline_encode`` + ``tdt_greedy_decode_batch`` in f32 with flash,
   token-exact with the CPU path; in bf16 with the shift and flash kernels,
   with f32 weights and with the bf16 weights of
   ``cast_params_for_compute``, whose encoder output must lie within twice
   the distance the CPU's own bf16 run moves when its features move by
   1e-6 (bf16 tokens are not held exact: that move alone changes some).
   The entry points as a user runs them, subprocesses on the card:
   ``python -m trt_asr_tpu_torch.cli`` (attention and joint kernels from
   the environment, ``--stream-sim 0.5 --no-sleep --timestamps``, then
   ``--continuous``) on a wav of two utterances 1 s apart, whose Final,
   Transcript, Word and Segment lines equal the port's CPU path in this
   process; ``python -m trt_asr_tpu_torch.serve`` (B = 4, joint kernel),
   whose two clients' tokens equal the CPU engine's.
4b. gate_r3's beam: the host and device beam sessions (and the device beam
   with an n-gram LM) on the card equal the CPU path, n-best token-exact;
   then, at once as subprocesses, the CLI with ``--beam 4``, ``--beam 4
   --beam-device``, ``--bias``, ``--lm`` and ``--continuous`` (Final,
   Transcript, Word and Segment lines equal the CPU's; NBest texts exact,
   scores within 2e-3) and the daemon with ``--beam 4 --lm`` (B = 4),
   whose three finals' n-best equal the CPU engine's.
4c. gate_r3's WER gate: its held-out set (``eval/synthetic.py``:
   ``make_words(1120)``, ``make_set(50, 2, words, 8, 13)``, 502 reference
   words) through ``eval.suite.run_suite`` (``feature_norm="none"``), each
   row's WER counts equal to the committed ``artifacts/e2e_wer_gate_r3.json``:
   python with the attention and joint kernels at sim 0.5 (0 errors) and
   under ``drop_time_carry`` (I = 436); batch (B = 4, joint kernel) at sim
   0.3 (0 errors) and under sabotage (I = 436); the fast mode (int8 weights,
   attention kernel; the JAX tool's native surface) on 12 utterances (0
   errors at 0.3 and 0.5; I = 104 under sabotage). The batch and fast rows
   run through the gate runner (``eval.gate.main``): its exit code (0, or 1
   under sabotage), its artifact's matrix and gate rows, its
   push-granularity check and its ``--sabotage`` restore. Every streaming kernel in f32 and int8
   on 20 utterances, each transcript equal to the port's CPU plain path; the
   cli surface (2 utterances, fast env, no JAX imported) equal to the fast
   row; ``beam=4`` on 4 utterances equal to the greedy row. Kernel launches
   counted a row; chunk ms p50 and p95 and RTFx of the f32_on row; seconds
   by row.
5. full-width offline batch (``ModelConfig()``, the phase-3 weights): 8
   synthetic utterances of mixed length up to 30 s (one under 10 s),
   batched and padded as ``transcribe_batch`` does, through
   ``offline_encode`` and ``tdt_greedy_decode_batch(use_pallas_joint=True)``
   with a blank bias searched on the plain f32 arm. Arms ``off_f32``
   (plain), ``off_f32_flash`` (token-exact with ``off_f32``),
   ``off_bf16_plain`` (the two offline wrappers swapped for their plain
   versions), ``off_bf16`` (shift and flash kernels: its encoder output
   lies within twice bf16's own distance from f32 of ``off_bf16_plain``'s)
   and ``off_bf16w`` (the JAX package's offline bench configuration:
   ``cast_params_for_compute``'s bf16 weights, bf16 compute, the shift and
   flash kernels; finite, tokens emitted, its products on the tensor
   cores: its f32 SIMT GEMM time under half of ``off_bf16``'s); encoder
   and end-to-end ms, launches, a profile of one forward.
   ``transcribe_batch`` on the card equals per-utterance
   ``transcribe_offline`` on the card.
5b. training at full width (``ModelConfig()``, phase 3's weights with the
   blank bias at 0; B = 2 utterances of ~4 s and ~3 s, 10 and 7 seeded
   labels; f32, TF32 off, kernels off, as the JAX package trains): the
   card's step-0 loss, gradient norm and gradients against the port's CPU
   path (offline; 1e-4 and 1e-3 relative, each leaf within 1e-4 of its
   largest value); remat against no remat on the card, offline and
   streaming (the same loss, each leaf's gradients within 1e-4 of its
   largest value, streaming's peak memory lower, offline's logged); 3 AdamW
   steps at a constant lr (``TRAIN_LR``), offline and streaming (finite,
   the 3rd loss under the 1st; median step ms, peak memory; launches,
   device ms and busy share of a profiled step). gate_r3 fine-tunes 3 steps
   offline and streaming on a batch from ``batches_from_manifest`` with
   SpecAugment masks drawn once on the CPU (step-0 gradients leaf by leaf
   within 1e-4 of the leaf's largest value, losses within 1e-4 relative of
   the CPU path's, parameters within 1e-5 but for Adam's moves on rounding
   noise), and resumes from ``save_train_state``/``load_train_state`` (2
   more steps equal 5 straight within 1e-6). ``python -m
   trt_asr_tpu_torch.train.toy`` runs as a subprocess on the card (exit 0,
   the loss halves, at least 1 of 4 utterances recovered). No kernel
   wrapper launches; the seconds of each step are logged.
6. neither ``jax`` nor ``trt_asr_tpu`` was imported, here or (by ``-X
   importtime``) in a subprocess (the toy's, the parity runner's, the
   debug-env CLI's, the importer's and the eval suite's cli surface's
   too), and the daemon's, the CLI's, their helpers', training's, the
   contract's, the golden runner's, the debug surface's, the eval suite's
   (``eval.wer``, ``eval.suite``, ``eval.synthetic``, ``eval.gate``) and
   the ONNX path's (``io.onnx_lite``, ``io.onnx_graphs``,
   ``io.onnx_weights``; ``import_onnx`` in its subprocess) modules were
   run.

Each phase's seconds are logged. The last line is ``{"ok": true, "device":
{...}}``; the line before it is
the card's name and power limit; before that one JSON line lists the
kernels with their launches, errors and times.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BEAM_WORDS = 12                    # phase 3d's utterance (about 6 s), whatever --words is
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS = {"f32": 67e12,          # f32 outside the tensor cores
            "bf16": 989e12}        # dense bf16 tensor-core rate
# short name -> (launch counter, source, the TPU kernel it replaces, and
# per weight type the full-width arm whose session reads its launches)
KERNEL_SRCS = {
    # the attention block with f32 weights: its own persistent kernel
    "att": ("att_block", "trt_asr_tpu_torch/csrc/att_block_f32.cu",
            "trt_asr_tpu/ops/pallas/att_block_kernel.py:170", {"f32": "f32_on"}),
    # the attention block with int8 weights: its own persistent kernel (the
    # fast arm's too: bf16, then int8)
    "attq": ("att_block", "trt_asr_tpu_torch/csrc/att_block_q8.cu",
             "trt_asr_tpu/ops/pallas/att_block_kernel.py:170",
             {"int8": "int8_on", "fast": "fast_on"}),
    # the attention block with bf16 weights: its own persistent kernel
    "attb": ("att_block", "trt_asr_tpu_torch/csrc/att_block_bf16.cu",
             "trt_asr_tpu/ops/pallas/att_block_kernel.py:170",
             {"bf16": "bf16_on", "bf16kv": "bf16_step"}),     # bf16kv: over a bf16 kv cache
    # the joint step with f32 weights: its own persistent kernel
    "joint": ("joint_step", "trt_asr_tpu_torch/csrc/joint_step_f32.cu",
              "trt_asr_tpu/ops/pallas/joint_step_kernel.py:124", {"f32": "f32_on"}),
    # the joint step with int8 weights: its own persistent kernel
    "jointq": ("joint_step", "trt_asr_tpu_torch/csrc/joint_step_q8.cu",
               "trt_asr_tpu/ops/pallas/joint_step_kernel.py:124",
               {"int8": "int8_on", "fast": "fast_on"}),
    # the joint step with bf16 weights: its own persistent kernel
    "jointb": ("joint_step", "trt_asr_tpu_torch/csrc/joint_step_bf16.cu",
               "trt_asr_tpu/ops/pallas/joint_step_kernel.py:124", {"bf16": "bf16_on"}),
    "mel": ("logmel", "trt_asr_tpu_torch/csrc/mel.cu",
            "trt_asr_tpu/ops/pallas/mel_kernel.py:65", {"f32": "f32_on"}),
    # the FFN with f32, int8 and bf16 weights: a persistent kernel each
    "ffn": ("ffn", "trt_asr_tpu_torch/csrc/ffn_f32.cu",
            "trt_asr_tpu/ops/pallas/ffn_kernel.py:115", {"f32": "f32_all"}),
    "ffnq": ("ffn", "trt_asr_tpu_torch/csrc/ffn_q8.cu",
             "trt_asr_tpu/ops/pallas/ffn_kernel.py:115", {"int8": "int8_all"}),
    "ffnb": ("ffn", "trt_asr_tpu_torch/csrc/ffn_bf16.cu",
             "trt_asr_tpu/ops/pallas/ffn_kernel.py:115", {"bf16": "bf16_all"}),
    # the conv module with f32, int8 and bf16 weights: a persistent kernel each
    "conv": ("conv_block", "trt_asr_tpu_torch/csrc/conv_block_f32.cu",
             "trt_asr_tpu/ops/pallas/conv_block_kernel.py:99", {"f32": "f32_all"}),
    "convq": ("conv_block", "trt_asr_tpu_torch/csrc/conv_block_q8.cu",
              "trt_asr_tpu/ops/pallas/conv_block_kernel.py:99", {"int8": "int8_conv"}),
    "convb": ("conv_block", "trt_asr_tpu_torch/csrc/conv_block_bf16.cu",
              "trt_asr_tpu/ops/pallas/conv_block_kernel.py:99", {"bf16": "bf16_all"}),
    "tail": ("conv_ffn_ln", "trt_asr_tpu_torch/csrc/conv_ffn_ln.cu",
             "trt_asr_tpu/ops/pallas/conv_block_kernel.py:184", {"int8": "int8_all"}),
    # offline kernels: the offline arm reads their launches (rel shift runs
    # in bf16 only: its auto gate, as the TPU's; the f32 arm reads 0)
    "shift": ("rel_shift", "trt_asr_tpu_torch/csrc/rel_shift.cu",
              "trt_asr_tpu/ops/pallas/rel_shift_kernel.py:102",
              {"f32": "off_f32_flash", "bf16": "off_bf16"}),
    "flash": ("flash_att", "trt_asr_tpu_torch/csrc/flash_att.cu",
              "trt_asr_tpu/ops/pallas/flash_att_kernel.py:116",
              {"f32": "off_f32_flash", "bf16": "off_bf16"}),
}
OFFLINE_WORDS = (64, 56, 48, 40, 32, 24, 16, 12)   # ~28 s down to ~6 s
OFFLINE_MAX_S = 30.0


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True)
    return out.stdout.strip().splitlines()[0]


# --- timing ----------------------------------------------------------------


class Timer:
    """Median device time of one call, L2 scrubbed before every launch so
    weights come from HBM as they do on the main path (24 layers of
    weights do not fit the 50 MB L2).

    A spin kernel holds the device while a batch of calls is enqueued, so
    the events around each call bracket its device work only, not the
    host's enqueue (a wrapper's Python work is longer than its kernels).
    The spin is checked to outlast the enqueue, and doubled if it did
    not. ``host_us`` keeps the last batch's host enqueue time per call."""

    MAX_SPIN_CYCLES = 640_000_000     # ~0.3 s at the H100's clock

    def __init__(self, torch, dev, reps: int = 30, batch: int = 10):
        self.torch, self.dev, self.reps, self.batch = torch, dev, reps, batch
        self.scrub = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
        self.spin_cycles = 20_000_000
        self.host_us = 0.0

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        while len(times) < self.reps:
            ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(self.batch)]
            spun = torch.cuda.Event()
            torch.cuda._sleep(self.spin_cycles)
            spun.record()
            t0 = time.perf_counter()
            for a, b in ev:
                self.scrub.zero_()
                a.record()
                fn()
                b.record()
            self.host_us = (time.perf_counter() - t0) * 1e6 / self.batch
            held = not spun.query()
            torch.cuda.synchronize()
            if not held and self.spin_cycles < self.MAX_SPIN_CYCLES:
                self.spin_cycles *= 2
                continue
            assert held, "timed call waits on the device: its time would hold host work"
            times += [a.elapsed_time(b) for a, b in ev]
        return float(np.median(times))


def bound(nbytes: float, ops: float, op_type: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[op_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def wbytes(w) -> int:
    from trt_asr_tpu_torch.ops.quant import QuantTensor

    if isinstance(w, QuantTensor):
        return w.q.numel() + 4 * w.s.numel()
    return w.numel() * w.element_size()


def max_err(got, want) -> float:
    return max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))


def measure(name, timer, err, kernel_fn, plain_fn, nbytes, ops, op_type, library_fn=None):
    """Time a kernel and its plain version (device ms) beside their bound,
    and the one PyTorch call that computes the same function, if any."""
    b_ms, b_by = bound(nbytes, ops, op_type)
    ms = timer(kernel_fn)
    host_us = timer.host_us
    plain_ms = timer(plain_fn)
    library_ms = timer(library_fn) if library_fn is not None else None
    lib_txt = f", library {library_ms:.4f} ms" if library_ms is not None else ""
    log(f"  {name} kernel {ms:.4f} ms (host enqueue {host_us:.1f} us/call), plain "
        f"{plain_ms:.4f} ms{lib_txt}, bound {b_ms:.4f} ms ({b_by})")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms)


def ptxas_kernels(text: str):
    """(kernel, registers, spill stores, spill loads, static shared bytes)
    of each entry function in an ``nvcc -Xptxas -v`` report."""
    import re

    out, name, spills = [], None, (0, 0)
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            name = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spills = (int(m.group(1)), int(m.group(2)))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            smem = re.search(r"(\d+) bytes smem", line)
            out.append((name, int(m.group(1)), *spills, int(smem.group(1)) if smem else 0))
            name = None
    return out


def log_resources(torch, build, cfg) -> None:
    """Registers, spills and static shared memory of every kernel (ptxas),
    and the dynamic shared memory and the blocks an SM holds of the flash
    kernels, the bf16 rel-shift kernel (bf16 at the full-width head dim),
    the fused tail, the int8, bf16 and f32 attention blocks and joint
    steps (a steady chunk's 8 rows at full width; the CUDA occupancy API),
    the int8, bf16 and f32 FFNs and conv modules (the same rows), and the
    log-mel kernel's grid at a 0.5 s push (50 frames)."""
    import ctypes

    from trt_asr_tpu_torch.ops.kernels.att_block import (att_block_bf16_plan, att_block_f32_plan,
                                                         att_block_q8_plan)
    from trt_asr_tpu_torch.ops.kernels.conv_block import (conv_block_bf16_plan,
                                                          conv_block_f32_plan,
                                                          conv_block_q8_plan, conv_ffn_ln_plan)
    from trt_asr_tpu_torch.ops.kernels.ffn import ffn_bf16_plan, ffn_f32_plan, ffn_q8_plan
    from trt_asr_tpu_torch.ops.kernels.joint_step import (joint_step_bf16_plan,
                                                          joint_step_f32_plan, joint_step_q8_plan)
    from trt_asr_tpu_torch.ops.kernels.mel import MEL_CL, logmel_plan

    for src in build.SOURCES:
        for name, regs, st, ld, smem in ptxas_kernels(build.build_log(src)):
            log(f"  ptxas[{src}]: {name.removeprefix('_ZN4port')[:56]}: {regs} registers, "
                f"spills {st}/{ld} B (stores/loads), static shared {smem} B")
    info = (ctypes.c_int * 2)()
    lib = build.load("flash_att")
    build.check(lib, lib.flash_att_bf16_occupancy(128, ctypes.addressof(info)),
                "flash_att_bf16_occupancy")
    log(f"  flash_att[bf16] at dh 128: {info[0]} B of dynamic shared memory, {info[1]} "
        f"blocks an SM")
    build.check(lib, lib.flash_att_f32_occupancy(ctypes.addressof(info)),
                "flash_att_f32_occupancy")
    log(f"  flash_att[f32]: {info[0]} B of dynamic shared memory, {info[1]} blocks an SM")
    lib = build.load("rel_shift")
    build.check(lib, lib.rel_shift_bf16_occupancy(128, ctypes.addressof(info)),
                "rel_shift_bf16_occupancy")
    log(f"  rel_shift[bf16] at dh 128: {info[0]} B of dynamic shared memory, {info[1]} "
        f"blocks an SM")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = conv_ffn_ln_plan(8, cfg.d_model, cfg.d_model * cfg.ff_expansion_factor,
                            cfg.conv_kernel_size, sms)
    lib = build.load("conv_ffn_ln")
    build.check(lib, lib.conv_ffn_ln_occupancy(plan.smem, ctypes.addressof(info)),
                "conv_ffn_ln_occupancy")
    log(f"  conv_ffn_ln[int8] at Tq 8: {plan.blocks} blocks of {plan.cols_d} + {plan.cols_e} "
        f"columns, {plan.smem} B of dynamic shared memory, {info[0]} blocks an SM, {sms} SMs")
    assert info[0] >= 1 and plan.blocks <= info[0] * sms, "conv_ffn_ln's grid is not resident"
    plan = att_block_q8_plan(8, cfg.d_model, cfg.n_heads, cfg.att_cache_size, sms)
    lib = build.load("att_block_q8")
    build.check(lib, lib.att_block_q8_occupancy(plan.smem, ctypes.addressof(info)),
                "att_block_q8_occupancy")
    log(f"  att_block[int8] at Tq 8: {plan.blocks} blocks of {plan.cols} columns, "
        f"{plan.ranges} scores items a head of {plan.slots} kv positions, {plan.smem} B of "
        f"dynamic shared memory, {info[0]} blocks an SM, {sms} SMs")
    assert info[0] >= 1 and plan.blocks <= info[0] * sms, "att_block[int8]'s grid is not resident"
    plan = att_block_bf16_plan(8, cfg.d_model, cfg.n_heads, cfg.att_cache_size, sms)
    lib = build.load("att_block_bf16")
    build.check(lib, lib.att_block_bf16_occupancy(plan.smem, ctypes.addressof(info)),
                "att_block_bf16_occupancy")
    log(f"  att_block[bf16] at Tq 8: {plan.blocks} blocks of {plan.cols} columns, "
        f"{plan.ranges} scores items a head of {plan.slots} kv positions, {plan.smem} B of "
        f"dynamic shared memory, {info[0]} blocks an SM, {sms} SMs")
    assert info[0] >= 1 and plan.blocks <= info[0] * sms, "att_block[bf16]'s grid is not resident"
    plan = att_block_f32_plan(8, cfg.d_model, cfg.n_heads, cfg.att_cache_size, sms)
    lib = build.load("att_block_f32")
    build.check(lib, lib.att_block_f32_occupancy(plan.smem, ctypes.addressof(info)),
                "att_block_f32_occupancy")
    log(f"  att_block[f32] at Tq 8: {plan.blocks} blocks of {plan.cols} columns, "
        f"{plan.ranges} scores items a head of {plan.slots} kv positions, a ring of "
        f"{plan.stages} slots for the weights, {plan.smem} B of dynamic shared memory, "
        f"{info[0]} blocks an SM, {sms} SMs")
    assert info[0] >= 1 and plan.blocks <= info[0] * sms, "att_block[f32]'s grid is not resident"
    for arm, plan_of, lib_name in (("int8", joint_step_q8_plan, "joint_step_q8"),
                                   ("bf16", joint_step_bf16_plan, "joint_step_bf16")):
        plan = plan_of(8, cfg.pred_hidden, cfg.joint_hidden, cfg.joint_vocab_size, sms)
        lib = build.load(lib_name)
        build.check(lib, getattr(lib, f"{lib_name}_occupancy")(plan.smem, ctypes.addressof(info)),
                    f"{lib_name}_occupancy")
        log(f"  joint_step[{arm}] at 8 rows: {plan.blocks} blocks of {plan.groups} column groups "
            f"and {plan.hcols} hidden columns, {plan.smem} B of dynamic shared memory, {info[0]} "
            f"blocks an SM, {sms} SMs")
        assert info[0] >= 1 and plan.blocks <= info[0] * sms, (
            f"joint_step[{arm}]'s grid is not resident")
    plan = joint_step_f32_plan(8, cfg.pred_hidden, cfg.joint_hidden, cfg.joint_vocab_size, sms)
    lib = build.load("joint_step_f32")
    build.check(lib, lib.joint_step_f32_occupancy(plan.smem, ctypes.addressof(info)),
                "joint_step_f32_occupancy")
    log(f"  joint_step[f32] at 8 rows: {plan.blocks} blocks of {plan.groups} column groups "
        f"and {plan.hcols} hidden columns, {plan.smem} B of dynamic shared memory, {info[0]} "
        f"blocks an SM, {sms} SMs")
    assert info[0] >= 1 and plan.blocks <= info[0] * sms, "joint_step[f32]'s grid is not resident"
    e = cfg.d_model * cfg.ff_expansion_factor
    for arm, plan, lib_name in (("int8", ffn_q8_plan(cfg.d_model, e, sms), "ffn_q8"),
                                ("bf16", ffn_bf16_plan(cfg.d_model, e, sms), "ffn_bf16"),
                                ("f32", ffn_f32_plan(cfg.d_model, e, sms), "ffn_f32")):
        lib = build.load(lib_name)
        build.check(lib, getattr(lib, f"{lib_name}_occupancy")(plan.smem, ctypes.addressof(info)),
                    f"{lib_name}_occupancy")
        ring = f", a ring of {plan.stages} slots for the weights" if plan.stages else ""
        log(f"  ffn[{arm}] at 8 rows: {plan.blocks} blocks of {plan.cols_e} expansion columns "
            f"and {plan.cols_d} columns of y{ring}, {plan.smem} B of dynamic shared memory, "
            f"{info[0]} blocks an SM, {sms} SMs")
        assert info[0] >= 1 and plan.blocks <= info[0] * sms, f"ffn[{arm}]'s grid is not resident"
    kk = cfg.conv_kernel_size
    for arm, plan, lib_name in (("int8", conv_block_q8_plan(8, cfg.d_model, kk, sms),
                                 "conv_block_q8"),
                                ("bf16", conv_block_bf16_plan(8, cfg.d_model, kk, sms),
                                 "conv_block_bf16"),
                                ("f32", conv_block_f32_plan(8, cfg.d_model, kk, sms),
                                 "conv_block_f32")):
        lib = build.load(lib_name)
        build.check(lib, getattr(lib, f"{lib_name}_occupancy")(plan.smem, ctypes.addressof(info)),
                    f"{lib_name}_occupancy")
        log(f"  conv_block[{arm}] at Tq 8: {plan.blocks} blocks of {plan.cols_d} columns, "
            f"{plan.smem} B of dynamic shared memory, {info[0]} blocks an SM, {sms} SMs")
        assert info[0] >= 1 and plan.blocks <= info[0] * sms, (
            f"conv_block[{arm}]'s grid is not resident")
    plan = logmel_plan(50, 400, 257, cfg.feat_in)
    log(f"  logmel[f32] at 50 frames: {plan.frame_tiles} clusters of {MEL_CL} blocks = "
        f"{plan.frame_tiles * MEL_CL} blocks on {sms} SMs, {plan.bins} DFT bins a block, "
        f"{plan.smem} B of dynamic shared memory a block")


# --- phase 2: kernels against their plain versions ---------------------------


def check_rounding_points(label, tol, got, unrounded) -> None:
    """The tolerance must tell the kernel from one that skips the bf16
    rounding points: the plain version without them (on dequantized f32
    weights, or on bf16 operands widened to f32) must lie farther than the
    tolerance from the kernel."""
    gap = max_err(got, unrounded)
    log(f"  {label}: max |kernel - plain without bf16 rounding points| = {gap:.3g}")
    assert gap > tol, f"{label} tolerance {tol:g} cannot see the rounding points"


def check_kernels(torch, dev, timer, cfg):
    from trt_asr_tpu_torch.ops.kernels.att_block import (att_block, att_block_chain,
                                                         att_block_plain, pack_att_block)
    from trt_asr_tpu_torch.ops.kernels.conv_block import (conv_block, conv_block_chain,
                                                          conv_block_plain, conv_ffn_ln,
                                                          conv_ffn_ln_plain, pack_conv_block,
                                                          pack_conv_ffn_ln)
    from trt_asr_tpu_torch.ops.kernels.ffn import (fused_ffn, fused_ffn_chain, fused_ffn_plain,
                                                   layer_norm_plain, pack_ffn)
    from trt_asr_tpu_torch.ops.kernels.joint_step import (joint_step, joint_step_chain,
                                                          joint_step_plain, pack_joint_step)
    from trt_asr_tpu_torch.ops.kernels.mel import logmel, logmel_plain
    from trt_asr_tpu_torch.ops.quant import QuantTensor, dequantize, quantize_tensor
    from trt_asr_tpu_torch.frontend.logmel import LogMelFrontend
    from trt_asr_tpu_torch.contract import FrontendSpec

    rng = np.random.default_rng(1234)
    t = lambda *s, sc=1.0: torch.as_tensor(  # noqa: E731
        (rng.standard_normal(s) * sc).astype(np.float32), device=dev)
    d, h, c = cfg.d_model, cfg.n_heads, cfg.att_cache_size
    tq, valid_tq = 8, 6                       # steady chunk: 6 steps padded to 8
    r = 2 * tq + c - 1
    records = {}

    # attention block, steady state: full ring cache, cursor mid-ring
    x = t(tq, d)
    ln_g, ln_b = 1.0 + t(d, sc=0.1), t(d, sc=0.1)
    ws = [t(d, d, sc=1 / math.sqrt(d)) for _ in range(4)]
    bu, bv = t(h, d // h, sc=0.3), t(h, d // h, sc=0.3)
    pos = t(r, d)
    kv = t(c, 2 * d)
    meta = torch.tensor([100, c, valid_tq], dtype=torch.int32, device=dev)
    qws = [quantize_tensor(w) for w in ws]
    # the kernels' weights packed once, as the model packs them
    att_packed = {}
    for arm, wts in (("f32", ws), ("int8", qws)):
        t0 = time.perf_counter()
        att_packed[arm] = pack_att_block(*wts)
        torch.cuda.synchronize()
        log(f"  att_block[{arm}]: one layer's weights packed in "
            f"{1e3 * (time.perf_counter() - t0):.2f} ms "
            f"({att_packed[arm].numel() * att_packed[arm].element_size()} B)")
    for arm, wts, tol in (("f32", ws, 2e-4), ("int8", qws, 1e-4)):
        packed = att_packed[arm]
        args = (x, ln_g, ln_b, *wts, bu, bv, pos, kv, meta)
        got = att_block(*args, n_heads=h, packed=packed)
        want = att_block_plain(*args, n_heads=h)
        torch.cuda.synchronize()
        err = max_err(got, want)
        log(f"att_block[{arm}]: max |kernel - plain| over (y, u, k_new, v_new) = {err:.3g} "
            f"(tolerance {tol:g})")
        assert err <= tol, f"att_block[{arm}] disagrees with its plain version"
        if arm == "int8":
            check_rounding_points("att_block[int8]", tol, got, att_block_plain(
                x, ln_g, ln_b, *[dequantize(w) for w in wts], bu, bv, pos, kv, meta,
                n_heads=h))
        s_valid = c + valid_tq
        nbytes = (x.numel() * 4 * 5 + 4 * d * 4 + sum(wbytes(w) for w in wts)
                  + 2 * d * 4 + pos.numel() * 4 + kv.numel() * 4 + 12)
        ops = 2 * tq * d * d * 4 + 6 * tq * s_valid * d
        kernel = lambda: att_block(*args, n_heads=h, packed=packed)  # noqa: E731
        records[arm + ("_att" if arm == "f32" else "_attq")] = measure(
            f"att_block[{arm}]", timer, err, kernel, lambda: att_block_plain(*args, n_heads=h),
            nbytes, ops, "f32" if arm == "f32" else "bf16")
        if arm == "f32":
            # the 6-launch chain that the f32 kernel replaced, in the same call
            chain = lambda: att_block_chain(*args, n_heads=h)  # noqa: E731
            chain_err = max_err(chain(), want)
            log(f"  att_block[f32] chain (csrc/att_block.cu): {timer(chain):.4f} ms (host "
                f"enqueue {timer.host_us:.1f} us/call), max |chain - plain| {chain_err:.3g}")
        check_graph_capture(torch, f"att_block[{arm}]", kernel, (), got)

    # joint step: rows = one padded steady chunk (B=1, Tq=8); int8 and f32
    # weights take their persistent kernels on weights packed once, as the
    # model packs them, each timed beside the three launches it replaced
    rows, j, p, v = tq, cfg.joint_hidden, cfg.pred_hidden, cfg.joint_vocab_size
    e, g = t(rows, j), t(rows, p, sc=0.5)
    wp, wo = t(p, j, sc=1 / math.sqrt(p)), t(j, v, sc=1 / math.sqrt(j))
    bp, bo = t(j, sc=0.1), t(v, sc=0.1)
    kw = dict(ths=cfg.token_head_size, ndur=cfg.num_duration_bins, blank_id=cfg.blank_id,
              blank_penalty=0.5)
    qwp, qwo = quantize_tensor(wp), quantize_tensor(wo)
    joint_packed = {}
    for arm, (wpp, woo) in (("f32", (wp, wo)), ("int8", (qwp, qwo))):
        t0 = time.perf_counter()
        joint_packed[arm] = pack_joint_step(wpp, bp, woo, bo)
        torch.cuda.synchronize()
        log(f"  joint_step[{arm}]: the joint's weights packed in "
            f"{1e3 * (time.perf_counter() - t0):.2f} ms "
            f"({joint_packed[arm].numel() * joint_packed[arm].element_size()} B)")
    for arm, (wpp, woo), tol in (("f32", (wp, wo), 1e-4), ("int8", (qwp, qwo), 1e-4)):
        args, jkw = (e, g, wpp, bp, woo, bo), {"packed": joint_packed[arm]}
        tok, dur, logits = joint_step(*args, **kw, **jkw)
        tok_p, dur_p, logits_p = joint_step_plain(*args, **kw)
        torch.cuda.synchronize()
        err = float((logits - logits_p).abs().max())
        log(f"joint_step[{arm}]: max |logits kernel - plain| = {err:.3g} (tolerance {tol:g})")
        assert err <= tol, f"joint_step[{arm}] logits disagree"
        if isinstance(woo, QuantTensor):
            check_rounding_points("joint_step[int8]", tol, (logits,), joint_step_plain(
                e, g, dequantize(wpp), bp, dequantize(woo), bo, **kw)[2:])
        # argmaxes must agree wherever the plain top-2 margin exceeds the tolerance
        tl = logits_p[:, :kw["ths"]].clone()
        tl[:, kw["blank_id"]] -= kw["blank_penalty"]
        for name, lg, a, b in (("token", tl, tok, tok_p),
                               ("duration", logits_p[:, kw["ths"]:kw["ths"] + kw["ndur"]], dur, dur_p)):
            top2 = torch.topk(lg, 2, dim=1).values
            clear = (top2[:, 0] - top2[:, 1]) > 2 * tol
            assert bool(((a == b) | ~clear).all()), f"joint_step[{arm}] {name} argmax disagrees"
        log(f"  tokens equal: {bool((tok == tok_p).all())}, durations equal: "
            f"{bool((dur == dur_p).all())}")
        nbytes = (e.numel() + g.numel() + j + v) * 4 + wbytes(wpp) + wbytes(woo) + rows * v * 4 + rows * 8
        ops = 2 * rows * (p * j + j * v)
        kernel = lambda: joint_step(*args, **kw, **jkw)  # noqa: E731
        records[arm + ("_joint" if arm == "f32" else "_jointq")] = measure(
            f"joint_step[{arm}]", timer, err, kernel, lambda: joint_step_plain(*args, **kw),
            nbytes, ops, "f32" if arm == "f32" else "bf16")
        # the three launches that the kernel replaced, in the same call
        chain = lambda: joint_step_chain(*args, **kw)  # noqa: E731
        chain_err = float((chain()[2] - logits_p).abs().max())
        log(f"  joint_step[{arm}] three launches (csrc/joint_step.cu): {timer(chain):.4f} ms "
            f"(host enqueue {timer.host_us:.1f} us/call), max |logits - plain| "
            f"{chain_err:.3g}")
        check_graph_capture(torch, f"joint_step[{arm}]", kernel, (), (tok, dur, logits))

    # log-mel: the bases packed once by the frontend; a 0.5 s push is 50
    # frames of 400 samples (the kernels line's reading); T 1 and 51 cut a
    # frame tile short, 300 is a flush
    fe = LogMelFrontend(FrontendSpec(n_mels=cfg.feat_in), use_kernel=True, device=dev)
    log(f"  logmel[f32]: the bases packed once by the frontend "
        f"({fe._basis.numel() * fe._basis.element_size()} B)")
    nb, nm = fe._mel.shape
    tol = 1e-3
    for n_t in (1, 50, 51, 300):
        frames = t(n_t, 400, sc=0.3)
        margs = (frames, fe._wcos, fe._wsin, fe._mel, fe.spec.log_floor)
        kernel = lambda: logmel(*margs, packed=fe._basis)  # noqa: E731
        got, want = kernel(), logmel_plain(*margs)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        log(f"logmel[f32] at T {n_t}: max |kernel - plain| = {err:.3g} (tolerance {tol:g})")
        assert err <= tol, f"logmel at T {n_t} disagrees with its plain version"
        nbytes = (frames.numel() + 2 * fe._wcos.numel() + fe._mel.numel() + n_t * nm) * 4
        ops = 2 * n_t * 400 * nb * 2 + 2 * n_t * nb * nm + 3 * n_t * nb
        rec = measure(f"logmel[f32] at T {n_t}", timer, err, kernel,
                      lambda: logmel_plain(*margs), nbytes, ops, "f32")
        if n_t == 50:
            records["f32_mel"] = rec
        check_graph_capture(torch, f"logmel[f32] at T {n_t}", lambda: (kernel(),), (), (got,))

    # FFN, conv module and the fused tail on the steady chunk's 8 rows
    # (6 valid: the conv masks the 2 padded rows)
    e, kk = d * cfg.ff_expansion_factor, cfg.conv_kernel_size
    half = (kk - 1) // 2
    norm = lambda: (1.0 + t(d, sc=0.1), t(d, sc=0.1))  # noqa: E731
    fln, cln, oln = norm(), norm(), norm()
    w1, w2 = t(d, e, sc=1 / math.sqrt(d)), t(e, d, sc=1 / math.sqrt(e))
    pw1, pw2 = t(d, 2 * d, sc=1 / math.sqrt(d)), t(d, d, sc=1 / math.sqrt(d))
    dw = t(kk, d, sc=1 / math.sqrt(kk))
    bn = (1.0 + t(d, sc=0.1), t(d, sc=0.1), t(d, sc=0.1), 1.0 + t(d, sc=0.1).abs())
    tc = t(half, d)
    mask = (torch.arange(tq, device=dev) < valid_tq).float()[:, None]
    qw1, qw2, qpw1, qpw2 = (quantize_tensor(w) for w in (w1, w2, pw1, pw2))
    # bytes besides the weights: x read, outputs written (y; y and c), norms,
    # and for the conv dw, BN, time cache and mask
    ffn_bytes = (2 * tq * d + 2 * d) * 4
    conv_bytes = (3 * tq * d + (2 + kk + 4 + half) * d + tq) * 4
    ffn_ops = 4 * tq * d * e
    conv_ops = 2 * tq * d * 3 * d + 2 * tq * kk * d
    conv_args = lambda a, b: (x, *cln, a, dw, *bn, b, tc, mask)  # noqa: E731

    # the FFN: int8 and f32 weights take their persistent kernels on weights
    # packed once, as the model packs them, each timed beside the five
    # launches it replaced
    for arm, short, tol, (a1, a2) in (("f32", "ffn", 2e-4, (w1, w2)),
                                      ("int8", "ffnq", 1e-4, (qw1, qw2))):
        t0 = time.perf_counter()
        packed = pack_ffn(a1, a2)
        torch.cuda.synchronize()
        log(f"  ffn[{arm}]: one FFN's weights packed in {1e3 * (time.perf_counter() - t0):.2f} ms "
            f"({packed.numel() * packed.element_size()} B)")
        args = (x, *fln, a1, a2)
        got = fused_ffn(*args, packed=packed)
        want = fused_ffn_plain(*args)
        torch.cuda.synchronize()
        err = max_err((got,), (want,))
        log(f"ffn[{arm}]: max |kernel - plain| = {err:.3g} (tolerance {tol:g})")
        assert err <= tol, f"ffn[{arm}] disagrees with its plain version"
        if arm == "int8":
            check_rounding_points("ffn[int8]", tol, (got,), (fused_ffn_plain(
                x, *fln, dequantize(a1), dequantize(a2)),))
        kernel = lambda: fused_ffn(*args, packed=packed)  # noqa: E731
        rec = records[f"{arm}_{short}"] = measure(
            f"ffn[{arm}]", timer, err, kernel, lambda: fused_ffn_plain(*args),
            ffn_bytes + wbytes(a1) + wbytes(a2), ffn_ops, "f32" if arm == "f32" else "bf16")
        # the five launches that the kernel replaced, in the same call
        chain = lambda: fused_ffn_chain(*args)  # noqa: E731
        chain_err = max_err((chain(),), (want,))
        chain_ms = timer(chain)
        log(f"  ffn[{arm}] five launches (csrc/ffn.cu): {chain_ms:.4f} ms (host enqueue "
            f"{timer.host_us:.1f} us/call), max |chain - plain| {chain_err:.3g}")
        assert rec["ms"] < chain_ms, f"ffn[{arm}] is not faster than the chain it replaced"
        check_graph_capture(torch, f"ffn[{arm}]", lambda: (kernel(),), (), (got,))

    # the conv module: int8 and f32 weights take their persistent kernels on
    # constants packed once, as the model packs them, each timed beside the
    # five launches it replaced
    for arm, short, tol, (a1, a2) in (("f32", "conv", 2e-4, (pw1, pw2)),
                                      ("int8", "convq", 1e-4, (qpw1, qpw2))):
        t0 = time.perf_counter()
        packed = pack_conv_block(a1, dw, *bn, a2)
        torch.cuda.synchronize()
        log(f"  conv_block[{arm}]: one layer's constants packed in "
            f"{1e3 * (time.perf_counter() - t0):.2f} ms "
            f"({packed.numel() * packed.element_size()} B)")
        args = conv_args(a1, a2)
        got = conv_block(*args, packed=packed)
        want = conv_block_plain(*args)
        torch.cuda.synchronize()
        err = max_err(got, want)
        log(f"conv_block[{arm}]: max |kernel - plain| over the outputs = {err:.3g} "
            f"(tolerance {tol:g})")
        assert err <= tol, f"conv_block[{arm}] disagrees with its plain version"
        if arm == "int8":
            check_rounding_points("conv_block[int8]", tol, got, conv_block_plain(
                *conv_args(dequantize(a1), dequantize(a2))))
        kernel = lambda: conv_block(*args, packed=packed)  # noqa: E731
        rec = records[f"{arm}_{short}"] = measure(
            f"conv_block[{arm}]", timer, err, kernel, lambda: conv_block_plain(*args),
            conv_bytes + wbytes(a1) + wbytes(a2), conv_ops, "f32" if arm == "f32" else "bf16")
        # the five launches that the kernel replaced, in the same call
        chain = lambda: conv_block_chain(*args)  # noqa: E731
        chain_err = max_err(chain(), want)
        chain_ms = timer(chain)
        log(f"  conv_block[{arm}] five launches (csrc/conv_block.cu): {chain_ms:.4f} ms (host "
            f"enqueue {timer.host_us:.1f} us/call), max |chain - plain| {chain_err:.3g}")
        assert rec["ms"] < chain_ms, f"conv_block[{arm}] is not faster than the chain it replaced"
        check_graph_capture(torch, f"conv_block[{arm}]", kernel, (), got)

    cases = [  # short name, arm, tolerance, arguments, weights, other bytes, ops
        ("tail", "int8", 1e-4, (*conv_args(qpw1, qpw2), *fln, qw1, qw2, *oln),
         (qpw1, qpw2, qw1, qw2), conv_bytes + 4 * d * 4, conv_ops + ffn_ops),
    ]

    def tail_composed(*a):
        """conv_ffn_ln_plain's function composed of its parts, which also
        take float weights (conv_ffn_ln_plain itself is int8-only)."""
        x1, c = conv_block_plain(*a[:12])
        return layer_norm_plain(fused_ffn_plain(x1, *a[12:16]), *a[16:]), c

    # the tail's constants packed once, as the model packs them with its
    # int8 weights (host clock, the first packing in this process)
    t0 = time.perf_counter()
    tail_packed = pack_conv_ffn_ln(qpw1, dw, *bn, qpw2, qw1, qw2)
    torch.cuda.synchronize()
    log(f"  conv_ffn_ln[int8]: one layer's constants packed in "
        f"{1e3 * (time.perf_counter() - t0):.2f} ms ({tail_packed.numel()} B)")

    def tail_kernel(*a):
        return conv_ffn_ln(*a, packed=tail_packed)

    kernels = {"tail": (tail_kernel, conv_ffn_ln_plain, tail_composed)}
    tup = lambda r: r if isinstance(r, tuple) else (r,)  # noqa: E731
    for short, arm, tol, args, ws, other_bytes, ops in cases:
        name = KERNEL_SRCS[short][0]
        kernel, plain, any_weights = kernels[short]
        got, want = tup(kernel(*args)), tup(plain(*args))
        torch.cuda.synchronize()
        err = max_err(got, want)
        log(f"{name}[{arm}]: max |kernel - plain| over the outputs = {err:.3g} "
            f"(tolerance {tol:g})")
        assert err <= tol, f"{name}[{arm}] disagrees with its plain version"
        if arm == "int8":
            deq = [dequantize(a) if isinstance(a, QuantTensor) else a for a in args]
            check_rounding_points(f"{name}[int8]", tol, got, tup(any_weights(*deq)))
        nbytes = other_bytes + sum(wbytes(w) for w in ws)
        records[f"{arm}_{short}"] = measure(
            f"{name}[{arm}]", timer, err, lambda: kernel(*args), lambda: plain(*args),
            nbytes, ops, "f32" if arm == "f32" else "bf16")
        check_graph_capture(torch, f"{name}[{arm}]", kernel, args, got)
    return records


# bf16 kernels and chains against their plain versions: both round the same
# operands to bf16, but the kernels' f32 sums (the tensor cores', the
# chains' split-K) run in another order than the plain version's, and an f32
# value one ulp apart can round to the neighbouring bf16 value. Readings at
# the full width on the H100: the chains' attention 2.55e-4, FFN 2.06e-4,
# joint and conv 7.2e-7, the kernels' attention 4.8e-7 and FFN 2.1e-4;
# without the rounding points the plain version lies 2.8e-3 to 7.1e-3 away,
# so the tolerance sees them.
BF16_CHAIN_ATOL = 1e-3


def check_bf16_kernels(torch, dev, timer, cfg):
    """Phase 2, the bf16 weights of ``cast_params_for_compute`` at the
    full-width steady-chunk shapes, with bf16 biases and taps (their f32
    copies kept once, as the model keeps them) and the session's f32
    caches: the bf16 attention block (``csrc/att_block_bf16.cu``; also over
    a bf16 kv cache, a bf16 encoder state, read as stored), joint step
    (``csrc/joint_step_bf16.cu``), FFN (``csrc/ffn_bf16.cu``) and conv
    module (``csrc/conv_block_bf16.cu``; also over a bf16 time cache, read
    as stored), each one cooperative launch on weights packed once, timed
    beside the chain it replaced in the same run and faster than it; then
    the int8 attention block and joint step with bf16 leftovers (the fast
    arm: bf16, then int8). Each against its plain version (the joint's
    tokens and durations equal wherever the top-2 margin is clear), timed
    beside it and its bound, captured into a CUDA graph and replayed."""
    from trt_asr_tpu_torch.ops.kernels.att_block import (att_block, att_block_chain,
                                                         att_block_plain, pack_att_block)
    from trt_asr_tpu_torch.ops.kernels.conv_block import (conv_block, conv_block_chain,
                                                          conv_block_plain, pack_conv_block)
    from trt_asr_tpu_torch.ops.kernels.ffn import (fused_ffn, fused_ffn_chain, fused_ffn_plain,
                                                   pack_ffn)
    from trt_asr_tpu_torch.ops.kernels.joint_step import (joint_step, joint_step_chain,
                                                          joint_step_plain, pack_joint_step)
    from trt_asr_tpu_torch.ops.quant import as_f32, keep_f32_copy, quantize_tensor

    rng = np.random.default_rng(4242)
    bf = torch.bfloat16
    t = lambda *s, sc=1.0: torch.as_tensor(  # noqa: E731
        (rng.standard_normal(s) * sc).astype(np.float32), device=dev)

    def small(*s, sc=1.0):
        """A bf16 bias or taps tensor with its f32 copy kept, as the model's."""
        v = t(*s, sc=sc).to(bf)
        keep_f32_copy(v)
        return v

    d, h, c, kk = cfg.d_model, cfg.n_heads, cfg.att_cache_size, cfg.conv_kernel_size
    tq, valid_tq = 8, 6
    e = d * cfg.ff_expansion_factor
    records = {}
    widened0 = as_f32.widened

    def check(label, key, tol, kernel, plain, nbytes, ops, unrounded=None):
        """The kernel against its plain version, timed beside it (and
        recorded under ``key``, where one is given)."""
        got, want = kernel(), plain()
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        torch.cuda.synchronize()
        err = max_err(got, want)
        log(f"{label}: max |kernel - plain| = {err:.3g} (tolerance {tol:g})")
        assert err <= tol, f"{label} disagrees with its plain version"
        if unrounded is not None:
            check_rounding_points(label, tol, got, got_tuple(unrounded()))
        rec = measure(label, timer, err, kernel, plain, nbytes, ops, "bf16")
        if key:
            records[key] = rec
        check_graph_capture(torch, label, lambda: got_tuple(kernel()), (), got)
        return rec

    def got_tuple(r):
        return r if isinstance(r, tuple) else (r,)

    def packed_once(label, fn):
        """The weights packed once, as the model packs them (host clock)."""
        t0 = time.perf_counter()
        packed = fn()
        torch.cuda.synchronize()
        log(f"  {label}: the weights packed in {1e3 * (time.perf_counter() - t0):.2f} ms "
            f"({packed.numel() * packed.element_size()} B)")
        return packed

    def beside_chain(label, rec, chain, plain):
        """The chain that the kernel replaced, timed in the same run: the
        kernel (``rec``) must be faster."""
        err = max_err(got_tuple(chain()), got_tuple(plain()))
        chain_ms = timer(chain)
        log(f"  {label}: {chain_ms:.4f} ms (host enqueue {timer.host_us:.1f} us/call), "
            f"max |chain - plain| {err:.3g}")
        assert rec["ms"] < chain_ms, f"{label}: the kernel is not faster than the chain"

    # attention block: bf16 weights and biases, f32 positional table, a full
    # ring with the cursor mid-ring; the kv cache f32 (the session's) and bf16
    x = t(tq, d)
    ln_g, ln_b = 1.0 + t(d, sc=0.1), t(d, sc=0.1)
    ws = [t(d, d, sc=1 / math.sqrt(d)) for _ in range(4)]
    wsb = [w.to(bf) for w in ws]
    bu, bv = small(h, d // h, sc=0.3), small(h, d // h, sc=0.3)
    pos = t(2 * tq + c - 1, d)
    kv = t(c, 2 * d)
    meta = torch.tensor([100, c, valid_tq], dtype=torch.int32, device=dev)
    s_valid = c + valid_tq
    att_ops = 2 * tq * d * d * 4 + 6 * tq * s_valid * d
    att_packed = packed_once("att_block[bf16]", lambda: pack_att_block(*wsb))
    # the session's f32 cache (bf16_on), then a bf16 state's cache (bf16_step)
    for cache, key, kvc in (("f32", "bf16_attb", kv), ("bf16", "bf16kv_attb", kv.to(bf))):
        args = (x, ln_g, ln_b, *wsb, bu, bv, pos, kvc, meta)
        nbytes = (x.numel() * 4 * 5 + 2 * d * 4 + sum(wbytes(w) for w in wsb) + 2 * d * 2
                  + pos.numel() * 4 + kvc.numel() * kvc.element_size() + 12)
        rec = check(f"att_block[bf16] ({cache} kv cache)", key, BF16_CHAIN_ATOL,
                    lambda: att_block(*args, n_heads=h, packed=att_packed),
                    lambda: att_block_plain(*args, n_heads=h), nbytes, att_ops,
                    lambda: att_block_plain(x, ln_g, ln_b, *[w.float() for w in wsb], bu, bv,
                                            pos, kvc.float(), meta, n_heads=h))
        beside_chain(f"att_block[bf16] ({cache} kv cache) chain (csrc/att_block.cu)", rec,
                     lambda: att_block_chain(*args, n_heads=h),
                     lambda: att_block_plain(*args, n_heads=h))
    # the fast arm's int8 attention block: bf16 biases, weights quantized after the cast
    qws = [quantize_tensor(w.float()) for w in wsb]
    packed = pack_att_block(*qws)
    args = (x, ln_g, ln_b, *qws, bu, bv, pos, kv, meta)
    nbytes = (x.numel() * 4 * 5 + 2 * d * 4 + sum(wbytes(w) for w in qws) + 2 * d * 2
              + pos.numel() * 4 + kv.numel() * 4 + 12)
    check("att_block[fast] (int8, bf16 biases)", "fast_attq", 1e-4,
          lambda: att_block(*args, n_heads=h, packed=packed),
          lambda: att_block_plain(*args, n_heads=h), nbytes, att_ops)

    # joint step: 8 rows, bf16 weights and biases (the bf16 kernel, on weights
    # packed once); int8 with bf16 biases
    rows, j, p, v = tq, cfg.joint_hidden, cfg.pred_hidden, cfg.joint_vocab_size
    eproj, g = t(rows, j), t(rows, p, sc=0.5)
    wp, wo = t(p, j, sc=1 / math.sqrt(p)).to(bf), t(j, v, sc=1 / math.sqrt(j)).to(bf)
    bp, bo = small(j, sc=0.1), small(v, sc=0.1)
    kw = dict(ths=cfg.token_head_size, ndur=cfg.num_duration_bins, blank_id=cfg.blank_id,
              blank_penalty=0.5)
    joint_ops = 2 * rows * (p * j + j * v)
    qwp, qwo = quantize_tensor(wp.float()), quantize_tensor(wo.float())
    jpacked = pack_joint_step(qwp, bp, qwo, bo)
    jbpacked = packed_once("joint_step[bf16]", lambda: pack_joint_step(wp, bp, wo, bo))
    for label, key, tol, (a1, a2), jkw in (
            ("joint_step[bf16]", "bf16_jointb", BF16_CHAIN_ATOL, (wp, wo), {"packed": jbpacked}),
            ("joint_step[fast] (int8, bf16 biases)", "fast_jointq", 1e-4, (qwp, qwo),
             {"packed": jpacked})):
        args = (eproj, g, a1, bp, a2, bo)
        nbytes = ((eproj.numel() + g.numel()) * 4 + (j + v) * 2 + wbytes(a1) + wbytes(a2)
                  + rows * v * 4 + rows * 8)
        kernel = lambda: joint_step(*args, **kw, **jkw)  # noqa: E731
        tok, dur, logits = kernel()
        tok_p, dur_p, logits_p = joint_step_plain(*args, **kw)
        torch.cuda.synchronize()
        tl = logits_p[:, :kw["ths"]].clone()
        tl[:, kw["blank_id"]] -= kw["blank_penalty"]
        for name, lg, a, b in (("token", tl, tok, tok_p),
                               ("duration", logits_p[:, kw["ths"]:kw["ths"] + kw["ndur"]], dur,
                                dur_p)):
            top2 = torch.topk(lg, 2, dim=1).values
            clear = (top2[:, 0] - top2[:, 1]) > 2 * tol
            assert bool(((a == b) | ~clear).all()), f"{label} {name} argmax disagrees"
        log(f"  {label}: tokens equal: {bool((tok == tok_p).all())}, durations equal: "
            f"{bool((dur == dur_p).all())}")
        bf16 = key == "bf16_jointb"
        rec = check(label, key, tol, lambda: kernel()[2], lambda: joint_step_plain(*args, **kw)[2],
                    nbytes, joint_ops,
                    (lambda: joint_step_plain(eproj, g, wp.float(), bp, wo.float(), bo,
                                              **kw)[2]) if bf16 else None)
        if bf16:
            beside_chain(f"{label} three launches (csrc/joint_step.cu)", rec,
                         lambda: joint_step_chain(*args, **kw)[2],
                         lambda: joint_step_plain(*args, **kw)[2])

    # FFN and conv module on the steady chunk's 8 rows (6 valid), bf16 weights
    fln = (1.0 + t(d, sc=0.1), t(d, sc=0.1))
    w1, w2 = t(d, e, sc=1 / math.sqrt(d)).to(bf), t(e, d, sc=1 / math.sqrt(e)).to(bf)
    args = (x, *fln, w1, w2)
    ffn_packed = packed_once("ffn[bf16]", lambda: pack_ffn(w1, w2))
    check("ffn[bf16]", "bf16_ffnb", BF16_CHAIN_ATOL, lambda: fused_ffn(*args, packed=ffn_packed),
          lambda: fused_ffn_plain(*args), (2 * tq * d + 2 * d) * 4 + wbytes(w1) + wbytes(w2),
          4 * tq * d * e, lambda: fused_ffn_plain(x, *fln, w1.float(), w2.float()))
    beside_chain("ffn[bf16] five launches (csrc/ffn.cu)", records["bf16_ffnb"],
                 lambda: fused_ffn_chain(*args), lambda: fused_ffn_plain(*args))
    cln = (1.0 + t(d, sc=0.1), t(d, sc=0.1))
    pw1, pw2 = t(d, 2 * d, sc=1 / math.sqrt(d)).to(bf), t(d, d, sc=1 / math.sqrt(d)).to(bf)
    dw = small(kk, d, sc=1 / math.sqrt(kk))
    bn = (1.0 + t(d, sc=0.1), t(d, sc=0.1), t(d, sc=0.1), 1.0 + t(d, sc=0.1).abs())
    half = (kk - 1) // 2
    tc = t(half, d)
    mask = (torch.arange(tq, device=dev) < valid_tq).float()[:, None]
    conv_packed = packed_once("conv_block[bf16]", lambda: pack_conv_block(pw1, dw, *bn, pw2))
    conv_ops = 2 * tq * d * 3 * d + 2 * tq * kk * d
    # the session's f32 time cache (bf16_all), then a bf16 state's, read as stored
    for cache, key, tcc in (("f32", "bf16_convb", tc), ("bf16", "", tc.to(bf))):
        args = (x, *cln, pw1, dw, *bn, pw2, tcc, mask)
        conv_bytes = ((3 * tq * d + (2 + 4) * d + tq) * 4 + kk * d * 2
                      + tcc.numel() * tcc.element_size())
        rec = check(f"conv_block[bf16] ({cache} time cache)", key, BF16_CHAIN_ATOL,
                    lambda: conv_block(*args, packed=conv_packed), lambda: conv_block_plain(*args),
                    conv_bytes + wbytes(pw1) + wbytes(pw2), conv_ops,
                    lambda: conv_block_plain(x, *cln, pw1.float(), dw, *bn, pw2.float(),
                                             tcc.float(), mask))
        beside_chain(f"conv_block[bf16] ({cache} time cache) five launches "
                     f"(csrc/conv_block.cu)", rec, lambda: conv_block_chain(*args),
                     lambda: conv_block_plain(*args))
    assert as_f32.widened == widened0, (
        "a kept f32 copy was not used, or a cache was widened: the bf16 kernels read it as stored")
    return records


def check_graph_capture(torch, label, fn, args, want) -> None:
    """Capture one call into a CUDA graph and replay it twice: a graph of
    the chunk step needs the cooperative launch to be capturable. The kernel
    is deterministic (and leaves no state behind: the log-mel tickets return
    to zero), so each replay must equal the direct call bit for bit."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*args)
    errs = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        errs.append(max_err(out, want))
    log(f"  {label}: captured into a CUDA graph and replayed twice, max |replay - direct| = "
        f"{max(errs):.3g}")
    assert max(errs) == 0, f"{label}: the graph's replay differs from the direct call"


# bf16 flash attention: the kernel sums q . k on the tensor cores, whose f32
# sums round otherwise than the plain version's f32 einsum, and one f32 ulp
# of a score can flip p's bf16 rounding at a key. Readings at the offline
# shapes on the H100: kernel vs plain 7.83e-4 (p unrounded: 2.48e-3), vs the
# plain version fed tensor-core sums 4.29e-6, 207 of 8,667,136 p roundings
# flipped between the two sums.
FLASH_BF16_ATOL = 1.5e-3       # kernel vs plain
FLASH_SAME_SUMS_ATOL = 1e-4    # kernel vs plain fed the tensor cores' sums
FLASH_FLIP_SHARE = 1e-4        # share of p roundings the two sums may flip


def tensor_core_qk(torch, q, k):
    """q . k [B, H, T, T] for bf16 q, k [B, T, H, dh], summed by a bf16
    tensor-core product with f32 output (cuBLAS ``bmm``): the summation of
    the flash kernel's ``mma.sync``."""
    b, t_len, h, dh = q.shape
    qh = q.transpose(1, 2).reshape(b * h, t_len, dh)
    kh = k.permute(0, 2, 3, 1).reshape(b * h, dh, t_len)
    return torch.bmm(qh, kh, out_dtype=torch.float32).view(b, h, t_len, t_len)


def check_flash_bf16_sums(torch, qd, kd, vd, bd, mask, got) -> None:
    """Hold the bf16 flash kernel to the plain version fed the tensor cores'
    sums of q . k (it rounds p at the same keys as the kernel), and count
    the p roundings (over every query row and key, at the plain version's
    block maxima) that differ between those sums and the f32 einsum's."""
    import trt_asr_tpu_torch.ops.kernels.flash_att as fa

    qk_tc = tensor_core_qk(torch, qd, kd)
    qk_f32 = torch.einsum("bthd,bshd->bhts", qd.float(), kd.float())
    err = float((got - fa.flash_bias_attention_plain(qd, kd, vd, bd, mask, qk=qk_tc))
                .abs().max())

    def p_bf16(qk):
        neg = torch.full((), fa.MASKED_BIAS, dtype=qd.dtype, device=qd.device)
        s = (qk + torch.where(mask[:, None, None, :], bd, neg).float()) \
            * (1.0 / math.sqrt(qd.shape[-1]))
        m = torch.full(s.shape[:-1] + (1,), -1e30, device=s.device)
        blocks = []
        for j0 in range(0, s.shape[-1], fa.KEY_BLOCK):
            m = torch.maximum(m, s[..., j0:j0 + fa.KEY_BLOCK].amax(dim=-1, keepdim=True))
            blocks.append(torch.exp(s[..., j0:j0 + fa.KEY_BLOCK] - m).to(torch.bfloat16))
        return torch.cat(blocks, dim=-1)

    p_tc = p_bf16(qk_tc)
    flips, n = int((p_tc != p_bf16(qk_f32)).sum()), p_tc.numel()
    log(f"  flash_att[bf16] against the plain version fed tensor-core sums of q . k: max "
        f"|diff| {err:.3g} (tolerance {FLASH_SAME_SUMS_ATOL:g}); {flips} of {n} bf16 "
        f"roundings of p differ between those sums and the f32 einsum's (limit "
        f"{FLASH_FLIP_SHARE:g} of them)")
    assert err <= FLASH_SAME_SUMS_ATOL, "flash_att[bf16] disagrees with the tensor-core sums"
    assert flips <= FLASH_FLIP_SHARE * n, "the tensor cores' sums flip too many p roundings"


# bf16 rel shift: the kernel sums q_v . pos on the tensor cores, in another
# order than the plain version's f32 einsum, and one f32 ulp of a sum can
# flip its bf16 rounding; near zero the sums' own error exceeds one bf16 ulp.
# Readings at the offline shapes on the H100 (B 8, T 368): 4.27e-6 of the
# values past one bf16 ulp of the plain version (all within the near-zero
# floor), 7.86e-5 differing from it, 2.42e-5 differing from the plain
# version fed cuBLAS's tensor-core sums (2.0e-5 at B 2).
SHIFT_PAST_ULP_SHARE = 1e-4    # values past one bf16 ulp of the plain version
SHIFT_TC_DIFF_SHARE = 5e-5     # values differing from the plain version fed tensor-core sums


def bf16_ulp(torch, x):
    """One bf16 ulp (8 significant bits) of each value of x."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def tensor_core_pd_operands(q_v, pos):
    """q_v [B, Tq, H, dh] as [B H, Tq, dh] and pos [R, H, dh] as [B H, dh, R],
    contiguous: the operands of ``tensor_core_pd``'s ``bmm``."""
    b, tq, h, dh = q_v.shape
    r = pos.shape[0]
    qh = q_v.transpose(1, 2).reshape(b * h, tq, dh)
    ph = pos.permute(1, 2, 0).expand(b, h, dh, r).reshape(b * h, dh, r)
    return qh, ph


def tensor_core_pd(torch, q_v, pos):
    """q_v . pos [B, H, Tq, R] for bf16 q_v and pos, summed by a bf16
    tensor-core product with f32 output (cuBLAS ``bmm``, as
    ``tensor_core_qk``)."""
    b, tq, h, _ = q_v.shape
    qh, ph = tensor_core_pd_operands(q_v, pos)
    return torch.bmm(qh, ph, out_dtype=torch.float32).view(b, h, tq, pos.shape[0])


def check_rel_shift_bf16(torch, q_v, pos, tkv, got, want) -> None:
    """Hold the bf16 rel-shift kernel to its plain version within one bf16
    ulp, the ulp floored near zero at twice the f32 sums' distance from the
    f64 sums (there one ulp is below the f32 sums' own error), with at most
    SHIFT_PAST_ULP_SHARE of the values past one ulp; and to the plain version
    fed tensor-core sums, shifted and rounded once, with at most
    SHIFT_TC_DIFF_SHARE of the values differing (the plain version itself
    differs at more), none by more than one ulp or the same floor. ``want``
    is the plain version's output on these inputs."""
    from trt_asr_tpu_torch.ops.kernels.rel_shift import rel_shift

    want = want.float()
    f32 = rel_shift(torch.einsum("bthd,rhd->bhtr", q_v.float(), pos.float()), tkv)
    f64 = rel_shift(torch.einsum("bthd,rhd->bhtr", q_v.double(), pos.double()), tkv)
    floor = 2 * float((f32.double() - f64).abs().max())
    g = got.float()
    diff, ulp = (g - want).abs(), bf16_ulp(torch, want)
    past = float((diff > ulp).float().mean())
    worst = float((diff - ulp.clamp_min(floor)).max())
    differ_plain = float((diff > 0).float().mean())
    tc = rel_shift(tensor_core_pd(torch, q_v, pos), tkv).to(q_v.dtype).float()
    dtc = (g - tc).abs()
    differ_tc = float((dtc > 0).float().mean())
    ulp_tc = bf16_ulp(torch, torch.maximum(g.abs(), tc.abs()))
    past_tc = int((dtc > ulp_tc).sum())
    worst_tc = float((dtc - ulp_tc.clamp_min(floor)).max())
    log(f"rel_shift[bf16]: max |kernel - plain| = {float(diff.max()):.3g}; {past:.3g} of the "
        f"values past one bf16 ulp (limit {SHIFT_PAST_ULP_SHARE:g}; near-zero floor "
        f"{floor:.3g}: worst excess {worst:.3g}); {differ_plain:.3g} of the values differ from "
        f"the plain version, {differ_tc:.3g} from the plain version fed tensor-core sums (limit "
        f"{SHIFT_TC_DIFF_SHARE:g}; {past_tc} past one ulp of it; worst excess over one ulp or "
        f"the floor {worst_tc:.3g})")
    assert worst <= 0 and past <= SHIFT_PAST_ULP_SHARE, (
        "rel_shift[bf16] disagrees with its plain version")
    assert worst_tc <= 0 and differ_tc <= SHIFT_TC_DIFF_SHARE, (
        "rel_shift[bf16] disagrees with the plain version fed tensor-core sums")


def check_offline_kernels(torch, dev, timer, cfg, t_steps: int, lengths):
    """Rel shift and flash attention against their plain versions at the
    offline batch's shapes: q/k/v [B, T, H, dh], the rel-pos table [2T-1,
    H, dh], kv lengths ``lengths`` [B]. Rel shift in f32 (logged; the path
    runs it in bf16 only) and bf16; flash in both, with the time of
    ``scaled_dot_product_attention`` on the same inputs (its mask the
    masked bias over sqrt(dh)) as the library call."""
    from trt_asr_tpu_torch.ops.kernels.flash_att import (MASKED_BIAS, flash_bias_attention,
                                                         flash_bias_attention_plain)
    from trt_asr_tpu_torch.ops.kernels.rel_shift import (rel_pos_bias_shifted,
                                                         rel_pos_bias_shifted_plain)

    rng = np.random.default_rng(4321)
    b, t_len, h, dh = len(lengths), t_steps, cfg.n_heads, cfg.head_dim
    t = lambda *s, sc=1.0: torch.as_tensor(  # noqa: E731
        (rng.standard_normal(s) * sc).astype(np.float32), device=dev)
    q, k, v, qv = (t(b, t_len, h, dh) for _ in range(4))
    pos = t(2 * t_len - 1, h, dh)
    mask = torch.arange(t_len, device=dev)[None, :] < torch.as_tensor(lengths, device=dev)[:, None]
    log(f"offline kernels at B={b} T={t_len} H={h} dh={dh}, kv lengths {list(lengths)}")
    records = {}
    for arm, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        es = 4 if arm == "f32" else 2
        op_type = "f32" if arm == "f32" else "bf16"
        qv_d, pos_d = qv.to(dtype), pos.to(dtype)
        got = rel_pos_bias_shifted(qv_d, pos_d, tkv=t_len)
        want = rel_pos_bias_shifted_plain(qv_d, pos_d, tkv=t_len)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if arm == "f32":
            rel = err / float(want.abs().max())
            log(f"rel_shift[f32]: max |kernel - plain| = {err:.3g} ({rel:.3g} of the largest "
                f"|value|, tolerance 1e-5)")
            assert rel <= 1e-5, "rel_shift[f32] disagrees with its plain version"
        else:
            check_rel_shift_bf16(torch, qv_d, pos_d, t_len, got, want)
        nbytes = (qv.numel() + pos.numel() + b * h * t_len * t_len) * es
        rec = measure(f"rel_shift[{arm}]", timer, err,
                      lambda: rel_pos_bias_shifted(qv_d, pos_d, tkv=t_len),
                      lambda: rel_pos_bias_shifted_plain(qv_d, pos_d, tkv=t_len),
                      nbytes, 2 * b * h * t_len * t_len * dh, op_type)
        records[f"{arm}_shift"] = rec
        if arm == "bf16":
            qh, ph = tensor_core_pd_operands(qv_d, pos_d)
            bmm_ms = timer(lambda: torch.bmm(qh, ph, out_dtype=torch.float32))
            log(f"  rel_shift[bf16] yardstick: cuBLAS bf16 tensor-core bmm of q_v against the "
                f"whole table, {list(qh.shape)} x {list(ph.shape)} -> f32 (twice bd's columns, "
                f"unshifted): {bmm_ms:.4f} ms; the kernel takes {rec['ms'] / bmm_ms:.2f}x its "
                f"time, {100 * rec['bound_ms'] / rec['ms']:.1f}% of its own bound")

        # bd as the offline path passes it at this T: in bf16 the rel-shift
        # kernel's contiguous output (its gate opens at T >= 128), in f32 the
        # plain shift's strided view
        strided = want
        qd, kd, vd, bd = q.to(dtype), k.to(dtype), v.to(dtype), got if arm == "bf16" else want
        got = flash_bias_attention(qd, kd, vd, bd, mask)
        want_f = flash_bias_attention_plain(qd, kd, vd, bd, mask)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all()), f"flash[{arm}] is not finite"
        err = float((got - want_f).abs().max())
        # bf16: see FLASH_BF16_ATOL
        atol, rtol = (2e-5, 1e-4) if arm == "f32" else (FLASH_BF16_ATOL, 0.0)
        excess = float(((got - want_f).abs() - rtol * want_f.abs()).max())
        log(f"flash_att[{arm}]: max |kernel - plain| = {err:.3g} (tolerance atol {atol:g} + "
            f"rtol {rtol:g}: worst |diff| - rtol |plain| = {excess:.3g})")
        assert excess <= atol, f"flash_att[{arm}] disagrees with its plain version"
        has_key = mask.any(dim=1)
        if arm == "bf16":
            check_flash_bf16_sums(torch, qd, kd, vd, bd, mask, got)
            # the same values in f32: p is not rounded (a fully masked row
            # differs by its -1e9 alone, so only rows with a valid key count)
            unrounded = flash_bias_attention_plain(qd.float(), kd.float(), vd.float(),
                                                   bd.float(), mask)
            check_rounding_points("flash_att[bf16]", atol, (got[has_key],),
                                  (unrounded[has_key],))
        scale = 1.0 / math.sqrt(dh)
        neg = torch.full((), MASKED_BIAS, dtype=dtype, device=dev)
        sdpa_mask = (torch.where(mask[:, None, None, :], bd, neg).float() * scale).to(dtype)
        qh, kh, vh = (x.transpose(1, 2) for x in (qd, kd, vd))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_out = sdpa(qh, kh, vh, attn_mask=sdpa_mask).transpose(1, 2).reshape(b, t_len, h * dh)
        log(f"  scaled_dot_product_attention[{arm}]: max |sdpa - plain| = "
            f"{float((lib_out.float() - want_f)[has_key].abs().max()):.3g} over rows with a "
            f"valid key (a fully masked row rounds the masked scores otherwise)")
        nbytes = (3 * q.numel() + bd.numel()) * es + mask.numel() + got.numel() * 4
        records[f"{arm}_flash"] = measure(
            f"flash_att[{arm}]", timer, err, lambda: flash_bias_attention(qd, kd, vd, bd, mask),
            lambda: flash_bias_attention_plain(qd, kd, vd, bd, mask),
            nbytes, 4 * b * h * t_len * t_len * dh, op_type,
            library_fn=lambda: sdpa(qh, kh, vh, attn_mask=sdpa_mask))
        r = records[f"{arm}_flash"]
        log(f"  flash_att[{arm}]: {100 * r['bound_ms'] / r['ms']:.1f}% of its bound, "
            f"{r['ms'] / r['library_ms']:.2f}x SDPA's time")
        if arm == "bf16":
            # the plain shift's view (T < 128 on the path): 2-byte bias rows
            got_s = flash_bias_attention(qd, kd, vd, strided, mask)
            err_s = float((got_s - flash_bias_attention_plain(qd, kd, vd, strided, mask))
                          .abs().max())
            assert err_s <= atol, "flash_att[bf16] on the strided bias disagrees"
            check_flash_bf16_sums(torch, qd, kd, vd, strided, mask, got_s)
            ms_s = timer(lambda: flash_bias_attention(qd, kd, vd, strided, mask))
            log(f"  flash_att[bf16] on the plain shift's strided view: max |kernel - plain| "
                f"{err_s:.3g}, kernel {ms_s:.4f} ms")
    return records


def f32_gemm_ms(rows) -> float:
    """Device ms of cuBLAS's f32 SIMT products (``...f32f32...ffma``,
    ``sgemm``) among profile rows."""
    return sum(us for us, key, _ in rows
               if "gemm" in key.lower() and ("f32f32" in key or "sgemm" in key)) / 1e3


def check_bf16_matmul(torch, dev, timer, rows: int, cfg) -> None:
    """``ops.common.matmul`` of bf16 activations and bf16 weights (the bf16
    weights configuration) at the offline FFN's shape [rows, d] x [d, 4d]:
    bf16, within one bf16 ulp of the f32 product rounded once (the ulp
    floored near zero at twice the f32 product's own distance from the
    f64 product: there one ulp is below the f32 sums' error), and its time
    beside the f32 SIMT product of the same operands (TF32 off)."""
    from trt_asr_tpu_torch.ops.common import matmul

    rng = np.random.default_rng(99)
    d, e = cfg.d_model, cfg.d_model * cfg.ff_expansion_factor
    a = torch.as_tensor(rng.standard_normal((rows, d)).astype(np.float32), device=dev)
    w = torch.as_tensor((rng.standard_normal((d, e)) / math.sqrt(d)).astype(np.float32),
                        device=dev)
    a, w = a.to(torch.bfloat16), w.to(torch.bfloat16)
    got = matmul(a, w)
    f32 = a.float() @ w.float()
    floor = 2 * float((f32.double() - a.double() @ w.double()).abs().max())
    want = f32.to(torch.bfloat16).float()
    ulp = bf16_ulp(torch, want)
    diff = (got.float() - want).abs()
    past = float((diff > ulp).float().mean())
    worst = float((diff - ulp.clamp_min(floor)).max())
    af, wf = a.float(), w.float()
    ms_bf16 = timer(lambda: matmul(a, w))
    ms_f32 = timer(lambda: af @ wf)
    log(f"matmul[bf16 x bf16] [{rows}, {d}] x [{d}, {e}]: {got.dtype}, {past:.3g} of the values "
        f"past one bf16 ulp of the f32 product (limit 1e-4; the near-zero floor {floor:.3g}: "
        f"worst excess {worst:.3g}); {ms_bf16:.4f} ms on the tensor cores against {ms_f32:.4f} "
        f"ms for the f32 SIMT product")
    assert got.dtype == torch.bfloat16, "bf16 x bf16 matmul does not return bf16"
    assert worst <= 0 and past <= 1e-4, "bf16 x bf16 matmul lies past one bf16 ulp"


# --- phases 3 and 4: sessions ----------------------------------------------


def synth_module():
    """The synthetic spoken-words task (the port's ``eval/synthetic.py``)."""
    from trt_asr_tpu_torch.eval import synthetic

    return synthetic


def wrappers():
    """Launch counter name -> kernel wrapper."""
    from trt_asr_tpu_torch.ops.kernels.att_block import att_block
    from trt_asr_tpu_torch.ops.kernels.conv_block import conv_block, conv_ffn_ln
    from trt_asr_tpu_torch.ops.kernels.ffn import fused_ffn
    from trt_asr_tpu_torch.ops.kernels.flash_att import flash_bias_attention
    from trt_asr_tpu_torch.ops.kernels.joint_step import joint_step
    from trt_asr_tpu_torch.ops.kernels.mel import logmel
    from trt_asr_tpu_torch.ops.kernels.rel_shift import rel_pos_bias_shifted

    return {"att_block": att_block, "joint_step": joint_step, "logmel": logmel,
            "ffn": fused_ffn, "conv_block": conv_block, "conv_ffn_ln": conv_ffn_ln,
            "rel_shift": rel_pos_bias_shifted, "flash_att": flash_bias_attention}


def reset_counts():
    for fn in wrappers().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in wrappers().items()}


def expected_kernels(rt, mel: bool = True) -> set:
    """The kernels a session with these runtime flags launches, the log-mel
    kernel with ``mel``."""
    tail = rt.use_pallas_conv and rt.use_pallas_ffn and rt.quant in ("encoder", "all")
    names = {"att_block", "joint_step"} | ({"logmel"} if mel else set())
    names |= {"ffn"} if rt.use_pallas_ffn else set()
    names |= {"conv_ffn_ln" if tail else "conv_block"} if rt.use_pallas_conv else set()
    return names


def check_launches(label, rt, counts, mel: bool = True) -> None:
    want = expected_kernels(rt, mel)
    got = {k for k, v in counts.items() if v > 0}
    assert got == want, f"{label}: launched {sorted(got)}, expected {sorted(want)} ({counts})"


def new_session(torch, model, rt, state_dtype=None):
    """A session on ``model``; with ``state_dtype`` its encoder state is
    replaced by one stored in that type (bf16: the graft entry's state), so
    that every chunk's ``_session_step`` takes it, closed loop."""
    from trt_asr_tpu_torch.models.parakeet.encoder import init_encoder_state
    from trt_asr_tpu_torch.streaming.session import StreamingSession

    sess = StreamingSession(model, rt)
    if state_dtype is not None:
        sess._enc_state = init_encoder_state(model.cfg, 1, device=model.device, dtype=state_dtype)
    return sess


def run_session(torch, model, rt, audio, piece: int, state_dtype=None, feats=None):
    """One utterance through a session: ``audio`` pushed in pieces, or with
    ``feats`` those features pushed in pieces of as many frames."""
    sess = new_session(torch, model, rt, state_dtype)
    if feats is not None:
        step = piece // model.frontend.spec.hop_length
        for i in range(0, feats.shape[0], step):
            sess.push_features(feats[i:i + step])
    else:
        for i in range(0, len(audio), piece):
            sess.push_audio(audio[i:i + piece])
    sess.finalize()
    torch.cuda.synchronize()
    return sess


def make_model(torch, cfg, params, tok, rt, dev, mel_kernel: bool, weights_dtype=None):
    from trt_asr_tpu_torch.contract import FrontendSpec
    from trt_asr_tpu_torch.frontend.logmel import LogMelFrontend
    from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT

    fe = LogMelFrontend(FrontendSpec(n_mels=cfg.feat_in), use_kernel=mel_kernel, device=dev)
    return ParakeetTDT(cfg, params, tok, frontend=fe, runtime=rt, device=dev,
                       weights_dtype=weights_dtype)


# the kernel of each route: one persistent kernel a call of every weight
# type, by the profiler's kernel names
PERSISTENT = {"att_block": {"int8": "att_block_q8_kernel", "f32": "att_block_f32_kernel",
                            "bf16": "att_block_bf16_kernel"},
              "joint_step": {"int8": "joint_step_q8_kernel", "f32": "joint_step_f32_kernel",
                             "bf16": "joint_step_bf16_kernel"},
              "ffn": {"int8": "ffn_q8_kernel", "f32": "ffn_f32_kernel", "bf16": "ffn_bf16_kernel"},
              "conv_block": {"int8": "conv_block_q8_kernel", "f32": "conv_block_f32_kernel",
                             "bf16": "conv_block_bf16_kernel"}}
# the kernels of the chains (csrc/att_block.cu, joint_step.cu, ffn.cu,
# conv_block.cu), on no path: none may run in a session or the engine
CHAIN_KERNELS = ("rel_attention_kernel", "argmax_reduce_kernel", "conv_module_kernel",
                 "port::layernorm_kernel", "small_m_gemm_partial", "small_m_gemm_epilogue")


def profile_session(torch, label, model, rt, audio, piece: int, state_dtype=None) -> None:
    """Device busy share and kernel time by name over one session
    (torch.profiler): where a steady chunk's time goes. Each wrapper call of
    the fused tail must be one kernel, with no conv module kernel beside
    it. Each call of the attention block, the joint step, the FFN and the
    conv module must be one persistent kernel of its weights' type
    (``att_block_q8_kernel`` / ``_bf16`` / ``_f32``, ``joint_step_q8_kernel``
    / ``_bf16`` / ``_f32``, ``ffn_q8_kernel`` / ``_bf16`` / ``_f32``,
    ``conv_block_q8_kernel`` / ``_bf16`` / ``_f32``), and no kernel of a
    chain may run (``CHAIN_KERNELS``)."""
    reset_counts()
    rows = profile_run(torch, label, "chunk", lambda: len(run_session(
        torch, model, rt, audio, piece, state_dtype).chunk_latencies_ms))
    counts = read_counts()
    launched = lambda name: sum(n for _, key, n in rows if name in key)  # noqa: E731
    calls, tail, conv = counts["conv_ffn_ln"], launched("conv_ffn_ln_kernel"), launched(
        "conv_module_kernel")
    log(f"  profile[{label}]: {calls} conv_ffn_ln calls, {tail} conv_ffn_ln_kernel launches, "
        f"{conv} conv_module_kernel launches")
    assert tail == calls, f"profile[{label}]: conv_ffn_ln is not one kernel a call"
    from trt_asr_tpu_torch.ops.kernels.persistent import weight_kind

    lp = model.layers[0]
    routes = {name: weight_kind(name, w) for name, w in (
        ("att_block", lp["att_wq"]), ("joint_step", model.params["joint"]["out"]["w"]),
        ("ffn", lp["ff1_w1"]), ("conv_block", lp["conv_pw1"]))}
    for name, kinds in PERSISTENT.items():
        n = counts[name]
        got = {kind: launched(kernel) for kind, kernel in kinds.items()}
        log(f"  profile[{label}]: {n} {name} calls ({routes[name]} weights), launches {got}")
        want = {kind: n if kind == routes[name] else 0 for kind in kinds}
        assert got == want, f"profile[{label}]: {name} is not its route's kernel a call"
    chain = {k: launched(k) for k in CHAIN_KERNELS}
    log(f"  profile[{label}]: the chains' launches (csrc/att_block.cu, joint_step.cu, ffn.cu, "
        f"conv_block.cu) {chain}, expected none")
    assert not any(chain.values()), f"profile[{label}]: a chain's kernel ran"


def device_rows(torch, prof) -> list:
    """(device us, name, count) of each kernel, copy and fill the profiler
    traced on the card, summed by name, longest first: read from its raw
    events (``key_averages`` builds every event's tree first, ~40 s for the
    200,000 launches of a streaming train step), each name demangled as
    ``key_averages`` names it."""
    from torch.autograd.profiler_util import _rewrite_name

    by_name = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            name = _rewrite_name(name=ev.name(), with_wildcard=True)
            us, n = by_name.get(name, (0.0, 0))
            by_name[name] = (us + ev.duration_ns() / 1e3, n + 1)
    return sorted(((us, k, n) for k, (us, n) in by_name.items() if us > 0), reverse=True)


def profile_run(torch, label, unit: str, fn):
    """Device busy share and kernel time by name over ``fn()``, which
    returns how many units of work it did, with torch.profiler. Returns the
    (device us, kernel name, launches) rows."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies): the CPU ops that launched
    # them carry the same device time again
    rows = device_rows(torch, prof)
    busy_ms = sum(r[0] for r in rows) / 1e3
    copy_ms = sum(r[0] for r in rows if "copy" in r[1].lower()) / 1e3
    log(f"profile[{label}]: {n} {unit}s, wall {wall_ms:.1f} ms, "
        f"device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}% busy, "
        f"{100 - 100 * busy_ms / wall_ms:.1f}% idle), {busy_ms / n:.3f} ms a {unit}; "
        f"copy kernels {copy_ms:.3f} ms")
    for dev_us, key, count in rows[:12]:
        log(f"  {dev_us / 1e3:9.3f} ms {count:6d}x  {key[:90]}")
    for dev_us, key, count in rows:
        if key.startswith(("port::", "void port::")):
            log(f"  kernel {key.split('(')[0][:60]}: {dev_us / count:.2f} us a launch, "
                f"{count}x")
    return rows


def decode_and_sync_counts(torch, model, rt, audio, piece: int, state_dtype=None):
    """Decode-loop iterations and host syncs per chunk over one session. A
    host sync is a synchronizing CUDA call that torch's sync debug mode
    reports (copies to the host, blocking copies to the card)."""
    import warnings

    from trt_asr_tpu_torch.decode.greedy_loop import greedy_decode_loop as dec

    it0 = dec.iterations
    sess = new_session(torch, model, rt, state_dtype)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for i in range(0, len(audio), piece):
                sess.push_audio(audio[i:i + piece])
            sess.finalize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    n = len(sess.chunk_latencies_ms)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    return (dec.iterations - it0) / n, syncs / n


def calibrate_blank_bias(model, n_words: int, count_tokens, what: str) -> float:
    """Bisect a bias on the joint's blank logit (plain f32 model; the
    tokens ``count_tokens()`` decodes) toward one token per spoken word of
    ``what``, the rate a trained model emits on these utterances (gate_r3,
    phase 4: one token a word). Random weights
    otherwise emit on almost every step, and their token count jumps with
    the bias, so the search keeps the bias whose count is closest to the
    target from above (at least one token a word: the f32 exactness check
    needs tokens). The bias lives in the shared joint bias tensor, so every
    arm decodes with it."""
    b = model.params["joint"]["out"]["b"]
    blank = model.cfg.blank_id
    base = float(b[blank])
    lo, hi = 0.0, 4.0
    tried = {}
    t0 = time.perf_counter()
    for _ in range(10):
        mid = 0.5 * (lo + hi)
        b[blank] = base + mid
        tried[mid] = n_tok = count_tokens()
        if n_words <= n_tok <= 2 * n_words:
            break
        lo, hi = (mid, hi) if n_tok > n_words else (lo, mid)
    bias = min(tried, key=lambda m: (tried[m] < n_words, abs(tried[m] - n_words)))
    b[blank] = base + bias
    log(f"emission profile: blank bias {bias:.5f} -> {tried[bias]} tokens (target {n_words}, "
        f"one a word of {what}, on the plain f32 path); tried "
        f"{ {round(m, 5): n for m, n in tried.items()} } in {time.perf_counter() - t0:.1f} s")
    return bias


def full_width_session(torch, dev, timer, n_words: int, seed: int):
    from trt_asr_tpu_torch.config import ModelConfig, RuntimeConfig
    from trt_asr_tpu_torch.models.parakeet.params import init_params_numpy
    from trt_asr_tpu_torch.models.parakeet.quant import keep_bf16_copies, quantize_params
    from trt_asr_tpu_torch.ops.common import matmul
    from trt_asr_tpu_torch.ops.quant import as_f32, q8_matmul
    from trt_asr_tpu_torch.tokenizer import Tokenizer, make_synthetic_vocab

    cfg = contract_config()            # phase 3e (a): the contract's architecture
    t0 = time.perf_counter()
    params = init_params_numpy(cfg, seed=seed)
    tok = Tokenizer(make_synthetic_vocab(cfg.vocab_size), blank_id=cfg.blank_id)
    log(f"full-width weights (seed {seed}) made in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(seed)
    synth = synth_module()
    audio = synth.synth_utterance(list(rng.integers(0, 1120, size=n_words)), rng)
    warm = audio[:16000]
    piece = 8000
    on = dict(use_pallas_att=True, use_pallas_joint=True)
    every = dict(on, use_pallas_ffn=True, use_pallas_conv=True)
    bf = torch.bfloat16
    arms = {  # runtime flags, log-mel kernel, weights' type (None: f32), encoder state's type
        "f32_off": (RuntimeConfig(), False, None, None),
        "f32_on": (RuntimeConfig(**on), True, None, None),
        "int8_on": (RuntimeConfig(**on, quant="all"), True, None, None),
        "f32_all": (RuntimeConfig(**every), True, None, None),
        "int8_all": (RuntimeConfig(**every, quant="all"), True, None, None),
        "int8_conv": (RuntimeConfig(**on, use_pallas_conv=True, quant="all"), True, None, None),
        # the JAX package's production type: the bf16 weights of
        # cast_params_for_compute, the session's f32 state; the fast arm's
        # weights quantize after the cast, over the session's f32 state
        # (fast_on) and over a bf16 state (fast_step: the JAX bench's fast
        # arm, bench.py:547-552); bf16_step keeps the graft entry's bf16 state
        "bf16_on": (RuntimeConfig(**on), True, bf, None),
        "bf16_all": (RuntimeConfig(**every), True, bf, None),
        "fast_on": (RuntimeConfig(**on, quant="all"), False, bf, None),
        "fast_step": (RuntimeConfig(**on, quant="all"), False, bf, bf),
        "bf16_step": (RuntimeConfig(**on), False, bf, bf),
    }
    results, previous = {}, {}      # per arm; int8 arms' tokens on the previous routes
    model_f32 = None
    for name, (rt, mel_k, wdt, sdt) in arms.items():
        t_arm = time.perf_counter()
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        model = make_model(torch, cfg, params if model_f32 is None else model_f32.params,
                           tok, rt, dev, mel_k, wdt)
        torch.cuda.synchronize()
        made_ms = (time.perf_counter() - t0) * 1e3      # casting, quantizing, packing included
        packs = {k: sum(lp[k].numel() * lp[k].element_size() for lp in model.layers if k in lp)
                 for k in ("att_block_packed", "ff1_packed", "ff2_packed", "conv_block_packed",
                           "conv_ffn_ln_packed")}
        if any(packs.values()):
            log(f"session[{name}]: the layers' weights packed once for their kernels, bytes: "
                f"{ {k: v for k, v in packs.items() if v} }")
        if model.joint_packed is not None:
            log(f"session[{name}]: the joint's weights packed once for its kernel: "
                f"{model.joint_packed.numel() * model.joint_packed.element_size()} B "
                f"({model.joint_packed.dtype})")
        if rt.quant != "none" or wdt is not None:
            log(f"session[{name}]: making the model allocated "
                f"{(torch.cuda.memory_allocated() - mem0) / 2**20:.1f} MiB on the card, of "
                f"which the bf16 copies of its int8 weights {model.bf16_copy_bytes / 2**20:.1f} "
                f"MiB")
        q8_matmul.widened = 0
        if model_f32 is None:
            model_f32 = model
            bias = calibrate_blank_bias(
                model, n_words, lambda: len(run_session(torch, model, rt, audio, piece).tokens),
                "the utterance")
        first_ms = run_session(torch, model, rt, warm, piece, sdt).chunk_latencies_ms[0]
        reset_counts()
        matmul.widened = as_f32.widened = as_f32.widened_bytes = 0
        sess = run_session(torch, model, rt, audio, piece, sdt)
        counts = read_counts()
        widened, small_widened = matmul.widened, (as_f32.widened, as_f32.widened_bytes)
        if rt.quant != "none" and wdt is None:
            with previous_int8_routes(torch):
                previous[name] = run_session(torch, model, rt, audio, piece).tokens
        lat = np.asarray(sess.chunk_latencies_ms)
        steady = lat[1:-1]
        n_chunks = len(lat)
        results[name] = dict(tokens=sess.tokens, stamps=sess.token_timestamps(), counts=counts,
                             n_chunks=n_chunks,
                             median_ms=float(np.median(steady)),
                             p90_ms=float(np.percentile(steady, 90)))
        iters, syncs = decode_and_sync_counts(torch, model, rt, audio[: len(audio) // 3], piece,
                                              sdt)
        profile_session(torch, name, model, rt, audio[: len(audio) // 3], piece, sdt)
        assert q8_matmul.widened == 0, (
            f"session[{name}] widened an int8 weight at {q8_matmul.widened} calls")
        log(f"session[{name}]: {len(audio) / 16000:.2f} s audio, {n_chunks} chunks, "
            f"{len(sess.tokens)} tokens ({len(sess.tokens) / n_chunks:.2f}/chunk), steady "
            f"chunk median {results[name]['median_ms']:.3f} ms p90 {results[name]['p90_ms']:.3f} ms, "
            f"first chunk {lat[0]:.3f} ms (the warm-up utterance's {first_ms:.3f} ms; "
            f"model made in {made_ms:.1f} ms), "
            f"launches {counts} ({ {k: round(v / n_chunks, 2) for k, v in counts.items()} }/chunk), "
            f"decode iterations {iters:.2f}/chunk, host syncs {syncs:.2f}/chunk, f32 x bf16 "
            f"widenings {widened / n_chunks:.2f}/chunk, small f32 copies made at a call "
            f"{small_widened[0]} ({small_widened[1]} B)")
        if name == "fast_step":
            # the int8 attention kernel reads an f32 copy of each layer's bf16
            # kv cache, made at the call: one a launch, C x 2D values each
            per = cfg.att_cache_size * 2 * cfg.d_model
            assert small_widened == (counts["att_block"], counts["att_block"] * per * 6), (
                f"session[{name}] made f32 copies other than the kv caches': {small_widened}")
            kv = torch.zeros((cfg.att_cache_size, 2 * cfg.d_model), dtype=bf, device=dev)
            copy_ms = timer(lambda: as_f32(kv))
            as_f32.widened = as_f32.widened_bytes = 0
            log(f"session[{name}]: the int8 attention kernel's f32 copies of the bf16 kv cache: "
                f"{small_widened[0] / n_chunks:.2f} a chunk, {small_widened[1] / n_chunks:.0f} B "
                f"a chunk (read and written), {copy_ms:.4f} ms a copy (L2 scrubbed): "
                f"{copy_ms * small_widened[0] / n_chunks:.3f} device ms a chunk")
            results[name]["kv_copies"] = (small_widened[0] / n_chunks, copy_ms)
        else:
            assert small_widened == (0, 0), f"session[{name}] made f32 copies at a call"
        if wdt is not None:
            hold_to_plain(torch, name, model, rt, audio, piece, sdt)
        log(f"session[{name}]: {time.perf_counter() - t_arm:.1f} s for the arm")
        del model, sess
    # the card memory the bf16 copies of the int8 weights add, alone
    q = quantize_params(model_f32.params, "all")
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    nbytes = keep_bf16_copies(q)
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    log(f"bf16 copies of the full-width quant='all' int8 weights: memory_allocated {mem0} -> "
        f"{mem1} B (+{(mem1 - mem0) / 2**20:.1f} MiB; {nbytes} B, 2 B a weight)")
    del q
    a_off = results["f32_off"]
    assert not any(a_off["counts"].values()), f"f32_off launched {a_off['counts']}"
    assert len(a_off["tokens"]) >= n_words, "f32 session emitted too few tokens to compare"
    for name, (rt, mel_k, _, _) in arms.items():
        if name != "f32_off":
            check_launches(f"session[{name}]", rt, results[name]["counts"], mel_k)
    for name in ("f32_on", "f32_all"):
        assert results[name]["tokens"] == a_off["tokens"], (
            f"session[{name}] is not token-exact with the kernels off")
    for name in ("int8_on", "int8_all", "int8_conv", "bf16_on", "bf16_all", "fast_on",
                 "fast_step", "bf16_step"):
        b = results[name]["tokens"]
        assert len(b) > 0
        same = sum(x == y for x, y in zip(a_off["tokens"], b))
        log(f"session[{name}] agreement with f32: {same}/{max(len(a_off['tokens']), len(b))} "
            f"positions, exact={a_off['tokens'] == b}")
        if name not in previous:
            continue
        prev = previous[name]
        same = sum(x == y for x, y in zip(prev, b))
        log(f"session[{name}] agreement with the previous int8 routes: "
            f"{same}/{max(len(prev), len(b))} positions, exact={prev == b} ({len(b)} tokens "
            f"against {len(prev)}): {b} against {prev}")
    log(f"f32 kernels on and all kernels == kernels off: token-exact "
        f"({len(a_off['tokens'])} tokens)")
    return results, model_f32.params, tok, bias


@contextlib.contextmanager
def record_encoder(module_name: str):
    """Record the valid encoder output rows of every ``encode`` call that
    ``module_name`` (the session's or the engine's module) makes: a list of
    [rows, D] f32 host tensors, one a chunk and stream row."""
    import importlib

    mod = importlib.import_module(module_name)
    outs, real = [], mod.encode

    def recorder(*args, **kwargs):
        enc, out_len, state = real(*args, **kwargs)
        for b, n in enumerate(out_len.tolist()):
            outs.append((b, enc[b, :n].float().cpu()))
        return enc, out_len, state

    mod.encode = recorder
    try:
        yield outs
    finally:
        mod.encode = real


@contextlib.contextmanager
def plain_streaming_wrappers():
    """The streaming path's kernel wrappers (attention block, FFN, conv
    module, fused tail, joint step) swapped for their plain versions, which
    run on the card."""
    from trt_asr_tpu_torch.decode import greedy_loop
    from trt_asr_tpu_torch.models.parakeet import encoder
    from trt_asr_tpu_torch.ops.kernels import att_block as ab
    from trt_asr_tpu_torch.ops.kernels import conv_block as cb
    from trt_asr_tpu_torch.ops.kernels import ffn as kf
    from trt_asr_tpu_torch.ops.kernels import joint_step as js

    saved = (encoder.att_block, encoder.fused_ffn, encoder.conv_block, encoder.conv_ffn_ln,
             greedy_loop.joint_step)
    encoder.att_block = lambda *a, n_heads, packed=None: ab.att_block_plain(*a, n_heads=n_heads)
    encoder.fused_ffn = lambda *a, scale=0.5, packed=None: kf.fused_ffn_plain(*a, scale)
    encoder.conv_block = lambda *a, packed=None: cb.conv_block_plain(*a)
    encoder.conv_ffn_ln = lambda *a, packed=None: cb.conv_ffn_ln_plain(*a)
    greedy_loop.joint_step = lambda *a, packed=None, **kw: js.joint_step_plain(*a, **kw)
    try:
        yield
    finally:
        (encoder.att_block, encoder.fused_ffn, encoder.conv_block, encoder.conv_ffn_ln,
         greedy_loop.joint_step) = saved


def enc_distance(a, b) -> float:
    """Max |difference| of two recorded closed-loop encoder outputs."""
    assert [x.shape for _, x in a] == [y.shape for _, y in b], "the chunk schedules differ"
    return max((float((x - y).abs().max()) for (_, x), (_, y) in zip(a, b) if x.numel()),
               default=0.0)


def stream_features(torch, model, audio) -> np.ndarray:
    """The plain frontend's streaming log-mel frames of ``audio``."""
    from trt_asr_tpu_torch.contract import FrontendSpec
    from trt_asr_tpu_torch.frontend.logmel import LogMelFrontend, StreamingLogMel

    fe = LogMelFrontend(FrontendSpec(n_mels=model.cfg.feat_in), device=model.device)
    return StreamingLogMel(fe).push(audio)


def hold_to_plain(torch, label, model, rt, audio, piece: int, state_dtype) -> None:
    """An arm's closed-loop encoder output against the same arm with every
    kernel wrapper swapped for its plain version on the card: within twice
    the distance the plain arm moves when its features move by 1e-6 (phase
    4's rule for offline bf16: bf16 rounding points turn 1e-6 into flips).
    The plain runs push the plain frontend's features; the kernel arm
    pushes audio through its own frontend. Tokens side by side."""
    name = "trt_asr_tpu_torch.streaming.session"
    with record_encoder(name) as enc_k:
        s_k = run_session(torch, model, rt, audio, piece, state_dtype)
    feats = stream_features(torch, model, audio)
    nudge = np.random.default_rng(5).standard_normal(feats.shape).astype(np.float32)
    runs = []
    with plain_streaming_wrappers():
        for f in (feats, feats + 1e-6 * nudge):
            reset_counts()
            with record_encoder(name) as enc:
                sess = run_session(torch, model, rt, audio, piece, state_dtype, feats=f)
            assert not launched(read_counts()), f"{label} plain run launched {read_counts()}"
            runs.append((sess, enc))
    (s_p, enc_p), (s_n, enc_n) = runs
    dist, floor = enc_distance(enc_k, enc_p), enc_distance(enc_p, enc_n)
    log(f"session[{label}] against its plain version on the card: encoder max |diff| "
        f"{dist:.4g}, the plain arm's own move under 1e-6 of feature noise {floor:.4g} (bound "
        f"twice that); tokens exact={s_k.tokens == s_p.tokens}: kernels {s_k.tokens} plain "
        f"{s_p.tokens} (plain with moved features {s_n.tokens})")
    assert dist <= 2 * floor, (
        f"session[{label}] lies {dist:.4g} from its plain version, beyond twice the plain "
        f"arm's own noise floor {floor:.4g}")


def engine_audios():
    """Phases 3b and 3c's eight seeded synthetic utterances of 3-12 words."""
    rng = np.random.default_rng(31)
    synth = synth_module()
    return [synth.synth_utterance(list(rng.integers(0, 1120, size=w)), rng)
            for w in (3, 10, 6, 12, 8, 5, 9, 7)]


def full_width_engine(torch, dev, cfg, params, tok):
    """Phase 3b: the lockstep engine at full width, 8 streams of different
    lengths, joint kernel on, f32 and bf16 weights. Seven streams open at
    once, the eighth attaches after three steps; the shortest finalizes
    while the others still stream, so its flush runs inside a lockstep step
    beside steady rows. Every joint call is one launch of the persistent
    kernel of the weights' type, and no chain's kernel runs (profiler, over
    a window of its own: ``profile_engine_joint``).
    f32: each stream's tokens equal its own session's on the card
    (attention kernel off, joint kernel on, the engine's chunk profile).
    bf16: each stream's encoder output lies within twice the distance its
    session moves when its features move by 1e-6."""
    from trt_asr_tpu_torch.config import RuntimeConfig
    from trt_asr_tpu_torch.ops.kernels.joint_step import joint_step
    from trt_asr_tpu_torch.streaming import batch_engine
    from trt_asr_tpu_torch.streaming.batch_engine import BatchStreamingEngine
    from trt_asr_tpu_torch.streaming.schedule import ChunkScheduler
    from trt_asr_tpu_torch.streaming.session import StreamingSession

    audios = engine_audios()
    b, piece = len(audios), 8000
    rt = RuntimeConfig(use_pallas_joint=True)
    for arm, wdt in (("f32", None), ("bf16", torch.bfloat16)):
        t_arm = time.perf_counter()
        model = make_model(torch, cfg, params, tok, rt, dev, False, wdt)
        eng = BatchStreamingEngine(model, batch_size=b, runtime=rt)
        log(f"engine[{arm}]: warm-up {eng.warmup():.2f} s")
        steps = []
        real_step = batch_engine._batch_step

        def spy(*args, **kwargs):
            valid, drop = args[2].tolist(), args[6].tolist()
            steps.append(sorted({d for d, v in zip(drop, valid) if v}))
            return real_step(*args, **kwargs)

        batch_engine._batch_step = spy
        reset_counts()
        try:
            with record_encoder("trt_asr_tpu_torch.streaming.batch_engine") as rows:
                sids = [eng.open_stream() for _ in range(b - 1)]
                offs = [0] * b
                shortest = int(np.argmin([len(a) for a in audios[:b - 1]]))
                n_step = 0
                while True:
                    if n_step == 3:
                        sids.append(eng.open_stream())          # attach under load
                    for k, sid in enumerate(sids):
                        if offs[k] < len(audios[k]):
                            eng.push_audio(sid, audios[k][offs[k]:offs[k] + piece])
                            offs[k] += piece
                            if offs[k] >= len(audios[k]) and k == shortest:
                                eng.finalize_stream(sid)        # flush beside steady rows
                    eng.step()
                    n_step += 1
                    if all(o >= len(a) for o, a in zip(offs, audios)) and len(sids) == b:
                        break
                for k, sid in enumerate(sids):
                    if k != shortest:
                        eng.finalize_stream(sid)
                eng.run_until_drained()
        finally:
            batch_engine._batch_step = real_step
        counts = read_counts()
        torch.cuda.synchronize()
        got = {k: list(eng._tokens[sid]) for k, sid in enumerate(sids)}
        per_stream = {k: [x for r, x in rows if r == sid] for k, sid in enumerate(sids)}
        lat = np.asarray(eng.step_latencies_ms)
        mixed = sum(len(d) > 1 for d in steps)
        log(f"engine[{arm}]: B {b}, {len(lat)} lockstep steps ({mixed} with a flush row beside "
            f"steady rows), step ms median {float(np.median(lat)):.3f} p90 "
            f"{float(np.percentile(lat, 90)):.3f} (host clock), joint_step launches "
            f"{counts['joint_step']} ({counts['joint_step'] / len(lat):.2f}/step), launches "
            f"{launched(counts)}, tokens per stream {[len(v) for v in got.values()]}")
        assert mixed > 0, f"engine[{arm}]: no flush ran inside a lockstep step"
        assert set(launched(counts)) == {"joint_step"}, f"engine[{arm}] launched {counts}"
        srt = RuntimeConfig(use_pallas_joint=True)
        for k, a in enumerate(audios):
            sess = StreamingSession(model, srt)
            sess._sched = ChunkScheduler(cfg, unified=True)      # the engine's chunk profile
            with record_encoder("trt_asr_tpu_torch.streaming.session") as enc_s:
                for i in range(0, len(a), piece):
                    sess.push_audio(a[i:i + piece])
                sess.finalize()
            if arm == "f32":
                assert got[k] == sess.tokens, (
                    f"engine[f32] stream {k}: {got[k]} differs from its session's {sess.tokens}")
                continue
            feats = stream_features(torch, model, a)
            nudge = np.random.default_rng(k).standard_normal(feats.shape).astype(np.float32)
            moved = StreamingSession(model, srt)
            moved._sched = ChunkScheduler(cfg, unified=True)
            with record_encoder("trt_asr_tpu_torch.streaming.session") as enc_n:
                moved.push_features(feats + 1e-6 * nudge)
                moved.finalize()
            eng_rows = [(0, x) for x in per_stream[k] if x.numel()]
            dist = enc_distance(eng_rows, [(0, x) for _, x in enc_s if x.numel()])
            floor = enc_distance([(0, x) for _, x in enc_s if x.numel()],
                                 [(0, x) for _, x in enc_n if x.numel()])
            log(f"engine[bf16] stream {k}: encoder max |diff| from its session {dist:.4g}, the "
                f"session's own move under 1e-6 of feature noise {floor:.4g}; tokens "
                f"exact={got[k] == sess.tokens}: engine {got[k]} session {sess.tokens}")
            assert dist <= 2 * floor, f"engine[bf16] stream {k} lies beyond twice the noise floor"
        if arm == "f32":
            log(f"engine[f32]: every stream token-exact with its own session "
                f"({sum(map(len, got.values()))} tokens)")
        profile_engine_joint(torch, model, rt, audios, piece, arm)
        log(f"engine[{arm}]: {time.perf_counter() - t_arm:.1f} s for the arm")
        del model, eng


def profile_engine_joint(torch, model, rt, audios, piece: int, arm: str) -> None:
    """Each joint call of the engine is one launch of the persistent kernel
    of the weights' type, and no kernel of a chain runs: torch.profiler over
    a window of a fresh engine (a stream an utterance, two lockstep steps,
    then each finalized and drained), kept apart from the timed run, whose
    host ms the profiler would inflate."""
    from torch.profiler import ProfilerActivity, profile

    from trt_asr_tpu_torch.streaming.batch_engine import BatchStreamingEngine

    eng = BatchStreamingEngine(model, batch_size=len(audios), runtime=rt)
    reset_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sids = [eng.open_stream() for _ in audios]
        for i in range(2):
            for sid, a in zip(sids, audios):
                eng.push_audio(sid, a[i * piece:(i + 1) * piece])
            eng.step()
        for sid in sids:
            eng.finalize_stream(sid)
        eng.run_until_drained()
        torch.cuda.synchronize()
    calls = read_counts()["joint_step"]
    kernels = {k: n for _, k, n in device_rows(torch, prof)}
    launched_as = lambda name: sum(n for k, n in kernels.items() if name in k)  # noqa: E731
    joint_kernel = PERSISTENT["joint_step"][arm]
    chain = {k: launched_as(k) for k in CHAIN_KERNELS}
    log(f"engine[{arm}] (profiled window): {calls} joint calls, {launched_as(joint_kernel)} "
        f"{joint_kernel} launches, the chains' launches {chain}")
    assert calls > 0 and launched_as(joint_kernel) == calls, (
        f"engine[{arm}]: a joint call is not one {joint_kernel} launch")
    assert not any(chain.values()), f"engine[{arm}]: a chain's kernel ran"


def direct_engine_stream(eng, audio, piece: int = 8000):
    """One stream alone through an engine driven directly: (tokens, words)."""
    sid = eng.open_stream()
    for i in range(0, len(audio), piece):
        eng.push_audio(sid, audio[i:i + piece])
    eng.finalize_stream(sid)
    eng.run_until_drained()
    out = (list(eng._tokens[sid]), eng.word_timestamps(sid))
    eng.close_stream(sid)
    return out


def served_client(serve, addr, audio, piece: int, out: dict, k: int) -> None:
    """A daemon client on a thread of its own: ``audio`` pushed in pieces
    without sleeping, then finalized; ``out[k]`` = (final event, wall s from
    the first push to the final) or the exception (an error event raises)."""
    final = []
    try:
        cli = serve._Client(*addr, 300.0, {"op": "open"},
                            lambda r: final.append(r) if r.get("event") == "final" else None)
        try:
            t0 = time.perf_counter()
            cli.push_all(audio, piece)
            cli.request({"op": "finalize"})
            while not final:
                cli.recv_routed()
            out[k] = (final[0], time.perf_counter() - t0)
        finally:
            cli.close()
    except Exception as e:  # noqa: BLE001 — reported and failed by the phase
        out[k] = e


def wait_idle(srv, quiet_s: float = 0.3, timeout_s: float = 30.0) -> None:
    """Return once the daemon's engine has nothing pending and has taken no
    step for ``quiet_s``."""
    t_end = time.perf_counter() + timeout_s
    n, since = -1, time.perf_counter()
    while time.perf_counter() < t_end:
        m = len(srv.engine.step_latencies_ms)
        if m != n or srv.engine.pending():
            n, since = m, time.perf_counter()
        elif time.perf_counter() - since >= quiet_s:
            return
        time.sleep(0.02)
    raise AssertionError("daemon: the engine did not go idle")


def full_width_daemon(torch, dev, cfg, params, tok):
    """Phase 3c: the port's daemon (``serve.AsrServer``, B = 8) at full
    width over 127.0.0.1, f32 weights, joint kernel on. Eight client
    threads push phase 3b's utterances as base64 f32le PCM in 0.5 s pieces
    without sleeping, then finalize: each final's tokens and words equal the
    engine driven directly on that audio alone. Then one continuous client
    pushes two utterances 1.0 s of zeros apart and gets exactly two segment
    events, each token-exact with a direct engine stream fed its samples
    [start_s, end_s], under torch.profiler: each joint call one launch of
    the persistent f32 kernel, no chain kernel. Logs the host ms of a
    served step (median, p90), each client's wall seconds and the joint
    launches a step. Any error event, or a ``step error``, fails it."""
    import io
    import threading
    from contextlib import redirect_stderr

    from torch.profiler import ProfilerActivity, profile

    from trt_asr_tpu_torch import serve
    from trt_asr_tpu_torch.config import RuntimeConfig
    from trt_asr_tpu_torch.streaming.batch_engine import BatchStreamingEngine

    audios = engine_audios()
    rt = RuntimeConfig(use_pallas_joint=True)
    model = make_model(torch, cfg, params, tok, rt, dev, False)
    srv = serve.AsrServer(model, batch_size=len(audios), port=0, runtime=rt)
    err = io.StringIO()
    try:
        with redirect_stderr(err):
            srv.start()
            reset_counts()
            lat0 = len(srv.engine.step_latencies_ms)
            out, t0 = {}, time.perf_counter()
            threads = [threading.Thread(target=served_client,
                                        args=(serve, srv.addr, a, 8000, out, k))
                       for k, a in enumerate(audios)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            wall = time.perf_counter() - t0
            counts = read_counts()
            lat = np.asarray(srv.engine.step_latencies_ms[lat0:])
            assert not any(t.is_alive() for t in threads), "daemon: a client did not finish"
            bad = {k: v for k, v in out.items() if isinstance(v, Exception)}
            assert not bad and len(out) == len(audios), f"daemon: clients failed {bad}"
            z = np.zeros(16000, np.float32)
            stream = np.concatenate([audios[1], z, audios[4]])
            reset_counts()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                segs = serve.transcribe_continuous(*srv.addr, stream, chunk_samples=8000,
                                                   timeout_s=300)
                cont_s = time.perf_counter() - t1
                # the stepper may still be stepping (the retired slot's
                # flush): the calls counted and the kernels traced must
                # cover the same steps, so both are read once it is idle
                wait_idle(srv)
                torch.cuda.synchronize()
                cont_counts = read_counts()
                win_s = time.perf_counter() - t1
    finally:
        srv.stop()
    log(err.getvalue().rstrip() or "daemon: nothing on stderr")
    assert "step error" not in err.getvalue(), "daemon: a step failed"
    log(f"daemon: B {len(audios)}, {len(audios)} clients in {wall:.2f} s, {len(lat)} served "
        f"steps, step ms median {float(np.median(lat)):.3f} p90 "
        f"{float(np.percentile(lat, 90)):.3f} (host clock), joint_step launches "
        f"{counts['joint_step']} ({counts['joint_step'] / len(lat):.2f}/step), launches "
        f"{launched(counts)}")
    log("daemon: client wall s from the first push to the final "
        f"{[round(out[k][1], 3) for k in range(len(audios))]}")
    assert set(launched(counts)) == {"joint_step"}, f"daemon launched {counts}"
    eng = BatchStreamingEngine(model, batch_size=len(audios), runtime=rt)
    for k, a in enumerate(audios):
        toks, words = direct_engine_stream(eng, a)
        final = out[k][0]
        assert final["tokens"] == toks and final["words"] == words, (
            f"daemon client {k}: {final['tokens']} differs from the engine's {toks}")
    log(f"daemon: every client token-exact with the engine driven directly "
        f"({sum(len(out[k][0]['tokens']) for k in out)} tokens)")
    assert len(segs) == 2, f"daemon continuous: {len(segs)} segments, expected 2"
    for seg in segs:
        a, b = int(round(seg["start_s"] * 16000)), int(round(seg["end_s"] * 16000))
        toks, _ = direct_engine_stream(eng, stream[a:b])
        log(f"daemon continuous: segment [{seg['start_s']:.2f} {seg['end_s']:.2f}] "
            f"{len(seg['tokens'])} tokens, direct {len(toks)}")
        assert seg["tokens"] == toks, "daemon continuous: a segment differs from the engine's"
    rows = device_rows(torch, prof)
    kernels = {k: n for _, k, n in rows}
    busy_ms = sum(us for us, _, _ in rows) / 1e3
    launched_as = lambda name: sum(n for k, n in kernels.items() if name in k)  # noqa: E731
    chain = {k: launched_as(k) for k in CHAIN_KERNELS}
    joint_kernel = PERSISTENT["joint_step"]["f32"]
    log(f"daemon continuous (profiled): {cont_s:.2f} s wall, device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / (win_s * 1e3):.1f}% of the {win_s:.2f} s window), "
        f"{cont_counts['joint_step']} joint calls, "
        f"{launched_as(joint_kernel)} {joint_kernel} launches, the chains' launches {chain}")
    assert cont_counts["joint_step"] > 0 and launched_as(joint_kernel) == cont_counts[
        "joint_step"], f"daemon: a joint call is not one {joint_kernel} launch"
    assert not any(chain.values()), "daemon: a chain's kernel ran"
    del model, srv, eng


# --- phase 3d: beam search at full width ------------------------------------


def same_nbest(label, got, want, tol: float = 2e-3) -> None:
    """Two n-best lists of Hypothesis objects: tokens, ranking and stamps'
    frames and durations exact, scores within ``tol`` (the f32 search adds
    in another order than the host's f64 sums)."""
    assert [h.tokens for h in got] == [h.tokens for h in want], (
        f"{label}: n-best tokens differ: {[h.tokens for h in got]} against "
        f"{[h.tokens for h in want]}")
    for a, b in zip(got, want):
        assert abs(a.score - b.score) <= tol, f"{label}: score {a.score} against {b.score}"
        assert [x[:2] for x in a.stamps] == [x[:2] for x in b.stamps], f"{label}: stamps differ"


def beam_session_run(model, audio, piece: int, unified: bool = False, **kw):
    """One utterance through a BeamStreamingSession; returns the session
    (its ``_nbest_hyps`` ranked) and its events as (type, tokens, error)."""
    from trt_asr_tpu_torch.streaming.beam_session import BeamStreamingSession
    from trt_asr_tpu_torch.streaming.schedule import ChunkScheduler

    sess = BeamStreamingSession(model, **kw)
    if unified:
        sess._sched = ChunkScheduler(model.cfg, unified=True)   # the engine's chunk profile
    for i in range(0, len(audio), piece):
        sess.push_audio(audio[i:i + piece])
    sess.finalize()
    events = []
    while (ev := sess.poll_event()) is not None:
        events.append((int(ev.type), list(ev.tokens), ev.error_message))
    return sess, events


def steady_ms(lat) -> tuple:
    steady = np.asarray(lat[1:-1] if len(lat) > 2 else lat)
    return float(np.median(steady)), float(np.percentile(steady, 90))


def full_width_lm(transcripts, vocab: int, seed: int):
    """An order-3 n-gram LM fitted from 200 seeded random token sentences
    and, three times each, the given transcripts' tokens (so that its deeper
    levels hit on the hypotheses the search builds and the fusion does not
    merely penalize every emission)."""
    from trt_asr_tpu_torch.decode.ngram_lm import NGramLM

    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, vocab, size=int(rng.integers(4, 16))).tolist() for _ in range(200)]
    return NGramLM.fit(seqs + [list(t) for t in transcripts] * 3, order=3, vocab_size=vocab)


def drive_engine_beam(eng, audios, piece: int):
    """Phase 3b's driving: all but the last stream open at once, the last
    attached after three steps, the shortest finalized while the others
    stream. Returns the sids and the step count."""
    sids = [eng.open_stream() for _ in range(len(audios) - 1)]
    offs = [0] * len(audios)
    shortest = int(np.argmin([len(a) for a in audios[:-1]]))
    n_step = 0
    while True:
        if n_step == 3:
            sids.append(eng.open_stream())
        for k, sid in enumerate(sids):
            if offs[k] < len(audios[k]):
                eng.push_audio(sid, audios[k][offs[k]:offs[k] + piece])
                offs[k] += piece
                if offs[k] >= len(audios[k]) and k == shortest:
                    eng.finalize_stream(sid)
        eng.step()
        n_step += 1
        if all(o >= len(a) for o, a in zip(offs, audios)) and len(sids) == len(audios):
            break
    for k, sid in enumerate(sids):
        if k != shortest:
            eng.finalize_stream(sid)
    eng.run_until_drained()
    return sids, n_step


def full_width_beam(torch, dev, cfg, params, tok, n_words: int, seed: int):
    """Phase 3d: beam search at full width (``ModelConfig()``, the phase-3
    weights with their blank bias, f32, TF32 off, kernels off as on every
    beam path), phase 3's utterance in 0.5 s pushes. The host and device
    beam sessions (beam 4) give the same n-best; device beam 1 equals the
    greedy session; the device beam with an n-gram LM (weight 0.6) and
    with a biasing LM equals the host beam with the same lm_fn;
    ``token_cap=8`` raises the saturation ERROR event once;
    ``transcribe_offline_beam`` equals the device beam over the same
    offline encoder rows; the engine (B = 8, beam 4) on phase 3b's
    utterances, one slot attached late and one finalized early, gives the
    late slot, the early one and the longest the n-best of a standalone
    device session, without and with the LM. Logs host ms a steady chunk
    (greedy, host beam, device beam), the device beam's device ms and busy
    share a chunk and its launches a chunk (a profiled window of its own)
    and the engine's beam step ms."""
    from trt_asr_tpu_torch.config import RuntimeConfig
    from trt_asr_tpu_torch.decode.beam import BeamSearchState, beam_finish
    from trt_asr_tpu_torch.decode.beam_device import (beam_device_to_hypotheses,
                                                      init_beam_device_state,
                                                      tdt_beam_chunk_device)
    from trt_asr_tpu_torch.decode.biasing import BiasingLM
    from trt_asr_tpu_torch.decode.tdt_greedy import init_decode_state, prime_decode_state
    from trt_asr_tpu_torch.models.parakeet.encoder import offline_encode
    from trt_asr_tpu_torch.streaming.batch_engine import BatchStreamingEngine

    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 is on"
    step_s, t0 = {}, time.perf_counter()
    rng = np.random.default_rng(seed)
    synth = synth_module()
    audio = synth.synth_utterance(list(rng.integers(0, 1120, size=n_words)), rng)
    piece = 8000
    rt = RuntimeConfig()
    model = make_model(torch, cfg, params, tok, rt, dev, False)
    run_session(torch, model, rt, audio[:16000], piece)              # warm-up
    reset_counts()
    greedy = run_session(torch, model, rt, audio, piece)
    g_ms = steady_ms(greedy.chunk_latencies_ms)
    out = {}
    for name, kw in (("host", dict(beam=4)), ("device", dict(beam=4, device=True)),
                     ("device1", dict(beam=1, device=True))):
        beam_session_run(model, audio[:16000], piece, **kw)         # warm-up
        torch.cuda.synchronize()
        out[name] = beam_session_run(model, audio, piece, **kw)
        torch.cuda.synchronize()
    counts = read_counts()
    assert not launched(counts), f"beam sessions launched kernels {counts}"
    (h_sess, _), (d_sess, _), (d1_sess, _) = out["host"], out["device"], out["device1"]
    h_ms, d_ms = steady_ms(h_sess.chunk_latencies_ms), steady_ms(d_sess.chunk_latencies_ms)
    log(f"beam: greedy f32_off {len(greedy.tokens)} tokens, host beam 1-best "
        f"{len(h_sess._nbest_hyps[0].tokens)} tokens, n-best "
        f"{[round(h.score, 4) for h in h_sess._nbest_hyps]}")
    same_nbest("beam host == device", d_sess._nbest_hyps, h_sess._nbest_hyps)
    log(f"beam: host beam == device beam (beam 4): {len(d_sess._nbest_hyps)} hypotheses, score "
        f"max |diff| {max(abs(a.score - b.score) for a, b in zip(d_sess._nbest_hyps, h_sess._nbest_hyps)):.3g}")
    assert d1_sess.tokens == greedy.tokens and greedy.tokens, (
        f"device beam 1 {d1_sess.tokens} differs from greedy {greedy.tokens}")
    log(f"beam: device beam 1 == greedy session ({len(greedy.tokens)} tokens)")
    step_s["sessions"], t0 = time.perf_counter() - t0, time.perf_counter()
    # fusion: an n-gram LM and a biasing LM, device against host
    lm = full_width_lm([greedy.tokens], cfg.vocab_size, seed + 5)
    # biasing phrases taken from the runner-up hypotheses' tokens, so that
    # the trie's levels hit on candidates the search weighs
    phrases = [tuple(h.tokens[i:i + 3]) for h in h_sess._nbest_hyps[1:] for i in (0, 4)
               if len(h.tokens) >= i + 3]
    cont = {}
    for p in phrases:
        for i in range(len(p)):
            cont.setdefault(p[:i], set()).add(p[i])
    bias = BiasingLM(cont, 2, 2.0, cfg.vocab_size)
    assert cont, "no biasing phrase"
    for label, lm_fn, w in (("ngram", lm, 0.6), ("bias", bias, 1.0)):
        dev_s, _ = beam_session_run(model, audio, piece, beam=4, device=True, lm_fn=lm_fn,
                                    lm_weight=w)
        host_s, _ = beam_session_run(model, audio, piece, beam=4, lm_fn=lm_fn, lm_weight=w)
        same_nbest(f"beam {label} host == device", dev_s._nbest_hyps, host_s._nbest_hyps)
        moved = [h.tokens for h in dev_s._nbest_hyps] != [h.tokens for h in d_sess._nbest_hyps]
        log(f"beam[{label}, weight {w}]: device == host, 1-best {len(dev_s.tokens)} tokens, the "
            f"n-best {'moved' if moved else 'unmoved'} by the fusion; device steady chunk "
            f"{steady_ms(dev_s.chunk_latencies_ms)} ms (median, p90)")
        step_s[label], t0 = time.perf_counter() - t0, time.perf_counter()
    # token_cap saturation: one ERROR event an utterance
    cap_s, cap_ev = beam_session_run(model, audio, piece, beam=4, device=True, token_cap=8)
    errors = [e for e in cap_ev if e[0] == 2]
    assert len(errors) == 1 and "token_cap=8 saturated" in errors[0][2], (
        f"token_cap=8: {len(errors)} error events {errors}")
    assert max(len(h.tokens) for h in cap_s._nbest_hyps) == 8
    log(f"beam: token_cap=8 raised the saturation ERROR once: {errors[0][2]!r}")
    step_s["token_cap"], t0 = time.perf_counter() - t0, time.perf_counter()
    # offline: the host beam of transcribe_offline_beam against the device
    # beam over the same offline encoder rows
    nb = model.transcribe_offline_beam(audio, beam=4, norm="none")
    feats = model.features(audio, norm="none")
    enc, enc_len = offline_encode(model.params, cfg, feats[None],
                                  torch.tensor([feats.shape[0]]), layers=model.layers)
    ds = prime_decode_state(model.params, cfg, init_decode_state(cfg, 1, device=dev),
                            model.prompt_ids)
    st = tdt_beam_chunk_device(model.params, cfg, enc[0], enc_len[0],
                               init_beam_device_state(cfg, ds, beam=4), beam=4,
                               max_symbols=cfg.max_symbols_per_timestep,
                               punct_mask=torch.as_tensor(model.punct_mask, device=dev),
                               use_punct_mask=rt.suppress_leading_punct)
    off_dev = beam_finish(BeamSearchState(active=beam_device_to_hypotheses(st)), beam=4)
    assert [n[1] for n in nb] == [h.tokens for h in off_dev], "offline beam != device beam"
    assert all(abs(n[2] - h.score) <= 2e-3 for n, h in zip(nb, off_dev))
    log(f"beam: transcribe_offline_beam == the device beam over its {int(enc_len[0])} encoder "
        f"rows ({len(nb[0][1])} tokens 1-best)")
    step_s["offline"], t0 = time.perf_counter() - t0, time.perf_counter()
    # the device beam in a profiled window of its own: device ms and
    # launches a chunk
    n = []
    rows = profile_run(torch, "beam device", "chunk", lambda: n.append(len(beam_session_run(
        model, audio[: len(audio) // 3], piece, beam=4, device=True)[0].chunk_latencies_ms))
        or n[0])
    kernels = sum(c for _, key, c in rows if "memcpy" not in key.lower()
                  and "memset" not in key.lower())
    prof = (sum(r[0] for r in rows) / 1e3 / n[0], kernels / n[0])
    step_s["profile"], t0 = time.perf_counter() - t0, time.perf_counter()
    log(f"beam device (profiled window): {prof[1]:.0f} kernel launches a chunk, "
        f"{prof[0]:.3f} device ms a chunk")
    # the engine: B = 8, beam 4, without and with the LM
    audios = engine_audios()
    lens = [len(a) for a in audios]
    # standalone references for the slot attached late, the one finalized
    # early (drive_engine_beam's shortest) and the longest
    checked = sorted({len(audios) - 1, int(np.argmin(lens[:-1])), int(np.argmax(lens))})
    step_ms, plain_best = {}, []
    for label in ("plain", "ngram"):
        # the LM is fitted on the plain run's 1-best transcripts
        kw = (dict(lm_fn=full_width_lm(plain_best, cfg.vocab_size, seed + 6), lm_weight=0.6)
              if label == "ngram" else {})
        eng = BatchStreamingEngine(model, batch_size=len(audios), runtime=rt, beam=4, **kw)
        log(f"engine beam[{label}]: warm-up {eng.warmup():.2f} s")
        sids, n_step = drive_engine_beam(eng, audios, piece)
        lat = eng.step_latencies_ms
        step_ms[label] = (float(np.median(lat)), float(np.percentile(lat, 90)))
        for k in checked:
            sess, _ = beam_session_run(model, audios[k], piece, unified=True, beam=4,
                                       device=True, **kw)
            same_nbest(f"engine beam[{label}] stream {k}", eng._nbest[sids[k]],
                       sess._nbest_hyps)
        plain_best = plain_best or [eng._nbest[sid][0].tokens for sid in sids]
        log(f"engine beam[{label}]: B {len(audios)}, {len(lat)} steps, beam step ms median "
            f"{step_ms[label][0]:.3f} p90 {step_ms[label][1]:.3f} (host clock); slots {checked}: "
            f"n-best == the standalone device session's "
            f"({[len(eng._nbest[s][0].tokens) for s in sids]} tokens 1-best)")
        del eng
        step_s[f"engine {label}"], t0 = time.perf_counter() - t0, time.perf_counter()
    assert not launched(read_counts()), "phase 3d launched a kernel"
    log(f"beam: host ms a steady chunk (median, p90): greedy f32_off {g_ms}, host beam {h_ms}, "
        f"device beam {d_ms}; device beam device ms a chunk {prof[0]:.3f}, launches a chunk "
        f"{prof[1]:.0f}; engine beam step ms {step_ms}")
    log(f"beam: seconds by step { {k: round(v, 1) for k, v in step_s.items()} }")
    del model


# --- phase 3e: the per-step route, the goldens and the debug surface ---------


def contract_config():
    """Phase 3e (a): the architecture the shipped contract fixes, which
    phase 3's full-width model is built from: it validates and equals
    ``ModelConfig()``."""
    from trt_asr_tpu_torch.config import ModelConfig
    from trt_asr_tpu_torch.contract import load_contract

    c = load_contract()
    cfg = ModelConfig.from_contract(c)
    assert c.validate() == [], c.validate()
    assert cfg == ModelConfig(), "ModelConfig.from_contract(load_contract()) != ModelConfig()"
    log(f"contract {c.model_id}: validate() == [], from_contract == ModelConfig() "
        f"(d {cfg.d_model}, {cfg.num_layers} layers, vocab {cfg.vocab_size})")
    return cfg


def per_step_route(torch, dev, cfg, params, tok, n_words: int, seed: int, batched) -> dict:
    """Phase 3e (b): phase 3's weights, blank bias and utterance in 0.5 s
    pushes with ``batched_decode=False`` and ``debug_tdt_steps`` on (JAX's
    per-step route, the same blank-run loop in the port, here with its
    trace): ``step_f32_off`` (kernels off), ``step_f32_on`` (attention,
    joint and log-mel kernels), ``step_int8_on`` (the int8 weights of
    ``int8_on``). Each equals phase 3's arm of the same weights in tokens
    and stamps, has as many non-blank trace records as tokens and launches
    its kernels; ``step_f32_on`` equals ``step_f32_off`` trace record for
    trace record. Logs host ms a steady chunk and joint launches a chunk
    beside phase 3's arm."""
    from trt_asr_tpu_torch.config import RuntimeConfig

    rng = np.random.default_rng(seed)
    audio = synth_module().synth_utterance(list(rng.integers(0, 1120, size=n_words)), rng)
    on = dict(use_pallas_att=True, use_pallas_joint=True)
    arms = {"f32_off": ({}, False), "f32_on": (on, True), "int8_on": (dict(on, quant="all"), True)}
    out = {}
    for name, (flags, mel_k) in arms.items():
        model = make_model(torch, cfg, params, tok, RuntimeConfig(**flags), dev, mel_k)
        rt = RuntimeConfig(**flags, batched_decode=False, debug_tdt_steps=True)
        run_session(torch, model, rt, audio[:16000], 8000)          # warm-up
        reset_counts()
        s = run_session(torch, model, rt, audio, 8000)
        counts = read_counts()
        if name != "f32_off":
            check_launches(f"per-step[step_{name}]", rt, counts, mel_k)
        else:
            assert not launched(counts), f"per-step[step_{name}] launched {counts}"
        b, n = batched[name], len(s.chunk_latencies_ms)
        assert s.tokens == b["tokens"], f"step_{name}: tokens differ from phase 3's {name}"
        assert s.token_timestamps() == b["stamps"], f"step_{name}: stamps differ"
        blank_free = sum(not r["is_blank"] for r in s.tdt_steps)
        assert blank_free == len(s.tokens) > 0, (
            f"step_{name}: {blank_free} non-blank records for {len(s.tokens)} tokens")
        ms = steady_ms(s.chunk_latencies_ms)
        log(f"per-step[step_{name}]: {n} chunks, {len(s.tokens)} tokens == phase 3's {name}, "
            f"stamps equal, {len(s.tdt_steps)} trace records ({blank_free} non-blank); host ms "
            f"a steady chunk (median, p90) step {ms[0]:.3f}, {ms[1]:.3f} / phase 3 "
            f"{b['median_ms']:.3f}, {b['p90_ms']:.3f}; joint launches a chunk step "
            f"{counts['joint_step'] / n:.2f} / phase 3 "
            f"{b['counts']['joint_step'] / b['n_chunks']:.2f}; launches {launched(counts)}")
        out[name] = s
        del model
    assert out["f32_on"].tdt_steps == out["f32_off"].tdt_steps, (
        "step_f32_on's trace differs from step_f32_off's")
    log(f"per-step: step_f32_on == step_f32_off, {len(out['f32_on'].tdt_steps)} trace records")
    return out


def golden_checks(torch, dev, tmp: str) -> dict:
    """Phase 3e (c): the committed goldens on the card through
    ``trt_asr_tpu_torch.parity`` (tiny, seed 1, f32, TF32 off): the
    encoder's closed loop over all 50 chunks with the kernels off (the
    contract's ``ort_f32`` rung: max abs <= 1e-4 on every chunk) and with
    ``--kernels`` (the attention, FFN and conv kernels, at least
    ``trt_fp32``), the functional mode with the kernels off (``ort_f32``),
    and the TDT trace at 300 frames, feats seed 0, IDENTICAL to
    ``artifacts/goldens/tdt_trace.jsonl`` (``python -m
    trt_asr_tpu_torch.parity --mode trace`` as a subprocess, its imports
    logged)."""
    from trt_asr_tpu_torch import parity
    from trt_asr_tpu_torch.contract import load_contract
    from trt_asr_tpu_torch.io.fixtures import read_jsonl

    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 is on"
    goldens = os.path.join(ROOT, "artifacts", "goldens")
    records = list(read_jsonl(os.path.join(goldens, "streaming_encoder_reference.jsonl")))[1:]
    tol = load_contract().tolerances
    out = {}
    for label, mode, kernels in (("closedloop", "closedloop", False),
                                 ("closedloop_kernels", "closedloop", True),
                                 ("functional", "functional", False)):
        model = parity.load_model(dev, config="tiny", seed=1, kernels=kernels)
        reset_counts()
        s = parity.encoder_parity(model, records, mode=mode, atol=tol.cpu_f32_atol,
                                  cache_atol=tol.cache_last_time_atol, kernels=kernels)
        counts = read_counts()
        dist = s["encoder_output_error_distribution"]
        log(f"golden[{label}]: {s['num_pass']}/{s['num_chunks']} chunks pass at "
            f"{s['atol']:g}, encoder max abs {dist['max']:.3e}, p95 {dist['p95']:.3e}; rungs "
            f"{ {k: v['pass'] for k, v in s['rung_verdicts'].items()} }, best "
            f"{s['best_rung']}; launches {launched(counts)}")
        assert s["num_chunks"] == 50, s["num_chunks"]
        if kernels:
            assert {"att_block", "ffn", "conv_block"} <= set(launched(counts)), counts
            assert s["best_rung"] in ("ort_f32", "trt_fp32"), f"golden[{label}]: {s['best_rung']}"
        else:
            assert not launched(counts), counts
            assert s["best_rung"] == "ort_f32" and s["pass_rate"] == 1.0, f"golden[{label}]"
        out[label] = dist
    trace = os.path.join(tmp, "port_trace.jsonl")
    errf = os.path.join(tmp, "parity_err.txt")
    with open(errf, "w") as ferr:
        res = subprocess.run([sys.executable, "-X", "importtime", "-m", "trt_asr_tpu_torch.parity",
                              "--mode", "trace", "--goldens",
                              os.path.join(goldens, "tdt_trace.jsonl"), "--config", "tiny",
                              "--seed", "1", "--frames", "300", "--feats-seed", "0",
                              "--out", trace],
                             cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                             stdout=subprocess.PIPE, stderr=ferr, text=True, timeout=300)
    with open(errf) as f:
        err = f.read()
    assert res.returncode == 0, f"parity --mode trace: exit {res.returncode}\n{res.stdout}\n{err[-2000:]}"
    check_no_jax_imported("parity", err, must="trt_asr_tpu_torch.debug.tdt_trace")
    assert res.stdout.startswith("traces IDENTICAL: 38 steps"), res.stdout
    log(f"golden[trace]: python -m trt_asr_tpu_torch.parity --mode trace on the card: "
        f"{res.stdout.splitlines()[0][:40]}")
    return out


def gate_r3_debug_surface(torch, dev, md: str, tmp: str) -> None:
    """Phase 3e (d): one gate_r3 utterance on the card with taps,
    snapshots, the halting NaN guard, stage markers, emitted-token lines
    and the decode trace on, and the joint and attention kernels: its tokens
    equal the same session's with every debug toggle off; its snapshot dirs
    and trace equal the port's CPU run (tokens exact, tensors within 1e-4,
    trace IDENTICAL, by ``debug.snapshot.compare_snapshot_dirs`` and
    ``debug.tdt_trace.compare_traces``); ``save_model_dir`` then
    ``from_model_dir`` gives the same tokens."""
    import io

    from trt_asr_tpu_torch.config import RuntimeConfig
    from trt_asr_tpu_torch.debug.snapshot import compare_snapshot_dirs
    from trt_asr_tpu_torch.debug.tdt_trace import compare_traces
    from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT

    rng = np.random.default_rng(23)
    words = list(rng.integers(0, 1120, size=6))
    audio = synth_module().synth_utterance(words, rng)
    kern = dict(use_pallas_joint=True, use_pallas_att=True)
    runs = {}
    for d in (dev, "cpu"):
        base = os.path.join(tmp, f"debug_{torch.device(d).type}")
        rt = RuntimeConfig(**kern, tap_enabled=True, tap_dir=os.path.join(base, "taps"),
                           snapshot_dir=os.path.join(base, "snaps"), nan_guard=True,
                           nan_guard_halt=True, stage_markers=True, debug_emit_tokens=True,
                           debug_tdt_steps=True, tdt_trace_path=os.path.join(base, "trace.jsonl"))
        model = ParakeetTDT.from_model_dir(md, runtime=RuntimeConfig(**kern), device=d)
        err = io.StringIO()
        reset_counts()
        with contextlib.redirect_stderr(err):
            sess = run_session(torch, model, rt, audio, 8000)
        counts = read_counts()
        lines = err.getvalue().splitlines()
        runs[str(d)] = (sess, base, counts, lines, model)
    (s_gpu, base_gpu, counts, lines, model), (s_cpu, base_cpu, _, _, _) = runs[str(dev)], runs["cpu"]
    assert {"att_block", "joint_step"} <= set(launched(counts)), counts
    reset_counts()
    plain = run_session(torch, model, RuntimeConfig(**kern), audio, 8000)
    assert s_gpu.tokens == plain.tokens == s_cpu.tokens and len(plain.tokens) == len(words), (
        f"gate_r3 debug: {s_gpu.tokens} / toggles off {plain.tokens} / CPU {s_cpu.tokens}")
    snaps = compare_snapshot_dirs(os.path.join(base_gpu, "snaps"), os.path.join(base_cpu, "snaps"),
                                  atol=1e-4)
    ok, verdict = compare_traces(os.path.join(base_cpu, "trace.jsonl"),
                                 os.path.join(base_gpu, "trace.jsonl"))
    (run_dir,) = os.listdir(os.path.join(base_gpu, "taps"))
    with open(os.path.join(base_gpu, "taps", run_dir, "audio.f32.json")) as f:
        tap = json.load(f)
    marks = [ln for ln in lines if ln.startswith("[stage +")]
    log(f"gate_r3 debug on the card: tokens {s_gpu.tokens} == toggles off == CPU; launches "
        f"{launched(counts)}; snapshots card vs CPU over {snaps['chunks']} chunks, max abs "
        f"{ {k: f'{v:.2e}' for k, v in snaps['max_abs'].items()} }; trace: {verdict[:40]}; "
        f"audio tap {tap['num_values']} samples; {len(marks)} stage marker lines, e.g. "
        f"{[m for m in marks if ' emitted ' in m][:1]}")
    assert snaps["pass"], f"gate_r3 debug: snapshots differ {snaps}"
    assert ok, verdict
    assert tap["num_values"] == len(audio) and any(" emitted " in m for m in marks)
    saved = os.path.join(tmp, "gate_r3_saved")
    model.save_model_dir(saved)
    again = ParakeetTDT.from_model_dir(saved, runtime=RuntimeConfig(**kern), device=dev)
    assert run_session(torch, again, RuntimeConfig(**kern), audio, 8000).tokens == plain.tokens
    log("gate_r3 debug: save_model_dir -> from_model_dir on the card gives the same tokens")


def cli_env_surface(torch, dev, md: str, tmp: str) -> None:
    """Phase 3e (e): ``python -m trt_asr_tpu_torch.cli`` on a gate_r3 wav as
    a subprocess with ``TRT_ASR_PROFILE_DIR``, ``TRT_ASR_DEBUG_TDT_STEPS``,
    ``TRT_ASR_TDT_TRACE_PATH``, ``TRT_ASR_TAP_ENABLE`` and
    ``TRT_ASR_TAP_DIR`` (attention and joint kernels from the environment
    too): its transcript equals the plain CLI's on the card (in this
    process), the trace and tap files parse, the profiler's Chrome trace
    holds CUDA kernel events of the joint-step kernel, and the subprocess
    imports nothing of JAX."""
    import io
    from contextlib import redirect_stdout

    from trt_asr_tpu_torch import cli
    from trt_asr_tpu_torch.debug.tdt_trace import load_trace
    from trt_asr_tpu_torch.io.wav import save_wav

    rng = np.random.default_rng(29)
    audio = synth_module().synth_utterance(list(rng.integers(0, 1120, size=5)), rng)
    wav = os.path.join(tmp, "cli_debug.wav")
    save_wav(wav, audio)
    flags = {"TRT_ASR_PALLAS_ATT": "1", "TRT_ASR_PALLAS_JOINT": "1"}
    base = [wav, "--model-dir", md, "--stream-sim", "0.5", "--no-sleep", "--feature-norm", "none"]
    buf = io.StringIO()
    with env_overrides(flags), redirect_stdout(buf):
        assert cli.main(base) == 0
    debug = {"TRT_ASR_PROFILE_DIR": os.path.join(tmp, "prof"), "TRT_ASR_DEBUG_TDT_STEPS": "1",
             "TRT_ASR_TDT_TRACE_PATH": os.path.join(tmp, "cli_trace.jsonl"),
             "TRT_ASR_TAP_ENABLE": "1", "TRT_ASR_TAP_DIR": os.path.join(tmp, "cli_taps")}
    errf = os.path.join(tmp, "cli_debug_err.txt")
    with open(errf, "w") as ferr:
        res = subprocess.run([sys.executable, "-X", "importtime", "-m", "trt_asr_tpu_torch.cli"]
                             + base, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT, **flags,
                                                        **debug),
                             stdout=subprocess.PIPE, stderr=ferr, text=True, timeout=300)
    with open(errf) as f:
        err = f.read()
    assert res.returncode == 0, f"cli (debug env): exit {res.returncode}\n{err[-3000:]}"
    check_no_jax_imported("cli (debug env)", err)
    transcript = lambda text: [ln for ln in text.splitlines()  # noqa: E731
                               if ln.startswith("Transcript: ")]
    got, want = transcript(res.stdout), transcript(buf.getvalue())
    assert got == want and len(got) == 1, f"cli (debug env): {got} against {want}"
    meta, steps = load_trace(debug["TRT_ASR_TDT_TRACE_PATH"])
    assert steps and meta["emitted"] == sum(not r["is_blank"] for r in steps), meta
    (tap_run,) = os.listdir(debug["TRT_ASR_TAP_DIR"])
    taps = {}
    for name in ("audio", "features"):
        with open(os.path.join(debug["TRT_ASR_TAP_DIR"], tap_run, name + ".f32.json")) as f:
            taps[name] = json.load(f)
        with open(os.path.join(debug["TRT_ASR_TAP_DIR"], tap_run, name + ".chunks.ndjson")) as f:
            assert all(json.loads(ln)["nan_inf_count"] == 0 for ln in f)
    assert taps["audio"]["num_values"] == len(audio), taps["audio"]
    (prof_run,) = os.listdir(debug["TRT_ASR_PROFILE_DIR"])
    with open(os.path.join(debug["TRT_ASR_PROFILE_DIR"], prof_run, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    joint = [e for e in kernels if "joint_step_f32_kernel" in e.get("name", "")]
    log(f"cli (debug env) on the card: {got[0]!r} == the plain CLI's; trace {len(steps)} "
        f"steps, {meta['emitted']} emitted; taps audio {taps['audio']['num_values']} samples, "
        f"features {taps['features']['frames']} frames; profiler trace {len(events)} events, "
        f"{len(kernels)} CUDA kernel events, {len(joint)} of joint_step_f32_kernel")
    assert joint, "the profiler's trace holds no joint-step kernel event"


def phase_3e(torch, dev, cfg, params, tok, n_words: int, seed: int, batched) -> dict:
    """Phase 3e, (b)-(e) (``contract_config`` is (a)); logs its seconds by
    part. Returns (b)'s arms."""
    md = os.path.join(ROOT, "artifacts", "models", "gate_r3")
    part_s, t0 = {}, time.perf_counter()
    steps = per_step_route(torch, dev, cfg, params, tok, n_words, seed, batched)
    part_s["b per-step"], t0 = time.perf_counter() - t0, time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        golden_checks(torch, dev, tmp)
        part_s["c goldens"], t0 = time.perf_counter() - t0, time.perf_counter()
        gate_r3_debug_surface(torch, dev, md, tmp)
        part_s["d gate_r3 debug"], t0 = time.perf_counter() - t0, time.perf_counter()
        cli_env_surface(torch, dev, md, tmp)
        part_s["e cli env"] = time.perf_counter() - t0
    log(f"phase 3e seconds by part: { {k: round(v, 1) for k, v in part_s.items()} }")
    return steps


# --- phase 3f: the ONNX import path at full width ------------------------------


def env_overrides(values: dict):
    """``values`` in ``os.environ`` for a block, restored after it (the
    port's ``config.env_overrides``)."""
    from trt_asr_tpu_torch.config import env_overrides as overrides

    return overrides(values)


def assert_same_tree(label: str, got, want, path: str = "") -> int:
    """Two numpy trees equal leaf for leaf, bit for bit (dtype, shape,
    values); returns the number of leaves."""
    if isinstance(want, dict):
        assert set(got) == set(want), f"{label}: keys differ at {path}"
        return sum(assert_same_tree(label, got[k], want[k], f"{path}/{k}") for k in want)
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), f"{label}: lengths differ at {path}"
        return sum(assert_same_tree(label, g, w, f"{path}/{i}")
                   for i, (g, w) in enumerate(zip(got, want)))
    assert got.dtype == want.dtype and got.shape == want.shape, f"{label}: {path}"
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), f"{label}: {path} differs"
    return 1


def suite_texts(rnd) -> list:
    """The transcripts of one round of a ``run_suite`` result."""
    return [u["transcript"] for u in rnd["utterances"]]


def import_path(torch, dev, cfg, params, tok, n_words: int, seed: int, f32_on_tokens) -> None:
    """Phase 3f: phase 3's weights (f32, the calibrated blank bias in the
    joint's out bias) exported with ``export_params_to_onnx`` (external data
    for large tensors), imported by ``python -m trt_asr_tpu_torch.import_onnx
    --verify`` as a subprocess on the card: its ``params.npz`` equals the
    source leaf for leaf, bit for bit. Then ``run_suite`` on the imported
    model dir over phase 3's utterance and three more like it, in 0.5 s
    pieces: the python surface with the attention and joint kernels, whose
    transcript of phase 3's utterance equals phase 3's ``f32_on`` arm on the
    same audio (read back from the wav the suite reads), and the batch
    surface (B = 4, joint kernel), equal to the python surface utterance by
    utterance. Logs the bytes written and the seconds of each step."""
    from trt_asr_tpu_torch.config import RuntimeConfig
    from trt_asr_tpu_torch.eval.manifest import ManifestEntry, write_manifest
    from trt_asr_tpu_torch.eval.suite import SuiteConfig, run_suite
    from trt_asr_tpu_torch.io.onnx_weights import export_params_to_onnx
    from trt_asr_tpu_torch.io.wav import load_wav, save_wav
    from trt_asr_tpu_torch.models.parakeet.params import load_checkpoint_numpy, params_to_numpy
    from trt_asr_tpu_torch.tokenizer import write_vocab

    synth = synth_module()
    rng = np.random.default_rng(seed)       # phase 3's utterance, as full_width_session draws it
    audios = [synth.synth_utterance(list(rng.integers(0, 1120, size=n_words)), rng)]
    rng = np.random.default_rng(seed + 1000)
    audios += [synth.synth_utterance(list(rng.integers(0, 1120, size=w)), rng) for w in (5, 8, 11)]
    on = {"TRT_ASR_PALLAS_ATT": "1", "TRT_ASR_PALLAS_JOINT": "1"}
    step_s = {}
    with tempfile.TemporaryDirectory() as tmp:
        exp, md = os.path.join(tmp, "export"), os.path.join(tmp, "model")
        free = shutil.disk_usage(tmp).free
        t0 = time.perf_counter()
        export_params_to_onnx(params, cfg, exp)
        write_vocab(os.path.join(exp, "vocab.txt"), tok.vocab)
        step_s["export"] = time.perf_counter() - t0
        sizes = {f: os.path.getsize(os.path.join(exp, f)) for f in sorted(os.listdir(exp))}
        log(f"import path: exported {sum(sizes.values())} B ({sizes}) in {step_s['export']:.1f} s "
            f"({free / 2**30:.1f} GiB free before)")
        t0 = time.perf_counter()
        errf = os.path.join(tmp, "import_err.txt")
        with open(errf, "w") as ferr:
            res = subprocess.run([sys.executable, "-X", "importtime", "-m",
                                  "trt_asr_tpu_torch.import_onnx", exp, "--out", md, "--verify"],
                                 cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                                 stdout=subprocess.PIPE, stderr=ferr, text=True, timeout=900)
        step_s["import"] = time.perf_counter() - t0
        with open(errf) as f:
            err = f.read()
        assert res.returncode == 0, f"import_onnx: exit {res.returncode}\n{err[-3000:]}"
        check_no_jax_imported("import_onnx", err, must="trt_asr_tpu_torch.io.onnx_weights")
        lines = res.stdout.splitlines()
        assert any(ln.startswith("imported ") for ln in lines), res.stdout
        verify = [ln for ln in lines if ln.startswith("verify: ")]
        assert len(verify) == 1 and " on cuda" in verify[0], res.stdout
        log(f"import path: import_onnx --verify on the card in {step_s['import']:.1f} s: {lines}")
        t0 = time.perf_counter()
        n = assert_same_tree("import path", load_checkpoint_numpy(md, verify=False),
                             params_to_numpy(params))
        md_bytes = sum(os.path.getsize(os.path.join(md, f)) for f in os.listdir(md))
        log(f"import path: the imported params.npz equals phase 3's weights, {n} leaves bit for "
            f"bit ({md_bytes} B in the model dir, compared in {time.perf_counter() - t0:.1f} s)")
        entries = []
        for k, a in enumerate(audios):
            path = os.path.join(tmp, f"utt{k}.wav")
            save_wav(path, a)
            entries.append(ManifestEntry(path, ""))
        man = os.path.join(tmp, "import.tsv")
        write_manifest(man, entries)
        # phase 3's f32_on arm on the audio the suite reads (16-bit wav)
        rt = RuntimeConfig(use_pallas_att=True, use_pallas_joint=True)
        model = make_model(torch, cfg, params, tok, rt, dev, mel_kernel=True)
        want = run_session(torch, model, rt, load_wav(entries[0].audio_path), 8000)
        del model
        log(f"import path: phase 3's f32_on arm on the wav's audio: {len(want.tokens)} tokens "
            f"(== its float audio's: {want.tokens == list(f32_on_tokens)})")
        t0 = time.perf_counter()
        common = dict(manifest_path=man, model_dir=md, stream_sim=0.5, feature_norm="none")
        with env_overrides(on):
            reset_counts()
            py = run_suite(SuiteConfig(out_dir=os.path.join(tmp, "py"), engine="python",
                                       **common))
            counts = read_counts()
        assert set(launched(counts)) == {"att_block", "joint_step"}, counts
        step_s["suite python"], t0 = time.perf_counter() - t0, time.perf_counter()
        with env_overrides({"TRT_ASR_PALLAS_JOINT": "1"}):
            reset_counts()
            bat = run_suite(SuiteConfig(out_dir=os.path.join(tmp, "batch"), engine="batch",
                                        batch_size=4, **common))
            b_counts = read_counts()
        assert set(launched(b_counts)) == {"joint_step"}, b_counts
        step_s["suite batch"] = time.perf_counter() - t0
    got, got_b = suite_texts(py["variants"]["base"][0]), suite_texts(bat["variants"]["base"][0])
    log(f"import path: suite python (launches {launched(counts)}) {got}; batch B 4 (launches "
        f"{launched(b_counts)}) {got_b}")
    assert got[0] == want.text, (
        f"import path: the suite's transcript {got[0]!r} differs from phase 3's f32_on arm's "
        f"{want.text!r}")
    assert got_b == got, "import path: the batch surface differs from the python surface"
    assert got[0], "import path: no transcript of phase 3's utterance"
    log(f"phase 3f seconds by step: { {k: round(v, 1) for k, v in step_s.items()} }")


@contextlib.contextmanager
def previous_int8_routes(torch):
    """The int8 routes the port took before the tensor-core products and
    the persistent joint step and conv module, for comparing their tokens:
    ``q8_matmul`` widening q to f32 at every call (the f32 product on the
    CUDA cores, TF32 off), the int8 joint step through the three launches
    of ``csrc/joint_step.cu``, the conv module through the five launches of
    ``csrc/conv_block.cu``."""
    from trt_asr_tpu_torch.models.parakeet import encoder
    from trt_asr_tpu_torch.ops import quant
    from trt_asr_tpu_torch.ops.kernels import conv_block as cb
    from trt_asr_tpu_torch.ops.kernels import joint_step as js

    saved = quant._q8_matmul_cuda, js._joint_step_q8, encoder.conv_block
    quant._q8_matmul_cuda = quant._q8_matmul_f32
    js._joint_step_q8 = lambda e, g, wp, bp, wo, bo, ths, ndur, blank_id, penalty, packed: (
        js.joint_step_chain(e, g, wp, bp, wo, bo, ths=ths, ndur=ndur, blank_id=blank_id,
                            blank_penalty=penalty))
    encoder.conv_block = lambda *args, packed=None: cb.conv_block_chain(*args)
    try:
        yield
    finally:
        quant._q8_matmul_cuda, js._joint_step_q8, encoder.conv_block = saved


def gate_r3_session(torch, dev):
    """gate_r3 on the card with the kernels on, each token-exact against the
    port's CPU plain path with the same runtime flags (on CPU tensors every
    kernel wrapper runs its plain version): the attention, joint and
    log-mel kernels in f32 and int8 (``quant="all"``); every kernel in f32
    and in int8 (conv + FFN2 + out-LN fused); int8 with the conv kernel and
    no FFN kernel (the conv module alone); with the bf16 weights of
    ``cast_params_for_compute`` the attention, joint and log-mel kernels,
    and every kernel; the fast arm's weights (bf16, then int8) over the
    session's f32 state and over a bf16 state (``fast_step``, as the JAX
    bench's fast arm runs). Then the lockstep engine
    (:func:`gate_r3_engine`)."""
    from trt_asr_tpu_torch.config import RuntimeConfig
    from trt_asr_tpu_torch.contract import FrontendSpec
    from trt_asr_tpu_torch.frontend.logmel import LogMelFrontend
    from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT
    from trt_asr_tpu_torch.ops.quant import q8_matmul

    md = os.path.join(ROOT, "artifacts", "models", "gate_r3")
    rng = np.random.default_rng(7)
    synth = synth_module()
    words = list(rng.integers(0, 1120, size=8))
    audio = synth.synth_utterance(words, rng)
    on = dict(use_pallas_att=True, use_pallas_joint=True)
    every = dict(on, use_pallas_ffn=True, use_pallas_conv=True)
    configs = {"f32": dict(on), "int8": dict(on, quant="all"), "f32_all": dict(every),
               "int8_all": dict(every, quant="all"),
               "int8_conv": dict(on, use_pallas_conv=True, quant="all"),
               # the bf16 weights of cast_params_for_compute; the fast arm's
               # weights over an f32 and over a bf16 encoder state
               "bf16": dict(on), "bf16_all": dict(every), "fast": dict(on, quant="all"),
               "fast_step": dict(on, quant="all")}
    for label, flags in configs.items():
        rt = RuntimeConfig(**flags)
        wdt = torch.bfloat16 if label.startswith(("bf16", "fast")) else None
        sdt = torch.bfloat16 if label == "fast_step" else None
        out = {}
        for d in (dev, "cpu"):
            model = ParakeetTDT.from_model_dir(md, runtime=rt, device=d, weights_dtype=wdt)
            model.frontend = LogMelFrontend(FrontendSpec(n_mels=model.cfg.feat_in),
                                            use_kernel=True, device=d)
            reset_counts()
            q8_matmul.widened = 0
            out[str(d)] = (run_session(torch, model, rt, audio, 8000, sdt), read_counts())
            assert q8_matmul.widened == 0, f"gate_r3[{label}] widened an int8 weight at a call"
        (s_gpu, counts), (s_cpu, cpu_counts) = out[str(dev)], out["cpu"]
        log(f"gate_r3[{label}] on the card (kernels on, launches {counts}): {s_gpu.text!r}")
        log(f"gate_r3[{label}] on the CPU (plain path):               {s_cpu.text!r}")
        check_launches(f"gate_r3[{label}]", rt, counts)
        assert not any(cpu_counts.values()), f"gate_r3[{label}] CPU run launched {cpu_counts}"
        assert s_gpu.tokens == s_cpu.tokens, (
            f"gate_r3[{label}] card tokens differ from the CPU plain path")
        assert len(s_gpu.tokens) == len(words), (
            f"gate_r3[{label}] emitted {len(s_gpu.tokens)} tokens for {len(words)} words")
    gate_r3_engine(torch, dev, md, synth)


def gate_r3_engine(torch, dev, md, synth):
    """gate_r3 in the lockstep engine at B = 4 (three streams, one attached
    after the first step), joint kernel on, f32 and bf16 weights: each
    stream's tokens on the card equal the engine's on the CPU (plain path)."""
    from trt_asr_tpu_torch.config import RuntimeConfig
    from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT
    from trt_asr_tpu_torch.streaming.batch_engine import BatchStreamingEngine

    rng = np.random.default_rng(17)
    words = [list(rng.integers(0, 1120, size=w)) for w in (5, 8, 3)]
    audios = [synth.synth_utterance(w, rng) for w in words]
    rt = RuntimeConfig(use_pallas_joint=True)
    for label, wdt in (("f32", None), ("bf16", torch.bfloat16)):
        out = {}
        for d in (dev, "cpu"):
            model = ParakeetTDT.from_model_dir(md, runtime=rt, device=d, weights_dtype=wdt)
            eng = BatchStreamingEngine(model, batch_size=4, runtime=rt)
            reset_counts()
            sids = [eng.open_stream(), eng.open_stream()]
            for k, sid in enumerate(sids):
                eng.push_audio(sid, audios[k][:8000])
            eng.step()
            sids.append(eng.open_stream())
            for k, sid in enumerate(sids):
                eng.push_audio(sid, audios[k][8000 if k < 2 else 0:])
                eng.finalize_stream(sid)
            eng.run_until_drained()
            out[str(d)] = ([list(eng._tokens[sid]) for sid in sids], read_counts())
        (gpu, counts), (cpu, cpu_counts) = out[str(dev)], out["cpu"]
        log(f"gate_r3 engine[{label}] B 4 on the card (launches {launched(counts)}): {gpu}; on "
            f"the CPU: {cpu}")
        assert launched(counts) and set(launched(counts)) == {"joint_step"}
        assert not launched(cpu_counts), f"gate_r3 engine[{label}] CPU run launched {cpu_counts}"
        assert gpu == cpu, f"gate_r3 engine[{label}] card tokens differ from the CPU path"
        assert [len(t) for t in gpu] == [len(w) for w in words], (
            f"gate_r3 engine[{label}] emitted {[len(t) for t in gpu]} tokens for "
            f"{[len(w) for w in words]} words")


def imported_modules(importtime_log: str) -> set:
    """Module names from ``python -X importtime`` output."""
    return {ln.rsplit("|", 1)[1].strip() for ln in importtime_log.splitlines()
            if ln.startswith("import time:") and ln.count("|") == 2}


def check_no_jax_imported(label: str, importtime_log: str,
                          must: str = "trt_asr_tpu_torch.streaming.session") -> None:
    """No module of JAX or of the JAX package in the log, which names
    ``must`` (so that it is the process's log)."""
    mods = imported_modules(importtime_log)
    bad = sorted(m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "trt_asr_tpu"))
    assert must in mods, f"{label}: no import log"
    assert not bad, f"{label} imported {bad}"


def entry_lines(text: str) -> list:
    """The CLI's lines that do not depend on the wall clock."""
    return [ln for ln in text.splitlines()
            if ln.startswith(("Final: ", "Transcript: ", "Word: ", "Segment: "))]


def gate_r3_entry_points(torch, dev, md, synth, tmp: str) -> None:
    """Phase 4, the user's entry points as subprocesses on the card:
    ``python -m trt_asr_tpu_torch.cli`` on a wav of two gate_r3 utterances
    1 s apart (``--stream-sim 0.5 --no-sleep --timestamps``, attention and
    joint kernels from the environment), then with ``--continuous``: their
    Final, Transcript, Word and Segment lines equal the port's CPU plain
    path in this process. ``python -m trt_asr_tpu_torch.serve`` (B = 4,
    joint kernel): two clients' tokens equal the CPU engine's. Each
    subprocess imports nothing of JAX (``-X importtime``), exits 0 (the
    daemon is terminated) and reports no error. ``--feature-norm none``:
    gate_r3 was trained without per_feature normalization."""
    import io
    import queue
    import threading
    from contextlib import redirect_stdout

    from trt_asr_tpu_torch import cli, serve
    from trt_asr_tpu_torch.config import RuntimeConfig
    from trt_asr_tpu_torch.io.wav import save_wav
    from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT
    from trt_asr_tpu_torch.streaming.batch_engine import BatchStreamingEngine

    rng = np.random.default_rng(41)
    words = [list(rng.integers(0, 1120, size=w)) for w in (6, 4)]
    utts = [synth.synth_utterance(w, rng) for w in words]
    wav = os.path.join(tmp, "gate_r3.wav")
    save_wav(wav, np.concatenate([utts[0], np.zeros(16000, np.float32), utts[1]]))
    flags = {"TRT_ASR_PALLAS_ATT": "1", "TRT_ASR_PALLAS_JOINT": "1"}
    env = dict(os.environ, PYTHONPATH=ROOT, **flags)
    base = [wav, "--model-dir", md, "--stream-sim", "0.5", "--no-sleep", "--timestamps",
            "--feature-norm", "none"]
    for extra in ([], ["--continuous"]):
        label = "cli" + (" --continuous" if extra else "")
        errf = os.path.join(tmp, "cli_err.txt")
        t0 = time.perf_counter()
        with open(errf, "w") as ferr:
            res = subprocess.run([sys.executable, "-X", "importtime", "-m",
                                  "trt_asr_tpu_torch.cli"] + base + extra,
                                 cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=ferr,
                                 text=True, timeout=300)
        wall = time.perf_counter() - t0
        with open(errf) as f:
            err = f.read()
        assert res.returncode == 0, f"{label}: exit {res.returncode}\n{err[-3000:]}"
        check_no_jax_imported(label, err)
        assert "Error: " not in res.stdout + err, f"{label}: an error event"
        buf = io.StringIO()
        with env_overrides(flags), redirect_stdout(buf):
            assert cli.main(base + extra + ["--device", "cpu"]) == 0
        got, want = entry_lines(res.stdout), entry_lines(buf.getvalue())
        lat = [ln for ln in err.splitlines() if ln.startswith("ChunkLatencyMs:")]
        log(f"gate_r3 {label} on the card ({wall:.1f} s, {lat[0] if lat else 'no latency line'}):"
            f" {[ln for ln in got if not ln.startswith('Word: ')]}")
        assert got == want, f"{label}: the card's lines differ from the CPU's: {want}"
        transcript = [ln for ln in got if ln.startswith("Transcript: ")]
        assert len(transcript) == 1 and len(transcript[0].split()) > 1, f"{label}: {got}"
        if extra:
            assert sum(ln.startswith("Segment: ") for ln in got) == 2, f"{label}: {got}"
    # the daemon as a subprocess
    rt = RuntimeConfig(use_pallas_joint=True)
    errf = os.path.join(tmp, "serve_err.txt")
    with open(errf, "w") as ferr:
        proc = subprocess.Popen([sys.executable, "-X", "importtime", "-m",
                                 "trt_asr_tpu_torch.serve", "--model-dir", md, "--port", "0",
                                 "--batch-size", "4"],
                                cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT,
                                                   TRT_ASR_PALLAS_JOINT="1"),
                                stdout=subprocess.PIPE, stderr=ferr, text=True)
        try:
            lines: queue.Queue = queue.Queue()
            threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                             daemon=True).start()
            t0, line = time.perf_counter(), ""
            while "listening on" not in line:
                line = lines.get(timeout=120)
            port = int(line.split("listening on ")[1].split()[0].rsplit(":", 1)[1])
            out = {}
            threads = [threading.Thread(target=served_client,
                                        args=(serve, ("127.0.0.1", port), u, 8000, out, k))
                       for k, u in enumerate(utts)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            wall = time.perf_counter() - t0
            assert not any(t.is_alive() for t in threads), "serve: a client did not finish"
            bad = {k: v for k, v in out.items() if isinstance(v, Exception)}
            assert not bad and len(out) == len(utts), f"serve: clients failed {bad}"
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
    with open(errf) as f:
        err = f.read()
    check_no_jax_imported("serve", err)
    assert "step error" not in err, f"serve: a step failed\n{err[-3000:]}"
    eng = BatchStreamingEngine(ParakeetTDT.from_model_dir(md, runtime=rt, device="cpu"),
                               batch_size=4, runtime=rt)
    want = [direct_engine_stream(eng, u)[0] for u in utts]
    got = [out[k][0]["tokens"] for k in range(len(utts))]
    log(f"gate_r3 serve subprocess on the card ({wall:.1f} s from start to the last final, "
        f"client s {[round(out[k][1], 2) for k in range(len(utts))]}): tokens {got}; CPU "
        f"engine {want}")
    assert got == want, "serve: the card's tokens differ from the CPU engine's"
    assert [len(t) for t in got] == [len(w) for w in words], "serve: one token a word expected"


def nbest_of(lines) -> list:
    """The CLI's ``NBest: <score> <text>`` lines as (score, text)."""
    return [(float(ln.split(" ", 2)[1]), ln.split(" ", 2)[2] if ln.count(" ") > 1 else "")
            for ln in lines if ln.startswith("NBest: ")]


def same_cli_nbest(label, got, want, tol: float = 2e-3) -> None:
    """NBest lines: texts and ranking exact, the printed scores within
    ``tol`` (the card's f32 sums round otherwise than the CPU's)."""
    assert [t for _, t in got] == [t for _, t in want] and got, (
        f"{label}: NBest texts differ: {got} against {want}")
    assert all(abs(a - b) <= tol for (a, _), (b, _) in zip(got, want)), (
        f"{label}: NBest scores differ: {got} against {want}")


def gate_r3_beam(torch, dev, md, synth, tmp: str) -> None:
    """Phase 4's beam part on gate_r3 (f32, kernels off as on every beam
    path): the host and device beam sessions (beam 4) on the card equal the
    port's CPU path, n-best token-exact. Then, all at once as subprocesses
    on the card, ``python -m trt_asr_tpu_torch.cli`` with ``--beam 4``,
    ``--beam 4 --beam-device``, ``--beam 4 --bias <three vocab words>``,
    ``--beam 4 --lm <an LM fitted here>`` and ``--beam 4 --continuous`` on a
    wav of two utterances 1 s apart (their Final, Transcript, Word and
    Segment lines equal the CPU's in this process; NBest texts exact,
    scores within 2e-3), and ``python -m trt_asr_tpu_torch.serve --beam 4
    --lm <file>`` (B = 4), whose three clients' final ``nbest`` equal the
    CPU engine's. Each subprocess imports nothing of JAX and reports no
    error."""
    import io
    import queue
    import threading
    from contextlib import redirect_stdout

    from trt_asr_tpu_torch import cli, serve
    from trt_asr_tpu_torch.config import RuntimeConfig
    from trt_asr_tpu_torch.decode.ngram_lm import NGramLM, fit_from_text
    from trt_asr_tpu_torch.io.wav import save_wav
    from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT
    from trt_asr_tpu_torch.streaming.batch_engine import BatchStreamingEngine

    rng = np.random.default_rng(43)
    words = [list(rng.integers(0, 1120, size=w)) for w in (6, 4, 5)]
    utts = [synth.synth_utterance(w, rng) for w in words]
    rt = RuntimeConfig()
    models = {str(d): ParakeetTDT.from_model_dir(md, runtime=rt, device=d) for d in (dev, "cpu")}
    vocab = models["cpu"].tokenizer.vocab
    text = lambda ws: " ".join(vocab[w].lstrip("▁") for w in ws)   # noqa: E731
    lm_path = os.path.join(tmp, "gate_r3_lm.json")
    lm_rng = np.random.default_rng(44)
    sentences = [text(ws) for ws in words] + [
        text(lm_rng.integers(0, 1120, size=6)) for _ in range(50)]
    fit_from_text(sentences, models["cpu"].tokenizer).save(lm_path)
    for kw in (dict(beam=4), dict(beam=4, device=True),
               dict(beam=4, device=True, lm_fn=NGramLM.load(lm_path), lm_weight=0.6)):
        got = {d: beam_session_run(m, utts[0], 8000, **kw)[0]._nbest_hyps
               for d, m in models.items()}
        same_nbest(f"gate_r3 beam {kw} card == CPU", got[str(dev)], got["cpu"])
        log(f"gate_r3 beam session {({k: v for k, v in kw.items() if k != 'lm_fn'})} on the card"
            f" == CPU: 1-best {got['cpu'][0].tokens}")
    wav = os.path.join(tmp, "gate_r3_beam.wav")
    save_wav(wav, np.concatenate([utts[0], np.zeros(16000, np.float32), utts[1]]))
    base = [wav, "--model-dir", md, "--stream-sim", "0.5", "--no-sleep", "--timestamps",
            "--feature-norm", "none"]
    variants = {"beam": ["--beam", "4"], "beam-device": ["--beam", "4", "--beam-device"],
                "bias": ["--beam", "4", "--bias", text(words[1][:3])],
                "lm": ["--beam", "4", "--lm", lm_path],
                "continuous": ["--beam", "4", "--continuous"]}
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs, t0 = {}, time.perf_counter()
    for name, extra in variants.items():
        out_f = open(os.path.join(tmp, f"cli_{name}.out"), "w")
        err_f = open(os.path.join(tmp, f"cli_{name}.err"), "w")
        procs[name] = (subprocess.Popen([sys.executable, "-X", "importtime", "-m",
                                         "trt_asr_tpu_torch.cli"] + base + extra,
                                        cwd=ROOT, env=env, stdout=out_f, stderr=err_f), out_f,
                       err_f)
    serr = open(os.path.join(tmp, "serve_beam.err"), "w")
    daemon = subprocess.Popen([sys.executable, "-X", "importtime", "-m", "trt_asr_tpu_torch.serve",
                               "--model-dir", md, "--port", "0", "--batch-size", "4",
                               "--beam", "4", "--lm", lm_path],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=serr, text=True)
    try:
        # the CPU references, in this process, while the card runs
        want = {}
        for name, extra in variants.items():
            buf = io.StringIO()
            with redirect_stdout(buf):
                assert cli.main(base + extra + ["--device", "cpu"]) == 0
            want[name] = buf.getvalue()
        cpu_eng = BatchStreamingEngine(models["cpu"], batch_size=4, runtime=rt, beam=4,
                                       lm_fn=NGramLM.load(lm_path), lm_weight=0.6)
        want_nbest = []
        for u in utts:
            sid = cpu_eng.open_stream()
            cpu_eng.push_audio(sid, u)
            cpu_eng.finalize_stream(sid)
            cpu_eng.run_until_drained()
            want_nbest.append(cpu_eng.nbest(sid))
            cpu_eng.close_stream(sid)
        lines: queue.Queue = queue.Queue()
        threading.Thread(target=lambda: [lines.put(ln) for ln in daemon.stdout],
                         daemon=True).start()
        line, deadline = "", time.monotonic() + 300
        while "listening on" not in line:
            assert daemon.poll() is None, f"serve --beam exited {daemon.returncode}"
            assert time.monotonic() < deadline, "serve --beam: no listening line"
            try:
                line = lines.get(timeout=1)
            except queue.Empty:
                pass
        port = int(line.split("listening on ")[1].split()[0].rsplit(":", 1)[1])
        served = {}
        threads = [threading.Thread(target=served_client,
                                    args=(serve, ("127.0.0.1", port), u, 8000, served, k))
                   for k, u in enumerate(utts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads), "serve --beam: a client did not finish"
        bad = {k: v for k, v in served.items() if isinstance(v, Exception)}
        assert not bad and len(served) == len(utts), f"serve --beam: clients failed {bad}"
        for name, (proc, out_f, err_f) in procs.items():
            assert proc.wait(timeout=600) == 0, f"cli {name}: exit {proc.returncode}"
    finally:
        for proc, out_f, err_f in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
            out_f.close()
            err_f.close()
        daemon.terminate()
        try:
            daemon.wait(timeout=30)
        except subprocess.TimeoutExpired:
            daemon.kill()
            daemon.wait(timeout=30)
        serr.close()
    wall = time.perf_counter() - t0
    for name in variants:
        with open(os.path.join(tmp, f"cli_{name}.out")) as f:
            got = f.read()
        with open(os.path.join(tmp, f"cli_{name}.err")) as f:
            err = f.read()
        check_no_jax_imported(f"cli {name}", err)
        assert "Error: " not in got + err, f"cli {name}: an error event"
        g_lines, w_lines = entry_lines(got), entry_lines(want[name])
        assert g_lines == w_lines, f"cli {name}: the card's lines differ from the CPU's: {w_lines}"
        if name == "continuous":
            assert sum(ln.startswith("Segment: ") for ln in g_lines) == 2, g_lines
        else:
            same_cli_nbest(f"cli {name}", nbest_of(got.splitlines()),
                           nbest_of(want[name].splitlines()))
        log(f"gate_r3 cli --beam [{name}] on the card == CPU: "
            f"{[ln for ln in g_lines if ln.startswith(('Transcript', 'Segment'))]}, "
            f"{len(nbest_of(got.splitlines()))} NBest lines")
    with open(os.path.join(tmp, "serve_beam.err")) as f:
        err = f.read()
    check_no_jax_imported("serve --beam", err)
    assert "step error" not in err, f"serve --beam: a step failed\n{err[-3000:]}"
    for k in range(len(utts)):
        got = served[k][0]["nbest"]
        want_k = want_nbest[k]
        assert [n["tokens"] for n in got] == [n[1] for n in want_k], (
            f"serve --beam client {k}: {got} against the CPU engine's {want_k}")
        assert all(abs(n["score"] - w[2]) <= 2e-3 for n, w in zip(got, want_k))
        assert served[k][0]["tokens"] == want_k[0][1]
    log(f"gate_r3 cli --beam (5 runs) and serve --beam 4 --lm on the card in {wall:.1f} s: "
        f"the daemon's three finals' n-best == the CPU engine's "
        f"({[len(served[k][0]['nbest']) for k in range(len(utts))]} hypotheses)")


# --- phase 4c: gate_r3's WER gate ----------------------------------------------

GATE_ARTIFACT = os.path.join(ROOT, "artifacts", "e2e_wer_gate_r3.json")
GATE_ENVS = {   # a row's kernel flags, and the kernels they launch in the suite's process
    "on": ({"TRT_ASR_PALLAS_ATT": "1", "TRT_ASR_PALLAS_JOINT": "1"}, {"att_block", "joint_step"}),
    "joint": ({"TRT_ASR_PALLAS_JOINT": "1"}, {"joint_step"}),
    # the JAX tool's native surface: int8 weights and the attention kernel
    "fast": ({"TRT_ASR_QUANT": "all", "TRT_ASR_PALLAS_ATT": "1"}, {"att_block"}),
    "f32_all": ({"TRT_ASR_PALLAS_ATT": "1", "TRT_ASR_PALLAS_JOINT": "1",
                 "TRT_ASR_PALLAS_FFN": "1", "TRT_ASR_PALLAS_CONV": "1"},
                {"att_block", "joint_step", "ffn", "conv_block"}),
    "int8_all": ({"TRT_ASR_QUANT": "all", "TRT_ASR_PALLAS_ATT": "1", "TRT_ASR_PALLAS_JOINT": "1",
                  "TRT_ASR_PALLAS_FFN": "1", "TRT_ASR_PALLAS_CONV": "1"},
                 {"att_block", "joint_step", "ffn", "conv_ffn_ln"}),
    "plain": ({}, set()),
}


def gate_r3_wer(torch, dev, md: str, tmp: str) -> None:
    """Phase 4c: gate_r3's held-out set (``make_words(1120)``, ``make_set(50,
    2, words, 8, 13)``: 502 reference words) through ``run_suite`` with
    ``feature_norm="none"``, as the JAX gate runs it. Each row's WER counts
    equal the committed artifact's (``artifacts/e2e_wer_gate_r3.json``):
    python with the attention and joint kernels at sim 0.5 (0 errors, no
    empty hypothesis) and under ``drop_time_carry`` (I = 436); the batch
    surface (B = 4, joint kernel) at sim 0.3 (0 errors) and under sabotage at
    0.5 (I = 436); the fast mode (int8, attention kernel) on the first 12
    utterances, the native rows (0 errors at 0.3, I = 104 under sabotage at
    0.5; 0 errors at 0.5 too). These four rows run through the gate runner
    (``gate_row``: ``eval.gate.main`` with ``--artifact``). Every streaming
    kernel in f32 and int8 (first 20 utterances): each hypothesis equals the port's CPU plain path with the same weights and
    env. The cli surface (2 utterances, fast env; its imports by
    ``PYTHONPROFILEIMPORTTIME``) equals the fast row; the beam (python,
    ``beam=4``, 4 utterances) equals the greedy row. Counts are reset before
    each in-process row and read after it. Logs the f32_on row's chunk ms
    (p50, p95) and RTFx, and each row's seconds."""
    from trt_asr_tpu_torch.eval import gate
    from trt_asr_tpu_torch.eval.manifest import read_manifest, write_manifest
    from trt_asr_tpu_torch.eval.suite import SuiteConfig, run_suite
    from trt_asr_tpu_torch.eval.synthetic import make_set, make_words

    with open(GATE_ARTIFACT) as f:
        art = json.load(f)
    clean, sab = art["clean"]["matrix"], art["sabotage_drop_time_carry"]["matrix"]
    words = make_words(1120)
    man = gate.write_eval_sets(tmp, words, make_set(50, 2, words, 8, 13), 0)["clean"]
    entries = read_manifest(man)
    subsets = {}

    def first(n: int) -> str:
        if n not in subsets:
            subsets[n] = os.path.join(tmp, f"eval_clean_{n}.tsv")
            write_manifest(subsets[n], entries[:n])
        return subsets[n]

    rows, row_s = {}, {}

    def row(name: str, env: str, n: int = 50, sabotage: bool = False, device: str = "",
            **kw) -> dict:
        flags, want = GATE_ENVS[env]
        flags = dict(flags, TRT_ASR_SABOTAGE="drop_time_carry" if sabotage else "")
        t0 = time.perf_counter()
        with env_overrides(flags):
            reset_counts()
            res = run_suite(SuiteConfig(manifest_path=first(n) if n < 50 else man,
                                        out_dir=os.path.join(tmp, name), model_dir=md,
                                        feature_norm="none", device=device, **kw))
            counts = read_counts()
        row_s[name] = time.perf_counter() - t0
        r = res["variants"]["base"][0]
        if device == "cpu" or kw["engine"] == "cli":     # the plain path; a subprocess
            want = set()
        assert set(launched(counts)) == want, (
            f"gate_r3 WER[{name}] launched {counts}, expected {sorted(want)}")
        w = r["wer"]
        log(f"gate_r3 WER[{name}] {w['wer'] * 100:.2f}% (S={w['substitutions']} "
            f"I={w['insertions']} D={w['deletions']} N={w['ref_words']} "
            f"empty={w['empty_hypotheses']}), launches {launched(counts)}, "
            f"{row_s[name]:.1f} s")
        rows[name] = r
        return r

    def gate_row(name: str, env: str, surface: str, sims: tuple, n: int = 50,
                 sabotage: bool = False) -> None:
        """A row through the gate runner (``eval.gate.main`` with
        ``--artifact``): its exit code (1 under sabotage, else 0), its
        artifact's gate row and, at every granularity but the first, 0
        errors (the push-granularity check); ``--sabotage`` restored after
        the run. The row is the suite's round at the first granularity."""
        flags, want = GATE_ENVS[env]
        out = os.path.join(tmp, name)
        argv = ["--model-dir", md, "--out-dir", out, "--eval-utts", str(n),
                "--noise-snr-db", "0", "--variants", "base", "--surfaces", surface,
                "--stream-sims", ",".join(str(x) for x in sims), "--batch-size", "4",
                "--artifact", os.path.join(out, "gate.json")]
        t0 = time.perf_counter()
        with env_overrides(dict(flags, TRT_ASR_SABOTAGE="")):
            reset_counts()
            rc = gate.main(argv + (["--sabotage", "drop_time_carry"] if sabotage else []))
            counts = read_counts()
            assert os.environ["TRT_ASR_SABOTAGE"] == "", f"{name}: --sabotage outlived the run"
        row_s[name] = time.perf_counter() - t0
        assert set(launched(counts)) == want, (
            f"gate_r3 WER[{name}] launched {counts}, expected {sorted(want)}")
        with open(os.path.join(out, "gate.json")) as f:
            written = json.load(f)
        matrix, per_surface = written["matrix"], written["gate_per_surface"]
        with open(os.path.join(out, f"suite_{surface}_clean_s{sims[0]}",
                               "suite_results.json")) as f:
            r = json.load(f)["variants"]["base"][0]
        assert sorted(matrix) == sorted(f"{surface}/clean/base/sim{x}" for x in sims), matrix
        assert matrix[f"{surface}/clean/base/sim{sims[0]}"] == r["wer"]
        assert all(matrix[f"{surface}/clean/base/sim{x}"]["wer"] == 0 for x in sims[1:]), matrix
        assert rc == int(sabotage) and per_surface[surface] == {
            "wer": r["wer"]["wer"], "variant": "base", "pass": not sabotage}, (rc, per_surface)
        w = r["wer"]
        log(f"gate_r3 WER[{name}] through the gate runner: exit {rc}, {w['wer'] * 100:.2f}% "
            f"(S={w['substitutions']} I={w['insertions']} D={w['deletions']} "
            f"N={w['ref_words']} empty={w['empty_hypotheses']}), matrix {sorted(matrix)}, "
            f"launches {launched(counts)}, {row_s[name]:.1f} s")
        rows[name] = r

    def same_counts(name: str, want: dict) -> None:
        got = rows[name]["wer"]
        assert got == want, f"gate_r3 WER[{name}]: {got} against the artifact's {want}"

    row("f32_on", "on", engine="python", stream_sim=0.5)
    same_counts("f32_on", clean["python/clean/base/sim0.5"])
    lat, rtfx = rows["f32_on"]["latency_ms"], rows["f32_on"]["rtfx"]
    log(f"gate_r3 WER[f32_on]: chunk ms p50 {lat['p50']:.3f} p95 {lat['p95']:.3f} mean "
        f"{lat['mean']:.3f}, RTFx {rtfx:.1f} (the suite's wall over 50 utterances)")
    row("sabotage", "on", sabotage=True, engine="python", stream_sim=0.5)
    same_counts("sabotage", sab["python/clean/base/sim0.5"])
    gate_row("batch", "joint", "batch", (0.3,))
    same_counts("batch", clean["batch/clean/base/sim0.3"])
    gate_row("batch_sabotage", "joint", "batch", (0.5,), sabotage=True)
    same_counts("batch_sabotage", sab["batch/clean/base/sim0.5"])
    gate_row("fast", "fast", "python", (0.3, 0.5), 12)
    same_counts("fast", clean["native/clean/base/sim0.3"])
    gate_row("fast_sabotage", "fast", "python", (0.5,), 12, sabotage=True)
    same_counts("fast_sabotage", sab["native/clean/base/sim0.5"])
    for env in ("f32_all", "int8_all"):
        row(env, env, 20, engine="python", stream_sim=0.5)
        row(f"{env}_cpu", env, 20, engine="python", stream_sim=0.5, device="cpu")
        got, want = suite_texts(rows[env]), suite_texts(rows[f"{env}_cpu"])
        diff = [k for k, (g, w) in enumerate(zip(got, want)) if g != w]
        assert not diff, f"gate_r3 WER[{env}]: utterances {diff} differ from the CPU plain path"
    # the cli surface: the CLI as a subprocess a utterance, its imports logged
    logs, real_run = [], subprocess.run

    def logged_run(cmd, **kw):
        out = real_run(cmd, **kw)
        logs.append(out.stderr)
        return out

    subprocess.run = logged_run
    try:
        with env_overrides({"PYTHONPROFILEIMPORTTIME": "1"}):
            row("cli", "fast", 2, engine="cli", stream_sim=0.3)
    finally:
        subprocess.run = real_run
    assert len(logs) == 2 and all(u["returncode"] == 0 for u in rows["cli"]["utterances"]), (
        [u.get("stderr_tail") for u in rows["cli"]["utterances"]])
    for k, err in enumerate(logs):
        check_no_jax_imported(f"suite cli {k}", err)
    assert suite_texts(rows["cli"]) == suite_texts(rows["fast"])[:2], (
        f"gate_r3 WER[cli]: {suite_texts(rows['cli'])} against the fast row's")
    row("beam4", "plain", 4, engine="python", stream_sim=0.5, beam=4)
    assert suite_texts(rows["beam4"]) == suite_texts(rows["f32_on"])[:4], (
        "gate_r3 WER[beam4]: transcripts differ from the greedy row's")
    assert rows["beam4"]["wer"]["wer"] == 0.0
    log(f"phase 4c seconds by row: { {k: round(v, 1) for k, v in row_s.items()} }")


# --- phases 4 (offline part) and 5: offline batches ---------------------------


def offline_audios(seed: int):
    """The full-width offline batch: synthetic utterances of OFFLINE_WORDS
    words, cut at OFFLINE_MAX_S seconds."""
    rng = np.random.default_rng(seed)
    synth = synth_module()
    return [synth.synth_utterance(list(rng.integers(0, 1120, size=w)), rng)
            [:int(OFFLINE_MAX_S * 16000)] for w in OFFLINE_WORDS]


def offline_shape(audios, pad_multiple: int = 128):
    """(encoder steps T, valid steps per row) of ``transcribe_batch``'s
    padded batch of these utterances."""
    from trt_asr_tpu_torch.contract import FrontendSpec
    from trt_asr_tpu_torch.ops.conv import subsampled_length

    fs = FrontendSpec()
    frames = [max((len(a) - fs.win_length) // fs.hop_length + 1, 0) for a in audios]
    t_pad = -(-max(frames) // pad_multiple) * pad_multiple
    return subsampled_length(t_pad, 3), [subsampled_length(f, 3) for f in frames]


def offline_run(torch, model, x, lens, dtype, flash: bool):
    """offline_encode + tdt_greedy_decode_batch(use_pallas_joint=True) over a
    padded batch, as the offline bench path runs them (mask_pad_subsample,
    the encoder output decoded in f32). Host-clock encoder and end-to-end
    ms, each span ending in a sync."""
    from trt_asr_tpu_torch.decode.batched import tdt_greedy_decode_batch
    from trt_asr_tpu_torch.decode.tdt_greedy import init_decode_state, prime_decode_state
    from trt_asr_tpu_torch.models.parakeet.encoder import offline_encode

    cfg, dev = model.cfg, model.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    dec = prime_decode_state(model.params, cfg, init_decode_state(cfg, len(lens), device=dev),
                             model.prompt_ids)
    valid = torch.as_tensor(lens, device=dev)
    sync()
    t0 = time.perf_counter()
    enc, enc_len = offline_encode(model.params, cfg, x, valid, compute_dtype=dtype,
                                  use_flash_att=flash, mask_pad_subsample=True,
                                  layers=model.layers)
    sync()
    t1 = time.perf_counter()
    toks, n, _ = tdt_greedy_decode_batch(
        model.params, cfg, enc.float(), enc_len, dec,
        max_tokens=cfg.max_symbols_per_timestep * enc.shape[1], use_pallas_joint=True)
    t2 = time.perf_counter()
    return dict(tokens=[toks[i, :int(n[i])].tolist() for i in range(len(lens))],
                enc=enc.float(), enc_len=enc_len.cpu(), enc_ms=(t1 - t0) * 1e3,
                e2e_ms=(t2 - t0) * 1e3)


@contextlib.contextmanager
def plain_offline_wrappers(swap: bool):
    """With ``swap``, the offline attention calls the rel-shift and flash
    wrappers' plain versions (the bf16 arm without its kernels)."""
    from trt_asr_tpu_torch.ops import attention
    from trt_asr_tpu_torch.ops.kernels.flash_att import flash_bias_attention_plain
    from trt_asr_tpu_torch.ops.kernels.rel_shift import rel_pos_bias_shifted_plain

    saved = attention.rel_pos_bias_shifted, attention.flash_bias_attention
    if swap:
        attention.rel_pos_bias_shifted = rel_pos_bias_shifted_plain
        attention.flash_bias_attention = flash_bias_attention_plain
    try:
        yield
    finally:
        attention.rel_pos_bias_shifted, attention.flash_bias_attention = saved


def launched(counts) -> dict:
    return {k: v for k, v in counts.items() if v}


def token_agreement(ta, tb):
    """(positions where two token lists per row agree, positions in all)."""
    same = sum(sum(p == q for p, q in zip(x, y)) for x, y in zip(ta, tb))
    return same, sum(max(len(x), len(y)) for x, y in zip(ta, tb))


def enc_diff(torch, ra, rb) -> float:
    """Max |encoder output difference| of two offline runs over valid steps."""
    ea, eb = ra["enc"].cpu(), rb["enc"].cpu()
    valid = torch.arange(ea.shape[1])[None, :] < ra["enc_len"][:, None]
    return float(((ea - eb).abs() * valid[..., None]).max())


def cast_weights(torch, model):
    """``model`` with the bf16 weights of ``cast_params_for_compute`` (the
    norm parameters stay f32), its per-layer views made anew."""
    from trt_asr_tpu_torch.models.parakeet import cast_params_for_compute
    from trt_asr_tpu_torch.models.parakeet.encoder import layer_params

    model.params = cast_params_for_compute(model.params, torch.bfloat16)
    model.layers = layer_params(model.params, model.cfg.num_layers)
    return model


def gate_r3_offline(torch, dev):
    """gate_r3 offline on 24- and 28-word utterances (T >= 128, so the
    shift kernel's auto gate opens on the card): ``transcribe_batch`` on the
    card equals the CPU path; offline_encode + decode in f32 with flash
    equals the CPU path token for token. In bf16 (shift and flash kernels
    on the card, their plain versions on the CPU), with f32 weights and
    with the bf16 weights of ``cast_params_for_compute``, the encoder
    output must lie within twice the CPU's own bf16 noise floor of the CPU
    path's: the same CPU run on features moved by 1e-6 (the size of the
    frontend's card/CPU gap). Both distances are single draws of one
    chaotic spread, so either may land above the other; a wrong result
    lies at the scale of the output itself."""
    from trt_asr_tpu_torch.config import RuntimeConfig
    from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT
    from trt_asr_tpu_torch.ops.conv import subsampled_length

    md = os.path.join(ROOT, "artifacts", "models", "gate_r3")
    rng = np.random.default_rng(9)
    synth = synth_module()
    audios = [synth.synth_utterance(list(rng.integers(0, 1120, size=w)), rng) for w in (24, 28)]
    gpu, cpu = (ParakeetTDT.from_model_dir(md, runtime=RuntimeConfig(), device=d)
                for d in (dev, "cpu"))
    got, want = gpu.transcribe_batch(audios), cpu.transcribe_batch(audios)
    log(f"gate_r3 offline transcribe_batch on the card: {[text for text, _ in got]}")
    assert got == want, "gate_r3 transcribe_batch on the card differs from the CPU path"
    n_layers = gpu.cfg.num_layers
    both = {"rel_shift": n_layers, "flash_att": n_layers}
    for label, dtype, expect in (("f32_flash", torch.float32, {"flash_att": n_layers}),
                                 ("bf16", torch.bfloat16, both), ("bf16w", torch.bfloat16, both)):
        if label == "bf16w":
            gpu, cpu = cast_weights(torch, gpu), cast_weights(torch, cpu)
        out = []
        for model in (gpu, cpu):
            x, lens = model.batch_features(audios)
            assert subsampled_length(int(lens.min()), 3) >= 128, "utterances too short"
            reset_counts()
            out.append((offline_run(torch, model, x, lens, dtype, True), read_counts()))
        (rg, cg), (rc, cc) = out
        same, total = token_agreement(rg["tokens"], rc["tokens"])
        card_diff = enc_diff(torch, rg, rc)
        log(f"gate_r3 offline[{label}] on the card, launches {launched(cg)}: "
            f"{[len(r) for r in rg['tokens']]} tokens; against the CPU path: tokens agree at "
            f"{same}/{total} positions, exact={rg['tokens'] == rc['tokens']}, encoder max "
            f"|diff| {card_diff:.4g}")
        assert launched(cg) == expect, f"gate_r3 offline[{label}] launched {cg}"
        assert not launched(cc), f"gate_r3 offline[{label}] CPU run launched {cc}"
        if dtype == torch.float32:
            assert rg["tokens"] == rc["tokens"], (
                f"gate_r3 offline[{label}] card tokens differ from the CPU path")
            continue
        x, lens = cpu.batch_features(audios)
        valid = torch.arange(x.shape[1])[None, :, None] < torch.as_tensor(lens)[:, None, None]
        nudge = torch.as_tensor(np.random.default_rng(1).standard_normal(x.shape),
                                dtype=x.dtype)
        moved = offline_run(torch, cpu, x + 1e-6 * nudge * valid, lens, torch.bfloat16, True)
        flips = float((x.to(torch.bfloat16) != (x + 1e-6 * nudge * valid).to(torch.bfloat16))
                      .float().mean())
        same, total = token_agreement(moved["tokens"], rc["tokens"])
        floor = enc_diff(torch, moved, rc)
        log(f"gate_r3 offline[{label}] CPU noise floor: features moved by 1e-6 "
            f"({100 * flips:.3f}% of their bf16 values change): tokens agree at {same}/{total} "
            f"positions, exact={moved['tokens'] == rc['tokens']}, encoder max |diff| "
            f"{floor:.4g} (largest |output| {float(rc['enc'].abs().max()):.4g})")
        assert card_diff <= 2 * floor, (
            f"gate_r3 offline[{label}] card encoder lies {card_diff:.4g} from the CPU path, "
            f"beyond twice the CPU's own bf16 noise floor {floor:.4g}")


def full_width_offline(torch, dev, cfg, params, tok, audios):
    """Phase 5: the full-width offline batch through its five arms; returns
    each arm's launch counts."""
    from trt_asr_tpu_torch.config import RuntimeConfig
    from trt_asr_tpu_torch.models.parakeet import cast_params_for_compute
    from trt_asr_tpu_torch.models.parakeet.encoder import offline_encode

    model = make_model(torch, cfg, params, tok, RuntimeConfig(), dev, mel_kernel=False)
    x, lens = model.batch_features(audios)
    n_words = sum(OFFLINE_WORDS)
    log(f"offline batch: {len(audios)} utterances of "
        f"{[round(len(a) / 16000, 2) for a in audios]} s, {n_words} words, features "
        f"{list(x.shape)} (lengths {lens.tolist()})")
    calibrate_blank_bias(
        model, n_words,
        lambda: sum(map(len, offline_run(torch, model, x, lens, torch.float32, False)["tokens"])),
        "the batch's utterances")
    n_layers = cfg.num_layers
    both = {"rel_shift": n_layers, "flash_att": n_layers}
    # the bf16 weights configuration of the JAX package's offline bench
    # (cast after the blank bias, as bench.py casts after its own)
    model_w = make_model(torch, cfg, cast_params_for_compute(model.params, torch.bfloat16), tok,
                         RuntimeConfig(), dev, mel_kernel=False)
    arms = {  # model, dtype, flash, plain wrappers, expected launches
        "off_f32": (model, torch.float32, False, False, {}),
        "off_f32_flash": (model, torch.float32, True, False, {"flash_att": n_layers}),
        "off_bf16_plain": (model, torch.bfloat16, True, True, {}),
        "off_bf16": (model, torch.bfloat16, True, False, both),
        "off_bf16w": (model_w, torch.bfloat16, True, False, both),
    }
    results, gemm_ms = {}, {}
    for name, (model, dtype, flash, plain, expect) in arms.items():
        with plain_offline_wrappers(plain):
            offline_run(torch, model, x, lens, dtype, flash)            # warm-up
            reset_counts()
            r = offline_run(torch, model, x, lens, dtype, flash)
            r["counts"] = read_counts()

            def forward():
                offline_encode(model.params, cfg, x, torch.as_tensor(lens, device=dev),
                               compute_dtype=dtype, use_flash_att=flash,
                               mask_pad_subsample=True, layers=model.layers)
                return 1
            gemm_ms[name] = f32_gemm_ms(
                profile_run(torch, f"offline[{name}] one forward", "forward", forward))
        results[name] = r
        log(f"offline[{name}]: encoder {r['enc_ms']:.1f} ms, end to end {r['e2e_ms']:.1f} ms "
            f"(host clock), {sum(map(len, r['tokens']))} tokens, launches {launched(r['counts'])}")
        assert launched(r["counts"]) == expect, f"offline[{name}] launched {r['counts']}"

    def compare(a, b):
        """(token-exact, encoder max |diff| over valid steps) of two arms."""
        ra, rb = results[a], results[b]
        same, total = token_agreement(ra["tokens"], rb["tokens"])
        diff = enc_diff(torch, ra, rb)
        log(f"offline[{a}] vs offline[{b}]: encoder max |diff| {diff:.4g} over valid steps, "
            f"tokens agree at {same}/{total} positions, exact={ra['tokens'] == rb['tokens']}")
        return ra["tokens"] == rb["tokens"], diff

    assert sum(map(len, results["off_f32"]["tokens"])) >= n_words, "too few f32 tokens"
    assert compare("off_f32_flash", "off_f32")[0], "off_f32_flash is not token-exact with off_f32"
    kernels_move = compare("off_bf16", "off_bf16_plain")[1]
    bf16_moves = compare("off_bf16_plain", "off_f32")[1]
    compare("off_bf16", "off_f32")
    compare("off_bf16w", "off_f32")
    compare("off_bf16w", "off_bf16")
    log(f"f32 SIMT products (cuBLAS ...f32f32... / sgemm) in one forward: "
        f"{ {k: round(v, 3) for k, v in gemm_ms.items()} } ms")
    assert bool(torch.isfinite(results["off_bf16w"]["enc"]).all()), "off_bf16w is not finite"
    assert sum(map(len, results["off_bf16w"]["tokens"])) > 0, "off_bf16w emitted no tokens"
    # bf16 weights take the products to the tensor cores: the f32 SIMT
    # products left are the positional projection's, off the layer weights
    assert gemm_ms["off_bf16w"] < 0.5 * gemm_ms["off_bf16"], (
        "off_bf16w still runs its products as f32 SIMT GEMMs")
    # the kernels may move the bf16 encoder by about as much as bf16 itself
    # moves it from f32 (two chaotic bf16 runs), not by a wrong result's size
    assert kernels_move <= 2 * bf16_moves, (
        f"off_bf16 lies {kernels_move:.4g} from off_bf16_plain, beyond twice bf16's own "
        f"distance from f32 ({bf16_moves:.4g})")

    model = arms["off_f32"][0]
    t0 = time.perf_counter()
    batch = model.transcribe_batch(audios)
    t1 = time.perf_counter()
    per_utt = [model.transcribe_offline(a) for a in audios]
    t2 = time.perf_counter()
    log(f"transcribe_batch (f32): {sum(len(ids) for _, ids in batch)} tokens in "
        f"{t1 - t0:.2f} s; per-utterance transcribe_offline {t2 - t1:.2f} s; equal: "
        f"{batch == per_utt}")
    assert batch == per_utt, "transcribe_batch differs from per-utterance transcribe_offline"
    return results


# --- phase 5b: training on the card -------------------------------------------

TRAIN_LR = 1e-4          # phase 5b's constant AdamW learning rate (full width)
TRAIN_STEPS = 3          # phase 5b's AdamW steps at full width, offline and streaming
GATE_LR = 3e-4           # and gate_r3's fine-tuning one


def lap(step_s: dict, name: str, t0: float) -> float:
    """Record and log the seconds since ``t0`` as phase 5b's step ``name``;
    return the time now."""
    now = time.perf_counter()
    step_s[name] = now - t0
    log(f"phase 5b step {name}: {now - t0:.1f} s")
    return now


def grads_of(torch, params, cfg, batch, **kw):
    """(mean NLL, gradients in ``optim.tree_leaves`` order) of one forward
    and backward of ``training_forward`` (no update)."""
    from trt_asr_tpu_torch.train import optim, training_forward

    live = [x.detach().requires_grad_(True) for x in optim.tree_leaves(params)]
    loss = training_forward(optim.tree_unflatten(params, live), cfg, batch, **kw).mean()
    return loss.detach(), list(torch.autograd.grad(loss, live))


def tree_max_diff(torch, a, b) -> float:
    from trt_asr_tpu_torch.train import optim

    return max(float((x.float().cpu() - y.float().cpu()).abs().max())
               for x, y in zip(optim.tree_leaves(a), optim.tree_leaves(b)))


def leaf_paths(tree, prefix: str = "") -> list:
    """Key paths of a parameter tree in ``optim.tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in leaf_paths(v, f"{prefix}/{i}")]
    return [prefix]


def check_leaf_grads(label, paths, g_card, g_cpu, rel_tol: float = 1e-4) -> float:
    """Step-0 gradients, card against CPU, leaf by leaf: each leaf's max
    |card - CPU| within ``rel_tol`` of its largest |g| on the CPU (the
    measure of the remat check). A wrong gradient on a few values of a leaf
    (a gather's backward on some token ids, one bias entry) shows here,
    before Adam rescales rounding noise into steps of about lr. Logs and
    returns the worst leaf's ratio."""
    worst, at = 0.0, ""
    for path, a, b in zip(paths, g_card, g_cpu):
        d = float((a.cpu() - b).abs().max())
        r = d / max(float(b.abs().max()), 1e-30)
        if r > worst:
            worst, at = r, path
    log(f"{label} step-0 gradients card against CPU: worst leaf max|dg| / max|g| {worst:.3g} "
        f"({at or 'all equal'}) over {len(paths)} leaves")
    assert worst <= rel_tol, f"{label}: the card's gradients differ from the CPU's at {at}"
    return worst


# gate_r3's parameters after 3 AdamW steps on the card against the CPU's:
# within PARAM_TOL, but for at most NOISE_SHARE of a leaf's values, which
# Adam moved on rounding noise. The positional weights on the low-frequency
# sinusoid columns, which add nearly the same score to every key (the
# softmax cancels it), get gradients down to 1e-6 of their leaf's largest
# (a CPU reading), whose rounding differs between the devices; Adam turns
# such differences into steps of up to about lr. A fault on a few values
# of a leaf is the step-0 gradient check's to find (``check_leaf_grads``).
PARAM_TOL, NOISE_SHARE = 1e-5, 0.1


def profile_step(torch, label, fn):
    """Kernel launches, device ms and busy share of ``fn()`` (one train
    step) in a profiled window of its own, device activity only."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(torch, prof)
    busy_ms = sum(us for us, _, _ in rows) / 1e3
    launches = sum(n for _, k, n in rows if not k.startswith(("Memcpy", "Memset")))
    log(f"train[{label}] profiled step: {launches} kernel launches, device {busy_ms:.1f} ms "
        f"of {wall_ms:.1f} ms wall ({100 * busy_ms / wall_ms:.1f}% busy); top: "
        f"{[(round(us / 1e3, 2), k[:40], n) for us, k, n in rows[:5]]}")
    return dict(launches=launches, device_ms=busy_ms, busy=busy_ms / wall_ms, wall_ms=wall_ms)


def full_width_train_batch(torch, cfg, seed: int):
    """Phase 5b's batch: 2 synthetic utterances (7 and 5 words, ~4 s and
    ~3 s), per-feature normalized log-mel (plain frontend, on the CPU),
    with 10 and 7 seeded token ids, as numpy arrays."""
    from trt_asr_tpu_torch.contract import FrontendSpec
    from trt_asr_tpu_torch.frontend.logmel import LogMelFrontend
    from trt_asr_tpu_torch.frontend.normalize import (apply_per_feature_norm,
                                                      compute_per_feature_stats)
    from trt_asr_tpu_torch.train.train_step import Batch

    rng = np.random.default_rng(seed + 50)
    synth = synth_module()
    fe = LogMelFrontend(FrontendSpec(n_mels=cfg.feat_in), device="cpu")
    feats, labels = [], []
    for n_words in (7, 5):
        f = fe(synth.synth_utterance(list(rng.integers(0, 1120, size=n_words)), rng))
        feats.append(apply_per_feature_norm(f, *compute_per_feature_stats(f)).numpy())
        labels.append(rng.integers(0, cfg.vocab_size, size=n_words + n_words // 2))
    t_max, u_max = max(len(f) for f in feats), max(len(lb) for lb in labels)
    x = np.zeros((2, t_max, cfg.feat_in), np.float32)
    y = np.zeros((2, u_max), np.int32)
    for k, (f, lb) in enumerate(zip(feats, labels)):
        x[k, :len(f)] = f
        y[k, :len(lb)] = lb
    return Batch(x, np.array([len(f) for f in feats], np.int32), y,
                 np.array([len(lb) for lb in labels], np.int32))


def full_width_training(torch, dev, cfg, params, seed: int, step_s: dict) -> dict:
    """Phase 5b (a): training at full width (``ModelConfig()``, phase 3's
    weights with the blank bias at its initial 0), f32, TF32 off, kernels
    off. The card's step-0 loss, gradient norm and each leaf's gradients
    against the port's CPU path (offline); remat against no remat on the
    card (offline and streaming: the same loss, each leaf's gradients
    within 1e-4 of its largest; streaming's peak memory lower, offline's
    logged); 3 AdamW steps at a constant lr (offline
    and streaming: finite, the 3rd loss under the 1st), their median step
    ms and peak memory, and a profiled step."""
    from trt_asr_tpu_torch.models.parakeet.params import params_to
    from trt_asr_tpu_torch.train import make_optimizer, make_train_step, optim

    t0 = time.perf_counter()
    params = optim.tree_map(lambda x: x.detach().clone(), params)
    params["joint"]["out"]["b"][cfg.blank_id] = 0.0            # phase 3's initial bias
    batch = full_width_train_batch(torch, cfg, seed)
    log(f"train batch: features {list(batch.feats.shape)}, lengths {batch.feat_len.tolist()}, "
        f"{batch.label_len.tolist()} labels; lr {TRAIN_LR} (constant, AdamW, clip 1.0)")
    out = {}

    # the card against the port's CPU path, offline
    loss_gpu, g_gpu = grads_of(torch, params, cfg, batch)
    norm_gpu = float(optim.global_norm(g_gpu))
    t1 = time.perf_counter()
    loss_cpu, g_cpu = grads_of(torch, params_to(params, "cpu"), cfg, batch)
    norm_cpu = float(optim.global_norm(g_cpu))
    step_s["card"] = t1 - t0
    t0 = lap(step_s, "cpu", t1)
    rel_l = abs(float(loss_gpu) - float(loss_cpu)) / abs(float(loss_cpu))
    rel_n = abs(norm_gpu - norm_cpu) / norm_cpu
    log(f"train[offline] step-0 loss card {float(loss_gpu):.6f} CPU {float(loss_cpu):.6f} "
        f"(rel {rel_l:.3g}); gradient norm card {norm_gpu:.6f} CPU {norm_cpu:.6f} "
        f"(rel {rel_n:.3g})")
    assert rel_l <= 1e-4, "the card's step-0 loss differs from the CPU's"
    assert rel_n <= 1e-3, "the card's gradient norm differs from the CPU's"
    out["grad_vs_cpu"] = check_leaf_grads("train[offline]", leaf_paths(params), g_gpu, g_cpu)
    del g_gpu, g_cpu

    for mode in ("offline", "streaming"):
        streaming = mode == "streaming"
        runs = {}
        for remat in (False, True):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            loss, g = grads_of(torch, params, cfg, batch, streaming=streaming, remat=remat)
            torch.cuda.synchronize()
            runs[remat] = (loss, g, torch.cuda.max_memory_allocated() - base)
        (l0, g0, m0), (l1, g1, m1) = runs[False], runs[True]
        worst = max(float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30)
                    for a, b in zip(g0, g1))
        log(f"train[{mode}] remat: loss {float(l1):.6f} against {float(l0):.6f} "
            f"(equal: {bool(l0 == l1)}), worst leaf max|dg| / max|g| {worst:.3g}; peak memory "
            f"above the weights {m1 / 2**30:.3f} GiB with remat, {m0 / 2**30:.3f} GiB without")
        assert bool(l0 == l1), f"train[{mode}]: remat changed the loss"
        assert worst <= 1e-4, f"train[{mode}]: remat changed the gradients"
        # offline the peak is the gradients' (T is 51 encoder steps), which
        # remat leaves as they are: logged; streaming keeps every chunk's
        # activations without it
        if streaming:
            assert m1 < m0, f"train[{mode}]: remat did not lower the peak memory"
        out[f"{mode}_peak_gib"] = (m0 / 2**30, m1 / 2**30)
        del runs, g0, g1
        t0 = lap(step_s, f"{mode} remat", t0)

        tx, _ = make_optimizer(TRAIN_LR, schedule="constant")
        init_opt, step = make_train_step(cfg, tx, streaming=streaming)
        p, o = params, init_opt(params)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        losses, ms = [], []
        for _ in range(TRAIN_STEPS):
            t1 = time.perf_counter()
            p, o, m = step(p, o, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            losses.append(float(m["loss"]))
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        prof = profile_step(torch, mode, lambda: step(p, o, batch))
        log(f"train[{mode}] {TRAIN_STEPS} steps: losses {[round(x, 4) for x in losses]}, step ms "
            f"{[round(x, 1) for x in ms]} (median {np.median(ms):.1f}), peak memory above the "
            f"weights {peak:.3f} GiB")
        assert all(np.isfinite(losses)), f"train[{mode}]: a loss is not finite"
        assert losses[-1] < losses[0], f"train[{mode}]: the last loss is not under the 1st"
        out[mode] = dict(losses=losses, step_ms=float(np.median(ms)), peak_gib=peak, **prof)
        del p, o, m
        t0 = lap(step_s, f"{mode} steps", t0)
    return out


def gate_r3_training(torch, dev, md, synth, tmp: str, step_s: dict) -> None:
    """Phase 5b (b): gate_r3 fine-tunes 3 steps, offline and streaming, on
    two of its synthetic utterances read back through a manifest by
    ``batches_from_manifest`` (labels from its tokenizer), with SpecAugment
    masks drawn once on the CPU: the step-0 gradients on the card, leaf by
    leaf, within 1e-4 of the leaf's largest on the CPU; each step's loss on
    the card within 1e-4 (relative) of the CPU path's, and every parameter
    after the 3rd step within 1e-5 but for at most a tenth of a leaf's
    values, which Adam moved on rounding noise (see ``PARAM_TOL``). Then
    ``save_train_state`` -> ``load_train_state`` -> 2 more steps equal 5
    straight within 1e-6, the 2 + 2 steps under
    ``torch.use_deterministic_algorithms`` (the backward of a gather adds
    with atomics on the card, and Adam turns a noise-level gradient's
    rounding into a step of about lr)."""
    from trt_asr_tpu_torch.eval.manifest import ManifestEntry, write_manifest
    from trt_asr_tpu_torch.io.wav import save_wav
    from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT
    from trt_asr_tpu_torch.models.parakeet.params import load_checkpoint
    from trt_asr_tpu_torch.train import make_optimizer, make_train_step, optim
    from trt_asr_tpu_torch.train.augment import apply_masks, draw_masks
    from trt_asr_tpu_torch.train.checkpoint import load_train_state, save_train_state
    from trt_asr_tpu_torch.train.data import batches_from_manifest

    t0 = time.perf_counter()
    model = ParakeetTDT.from_model_dir(md, device="cpu")
    cfg, tok = model.cfg, model.tokenizer
    rng = np.random.default_rng(23)
    words = [list(rng.integers(0, 1120, size=w)) for w in (6, 5)]
    entries = []
    for k, w in enumerate(words):
        path = os.path.join(tmp, f"train{k}.wav")
        save_wav(path, synth.synth_utterance(w, rng))
        entries.append(ManifestEntry(path, tok.decode(w)))
    man = os.path.join(tmp, "train.tsv")
    write_manifest(man, entries)
    batch = next(batches_from_manifest(man, model, batch_size=2, feature_norm="none"))
    got = sorted(tuple(batch.labels[k, :batch.label_len[k]].tolist()) for k in range(2))
    assert got == sorted(tuple(int(x) for x in w) for w in words), "labels lost their words"
    masks = draw_masks(torch.Generator().manual_seed(5), torch.as_tensor(batch.feat_len),
                       cfg.feat_in, freq_masks=2, freq_width=6, time_masks=4, time_width=0.05)
    feats = apply_masks(torch.as_tensor(batch.feats), torch.as_tensor(batch.feat_len), masks)
    batch = batch._replace(feats=feats.numpy())
    tx, _ = make_optimizer(GATE_LR, schedule="constant")
    for mode in ("offline", "streaming"):
        init_opt, step = make_train_step(cfg, tx, streaming=mode == "streaming")
        runs, g0 = {}, {}
        for d in (dev, "cpu"):
            p0 = load_checkpoint(md, device=d)
            g0[str(d)] = grads_of(torch, p0, cfg, batch, streaming=mode == "streaming")[1]
            p, o, losses = p0, init_opt(p0), []
            for _ in range(3):
                p, o, m = step(p, o, batch)
                losses.append(float(m["loss"]))
            runs[str(d)] = (p, o, losses, p0, init_opt)
        (pg, og, lg, p0g, _), (pc, _, lc, _, _) = runs[str(dev)], runs["cpu"]
        check_leaf_grads(f"gate_r3 train[{mode}]", leaf_paths(pc), g0[str(dev)], g0["cpu"])
        del g0
        rel = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
        diffs = [(x.cpu() - y).abs() for x, y in zip(optim.tree_leaves(pg), optim.tree_leaves(pc))]
        far = {path: int((d > PARAM_TOL).sum()) for path, d in zip(leaf_paths(pc), diffs)
               if bool((d > PARAM_TOL).any())}
        n_all = sum(d.numel() for d in diffs)
        worst = max(float(d.max()) for d in diffs)
        share = max(int((d > PARAM_TOL).sum()) / d.numel() for d in diffs)
        log(f"gate_r3 train[{mode}] losses card {[round(x, 5) for x in lg]} CPU "
            f"{[round(x, 5) for x in lc]} (worst rel {rel:.3g}); parameters after 3 steps max "
            f"|diff| {worst:.3g}, {sum(far.values())} of {n_all} values beyond {PARAM_TOL} "
            f"({far}; at most {100 * share:.2f}% of a leaf)")
        assert rel <= 1e-4, f"gate_r3 train[{mode}]: the card's losses differ from the CPU's"
        assert share <= NOISE_SHARE, (
            f"gate_r3 train[{mode}]: the card's parameters differ from the CPU's")
        if mode == "offline":
            ts = os.path.join(tmp, "train_state")
            save_train_state(ts, pg, og, step=3, meta={"model": "gate_r3"})
            pr, orr, at = load_train_state(ts, init_opt(p0g))
            assert at == 3
            pa, oa = pg, og
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                for _ in range(2):
                    pa, oa, ma = step(pa, oa, batch)
                    pr, orr, mr = step(pr, orr, batch)
            finally:
                torch.use_deterministic_algorithms(False)
            d_p = tree_max_diff(torch, pa, pr)
            d_o = tree_max_diff(torch, oa, orr)
            bitwise = d_p == 0.0 and d_o == 0.0 and float(ma["loss"]) == float(mr["loss"])
            log(f"gate_r3 resume: 3 steps + save + load + 2 steps against 5 straight: parameters "
                f"max |diff| {d_p:.3g}, optimizer state {d_o:.3g}, loss {float(mr['loss']):.6f} "
                f"against {float(ma['loss']):.6f}; bitwise: {bitwise}")
            assert d_p <= 1e-6 and d_o <= 1e-6, "gate_r3: the resumed run left the straight one"
        t0 = lap(step_s, f"gate_r3 {mode}", t0)


def toy_entry_point(tmp: str, step_s: dict) -> None:
    """Phase 5b (c): ``python -m trt_asr_tpu_torch.train.toy --steps 100``
    as a subprocess on the card: exit 0, no JAX imported, its last loss under
    half its first, at least 1 of its 4 utterances recovered."""
    t0 = time.perf_counter()
    errf = os.path.join(tmp, "toy_err.txt")
    with open(errf, "w") as ferr:
        res = subprocess.run([sys.executable, "-X", "importtime", "-m",
                              "trt_asr_tpu_torch.train.toy", "--steps", "100", "--out",
                              os.path.join(tmp, "toy_ckpt")],
                             cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                             stdout=subprocess.PIPE, stderr=ferr, text=True, timeout=300)
    with open(errf) as f:
        err = f.read()
    assert res.returncode == 0, f"toy: exit {res.returncode}\n{err[-3000:]}"
    check_no_jax_imported("toy", err, "trt_asr_tpu_torch.train.train_step")
    lines = res.stdout.splitlines()
    losses = [float(ln.split("loss")[1].split()[0]) for ln in lines if ln.startswith("step")]
    recovered = int(lines[-1].split()[1].split("/")[0])
    trained = next(ln for ln in lines if ln.startswith("trained"))
    log(f"toy on the card ({time.perf_counter() - t0:.1f} s): {lines[0]}; losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; {trained}; {lines[-1]}")
    assert lines[0] == "device: cuda", f"toy ran on {lines[0]}"
    assert losses[-1] < 0.5 * losses[0], "toy: the loss did not halve"
    assert recovered >= 1, "toy recovered no utterance"
    lap(step_s, "toy", t0)


def training_phase(torch, dev, cfg, params, seed: int) -> dict:
    """Phase 5b: (a) full width, (b) gate_r3, (c) the toy entry point; no
    kernel wrapper launches (training runs with the kernels off). Logs its
    seconds by step."""
    step_s = {}
    reset_counts()
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 is on"
    out = full_width_training(torch, dev, cfg, params, seed, step_s)
    md = os.path.join(ROOT, "artifacts", "models", "gate_r3")
    with tempfile.TemporaryDirectory() as tmp:
        gate_r3_training(torch, dev, md, synth_module(), tmp, step_s)
        toy_entry_point(tmp, step_s)
    assert not launched(read_counts()), "phase 5b launched a kernel"
    log(f"phase 5b seconds by step: { {k: round(v, 1) for k, v in step_s.items()} }")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--words", type=int, default=8,
                    help="words in phase 3's utterance (8: about 4 s); phase 3d's beam "
                         f"utterance has {BEAM_WORDS}")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "trt_asr_tpu_torch")):
        print("chip_smoke: trt_asr_tpu_torch package not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from trt_asr_tpu_torch.config import ModelConfig
    from trt_asr_tpu_torch.ops.kernels import build

    dev = torch.device("cuda")
    smi = smi_line()
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; nvidia-smi: {smi}")
    secs = build.build()
    log(f"kernel build: {secs:.1f} s ({', '.join(build.SOURCES)})")
    log_resources(torch, build, ModelConfig())

    timer = Timer(torch, dev)
    cfg = ModelConfig()
    phase_s = {"build": secs}
    t0 = time.perf_counter()
    rec = check_kernels(torch, dev, timer, cfg)
    rec.update(check_bf16_kernels(torch, dev, timer, cfg))
    audios = offline_audios(args.seed + 1)
    t_steps, sub_lens = offline_shape(audios)
    rec.update(check_offline_kernels(torch, dev, timer, cfg, t_steps, sub_lens[:-1] + [0]))
    check_bf16_matmul(torch, dev, timer, len(audios) * t_steps, cfg)
    phase_s["2 kernels"], t0 = time.perf_counter() - t0, time.perf_counter()
    sess, params, tok, bias = full_width_session(torch, dev, timer, args.words, args.seed)
    phase_s["3 session"], t0 = time.perf_counter() - t0, time.perf_counter()
    full_width_engine(torch, dev, cfg, params, tok)
    phase_s["3b engine"], t0 = time.perf_counter() - t0, time.perf_counter()
    full_width_daemon(torch, dev, cfg, params, tok)
    phase_s["3c daemon"], t0 = time.perf_counter() - t0, time.perf_counter()
    full_width_beam(torch, dev, cfg, params, tok, BEAM_WORDS, args.seed)
    phase_s["3d beam"], t0 = time.perf_counter() - t0, time.perf_counter()
    phase_3e(torch, dev, cfg, params, tok, args.words, args.seed, sess)
    phase_s["3e per-step, goldens, debug"], t0 = time.perf_counter() - t0, time.perf_counter()
    import_path(torch, dev, cfg, params, tok, args.words, args.seed, sess["f32_on"]["tokens"])
    phase_s["3f import"], t0 = time.perf_counter() - t0, time.perf_counter()
    md = os.path.join(ROOT, "artifacts", "models", "gate_r3")
    gate_r3_session(torch, dev)
    gate_r3_offline(torch, dev)
    with tempfile.TemporaryDirectory() as tmp:
        gate_r3_entry_points(torch, dev, md, synth_module(), tmp)
        phase_s["4 gate_r3"], t0 = time.perf_counter() - t0, time.perf_counter()
        gate_r3_beam(torch, dev, md, synth_module(), tmp)
        phase_s["4b gate_r3 beam"], t0 = time.perf_counter() - t0, time.perf_counter()
        gate_r3_wer(torch, dev, md, tmp)
        phase_s["4c gate_r3 WER"], t0 = time.perf_counter() - t0, time.perf_counter()
    params["joint"]["out"]["b"][cfg.blank_id] -= bias        # phase 5 searches its own
    sess.update(full_width_offline(torch, dev, cfg, params, tok, audios))
    phase_s["5 offline"], t0 = time.perf_counter() - t0, time.perf_counter()
    training_phase(torch, dev, cfg, params, args.seed)
    phase_s["5b training"] = time.perf_counter() - t0
    log(f"phase seconds: { {k: round(v, 1) for k, v in phase_s.items()} }")

    bad = [m for m in ("jax", "trt_asr_tpu") if m in sys.modules]
    assert not bad, f"imported {bad}"
    entry = [f"trt_asr_tpu_torch.{m}" for m in ("serve", "cli", "streaming.continuous",
                                                 "io.resample", "io.subtitles",
                                                 "streaming.beam_session", "decode.beam_device",
                                                 "decode.lm_device", "decode.biasing",
                                                 "train.train_step", "train.tdt_loss",
                                                 "train.optim", "train.augment",
                                                 "train.checkpoint", "train.data",
                                                 "eval.manifest", "contract", "io.fixtures",
                                                 "parity", "decode.host_decode",
                                                 "debug.tdt_trace", "debug.stage_markers",
                                                 "debug.nan_guard", "debug.snapshot",
                                                 "debug.taps", "debug.profiler",
                                                 "eval.wer", "eval.suite", "eval.synthetic",
                                                 "eval.gate", "io.onnx_lite", "io.onnx_graphs",
                                                 "io.onnx_weights")]
    assert all(m in sys.modules for m in entry), "the entry points' modules were not run"

    kernels = []
    for key, r in rec.items():
        arm, short = key.split("_")
        name, src, rep, arm_of = KERNEL_SRCS[short]
        kernels.append({"name": f"{name}[{arm}]", "route": "cuda", "source": src,
                        "replaces": rep,
                        "launches": sess[arm_of[arm]]["counts"][name],
                        "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
