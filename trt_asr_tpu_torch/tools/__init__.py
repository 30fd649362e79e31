"""The repo's verification tools through the port, one module per tool of
``tools/`` under the same file name, each runnable as ``python -m
trt_asr_tpu_torch.tools.<name>`` with that tool's flags, defaults, stdout
lines, artifact keys and exit codes:

- ``ngram_lm_fit``: fit a token n-gram LM for shallow fusion;
- ``gate_beam_eval``: gate_r3's held-out set through greedy and the beam;
- ``gate_lm_eval``: shallow fusion's WER sweep on a noisy copy of it;
- ``gate_continuous_eval``: the held-out set as one stream through the
  endpointer;
- ``fuzz_session``: random push plans and snapshot points over every
  streaming surface;
- ``soak_daemon``: the daemon under continuous clients over wall-clock time.

One difference: where they run. The JAX tools default to ``--platform
cpu``; these run on the CUDA device unless ``--device cpu`` (or
``--platform cpu``) asks for the CPU, and raise without a card otherwise
(:func:`tool_device`). Kernel flags come from the environment
(``TRT_ASR_PALLAS_*``, ``TRT_ASR_QUANT``), off by default, as in the JAX
package.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch


def add_device_args(ap: argparse.ArgumentParser) -> None:
    """``--device`` and the JAX tools' ``--platform``, which selects the same
    thing: ``cpu`` is the CPU, ``tpu`` the accelerator (here the card),
    ``env`` whatever ``JAX_PLATFORMS`` asks for (``runtime/platform.py``)."""
    ap.add_argument("--device", default="",
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--platform", default=None, choices=["cpu", "tpu", "env"],
                    help="the JAX tools' flag: cpu means --device cpu, tpu the card, "
                         "env JAX_PLATFORMS's request")


def tool_device(args: argparse.Namespace) -> torch.device:
    """The device a tool runs on; raises without a card unless the CPU was
    asked for."""
    from trt_asr_tpu_torch.device import resolve_device

    if args.device:
        return resolve_device(args.device)
    if args.platform == "cpu":
        return torch.device("cpu")
    if args.platform == "env":
        from trt_asr_tpu_torch.runtime.platform import requested_device

        return requested_device()
    return resolve_device(None)


def default_out_dir(name: str) -> str:
    """The JAX tools' ``/tmp/<name>``, under this process's temporary
    directory."""
    return os.path.join(tempfile.gettempdir(), name)

