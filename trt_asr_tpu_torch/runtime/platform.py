"""The device an embedded caller asks for, where no argument can be passed
(the C-ABI bridge, ``runtime/capi_bridge.py``): the counterpart of the JAX
package's ``runtime/platform.py`` ``ensure_requested_platform``.

It is the card unless the caller's environment asks for the CPU. The
request is read from ``JAX_PLATFORMS``: it is the variable the native
runtime's callers already set to run the bridge off the chip
(``JAX_PLATFORMS=cpu``), so one setting selects the CPU in both packages.
Only its first entry is read, and only ``cpu`` changes anything; any other
value (``tpu``, ``cuda``, a plugin's name) means the card. Without a card and
without a request, :func:`requested_device` raises: unlike the JAX bridge,
nothing falls back to the CPU by itself, since that would hide the device.
"""

from __future__ import annotations

import os

import torch

from trt_asr_tpu_torch.device import resolve_device


def requested_device() -> torch.device:
    want = os.environ.get("JAX_PLATFORMS", "").split(",")[0].strip().lower()
    return resolve_device("cpu" if want == "cpu" else None)
