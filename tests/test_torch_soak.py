"""The port's daemon soak (``trt_asr_tpu_torch/tools/soak_daemon.py``)
against the repo's JAX tool (``tools/soak_daemon.py``), each run in this
process for a few seconds with 2 continuous clients (the port's daemon in a
thread while JAX's runs): the same artifact
keys and sample fields (the port adds ``device_mb`` only on a CUDA device),
no stuck client, and every client of the port's daemon producing segments.
The RSS slope and step drift are not gated at this length (the 1 MB/min
rule is meant for minutes). The clients' wire messages and speech/silence
cycles are the JAX tool's, so the port's daemon reads the same protocol.
"""

import json
import os
import sys

import pytest

from torch_port_helpers import one_torch_thread  # noqa: F401

from trt_asr_tpu_torch.tools import soak_daemon

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.usefixtures("one_torch_thread")
FLAGS = ["--minutes", "0.06", "--clients", "2", "--batch-size", "3", "--sample-s", "1.2"]


@pytest.fixture(scope="module")
def soak_runs(tmp_path_factory):
    import importlib
    import threading

    root = tmp_path_factory.mktemp("soak")
    rc = {}
    port = threading.Thread(target=lambda: rc.update(port=soak_daemon.main(
        [*FLAGS, "--artifact", str(root / "port.json"), "--device", "cpu"])))
    port.start()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JAX_PLATFORMS", "cpu")
        mp.syspath_prepend(ROOT)
        jax_tool = importlib.import_module("tools.soak_daemon")
        mp.setattr(sys, "argv", ["tools/soak_daemon.py", *FLAGS, "--artifact",
                                 str(root / "jax.json"), "--platform", "cpu"])
        rc_jax = jax_tool.main()
    port.join(120)
    assert not port.is_alive()
    return (json.loads((root / "port.json").read_text()), rc["port"],
            json.loads((root / "jax.json").read_text()), rc_jax)


def test_soak_artifact_keys_match_jax(soak_runs):
    got, _, want, _ = soak_runs
    assert set(got) == set(want) == {"config", "samples", "verdict"}
    assert set(got["verdict"]) == set(want["verdict"])
    assert len(got["samples"]) >= 2 and len(want["samples"]) >= 2
    for g, w in zip(got["samples"], want["samples"]):
        assert set(g) == set(w)          # no device_mb on the CPU
        assert len(g["segments"]) == 2
    assert set(got["config"]) - set(want["config"]) == {"device"}


def test_soak_clients_served(soak_runs):
    got, _, want, _ = soak_runs
    for art in (got, want):
        v = art["verdict"]
        assert v["stuck_clients"] == []
        assert len(v["segments_per_client"]) == 2
    v = got["verdict"]
    assert all(s > 0 for s in v["segments_per_client"]), v
    last = got["samples"][-1]
    assert last["steps_total"] > 0 and last["step_p50_ms"] > 0 and last["threads"] > 1
    assert last["segments"] == v["segments_per_client"] or all(
        a <= b for a, b in zip(last["segments"], v["segments_per_client"]))


def test_soak_needs_rollover_headroom(capsys):
    with pytest.raises(SystemExit, match="needs --batch-size > clients"):
        soak_daemon.main(["--clients", "3", "--batch-size", "3", "--device", "cpu"])
