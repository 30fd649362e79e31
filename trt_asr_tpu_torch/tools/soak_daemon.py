"""Wall-clock soak of the serving daemon, as ``tools/soak_daemon.py``: N
continuous clients stream speech/silence cycles to the port's ``AsrServer``
over TCP for M minutes; the tool samples the process's RSS, thread count,
live slots, steps, step-latency p50 and segments a client over time, and
fails on drift (a leak) or client starvation:

    python -m trt_asr_tpu_torch.tools.soak_daemon --minutes 20 --clients 4 \\
        --artifact soak.json [--device cpu]

PASS = RSS slope of the second half < 1 MB/min, no stuck client, step p50
drift (last/first decile) < 2x, every client produced segments. On a CUDA
device each sample also records ``device_mb``
(``torch.cuda.memory_allocated``): a leak in device memory does not show in
RSS. The model is ``ParakeetTDT.random(ModelConfig.tiny(), seed=0)``; kernel
flags come from the environment.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import socket
import threading
import time

import numpy as np

from trt_asr_tpu_torch.tools import add_device_args, tool_device


def rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return 0.0


def n_threads() -> int:
    return len(os.listdir("/proc/self/task"))


def client_loop(addr, stop, stats, idx):
    """One continuous client: speech burst + silence, repeated; counts
    segment events."""
    conn = socket.create_connection(addr)
    f = conn.makefile("rw")

    def send(d):
        f.write(json.dumps(d) + "\n")
        f.flush()

    send({"op": "open", "continuous": True})
    f.readline()
    reader_done = threading.Event()

    def reader():
        while not reader_done.is_set():
            line = f.readline()
            if not line:
                break
            ev = json.loads(line)
            if ev.get("event") == "segment":
                stats["segments"][idx] += 1
                stats["last_segment_t"][idx] = time.monotonic()

    rt = threading.Thread(target=reader, daemon=True)
    rt.start()
    t = 0
    while not stop.is_set():
        # 1.2 s tone burst (speech) + 0.8 s silence, pushed in 100 ms slices
        tone = 0.3 * np.sin(2 * np.pi * (200 + 37 * idx + 13 * (t % 7))
                            * np.arange(19200) / 16000.0)
        burst = np.concatenate([tone, np.zeros(12800)]).astype(np.float32)
        for s in range(0, len(burst), 1600):
            if stop.is_set():
                break
            send({"op": "push",
                  "pcm": base64.b64encode(burst[s:s + 1600].tobytes()).decode()})
            time.sleep(0.02)   # ~5x real time: load without starving the host
        t += 1
    reader_done.set()
    conn.close()   # dropping the connection releases the slot


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m trt_asr_tpu_torch.tools.soak_daemon",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--minutes", type=float, default=20.0)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=6)
    ap.add_argument("--sample-s", type=float, default=30.0)
    ap.add_argument("--artifact", default="")
    add_device_args(ap)
    args = ap.parse_args(argv)
    device = tool_device(args)

    import torch

    from trt_asr_tpu_torch.config import ModelConfig
    from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT
    from trt_asr_tpu_torch.serve import AsrServer

    if args.clients >= args.batch_size:
        # a continuous rollover opens the next segment's slot while the
        # previous one finalizes, so every client transiently needs a second
        # slot: at clients == batch_size the soak measures a
        # misconfiguration, not the daemon
        raise SystemExit(f"--clients {args.clients} needs --batch-size > "
                         f"clients (rollover headroom); got "
                         f"{args.batch_size}")

    model = ParakeetTDT.random(ModelConfig.tiny(), seed=0, device=device)
    srv = AsrServer(model, batch_size=args.batch_size, port=0)
    srv.start(warmup=True)

    stop = threading.Event()
    stats = {"segments": [0] * args.clients,
             "last_segment_t": [time.monotonic()] * args.clients}
    threads = [threading.Thread(target=client_loop,
                                args=(srv.addr, stop, stats, i), daemon=True)
               for i in range(args.clients)]
    for th in threads:
        th.start()

    samples = []
    t_end = time.monotonic() + args.minutes * 60
    while time.monotonic() < t_end:
        time.sleep(args.sample_s)
        lat = srv.engine.step_latencies_ms
        recent = lat[-200:] if lat else [0.0]
        samples.append({
            "t_s": round(time.monotonic() - (t_end - args.minutes * 60), 1),
            "rss_mb": round(rss_mb(), 1),
            "threads": n_threads(),
            "live_slots": sum(srv.engine._active),
            "steps_total": len(lat),
            "step_p50_ms": round(float(np.percentile(recent, 50)), 2),
            "segments": list(stats["segments"]),
        })
        if device.type == "cuda":
            samples[-1]["device_mb"] = round(torch.cuda.memory_allocated(device) / 2 ** 20, 1)
        print(json.dumps(samples[-1]), flush=True)
    stop.set()
    time.sleep(1.5)
    srv.stop()

    if not samples:
        print(json.dumps({"pass": False,
                          "error": "no samples: --minutes shorter than "
                                   "--sample-s; lower --sample-s"}))
        return 1
    half = len(samples) // 2 or 1
    rss = [s["rss_mb"] for s in samples]
    dt_min = (samples[-1]["t_s"] - samples[half]["t_s"]) / 60 or 1
    rss_slope = (rss[-1] - rss[half]) / dt_min
    p50s = [s["step_p50_ms"] for s in samples if s["step_p50_ms"] > 0]
    n10 = max(len(p50s) // 10, 1)
    drift = (float(np.mean(p50s[-n10:])) / max(float(np.mean(p50s[:n10])), 1e-9)
             if p50s else 1.0)
    now = time.monotonic()
    stuck = [i for i, t in enumerate(stats["last_segment_t"]) if now - t > 120]
    verdict = {
        "rss_slope_mb_per_min_2nd_half": round(rss_slope, 3),
        "step_p50_drift_last_over_first_decile": round(drift, 3),
        "stuck_clients": stuck,
        "segments_per_client": stats["segments"],
        "pass": (rss_slope < 1.0 and drift < 2.0 and not stuck
                 and all(s > 0 for s in stats["segments"])),
    }
    print(json.dumps(verdict))
    if args.artifact:
        os.makedirs(os.path.dirname(args.artifact) or ".", exist_ok=True)
        with open(args.artifact, "w") as f:
            json.dump({"config": vars(args), "samples": samples,
                       "verdict": verdict}, f, indent=1)
    return 0 if verdict["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
