"""Where a GPU run's time goes: 2pc-N under ``torch.profiler``.

    python -m stateright_tpu_torch.profile_run [RM_COUNT] [TARGET]

Runs ``TwoPhaseSys(n).checker().spawn_gpu()`` once to warm up (kernel
build, allocator), then once under the profiler with CPU and CUDA
activities, and prints one JSON object: wall seconds, the summed device
time of all kernels, the device busy share (summed kernel time over wall;
kernels on one stream do not overlap), the number of device operations
(kernels and copies) in all and per engine step, and the top kernels and
host operators by time.  Needs a CUDA device.
"""

from __future__ import annotations

import json
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .models.two_phase_commit import TwoPhaseSys


def _run(n: int, target):
    b = TwoPhaseSys(n).checker()
    if target:
        b = b.target_states(target)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    c = b.spawn_gpu().join()
    torch.cuda.synchronize()
    return c, time.monotonic() - t0


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    n = int(args[0]) if args else 7
    target = int(args[1]) if len(args) > 1 else None
    if not torch.cuda.is_available():
        print("profile_run: no CUDA device available", file=sys.stderr)
        return 2
    _run(n, target)  # warm-up
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        c, wall = _run(n, target)
    events = prof.key_averages()
    kernels = sorted(
        (e for e in events if getattr(e, "self_device_time_total", 0) > 0),
        key=lambda e: -e.self_device_time_total,
    )
    device_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    host = sorted(events, key=lambda e: -e.self_cpu_time_total)[:12]
    print(json.dumps({
        "model": f"2pc-{n}", "target": target,
        "unique": c.unique_state_count(), "states": c.state_count(),
        "wall_sec": wall, "states_per_sec": c.state_count() / wall,
        "device_kernel_sec": device_us / 1e6,
        "device_busy_share": device_us / 1e6 / wall,
        "kernel_launches": launches,
        "steps": c.steps_run,
        "device_ops_per_step": launches / max(c.steps_run, 1),
        "top_device": [
            {"name": e.key[:80], "count": e.count,
             "ms": e.self_device_time_total / 1e3}
            for e in kernels[:12]
        ],
        "top_host": [
            {"name": e.key[:80], "count": e.count,
             "ms": e.self_cpu_time_total / 1e3}
            for e in host
        ],
        "card": torch.cuda.get_device_name(0),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
