"""Where a GPU run's time goes: 2pc-N, paxos-N, single-copy-N or
per-channel paxos-N, or 2pc-N and raft-N under symmetry, under
``torch.profiler``.

    python -m stateright_tpu_torch.profile_run [RM_COUNT] [TARGET]
    python -m stateright_tpu_torch.profile_run paxos [CLIENT_COUNT] [TARGET]
    python -m stateright_tpu_torch.profile_run singlecopy [CLIENT_COUNT] [TARGET]
    python -m stateright_tpu_torch.profile_run paxos-per-channel [CLIENT_COUNT] [TARGET]
    python -m stateright_tpu_torch.profile_run 2pc-sym [RM_COUNT] [TARGET]
    python -m stateright_tpu_torch.profile_run raft-sym [SERVER_COUNT] [TARGET]

Each takes ``--prededup`` (and ``--mxu``, which has no effect in the
port) anywhere after the module name, to profile the run with it on.

Runs ``TwoPhaseSys(n)`` (or ``paxos_model(n)``, or ``single_copy_model(n)``,
whose twin the actor compiler builds, or ``paxos_model(n).per_channel_()``
at the JAX package's bench configuration, ``capacity=1 << 16``,
``batch=512``; or ``TwoPhaseSys(n)``/``raft_model(n)`` under
``.symmetry()``) ``.checker().spawn_gpu()`` once to warm up (kernel build,
allocator), then once under the profiler with CPU and CUDA activities, and
prints one JSON object: wall seconds, the summed device time of all kernels
and copies, the device busy share (summed device time over wall; kernels on
one stream do not overlap), the number of device operations in all and per
engine step, the host-device synchronizations (``cudaStreamSynchronize``
and kin) beside the blocks of ``steps_per_call`` steps, the device-to-device
copies (``Memcpy DtoD``) in all and per step, the ``row_hash`` kernel's
launches and device milliseconds per step (under ``--prededup`` it runs
once a step), the share of valid successor lanes the pre-dedup took out,
the growth events with their host seconds, and the top device items and
host operators by time.  Needs a CUDA device.
"""

from __future__ import annotations

import json
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .models._cli import pop_step_flags, with_step_flags
from .models.paxos import paxos_model
from .models.raft import raft_model
from .models.single_copy_register import single_copy_model
from .models.two_phase_commit import TwoPhaseSys

#: CUDA runtime calls that wait for the device or copy to the host
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpyAsync")


def host_sync_counts(events) -> dict:
    """``{call: count}`` of the :data:`SYNC_CALLS` in a profiler's
    ``key_averages()``."""
    return {e.key: e.count for e in events if e.key in SYNC_CALLS}


def _paxos_per_channel(n: int):
    m = paxos_model(n)
    m.per_channel_()
    return m


# name: (builder, default size, spawn_gpu arguments, under symmetry)
MODELS = {
    "paxos": (paxos_model, 3, {}, False),
    "singlecopy": (single_copy_model, 4, {}, False),
    "paxos-per-channel": (_paxos_per_channel, 2,
                          dict(capacity=1 << 16, batch=512), False),
    "2pc-sym": (TwoPhaseSys, 15, {}, True),
    "raft-sym": (raft_model, 3, {}, True),
}


def _run(model, n: int, target, kw=None, sym: bool = False, flags=()):
    b = model(n).checker()
    if sym:
        b = b.symmetry()
    b = with_step_flags(b, flags)
    if target:
        b = b.target_states(target)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    c = b.spawn_gpu(**(kw or {})).join()
    torch.cuda.synchronize()
    return c, time.monotonic() - t0


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    flags, args = pop_step_flags(args)
    model, name, n, kw, sym = TwoPhaseSys, "2pc", 7, {}, False
    if args and args[0] in MODELS:
        name = args.pop(0)
        model, n, kw, sym = MODELS[name]
    n = int(args[0]) if args else n
    target = int(args[1]) if len(args) > 1 else None
    if not torch.cuda.is_available():
        print("profile_run: no CUDA device available", file=sys.stderr)
        return 2
    _run(model, n, target, kw, sym, flags)  # warm-up
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        c, wall = _run(model, n, target, kw, sym, flags)
    events = prof.key_averages()
    blocks = -(-c.steps_run // c._steps)
    kernels = sorted(
        (e for e in events if getattr(e, "self_device_time_total", 0) > 0),
        key=lambda e: -e.self_device_time_total,
    )
    device_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    host = sorted(events, key=lambda e: -e.self_cpu_time_total)[:12]
    steps = max(c.steps_run, 1)
    dtod = [e for e in kernels if "Memcpy DtoD" in e.key]
    hashes = [e for e in kernels if "row_hash" in e.key]
    removed = c.prededup_removed()
    print(json.dumps({
        "model": f"{name}-{n}", "target": target, "flags": flags,
        "unique": c.unique_state_count(), "states": c.state_count(),
        "width": c.tensor.width, "arity": c.tensor.max_actions,
        "wall_sec": wall, "states_per_sec": c.state_count() / wall,
        "device_kernel_sec": device_us / 1e6,
        "device_busy_share": device_us / 1e6 / wall,
        "kernel_launches": launches,
        "steps": c.steps_run,
        "device_ops_per_step": launches / steps,
        "dtod_copies": sum(e.count for e in dtod),
        "dtod_copies_per_step": sum(e.count for e in dtod) / steps,
        "dtod_ms": sum(e.self_device_time_total for e in dtod) / 1e3,
        "row_hash_launches": sum(e.count for e in hashes),
        "row_hash_device_ms_per_step": sum(
            e.self_device_time_total for e in hashes) / 1e3 / steps,
        "prededup_removed": removed,
        "prededup_removed_share": (None if removed is None
                                   else removed / max(c.state_count(), 1)),
        "steps_per_call": c._steps, "blocks": blocks,
        "host_syncs": host_sync_counts(events),
        "growth_events": c.growth_events,
        "growth_host_sec": c.growth_secs,
        "table_slots": c._cap,
        "top_device": [
            {"name": e.key[:80], "count": e.count,
             "ms": e.self_device_time_total / 1e3}
            for e in kernels[:20]
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
