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
executed engine step, the steps executed beside the steps issued (blocks
times ``steps_per_call``), the operations the host issues a block (each
block is one launch of the engine's block graph, ``ops/block_loop.py``,
plus the stats packing; counted in the warm-up run by a
``TorchDispatchMode`` around every block, each engine's capture left out)
beside each block graph's node count (the step's device operations) and
capture seconds, the host-device synchronizations (``cudaStreamSynchronize``
and kin) beside the blocks of ``steps_per_call`` steps, the device-to-device
copies (``Memcpy DtoD``) in all and per step, the ``row_hash`` kernel's
launches and device milliseconds per step (under ``--prededup`` it runs
once a step), the share of valid successor lanes the pre-dedup took out,
the growth events with their host seconds, and the top device items and
host operators by time.  Beside the busy share, the block graphs' own
(CUDA events around each graph's launch: the device time from a block's
first operation to its last, summed, over the wall).  A run whose block
graphs will execute more than ``ops.block_loop.CUPTI_KERNEL_BUDGET`` body
kernels (the warm-up's executed steps times its largest graph) is traced
on the CPU only (``cuda_off`` in the output, every CUPTI figure None):
CUPTI faults the device past that count.  Needs a CUDA device.
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
from .ops.block_loop import CUPTI_FAULT, CUPTI_KERNEL_BUDGET

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


class _BlockOps:
    """The operations PyTorch dispatches inside ``_Engine.run``
    (:class:`~.testing.block_legs.OpCount` around each block) over the
    blocks run while the ``with`` block is on, less those of each
    engine's capture (its warm step and captured step, counted by a
    second ``OpCount`` inside the first)."""

    def __enter__(self):
        from .ops import block_loop
        from .parallel import wavefront
        from .testing.block_legs import OpCount

        run = self._run = wavefront._Engine.run
        build = self._build = block_loop.BlockGraph.__init__
        self.ops = self.blocks = self._capture = 0

        def counted(eng, carry):
            with OpCount() as count:
                out = run(eng, carry)
            self.ops += count.n - self._capture
            self.blocks += 1
            self._capture = 0
            return out

        def capture(graph, *args, **kw):
            with OpCount() as count:
                build(graph, *args, **kw)
            self._capture += count.n

        wavefront._Engine.run = counted
        block_loop.BlockGraph.__init__ = capture
        return self

    def __exit__(self, *exc):
        from .ops import block_loop
        from .parallel import wavefront

        wavefront._Engine.run = self._run
        block_loop.BlockGraph.__init__ = self._build


class _BlockSpans:
    """CUDA events around every launch of a block graph while the ``with``
    block is on (``BlockGraph.run``: the carry's copy-in and the graph):
    :meth:`seconds` sums the device time from each block's first
    operation to its last, a busy figure that needs no CUPTI."""

    def __enter__(self):
        from .ops import block_loop

        run = self._run = block_loop.BlockGraph.run
        self.spans = []

        def timed(graph, carry):
            begin = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            begin.record()
            out = run(graph, carry)
            end.record()
            self.spans.append((begin, end))
            return out

        block_loop.BlockGraph.run = timed
        return self

    def __exit__(self, *exc):
        from .ops import block_loop

        block_loop.BlockGraph.run = self._run

    def seconds(self) -> float:
        torch.cuda.synchronize()
        return sum(b.elapsed_time(e) for b, e in self.spans) / 1e3


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
    with _BlockOps() as block_ops:  # the warm-up counts the host's issue
        warm, _ = _run(model, n, target, kw, sym, flags)
    # the block graphs' body kernels the run will execute (each step's
    # nodes and its cond, at most): past CUPTI's budget the run is traced
    # on the CPU only, and every device figure is None
    body = warm.steps_executed * (1 + max(
        (g["nodes"] for g in warm.block_graphs), default=0))
    cuda_off = CUPTI_FAULT if body > CUPTI_KERNEL_BUDGET else None
    acts = [ProfilerActivity.CPU] + ([] if cuda_off else
                                     [ProfilerActivity.CUDA])
    del warm
    with profile(activities=acts) as prof, _BlockSpans() as spans:
        c, wall = _run(model, n, target, kw, sym, flags)
    events = prof.key_averages()
    graph_sec = spans.seconds()

    def dev(value):
        return None if cuda_off else value

    blocks = -(-c.steps_run // c._steps)
    kernels = sorted(
        (e for e in events if getattr(e, "self_device_time_total", 0) > 0),
        key=lambda e: -e.self_device_time_total,
    )
    device_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    host = sorted(events, key=lambda e: -e.self_cpu_time_total)[:12]
    steps = max(c.steps_executed, 1)
    dtod = [e for e in kernels if "Memcpy DtoD" in e.key]
    hashes = [e for e in kernels if "row_hash" in e.key]
    removed = c.prededup_removed()
    print(json.dumps({
        "model": f"{name}-{n}", "target": target, "flags": flags,
        "unique": c.unique_state_count(), "states": c.state_count(),
        "width": c.tensor.width, "arity": c.tensor.max_actions,
        "wall_sec": wall, "states_per_sec": c.state_count() / wall,
        "cuda_off": cuda_off, "body_kernels": body,
        "device_kernel_sec": dev(device_us / 1e6),
        "device_busy_share": dev(device_us / 1e6 / wall),
        "kernel_launches": dev(launches),
        "graph_device_sec": graph_sec,
        "graph_busy_share": graph_sec / wall,
        "steps": c.steps_run,
        "steps_executed": c.steps_executed,
        "device_ops_per_step": dev(launches / steps),
        "host_ops_per_block": (block_ops.ops / block_ops.blocks + 1
                               if block_ops.blocks else None),
        "graph_nodes": [g["nodes"] for g in c.block_graphs],
        "capture_secs": [g["capture_secs"] for g in c.block_graphs],
        "graph_pool_bytes": [g["pool_bytes"] for g in c.block_graphs],
        "dtod_copies": dev(sum(e.count for e in dtod)),
        "dtod_copies_per_step": dev(sum(e.count for e in dtod) / steps),
        "dtod_ms": dev(sum(e.self_device_time_total for e in dtod) / 1e3),
        "row_hash_launches": dev(sum(e.count for e in hashes)),
        "row_hash_device_ms_per_step": dev(sum(
            e.self_device_time_total for e in hashes) / 1e3 / steps),
        "prededup_removed": removed,
        "prededup_removed_share": (None if removed is None
                                   else removed / max(c.state_count(), 1)),
        "steps_per_call": c._steps, "blocks": blocks,
        "host_syncs": dev(host_sync_counts(events)),
        "growth_events": c.growth_events,
        "growth_host_sec": c.growth_secs,
        "table_slots": c._cap,
        "top_device": dev([
            {"name": e.key[:80], "count": e.count,
             "ms": e.self_device_time_total / 1e3}
            for e in kernels[:20]
        ]),
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
