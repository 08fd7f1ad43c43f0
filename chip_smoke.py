"""Chip smoke test of the PyTorch/CUDA port (``stateright_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``stateright_tpu_torch/csrc``
(``cand_prep``, ``row_hash``, ``bucket_plan``, ``insert_commit``), holds
each against its plain PyTorch version on the card (integer outputs: they
must be equal on every lane), times both, and drives the port's main path
through the user's entry points, ``TwoPhaseSys(n).checker().spawn_gpu()``
and ``paxos_model(n).checker().spawn_gpu()``:

 - kernels at 2pc-7 shapes: the next batch of a 2pc-7 run bounded at
   100,000 unique states (its table fits in the L2, as on the main path);
 - 2pc-5 on ``cuda`` and on ``cpu`` in one process: 8,832 unique and
   identical visited-table bytes on both devices;
 - 2pc-7, complete: 296,448 unique, both agreement discoveries replayed
   through the object model, ``consistent`` never violated, and every
   kernel launched (each wrapper counts its launches; the counts are reset
   just before this run and read just after it);
 - 2pc-10, bounded by ``target_states``: the visited table in the
   hundreds of MB, discoveries replayed, peak device memory, and every
   kernel launched;
 - kernels at 2pc-10 shapes: the next batch of that run's final carry,
   with the L2 flushed before every timed call (the 512 MiB table is cold
   there on the main path);
 - paxos-2 on ``cuda`` and on ``cpu`` in one process, through
   ``paxos_model(2).checker().spawn_gpu()``: 16,668 unique, "value chosen"
   discovered, identical table bytes and queue rows ``[0, tail)``;
 - paxos-3, complete (W = 33 words per row, A = 30 actions): 1,194,428
   unique, "value chosen" replayed through the object model,
   "linearizable" never violated, every kernel launched, and the wall
   time, states/s, peak device memory, table slots, growth events with
   their host seconds, queue size and steps;
 - kernels at paxos-3 shapes: the next batch of a paxos-3 run bounded at
   600,000 unique (a 64 MiB table: L2 flushed before every timed call);
 - the actor compiler's twins (``parallel/actor_compiler.py``), through
   ``single_copy_model(4)``, ``abd_model(3, 2, Network.new_ordered())``,
   ``raft_model(3)`` and ``dining_model(3)`` ``.checker().spawn_gpu()``:
   single-copy-4 complete (W = 21, A = 20: 400,233 unique, 731,789
   states, "value chosen" replayed, "linearizable" never violated, every
   kernel launched); lin-reg-3-ordered on ``cuda`` and on ``cpu`` (36,213
   unique, identical table bytes and queue rows); raft-3 (5,725 unique,
   the leader path replayed); dining-3 (the deadlock counterexample, a
   terminal circular wait); each with its wall time, states/s, steps,
   growth events and peak device memory;
 - kernels at single-copy-4 shapes: the next batch of a single-copy-4 run
   bounded at 200,000 unique, L2 flushed before every timed call; before
   it, a single-copy-4 run bounded at 100,000 unique with a table large
   enough for no growth event goes under ``torch.profiler`` twice, with
   blocks of 64 and of 4 steps (1 and 8 blocks), and the
   ``cudaStreamSynchronize`` count per block (the difference of the two
   counts over the difference of their blocks) is printed with each run's
   count (the engine reads one stats tensor per block and
   nothing inside a step);
 - the per-channel packing and the multi-op and write-once histories:
   per-channel paxos-2 at the JAX package's bench configuration
   (``paxos_model(2).per_channel_()``, ``capacity=1 << 16``, ``batch=512``;
   W = 83, A = 82), complete on ``cuda`` (16,668 unique, 32,971 states,
   "value chosen" replayed, "linearizable" never violated, every kernel
   launched) and again on ``cpu`` with identical table bytes and queue
   rows; ABD(2,2,put_count=2) (2,980 unique) and the write-once register
   wo(2,1) (71 unique) on ``cuda`` and ``cpu``, identical likewise;
 - kernels at per-channel paxos-2 shapes (W = 83): the next batch of a run
   bounded at 8,000 unique, L2 flushed before every timed call;
 - symmetry reduction (``.symmetry().spawn_gpu()``: canonical keys through
   ``representative_rows``, ``bucket_plan`` in generation order, two
   launches a step): 2pc-15 complete on ``cuda`` (654,198 classes,
   10,982,530 states, both agreement discoveries replayed through the
   class-matching walk, ``consistent`` never violated, every kernel
   launched, with its wall time, states/s, steps and launches per step);
   2pc-7 (2,326 / 19,758) and raft-3 (2,926 / 7,917, the compiler's
   mechanical symmetry) on ``cuda`` and on ``cpu``, with identical table
   bytes and queue rows; the ``two_phase_commit check-sym-gpu 5`` verb
   (508 classes);
 - the generation-order ``bucket_plan`` at 2pc-15 symmetry shapes: the next
   batch of a 2pc-15 symmetry run bounded at 300,000 classes (canonical
   rows through ``cand_prep``), L2 flushed before every timed call, and the
   table-order plan on the same batch beside it.

The last three legs drive the checkpoint protocol, ``spawn_auto`` and an
ORL-wrapped system, each with its launch counts reset just before it and
read just after:

 - ``checkpoint_sc4``: single-copy-4 at the uninterrupted leg's capacity,
   batch and budget, ``steps_per_call=4``, autosaving every 0.5 s (keep 2):
   a live ``checkpoint()`` mid-run, a generation on disk, then ``stop()``;
   the run resumed on ``cuda`` from the live snapshot (after an
   ``np.savez`` round trip) and from the newest generation, each ending at
   400,233 / 731,789 with the uninterrupted leg's discoveries, table bytes
   and queue rows ``[0, tail)``; the seconds of each save (the snapshot
   off the card, then the write) and the bytes of a generation;
 - ``auto_2pc7``: ``TwoPhaseSys(7).checker().spawn_auto(probe_secs=0.5)``
   escalates to the GPU engine on ``cuda`` (296,448 unique, every kernel
   launched), while ``TwoPhaseSys(3).checker().spawn_auto()`` stays on the
   host probe (288 unique, no kernel launched);
 - ``orl``: the ORL sender/receiver (``models/orl.py``) on ``cuda`` and
   ``cpu``: 148 unique, "delivered" found and replayed on the host model
   through ``assert_discovery``, neither ``always`` property violated, and
   identical table bytes and queue rows; then every kernel against its
   plain version (L2-cold) on the next batch of a ``cuda`` run bounded at
   60 states (W = 17, 34 actions: a partial batch, as all of that model's
   are).

The pre-dedup (``.prededup()``, through the CLI's ``--prededup``; each
leg's launch counts reset just before it and read just after), right
after the plain paxos legs:

 - ``paxos3_prededup``: paxos-3 complete under ``.prededup()`` (the
   dedup's ``row_hash`` launch every step, ``window_unique``):
   1,194,428 unique, 2,420,477 states and the plain leg's discoveries,
   with the share of valid lanes the pre-dedup took out and the launches
   per step;
 - paxos-2 and per-channel paxos-2 (``capacity=1 << 16``, ``batch=512``)
   under the flag on ``cuda`` and ``cpu``: identical table bytes and
   queue rows ``[0, tail)``;
 - 2pc-7 under ``.symmetry().prededup()`` on ``cuda`` and ``cpu``: 2,326 /
   19,758, identical likewise;
 - the paxos-3 kernel cell's batch again as a prededup step gives it
   (``row_hash`` on the step's valid rows, ``cand_prep`` on their first
   occurrences), every kernel against its plain version.

Each kernel cell also holds ``row_hash`` on that model's init rows, the
only rows an unflagged main path gives it (``init_rows`` in its record),
and the ``total`` record gives each phase's wall seconds.

Any failure raises (non-zero exit).  The second-to-last line of standard
output is the ``{"kernels": [...]}`` record (2pc-7 shapes, with the 2pc-10
numbers under ``at_2pc10``, the paxos-3 ones under ``at_paxos3``, the
single-copy-4 ones, with that run's launches, under ``at_singlecopy4``,
and the per-channel paxos-2 ones, with that run's launches, under
``at_paxos2_per_channel``; then one more entry, ``bucket_plan`` in
generation order at 2pc-15 symmetry shapes, with the 2pc-15 symmetry
run's launches; every kernel entry also gives the launches of the last
three legs under ``at_checkpoint_sc4``, ``at_auto_2pc7`` and ``at_orl``,
the last with the ORL kernel records beside them, and the prededup legs'
under ``at_paxos3_prededup`` (with the prededup kernel cell's records),
``at_paxos2_prededup``, ``at_paxos2_per_channel_prededup`` and
``at_2pc7_symmetry_prededup``)
and the last line is ``{"ok": true, "device": {...}}``.  Everything printed is
also written to ``chiprun_out/chip_smoke.json``.  Exits non-zero without a result when no
CUDA device is available.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from stateright_tpu_torch import checkpoint as ckpt
from stateright_tpu_torch import convert
from stateright_tpu_torch.checker.bfs import BfsChecker
from stateright_tpu_torch.ops import _cuda
from stateright_tpu_torch.ops.buckets import (
    SLOTS,
    PlanBuffers,
    bucket_plan,
    bucket_plan_plain,
    window_unique,
)
from stateright_tpu_torch.ops.cand_prep import (
    PrepBuffers,
    cand_prep,
    cand_prep_plain,
    sort_prepared,
)
from stateright_tpu_torch.ops.hashing import EMPTY, row_hash, row_hash_plain
from stateright_tpu_torch.ops.insert_commit import (
    QueueAppend,
    insert_commit,
    insert_commit_plain,
)
from stateright_tpu_torch.actor import Network
from stateright_tpu_torch.models.dining import HAS_LEFT, dining_model
from stateright_tpu_torch.models.linearizable_register import abd_model
from stateright_tpu_torch.models.orl import ORL_UNIQUE, orl_model
from stateright_tpu_torch.models.paxos import paxos_model
from stateright_tpu_torch.models.raft import LEADER, raft_model
from stateright_tpu_torch.models import two_phase_commit
from stateright_tpu_torch.models._cli import with_step_flags
from stateright_tpu_torch.models.single_copy_register import single_copy_model
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.models.write_once_register import wo_register_model
from stateright_tpu_torch.parallel.wavefront import GpuChecker
from stateright_tpu_torch.profile_run import host_sync_counts

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
# the card's non-tensor-core rate (67 TFLOP/s fp32), standing in for its
# integer rate, which the data sheet does not list
OPS_PER_S = 67e12
TPC10_TARGET = 4_000_000
PAXOS3_UNIQUE = 1_194_428  # the JAX engine's complete paxos-3 count
PAXOS3_STATES = 2_420_477
# the step flag of the prededup legs (models/_cli.py's STEP_FLAGS)
PREDEDUP = ("--prededup",)
PAXOS3_KERNEL_TARGET = 600_000
# the JAX engine's complete counts (unique, states) of the compiled models
SC4 = (400_233, 731_789)
LINREG3O = (36_213, 63_053)
RAFT3 = (5_725, 15_607)
SC4_KERNEL_TARGET = 200_000
# the sync count's runs: their bound, table slots that hold it with no
# growth event, and the two block lengths they compare
SC4_SYNC_TARGET = 100_000
SC4_SYNC_CAPACITY = 1 << 21
SYNC_STEPS_PER_CALL = (64, 4)
# the JAX package's pins: per-channel paxos-2 (unique, states)
# (tests/test_per_channel.py:53), ABD(2,2,put_count=2) unique
# (tests/test_actor_compiler.py:169) and wo(2,1) (unique, states)
# (tests/test_per_channel.py:166)
P2_PER_CHANNEL = (16_668, 32_971)
ABD22_PUT2_UNIQUE = 2_980
WO21 = (71, 97)
P2_PER_CHANNEL_KW = dict(capacity=1 << 16, batch=512)  # bench.py:886-918
P2_PER_CHANNEL_KERNEL_TARGET = 8_000
# symmetry runs (classes, states), as the JAX engine gives them:
# TwoPhaseSys(n).checker().symmetry().spawn_tpu(sync=True) on the CPU for
# 2pc-7 and 2pc-15; raft-3 from
# tests/test_raft.py:110 and tests/test_per_channel.py:201; 2pc-5's 508
# from tests/test_tensor_models.py:191-207
SYM_2PC7 = (2_326, 19_758)
SYM_2PC15 = (654_198, 10_982_530)
SYM_RAFT3 = (2_926, 7_917)
SYM_2PC5_UNIQUE = 508
SYM_2PC15_KERNEL_TARGET = 300_000
# stops the ORL run at 73 of 148 states, 34 queued: its next batch is a
# partial one, as every batch of that model is
ORL_KERNEL_TARGET = 60
# the checkpoint leg: the block length, the autosave cadence and how
# many generations are kept, and the live unique count past which the
# live checkpoint is asked for
CKPT_STEPS_PER_CALL = 4
CKPT_EVERY_SECS = 0.5
CKPT_KEEP = 2
CKPT_AT_UNIQUE = 100_000
TPC7_UNIQUE = 296_448
FLUSH_BYTES = 256 << 20  # rewritten between cold calls: past the 50 MB L2
# about 2 ms of spinning at the H100's clock: longer than the host takes to
# enqueue any call timed here (the plain versions issue some 50 launches)
SLEEP_CYCLES = 4_000_000
OUT = Path("chiprun_out/chip_smoke.json")
RECORD: dict = {}
# the keys every kernel record carries in the final line
KERNEL_KEYS = ("name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms", "matched", "device_ms", "plain_device_ms",
               "device_ms_by", "plain_device_ms_by", "events_device_ms",
               "plain_events_device_ms", "host_ms", "engine_host_ms", "shape")


def emit(key: str, value) -> None:
    RECORD[key] = value
    print(json.dumps({key: value}), flush=True)


PHASES: dict = {}
_LAP = [time.monotonic()]


def lap(name: str) -> None:
    """Record the wall seconds since the previous lap under ``name``."""
    now = time.monotonic()
    PHASES[name] = now - _LAP[0]
    _LAP[0] = now


def time_ms(fn, iters: int = 100, warmup: int = 5) -> float:
    """Mean milliseconds per call, by CUDA events around ``iters``
    back-to-back calls (so the host's issue time between launches counts)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_cold_ms(fn, flush, iters: int = 30) -> float:
    """Mean milliseconds per call, by CUDA events around each call, with
    the L2 flushed (``flush`` rewritten by one kernel) before each."""
    for _ in range(3):
        flush.add_(1)
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.add_(1)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def profiler_device_ms(fn, flush=None, iters: int = 20):
    """Mean milliseconds of DEVICE time per call (every kernel and copy the
    call enqueues, summed), from ``torch.profiler``: unlike :func:`time_ms`
    it leaves out the gaps while the host issues the next launch.  With
    ``flush``, the L2 is flushed before each call and the flush's own
    kernel is left out of the sum.  ``None`` when the profiler recorded no
    device time (for the call, or for the flush it must leave out)."""
    from torch.profiler import ProfilerActivity, profile

    def profiled(call, n):
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                call()
            torch.cuda.synchronize()
        return {e.key: e.self_device_time_total for e in prof.key_averages()
                if e.self_device_time_total > 0}

    skip = set()
    if flush is not None:
        # the flush's own device operations, by name, are left out
        skip = set(profiled(lambda: flush.add_(1), 3))
        if not skip:
            return None
        times = profiled(lambda: (flush.add_(1), fn()), iters)
    else:
        times = profiled(fn, iters)
    total = sum(t for k, t in times.items() if k not in skip)
    return total / 1e3 / iters if total > 0 else None


def events_device_ms(fn, flush=None, iters: int = 20) -> float:
    """Mean milliseconds per call by CUDA events, with the stream held busy
    (``torch.cuda._sleep``) while the host enqueues the call, so the window
    holds device time and no host issue gaps, unless the call itself
    waits for the device.  ``flush``: the L2 is flushed before each call,
    outside the window."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        if flush is not None:
            flush.add_(1)
        torch.cuda._sleep(SLEEP_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def device_ms(fn, flush=None) -> tuple[float, str, float]:
    """Device milliseconds per call, how they were taken, and the events
    figure: by the profiler, tried three times, and else by CUDA events
    behind a busy stream (the profiler's device trace is sometimes empty).
    The events figure is taken every time, as a cross-check."""
    events = events_device_ms(fn, flush)
    for _ in range(3):
        t = profiler_device_ms(fn, flush)
        if t is not None:
            return t, "profiler", events
    return events, "events", events


def host_ms(fn, iters: int = 200) -> float:
    """Mean host milliseconds to issue one call (no synchronisation inside
    the window): what the wrapper itself costs the engine's loop."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed * 1e3 / iters


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


KERNELS = (cand_prep, row_hash, bucket_plan, insert_commit)


def kernel_launches() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def check_discoveries(model, checker, expect: set) -> dict:
    """Every discovery path replays through the object model (the
    reconstruction re-executes it) and ends in a state that satisfies its
    property; ``consistent`` is never violated."""
    paths = checker.discoveries()
    if set(paths) != expect:
        raise AssertionError(f"discoveries {sorted(paths)} != {sorted(expect)}")
    for name, path in paths.items():
        if not model.property_by_name(name).condition(model, path.final_state()):
            raise AssertionError(f"{name}: replayed path does not satisfy it")
    return {name: len(path) for name, path in paths.items()}


def timed_run(n: int, target=None, model=TwoPhaseSys, **kw):
    builder = model(n).checker()
    if target is not None:
        builder = builder.target_states(target)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    checker = builder.spawn_gpu(**kw).join()
    torch.cuda.synchronize()
    return checker, time.monotonic() - t0


def next_batch(checker, carry, sym: bool = False, flags=()) -> dict:
    """The next batch popped from a run's carry (device tensors, as the
    engine's ``_final_carry`` holds them), pushed through the step's plain
    stages up to each kernel: real inputs at the shapes the main path
    gives the kernels.  ``sym``: as a symmetry run's step, the canonical
    rows go to ``cand_prep`` and the plan is in generation order.
    ``flags`` (:data:`PREDEDUP`): as a prededup run's step, ``row_hash``
    hashes the valid rows (``hvalid``) and ``cand_prep`` gets the first
    occurrences only (``cvalid``)."""
    head, tail = int(carry[convert.HEAD]), int(carry[convert.TAIL])
    batch, cand = checker._batch, checker._cand
    arity = checker.tensor.max_actions
    if tail == head:
        raise AssertionError("the run left nothing queued")
    # the engine's pop: lanes past the tail read a clamped row and are
    # masked off (a small model's every batch is such a partial one)
    lanes = torch.arange(batch, device=carry[convert.QROWS].device)
    span = (head + lanes).clamp_(max=carry[convert.QROWS].shape[0] - 1)
    succ, valid = checker.tensor.step_rows(carry[convert.QROWS][span])
    valid = valid & (lanes < tail - head)[:, None]
    m = batch * arity
    crows, cvalid = succ.reshape(m, -1), valid.reshape(m)
    krows = (checker.tensor.representative_rows(succ).reshape(m, -1)
             if sym else crows)
    hvalid = cvalid
    if "--prededup" in flags:
        cvalid = window_unique(row_hash_plain(krows, hvalid)) != EMPTY
    pfp = carry[convert.QFP][span]
    tfp, tpl = carry[convert.TFP], carry[convert.TPL]
    cb = min(cand, m)
    prep = cand_prep_plain(krows, cvalid, pfp, arity, cb)
    # the engine's order: cand_prep, one stable sort, then the plan
    sort = (*sort_prepared(prep[0], prep[1], prep[3], tfp.shape[0] // SLOTS),
            prep[2], prep[5])
    plan = bucket_plan_plain(tfp, *sort, generation_order=sym)
    n_new = int(plan[4])
    if n_new == 0:
        raise AssertionError(f"captured batch wrote nothing (overflow="
                             f"{bool(plan[5])}, cand_overflow={bool(sort[5])})")
    queue = QueueAppend(
        carry[convert.QROWS], carry[convert.QFP], carry[convert.QEBITS],
        carry[convert.QDEPTH], carry[convert.TAIL], plan[3], crows,
        carry[convert.QEBITS][span], carry[convert.QDEPTH][span], arity,
    )
    return dict(crows=crows, krows=krows, cvalid=cvalid, hvalid=hvalid,
                pfp=pfp,
                arity=arity, cb=cb, prep=prep, tfp=tfp, tpl=tpl, sort=sort, plan=plan,
                queue=queue, n_new=n_new)


def timings(kernel, plain, cold: bool, engine=None) -> dict:
    """``ms``/``plain_ms`` by CUDA events, ``device_ms``/``plain_device_ms``
    by the profiler or else by events behind a busy stream (``*_by`` says
    which; ``*events_device_ms`` is the events figure, always taken),
    ``host_ms`` by the host clock over enqueues alone (the
    public wrapper's own cost, checks included) and ``engine_host_ms`` the
    same for the engine's call (buffers validated at allocation, no
    per-call checks).  ``cold`` flushes the L2 before every timed call."""
    flush = None
    if cold:
        flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
        t = dict(ms=time_cold_ms(kernel, flush),
                 plain_ms=time_cold_ms(plain, flush))
    else:
        t = dict(ms=time_ms(kernel), plain_ms=time_ms(plain))
    k_dev, k_by, k_ev = device_ms(kernel, flush)
    p_dev, p_by, p_ev = device_ms(plain, flush)
    t.update(device_ms=k_dev, plain_device_ms=p_dev,
             device_ms_by=k_by, plain_device_ms_by=p_by,
             events_device_ms=k_ev, plain_events_device_ms=p_ev,
             host_ms=host_ms(kernel),
             engine_host_ms=host_ms(engine) if engine is not None else None)
    return t


def plan_record(x: dict, cold: bool, stream, sym: bool = False) -> dict:
    """``bucket_plan`` (in generation order with ``sym``) against its plain
    version on the batch ``x`` of :func:`next_batch`."""
    tfp, sort, want = x["tfp"], x["sort"], x["plan"]
    sfp, bucket, cidx = sort[0], sort[2], sort[4]
    pbuf = PlanBuffers(sfp.shape[0], sfp.device, sym)
    got = bucket_plan(tfp, *sort, out=pbuf, generation_order=sym)
    m = sfp.shape[0]
    planned = int((want[0] != tfp.shape[0]).sum())  # novel lanes, blocked or not
    errs = [int((g[:planned] != p[:planned]).sum()) for g, p in zip(got[:4], want[:4])]
    errs += [abs(int(got[4]) - int(want[4])), int(bool(got[5]) != bool(want[5]))]
    live = sfp != EMPTY
    nlive = int(live.sum())
    lines = int(torch.unique(bucket[live]).numel())
    # every lane reads its fingerprint; live lanes their bucket index and
    # each distinct line once; novel lanes their payload, order (and cidx)
    # entries and write four words; the flags in and out.  Generation
    # order moves the same bytes in and out (its staging area is the
    # kernel's own scratch)
    per_novel = 8 * (2 if cidx is None else 3) + 32
    p_ms, p_by = bound(m * 8 + nlive * 8 + lines * SLOTS * 8
                       + planned * per_novel + 1 + 9, nlive * SLOTS * 2)
    return dict(
        name="bucket_plan_generation_order" if sym else "bucket_plan",
        route="cuda", source="stateright_tpu_torch/csrc/bucket_plan.cu",
        replaces=("stateright_tpu/ops/buckets.py:282" if sym
                  else "stateright_tpu/ops/buckets.py:202"),
        shape=(f"cand {m} ({nlive} valid, {lines} lines, {planned} novel), "
               f"table {tfp.shape[0]} slots"),
        matched=sum(errs) == 0, max_abs_err=sum(errs),
        bound_ms=p_ms, bound_by=p_by, library_ms=None,
        **timings(lambda: bucket_plan(tfp, *sort, out=pbuf,
                                      generation_order=sym),
                  lambda: bucket_plan_plain(tfp, *sort, generation_order=sym),
                  cold,
                  lambda: bucket_plan(tfp, *sort, out=pbuf,
                                      generation_order=sym, check=False,
                                      stream=stream)),
    )


def check_kernels(checker, carry, cold: bool, sym: bool = False,
                  flags=()) -> dict:
    """Each kernel against its plain version on one real batch; returns
    ``{name: record}``.  ``sym``: the batch as a symmetry run's step gives
    it to the kernels (canonical rows to ``cand_prep`` and ``row_hash``,
    the plan and the insert in generation order), with the table-order
    plan on the same batch as one more record.  ``flags``: as a run with
    those step flags gives it (:func:`next_batch`): under ``--prededup``
    ``row_hash`` runs on the step's valid rows, as the step calls it."""
    x = next_batch(checker, carry, sym, flags)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}

    # -- cand_prep over the batch's B*A successor (or canonical) rows --------
    rows, valid = x["krows"], x["cvalid"]
    pfp, arity, cb, want = x["pfp"], x["arity"], x["cb"], x["prep"]
    n, w = rows.shape
    qbuf = PrepBuffers(n, cb, rows.device)
    got = cand_prep(rows, valid, pfp, arity, cb, out=qbuf)
    errs = sum(int((g != p).sum()) for g, p in zip(got, want))
    nv = int(want[4])
    parents = int(torch.unique(want[2] // arity).numel())
    # valid lanes read their row, every lane its valid byte, each parent
    # whose lane is read its fingerprint once; four words per output lane
    # and the two scalars out
    q_ms, q_by = bound(nv * w * 8 + n + parents * 8 + cb * 32 + 9,
                       nv * (w + 2) * 10)
    out["cand_prep"] = dict(
        name="cand_prep", route="cuda",
        source="stateright_tpu_torch/csrc/cand_prep.cu",
        replaces=("stateright_tpu/parallel/wavefront.py:491 with "
                  "stateright_tpu/ops/buckets.py:181"),
        shape=(f"rows int64[{n}, {w}], {nv} valid, budget {cb}, "
               f"{parents} parents read"),
        matched=errs == 0, max_abs_err=errs,
        bound_ms=q_ms, bound_by=q_by, library_ms=None,
        **timings(lambda: cand_prep(rows, valid, pfp, arity, cb, out=qbuf),
                  lambda: cand_prep_plain(rows, valid, pfp, arity, cb), cold,
                  lambda: cand_prep(rows, valid, pfp, arity, cb, qbuf,
                                    check=False, stream=stream)),
    )

    # -- B: row_hash over the same rows (under prededup: the step's own
    # call, on the valid rows before the dedup), and over the run's init
    # rows (without prededup, the only rows the main path gives it) -------
    init = torch.from_numpy(np.asarray(checker.tensor.init_rows(), np.uint64)
                            .view(np.int64).copy()).to(rows.device)
    if sym:
        init = checker.tensor.representative_rows(init).contiguous()
    ni, wi = init.shape
    got_i, want_i = row_hash(init), row_hash_plain(init)
    bi_ms, bi_by = bound(ni * wi * 8 + ni * 8, ni * (wi + 1) * 10)
    init_record = dict(
        shape=f"init rows int64[{ni}, {wi}]",
        matched=bool(torch.equal(got_i, want_i)),
        max_abs_err=int((got_i != want_i).sum()),
        bound_ms=bi_ms, bound_by=bi_by,
        **timings(lambda: row_hash(init), lambda: row_hash_plain(init), cold),
    )
    hvalid = x["hvalid"]
    nh = int(hvalid.sum())
    got, want = row_hash(rows, hvalid), row_hash_plain(rows, hvalid)
    # every lane reads its valid byte and writes its fingerprint; only the
    # valid lanes read their row (invalid ones return before it)
    b_ms, b_by = bound(nh * w * 8 + n + n * 8, nh * (w + 1) * 10)
    out["row_hash"] = dict(
        name="row_hash", route="cuda",
        source="stateright_tpu_torch/csrc/row_hash.cu",
        replaces="stateright_tpu/ops/hashing.py:105",
        shape=f"rows int64[{n}, {w}], {nh} valid",
        matched=bool(torch.equal(got, want)) and init_record["matched"],
        max_abs_err=int((got != want).sum()) + init_record["max_abs_err"],
        init_rows=init_record,
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        **timings(lambda: row_hash(rows, hvalid),
                  lambda: row_hash_plain(rows, hvalid), cold),
    )
    if "--prededup" in flags:
        # the plain stage between the step's row_hash and cand_prep
        fps = row_hash_plain(rows, hvalid)
        out["row_hash"]["window_unique"] = dict(
            kept=nv, ms=time_ms(lambda: window_unique(fps)))

    # -- bucket_plan over the sorted candidate budget ------------------------
    out["bucket_plan"] = plan_record(x, cold, stream, sym)
    if sym:  # what the second launch costs: table order on the same batch
        tab = dict(x, plan=bucket_plan_plain(x["tfp"], *x["sort"]))
        out["bucket_plan_table_order"] = plan_record(tab, cold, stream)

    # -- insert_commit of the batch's novel candidates -----------------------
    tfp, want = x["tfp"], x["plan"]
    tgt, wfp, wpl, sel, n_new_t = want[0], want[1], want[2], want[3], want[4]
    q = x["queue"]
    nn = x["n_new"]
    kt = (tfp.clone(), x["tpl"].clone())
    pt = (tfp.clone(), x["tpl"].clone())
    kq = q._replace(rows=q.rows.clone(), fps=q.fps.clone(),
                    ebits=q.ebits.clone(), depths=q.depths.clone())
    pq = q._replace(rows=q.rows.clone(), fps=q.fps.clone(),
                    ebits=q.ebits.clone(), depths=q.depths.clone())
    insert_commit(*kt, tgt, wfp, wpl, n_new_t, kq)
    insert_commit_plain(*pt, tgt, wfp, wpl, n_new_t, pq)
    c_err = sum(int((a != b).sum()) for a, b in zip(kt + tuple(kq[:4]),
                                                    pt + tuple(pq[:4])))
    width = x["crows"].shape[1]  # the queue keeps the successor rows
    parents = int(torch.unique(sel[:nn] // q.arity).numel())
    # plan lanes, count and tail in; parents' ebits and depth; the rows;
    # 16 table bytes and a queue row (8W + 16 bytes) out per novel lane
    c_ms, c_by = bound(nn * 32 + 16 + parents * 8 + nn * 8 * width
                       + nn * 16 + nn * (8 * width + 16), 0)
    out["insert_commit"] = dict(
        name="insert_commit", route="cuda",
        source="stateright_tpu_torch/csrc/insert_commit.cu",
        replaces="stateright_tpu/ops/pallas_insert.py:85",
        shape=(f"cand {tgt.shape[0]}, n_new {nn}, table {tfp.shape[0]} slots, "
               f"queue {q.fps.shape[0]} rows"),
        matched=c_err == 0, max_abs_err=c_err,
        bound_ms=c_ms, bound_by=c_by, library_ms=None,
        **timings(lambda: insert_commit(*kt, tgt, wfp, wpl, n_new_t, kq),
                  lambda: insert_commit_plain(*pt, tgt, wfp, wpl, n_new_t, pq),
                  cold,
                  lambda: insert_commit(*kt, tgt, wfp, wpl, n_new_t, kq,
                                        check=False, stream=stream)),
    )
    return out


def same_tables_and_queue(g, c) -> tuple[bool, int]:
    """Whether two finished runs hold the same table bytes, cursors and
    queue rows ``[0, tail)``; and the tail."""
    return same_snapshots(g.final_snapshot(), c.final_snapshot())


def same_snapshots(gs: dict, cs: dict) -> tuple[bool, int]:
    """Whether two snapshots hold the same table bytes, cursors and queue
    rows ``[0, tail)``; and the tail."""
    tail = int(gs["tail"])
    same = (int(gs["head"]) == int(cs["head"]) and tail == int(cs["tail"])
            and all((gs[k] == cs[k]).all() for k in ("table_fp", "table_parent"))
            and all((gs[k][:tail] == cs[k][:tail]).all()
                    for k in ("q_rows", "q_fp", "q_ebits", "q_depth")))
    return bool(same), tail


def paxos_phases(dev, smi: str) -> tuple:
    """Paxos-2 on ``cuda`` and ``cpu``, then paxos-3 complete with the
    main path's launch counts; returns paxos-3's discovery fingerprints
    and path lengths."""
    # -- paxos-2 on cuda and cpu: same counts, table bytes and queue rows ---
    def p2(device):
        c = paxos_model(2).checker().spawn_gpu(device=device, batch=256)
        t0 = time.monotonic()
        c.join()
        if device != "cpu":
            torch.cuda.synchronize()
        return c, time.monotonic() - t0

    (g2, g2_s), (c2, c2_s) = p2(dev), p2("cpu")
    same, tail = same_tables_and_queue(g2, c2)
    disc = check_discoveries(g2.model, g2, {"value chosen"})
    emit("paxos2", {"unique_cuda": g2.unique_state_count(),
                    "unique_cpu": c2.unique_state_count(),
                    "states": g2.state_count(), "tail": tail,
                    "table_slots": g2._cap,
                    "tables_and_queue_identical": same,
                    "sec_cuda": g2_s, "sec_cpu": c2_s, "path_lengths": disc})
    if not (same and g2.unique_state_count() == c2.unique_state_count()
            == 16_668):
        raise AssertionError("paxos-2: cuda and cpu disagree")
    del g2, c2

    # -- paxos-3, complete: the main path at paxos width ----------------------
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    g3, g3_s = timed_run(3, model=paxos_model)
    peak = torch.cuda.max_memory_allocated(dev)
    launches3 = kernel_launches()
    paths3 = check_discoveries(g3.model, g3, {"value chosen"})
    g3.assert_properties()  # "linearizable" never violated
    tm = g3.tensor
    qrows = g3._qcap + g3._batch * tm.max_actions
    emit("paxos3", {"unique": g3.unique_state_count(),
                    "states": g3.state_count(), "depth": g3.max_depth(),
                    "sec": g3_s, "states_per_sec": g3.state_count() / g3_s,
                    "unique_per_sec": g3.unique_state_count() / g3_s,
                    "width": tm.width, "arity": tm.max_actions,
                    "table_slots": g3._cap, "table_mib": g3._cap * 16 / 2**20,
                    "queue_rows": qrows,
                    "queue_mib": qrows * (8 * tm.width + 16) / 2**20,
                    "peak_device_mib": peak / 2**20, "cand": g3._cand,
                    "steps": g3.steps_run,
                    "growth_events": [
                        {"status": st, "unique": u, "host_sec": sec}
                        for (st, u), sec in zip(g3.growth_events,
                                                g3.growth_secs)],
                    "growth_host_sec": sum(g3.growth_secs),
                    "path_lengths": paths3, "launches": launches3,
                    "card": smi})
    if g3.unique_state_count() != PAXOS3_UNIQUE:
        raise AssertionError(
            f"paxos-3: {g3.unique_state_count()} unique, not {PAXOS3_UNIQUE}")
    if not all(v > 0 for v in launches3.values()):
        raise AssertionError(f"a kernel never launched on paxos-3: {launches3}")
    return g3.discovery_fps(), paths3


def flag_phases(dev, smi: str, p3_ref) -> tuple:
    """The pre-dedup on the card: paxos-3 under ``.prededup()`` complete,
    with the plain leg's counts and discoveries ``p3_ref``; paxos-2 and
    per-channel paxos-2 under the flag on ``cuda`` and ``cpu``; 2pc-7
    under ``.symmetry().prededup()`` on both.  Returns each leg's
    launches."""
    # -- paxos-3, complete, prededup: the slice's main path ------------------
    g, g_s, peak, launches = compiled_leg(dev, lambda: paxos_model(3),
                                          flags=PREDEDUP)
    paths = check_discoveries(g.model, g, {"value chosen"})
    g.assert_properties()  # "linearizable" never violated
    removed = g.prededup_removed()
    rec = dict(leg_record(g, g_s, peak, launches, smi), path_lengths=paths,
               flags=list(PREDEDUP),
               unique_per_sec=g.unique_state_count() / g_s,
               prededup_removed=removed,
               prededup_removed_share=removed / g.state_count(),
               launches_per_step={k: v / g.steps_run
                                  for k, v in launches.items()},
               discoveries_identical=(g.discovery_fps() == p3_ref[0]
                                      and paths == p3_ref[1]))
    emit("paxos3_prededup", rec)
    if (g.unique_state_count(), g.state_count()) != (PAXOS3_UNIQUE,
                                                     PAXOS3_STATES):
        raise AssertionError("paxos-3 prededup: not "
                             f"{(PAXOS3_UNIQUE, PAXOS3_STATES)}")
    if not rec["discoveries_identical"]:
        raise AssertionError("paxos-3 prededup: discoveries differ from the "
                             "plain leg's")
    # the step hashes its candidates once more under prededup
    if launches["row_hash"] < g.steps_run:
        raise AssertionError(f"paxos-3 prededup: row_hash {launches}")
    del g

    # -- paxos-2 in both packings, prededup, on cuda and cpu -----------------
    leg_launches = {}
    for name, build, kw in (
        ("paxos2_prededup", lambda: paxos_model(2), dict(batch=256)),
        ("paxos2_per_channel_prededup", per_channel_paxos2,
         P2_PER_CHANNEL_KW),
    ):
        g, g_s, peak, leg_launches[name] = compiled_leg(
            dev, build, flags=PREDEDUP, **kw)
        t0 = time.monotonic()
        c = with_step_flags(build().checker(), PREDEDUP).spawn_gpu(
            device="cpu", **kw).join()
        c_s = time.monotonic() - t0
        same, tail = same_tables_and_queue(g, c)
        paths = check_discoveries(g.model, g, {"value chosen"})
        g.assert_properties()
        emit(name, dict(leg_record(g, g_s, peak, leg_launches[name], smi),
                        unique_cpu=c.unique_state_count(),
                        states_cpu=c.state_count(), sec_cpu=c_s, tail=tail,
                        tables_and_queue_identical=same, path_lengths=paths,
                        network_encoding=getattr(g.tensor, "network_encoding",
                                                 "hand-written"),
                        prededup_removed=g.prededup_removed(),
                        prededup_removed_cpu=c.prededup_removed(), **kw))
        for x in (g, c):  # paxos-2's counts are the same in both packings
            if (x.unique_state_count(), x.state_count()) != P2_PER_CHANNEL:
                raise AssertionError(f"{name}: not {P2_PER_CHANNEL}")
        if not same or g.prededup_removed() != c.prededup_removed():
            raise AssertionError(f"{name}: cuda and cpu disagree")
        del g, c

    # -- 2pc-7 under symmetry with prededup, on cuda and cpu ------------------
    g, g_s, peak, sym_launches = compiled_leg(
        dev, lambda: TwoPhaseSys(7), sym=True, flags=PREDEDUP)
    c = TwoPhaseSys(7).checker().symmetry().prededup().spawn_gpu(
        device="cpu").join()
    same, tail = same_tables_and_queue(g, c)
    paths = check_discoveries(g.model, g, {"abort agreement",
                                           "commit agreement"})
    g.assert_properties()
    emit("2pc7_symmetry_prededup", dict(
        leg_record(g, g_s, peak, sym_launches, smi),
        unique_cpu=c.unique_state_count(), states_cpu=c.state_count(),
        tail=tail, tables_and_queue_identical=same, path_lengths=paths,
        prededup_removed=g.prededup_removed()))
    for x in (g, c):
        if (x.unique_state_count(), x.state_count()) != SYM_2PC7:
            raise AssertionError(f"2pc-7 symmetry prededup: not {SYM_2PC7}")
    if not same:
        raise AssertionError("2pc-7 symmetry prededup: cuda and cpu disagree")
    if sym_launches["bucket_plan"] != 2 * sym_launches["insert_commit"]:
        raise AssertionError(f"2pc-7 symmetry prededup: {sym_launches}")
    return launches, leg_launches, sym_launches


def leg_record(checker, sec: float, peak: int, launches: dict,
               smi: str) -> dict:
    """What every compiled leg reports."""
    tm = checker.tensor
    return {"unique": checker.unique_state_count(),
            "states": checker.state_count(), "depth": checker.max_depth(),
            "sec": sec, "states_per_sec": checker.state_count() / sec,
            "width": tm.width, "arity": tm.max_actions,
            "table_slots": checker._cap, "cand": checker._cand,
            "steps": checker.steps_run,
            "growth_events": [
                {"status": st, "unique": u, "host_sec": g}
                for (st, u), g in zip(checker.growth_events,
                                      checker.growth_secs)],
            "growth_host_sec": sum(checker.growth_secs),
            "peak_device_mib": peak / 2**20, "launches": launches,
            "card": smi}


def compiled_leg(dev, build, sym: bool = False, flags=(), **kw):
    """One ``spawn_gpu(**kw)`` run of ``build()``'s model (under
    ``.symmetry()`` with ``sym``, with the step ``flags`` on) with the
    launch counts reset just before it and read just after; returns the
    checker, its wall seconds (the twin's host-side compile included),
    peak device memory and launches."""
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    builder = build().checker()
    if sym:
        builder = builder.symmetry()
    builder = with_step_flags(builder, flags)
    checker = builder.spawn_gpu(**kw).join()
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    launches = kernel_launches()
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"a kernel never launched: {launches}")
    return checker, sec, torch.cuda.max_memory_allocated(dev), launches


def compiled_phases(dev, smi: str) -> dict:
    """The actor compiler's twins on the card; returns the single-copy-4
    run's launches, and its final snapshot and discoveries."""
    # -- single-copy-4, complete ---------------------------------------------
    sc, sc_s, peak, launches = compiled_leg(dev, lambda: single_copy_model(4))
    paths = check_discoveries(sc.model, sc, {"value chosen"})
    sc.assert_properties()  # "linearizable" never violated
    emit("singlecopy4", dict(leg_record(sc, sc_s, peak, launches, smi),
                             path_lengths=paths))
    if (sc.unique_state_count(), sc.state_count()) != SC4:
        raise AssertionError(f"single-copy-4: not {SC4}")
    # what the checkpoint leg's resumed runs must end with
    sc4_ref = (sc.final_snapshot(), sc.discovery_fps())
    del sc

    # -- lin-reg-3-ordered on cuda and cpu -----------------------------------
    def linreg():
        return abd_model(3, 2, Network.new_ordered())

    lg, lg_s, peak, launches_l = compiled_leg(dev, linreg)
    t0 = time.monotonic()
    lc = linreg().checker().spawn_gpu(device="cpu").join()
    lc_s = time.monotonic() - t0
    same, tail = same_tables_and_queue(lg, lc)
    paths = check_discoveries(lg.model, lg, {"value chosen"})
    lg.assert_properties()
    emit("linreg3_ordered", dict(
        leg_record(lg, lg_s, peak, launches_l, smi),
        unique_cpu=lc.unique_state_count(), states_cpu=lc.state_count(),
        sec_cpu=lc_s, tail=tail, tables_and_queue_identical=same,
        path_lengths=paths))
    for c in (lg, lc):
        if (c.unique_state_count(), c.state_count()) != LINREG3O:
            raise AssertionError(f"lin-reg-3-ordered: not {LINREG3O}")
    if not same:
        raise AssertionError("lin-reg-3-ordered: cuda and cpu disagree")
    del lg, lc

    # -- raft-3: timers and factored pair properties --------------------------
    rg, rg_s, peak, launches_r = compiled_leg(dev, lambda: raft_model(3))
    paths = check_discoveries(rg.model, rg, {"a leader is elected"})
    rg.assert_properties()  # "election safety" never violated
    path = rg.discovery("a leader is elected")
    leader = int(path.actions()[-1].dst)
    if path.final_state().actor_states[leader].role != LEADER:
        raise AssertionError("raft-3: the replayed path elects no leader")
    emit("raft3", dict(leg_record(rg, rg_s, peak, launches_r, smi),
                       path_lengths=paths))
    if (rg.unique_state_count(), rg.state_count()) != RAFT3:
        raise AssertionError(f"raft-3: not {RAFT3}")
    del rg

    # -- dining-3: the deadlock, an eventually counterexample ----------------
    dg, dg_s, peak, launches_d = compiled_leg(dev, lambda: dining_model(3))
    path = dg.discovery("everyone eats")
    if path is None:
        raise AssertionError("dining-3: the deadlock was not found")
    final = path.final_state()
    deadlock = (all(p.phase == HAS_LEFT for p in final.actor_states[:3])
                and dg.model.next_steps(final) == [])
    emit("dining3", dict(leg_record(dg, dg_s, peak, launches_d, smi),
                         deadlock_path_length=len(path),
                         circular_wait=deadlock))
    if not deadlock:
        raise AssertionError("dining-3: the counterexample is no deadlock")
    return launches, sc4_ref


def per_channel_paxos2():
    m = paxos_model(2)
    m.per_channel_()
    return m


def channel_and_history_phases(dev, smi: str) -> dict:
    """Per-channel paxos-2 at the bench configuration on cuda and cpu, then
    ABD(2,2,put_count=2) and wo(2,1) on cuda and cpu; returns the
    per-channel run's launches."""
    pg, pg_s, peak, launches = compiled_leg(dev, per_channel_paxos2,
                                            **P2_PER_CHANNEL_KW)
    if pg.tensor.network_encoding != "per-channel":
        raise AssertionError("per-channel paxos-2: not the per-channel twin")
    paths = check_discoveries(pg.model, pg, {"value chosen"})
    pg.assert_properties()  # "linearizable" never violated
    t0 = time.monotonic()
    pc = per_channel_paxos2().checker().spawn_gpu(
        device="cpu", **P2_PER_CHANNEL_KW).join()
    pc_s = time.monotonic() - t0
    same, tail = same_tables_and_queue(pg, pc)
    emit("paxos2_per_channel", dict(
        leg_record(pg, pg_s, peak, launches, smi),
        unique_cpu=pc.unique_state_count(), states_cpu=pc.state_count(),
        sec_cpu=pc_s, tail=tail, tables_and_queue_identical=same,
        path_lengths=paths, **P2_PER_CHANNEL_KW))
    for c in (pg, pc):
        if (c.unique_state_count(), c.state_count()) != P2_PER_CHANNEL:
            raise AssertionError(f"per-channel paxos-2: not {P2_PER_CHANNEL}")
    if not same:
        raise AssertionError("per-channel paxos-2: cuda and cpu disagree")
    del pg, pc

    for name, build, want in (
        ("abd22_put2", lambda: abd_model(2, 2, put_count=2),
         (ABD22_PUT2_UNIQUE, None)),
        ("wo21", lambda: wo_register_model(2, 1), WO21),
    ):
        g, g_s, peak, leg_launches = compiled_leg(dev, build)
        c = build().checker().spawn_gpu(device="cpu").join()
        same, tail = same_tables_and_queue(g, c)
        paths = check_discoveries(g.model, g, {"value chosen"})
        g.assert_properties()
        emit(name, dict(leg_record(g, g_s, peak, leg_launches, smi),
                        unique_cpu=c.unique_state_count(),
                        states_cpu=c.state_count(), tail=tail,
                        tables_and_queue_identical=same,
                        path_lengths=paths))
        for x in (g, c):
            if x.unique_state_count() != want[0] or (
                    want[1] is not None and x.state_count() != want[1]):
                raise AssertionError(f"{name}: not {want}")
        if not same:
            raise AssertionError(f"{name}: cuda and cpu disagree")
    return launches


def symmetry_phases(dev, smi: str) -> dict:
    """2pc-15 under symmetry on cuda, the slice's full-size path; 2pc-7 and
    raft-3 under symmetry on cuda and cpu; the ``check-sym-gpu 5`` verb.
    Returns the 2pc-15 run's launches."""
    g, g_s, peak, launches = compiled_leg(dev, lambda: TwoPhaseSys(15),
                                          sym=True)
    paths = check_discoveries(g.model, g, {"abort agreement",
                                           "commit agreement"})
    g.assert_properties()  # "consistent" never violated
    # a symmetry step launches bucket_plan twice (plan, then the
    # generation-order compaction), the init's insert too
    if launches["bucket_plan"] != 2 * launches["insert_commit"]:
        raise AssertionError(f"2pc-15 symmetry: launches {launches}")
    emit("2pc15_symmetry", dict(
        leg_record(g, g_s, peak, launches, smi), path_lengths=paths,
        unique_per_sec=g.unique_state_count() / g_s,
        launches_per_step={k: v / g.steps_run for k, v in launches.items()}))
    if (g.unique_state_count(), g.state_count()) != SYM_2PC15:
        raise AssertionError(f"2pc-15 symmetry: not {SYM_2PC15}")
    del g

    for name, build, want in (
        ("2pc7_symmetry", lambda: TwoPhaseSys(7), SYM_2PC7),
        ("raft3_symmetry", lambda: raft_model(3), SYM_RAFT3),
    ):
        g, g_s, peak, leg_launches = compiled_leg(dev, build, sym=True)
        t0 = time.monotonic()
        c = build().checker().symmetry().spawn_gpu(device="cpu").join()
        c_s = time.monotonic() - t0
        same, tail = same_tables_and_queue(g, c)
        paths = check_discoveries(g.model, g, set(g.discovery_fps()))
        g.assert_properties()
        emit(name, dict(leg_record(g, g_s, peak, leg_launches, smi),
                        unique_cpu=c.unique_state_count(),
                        states_cpu=c.state_count(), sec_cpu=c_s, tail=tail,
                        tables_and_queue_identical=same, path_lengths=paths))
        for x in (g, c):
            if (x.unique_state_count(), x.state_count()) != want:
                raise AssertionError(f"{name}: not {want}")
        if not same:
            raise AssertionError(f"{name}: cuda and cpu disagree")

    # -- the user's verb: two_phase_commit check-sym-gpu 5 ------------------
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = two_phase_commit.main(["check-sym-gpu", "5"])
    done = [ln for ln in buf.getvalue().splitlines() if ln.startswith("Done.")]
    emit("cli_check_sym_gpu_5", {"rc": rc, "done": done})
    if rc != 0 or not done or f"unique={SYM_2PC5_UNIQUE}," not in done[0]:
        raise AssertionError(f"check-sym-gpu 5: rc {rc}, {done}")
    return launches


def add_launches(total: dict, more: dict) -> dict:
    return {k: total.get(k, 0) + v for k, v in more.items()}


def checkpoint_phase(dev, smi: str, ref) -> dict:
    """single-copy-4 with autosave and a live checkpoint, stopped, then
    resumed twice on ``cuda``; each resume must end with the uninterrupted
    leg's snapshot ``ref`` (table bytes, cursors, queue rows) and
    discoveries.  Returns the leg's launches (the interrupted run and both
    resumes)."""
    ref_snap, ref_disc = ref
    with tempfile.TemporaryDirectory(prefix="autosave-sc4-") as root:
        reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.monotonic()
        run = single_copy_model(4).checker().autosave(
            root, every_secs=CKPT_EVERY_SECS, keep=CKPT_KEEP,
        ).spawn_gpu(steps_per_call=CKPT_STEPS_PER_CALL)
        deadline = time.monotonic() + 120
        while run.unique_state_count() < CKPT_AT_UNIQUE:
            if run.is_done() or time.monotonic() > deadline:
                raise AssertionError("checkpoint_sc4: no mid-run sync seen")
            time.sleep(0.01)
        t_ask = time.monotonic()
        live = run.checkpoint(timeout=120)
        t_live = time.monotonic() - t_ask
        if not (0 < int(live["unique"]) < SC4[0]
                and int(live["head"]) < int(live["tail"])):
            raise AssertionError("checkpoint_sc4: the live snapshot is not "
                                 "mid-run")
        while ckpt.latest_gen_number(root) is None:
            if run.is_done() or time.monotonic() > deadline:
                raise AssertionError("checkpoint_sc4: no generation on disk")
            time.sleep(0.01)
        run.stop().join()
        torch.cuda.synchronize()
        run_s = time.monotonic() - t0
        launches = kernel_launches()
        if not all(v > 0 for v in launches.values()):
            raise AssertionError(f"checkpoint_sc4: a kernel never launched: "
                                 f"{launches}")
        gens = ckpt.list_generations(root)
        if not gens or len(gens) > CKPT_KEEP:
            raise AssertionError(f"checkpoint_sc4: {len(gens)} generations")
        latest = ckpt.latest_generation(root)
        gen_bytes = os.path.getsize(os.path.join(gens[-1]["path"],
                                                 "snapshot.npz"))
        stopped_at = (run.unique_state_count(), run.state_count())
        buf = io.BytesIO()
        np.savez(buf, **live)
        buf.seek(0)
        with np.load(buf) as z:
            live_loaded = {k: z[k] for k in z.files}
        resumes = {}
        for name, snap in (("live", live_loaded), ("generation", latest[0])):
            reset_launches()
            torch.cuda.synchronize()
            t1 = time.monotonic()
            r = single_copy_model(4).checker().spawn_gpu(resume=snap).join()
            torch.cuda.synchronize()
            r_s = time.monotonic() - t1
            r_launches = kernel_launches()
            launches = add_launches(launches, r_launches)
            same, tail = same_snapshots(r.final_snapshot(), ref_snap)
            resumes[name] = {
                "from_unique": int(snap["unique"]),
                "unique": r.unique_state_count(), "states": r.state_count(),
                "sec": r_s, "tail": tail,
                "tables_and_queue_identical": same,
                "discoveries_identical": r.discovery_fps() == ref_disc,
                "launches": r_launches}
            if (r.unique_state_count(), r.state_count()) != SC4:
                raise AssertionError(f"checkpoint_sc4 ({name}): not {SC4}")
            if not same or r.discovery_fps() != ref_disc:
                raise AssertionError(f"checkpoint_sc4 ({name}): the resumed "
                                     "run differs from the uninterrupted one")
            if not all(r_launches[k] > 0 for k in
                       ("cand_prep", "bucket_plan", "insert_commit")):
                raise AssertionError(f"checkpoint_sc4 ({name}): a step kernel "
                                     f"never launched: {r_launches}")
            del r
    saves = run.autosave_secs
    emit("checkpoint_sc4", {
        "steps_per_call": CKPT_STEPS_PER_CALL,
        "every_secs": CKPT_EVERY_SECS, "keep": CKPT_KEEP,
        "table_slots": run._cap, "batch": run._batch, "cand": run._cand,
        "interrupted": {"sec": run_s, "stopped_at": stopped_at,
                        "live_unique": int(live["unique"]),
                        "live_head": int(live["head"]),
                        "live_tail": int(live["tail"]),
                        "live_checkpoint_sec": t_live,
                        "generations_written": len(saves),
                        "generations_left": [g["gen"] for g in gens],
                        "peak_device_mib":
                            torch.cuda.max_memory_allocated(dev) / 2**20},
        "save_snapshot_sec": [a for a, _ in saves],
        "save_write_sec": [b for _, b in saves],
        "save_sec_mean": sum(a + b for a, b in saves) / len(saves),
        "generation_bytes": gen_bytes,
        "generation_table_slots": int(latest[0]["cap"]),
        "generation_queue_rows": int(latest[0]["q_rows"].shape[0]),
        "generation_unique": int(latest[0]["unique"]),
        "resumed": resumes, "launches": launches, "card": smi})
    return launches


def auto_phase(dev, smi: str) -> dict:
    """``spawn_auto`` escalating to the card at 2pc-7 and staying on the
    host probe at 2pc-3; returns the 2pc-7 run's launches."""
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    g = TwoPhaseSys(7).checker().spawn_auto(probe_secs=0.5)
    if not isinstance(g, GpuChecker) or g.device.type != "cuda":
        raise AssertionError(f"auto_2pc7: stayed on {type(g).__name__}")
    g.join()
    torch.cuda.synchronize()
    g_s = time.monotonic() - t0
    launches = kernel_launches()
    paths = check_discoveries(g.model, g, {"abort agreement",
                                           "commit agreement"})
    g.assert_properties()
    reset_launches()
    h = TwoPhaseSys(3).checker().spawn_auto()
    host_launches = kernel_launches()
    emit("auto_2pc7", {
        "engine": type(g).__name__, "device": str(g.device),
        "unique": g.unique_state_count(), "states": g.state_count(),
        "sec": g_s, "path_lengths": paths, "launches": launches,
        "small": {"engine": type(h).__name__,
                  "unique": h.unique_state_count(),
                  "launches": host_launches},
        "card": smi})
    if g.unique_state_count() != TPC7_UNIQUE:
        raise AssertionError(f"auto_2pc7: not {TPC7_UNIQUE}")
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"auto_2pc7: a kernel never launched: {launches}")
    if not isinstance(h, BfsChecker) or h.unique_state_count() != 288:
        raise AssertionError("auto 2pc-3: did not finish on the host probe")
    if any(host_launches.values()):
        raise AssertionError(f"auto 2pc-3 launched kernels: {host_launches}")
    return launches


def orl_phase(dev, smi: str) -> tuple[dict, dict]:
    """The ORL sender/receiver on ``cuda`` and ``cpu``; returns the cuda
    run's launches, and each kernel against its plain version on the next
    batch of a cuda run bounded at ``ORL_KERNEL_TARGET``."""
    g, g_s, peak, launches = compiled_leg(dev, orl_model)
    c = orl_model().checker().spawn_gpu(device="cpu").join()
    same, tail = same_tables_and_queue(g, c)
    paths = check_discoveries(g.model, g, {"delivered"})
    g.assert_properties()  # neither "no redelivery" nor "ordered" violated
    h = orl_model().checker().spawn_bfs().join()
    h.assert_discovery("delivered",
                       list(g.discovery("delivered").actions()))
    emit("orl", dict(leg_record(g, g_s, peak, launches, smi),
                     unique_cpu=c.unique_state_count(),
                     states_cpu=c.state_count(), unique_host_bfs=
                     h.unique_state_count(), tail=tail,
                     tables_and_queue_identical=same, path_lengths=paths))
    for x in (g, c, h):
        if x.unique_state_count() != ORL_UNIQUE:
            raise AssertionError(f"orl: not {ORL_UNIQUE}")
    if not same:
        raise AssertionError("orl: cuda and cpu disagree")
    gk = orl_model().checker().target_states(ORL_KERNEL_TARGET).spawn_gpu()
    gk.join()
    kernels = check_kernels(gk, gk._final_carry, cold=True)
    for name, k in kernels.items():
        emit(f"kernel_{name}_orl", k)
    return launches, kernels


def profiled_sync_count(dev, run) -> tuple:
    """``run()`` under ``torch.profiler`` (CPU and CUDA activities): its
    result and the count of each CUDA runtime call that waits for the
    device or copies to the host."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize(dev)
    return out, host_sync_counts(prof.key_averages())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    start = _LAP[0] = time.monotonic()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    emit("card", {"nvidia_smi": smi, "torch": torch.__version__,
                  "cuda": torch.version.cuda,
                  "name": torch.cuda.get_device_name(0)})
    t0 = time.monotonic()
    _cuda.library()
    emit("build", {"seconds": time.monotonic() - t0,
                   "sources": [str(s.relative_to(_cuda.CSRC.parent.parent))
                               for s in _cuda.sources()]})
    lap("build")

    # -- kernels at 2pc-7 shapes -------------------------------------------
    b7, _ = timed_run(7, target=100_000)
    kernels = check_kernels(b7, b7._final_carry, cold=False)
    for name, k in kernels.items():
        emit(f"kernel_{name}", k)
    del b7
    lap("kernels_2pc7")

    # -- 2pc-5 on cuda and cpu: same counts, same table bytes ---------------
    g5, g5_s = timed_run(5)
    c5 = TwoPhaseSys(5).checker().spawn_gpu(device="cpu").join()
    gt, ct = g5._table_np(), c5._table_np()
    same = all((a == b).all() and a.shape == b.shape for a, b in zip(gt, ct))
    emit("2pc5", {"unique_cuda": g5.unique_state_count(),
                  "unique_cpu": c5.unique_state_count(),
                  "states": g5.state_count(), "table_slots": int(gt[0].size),
                  "tables_identical": bool(same), "sec_cuda": g5_s})
    if not (same and g5.unique_state_count() == c5.unique_state_count() == 8832):
        raise AssertionError("2pc-5: cuda and cpu disagree")
    lap("2pc5")

    # -- 2pc-7, complete: the main path's launch counts ----------------------
    reset_launches()
    g7, g7_s = timed_run(7)
    launches = kernel_launches()
    model7 = g7.model
    paths = check_discoveries(
        model7, g7, {"abort agreement", "commit agreement"}
    )
    g7.assert_properties()
    emit("2pc7", {"unique": g7.unique_state_count(),
                  "states": g7.state_count(), "depth": g7.max_depth(),
                  "sec": g7_s, "states_per_sec": g7.state_count() / g7_s,
                  "unique_per_sec": g7.unique_state_count() / g7_s,
                  "table_slots": g7._cap, "cand": g7._cand,
                  "growth_events": g7.growth_events,
                  "path_lengths": paths, "launches": launches,
                  "card": smi})
    if g7.unique_state_count() != 296_448:
        raise AssertionError("2pc-7: unique count is not 296,448")
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"a kernel never launched on 2pc-7: {launches}")
    lap("2pc7")

    # -- 2pc-10, target-bounded ----------------------------------------------
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    g10, g10_s = timed_run(10, target=TPC10_TARGET)
    peak = torch.cuda.max_memory_allocated(dev)
    launches10 = kernel_launches()
    paths10 = check_discoveries(g10.model, g10, set(g10.discovery_fps()))
    emit("2pc10", {"target": TPC10_TARGET, "unique": g10.unique_state_count(),
                   "states": g10.state_count(), "depth": g10.max_depth(),
                   "sec": g10_s, "states_per_sec": g10.state_count() / g10_s,
                   "unique_per_sec": g10.unique_state_count() / g10_s,
                   "table_slots": g10._cap,
                   "table_mib": g10._cap * 16 / 2**20,
                   "peak_device_mib": peak / 2**20, "cand": g10._cand,
                   "discoveries": paths10, "launches": launches10,
                   "card": smi})
    if g10.unique_state_count() < TPC10_TARGET:
        raise AssertionError("2pc-10: stopped short of the target")
    if "consistent" in paths10:
        raise AssertionError("2pc-10: consistent violated")
    if not all(v > 0 for v in launches10.values()):
        raise AssertionError(f"a kernel never launched on 2pc-10: {launches10}")
    lap("2pc10")

    # -- kernels at 2pc-10 shapes, L2-cold -----------------------------------
    kernels10 = check_kernels(g10, g10._final_carry, cold=True)
    for name, k in kernels10.items():
        emit(f"kernel_{name}_2pc10", k)
    del g10
    lap("kernels_2pc10")

    p3_ref = paxos_phases(dev, smi)
    lap("paxos2_and_paxos3")
    launches_p3f, launches_p2f, launches_sym7f = flag_phases(dev, smi, p3_ref)
    lap("step_flags")
    # -- kernels at paxos-3 shapes, L2-cold: plain, and the same batch as a
    # .prededup() step gives it (the queue holds the same rows with the
    # flag on or off) ---------------------------------------------------------
    gp, _ = timed_run(3, target=PAXOS3_KERNEL_TARGET, model=paxos_model)
    kernels_p3 = check_kernels(gp, gp._final_carry, cold=True)
    for name, k in kernels_p3.items():
        emit(f"kernel_{name}_paxos3", k)
    kernels_p3f = check_kernels(gp, gp._final_carry, cold=True,
                                flags=PREDEDUP)
    for name, k in kernels_p3f.items():
        emit(f"kernel_{name}_paxos3_prededup", k)
    del gp
    lap("kernels_paxos3")

    launches_sc4, sc4_ref = compiled_phases(dev, smi)
    lap("compiled_twins")
    # -- host syncs per block: single-copy-4 with no growth, profiled -------
    # the same bounded run at two block lengths: the difference in
    # cudaStreamSynchronize over the difference in blocks is the count per
    # block; what is left is the run's constant (the twin's tables and the
    # init rows going to the card, the first stats read)
    sync_runs = {}
    for spc in SYNC_STEPS_PER_CALL:
        (gsy, gsy_s), syncs = profiled_sync_count(dev, lambda spc=spc: timed_run(
            4, target=SC4_SYNC_TARGET, model=single_copy_model,
            capacity=SC4_SYNC_CAPACITY, steps_per_call=spc))
        if gsy.growth_events:
            raise AssertionError("the sync count's run grew: it must not")
        sync_runs[spc] = {
            "unique": gsy.unique_state_count(), "steps": gsy.steps_run,
            "blocks": -(-gsy.steps_run // spc), "calls": syncs,
            "stream_syncs": syncs.get("cudaStreamSynchronize", 0),
            "sec_profiled": gsy_s}
        del gsy
    a, b = (sync_runs[spc] for spc in SYNC_STEPS_PER_CALL)
    per_block = ((b["stream_syncs"] - a["stream_syncs"])
                 / (b["blocks"] - a["blocks"]))
    emit("singlecopy4_host_syncs", {
        "target": SC4_SYNC_TARGET, "capacity": SC4_SYNC_CAPACITY,
        "runs": {str(k): v for k, v in sync_runs.items()},
        "stream_syncs_per_block": per_block,
        "stream_syncs_per_run": a["stream_syncs"] - per_block * a["blocks"],
        "card": smi})
    lap("singlecopy4_host_syncs")
    # -- kernels at single-copy-4 shapes, L2-cold -----------------------------
    gs4, _ = timed_run(4, target=SC4_KERNEL_TARGET, model=single_copy_model)
    kernels_sc4 = check_kernels(gs4, gs4._final_carry, cold=True)
    for name, k in kernels_sc4.items():
        emit(f"kernel_{name}_singlecopy4", k)
    del gs4
    lap("kernels_singlecopy4")

    launches_p2pc = channel_and_history_phases(dev, smi)
    lap("per_channel_and_histories")
    # -- kernels at per-channel paxos-2 shapes (W = 83), L2-cold -------------
    gp2 = per_channel_paxos2().checker().target_states(
        P2_PER_CHANNEL_KERNEL_TARGET).spawn_gpu(**P2_PER_CHANNEL_KW).join()
    kernels_p2pc = check_kernels(gp2, gp2._final_carry, cold=True)
    for name, k in kernels_p2pc.items():
        emit(f"kernel_{name}_paxos2_per_channel", k)
    del gp2
    lap("kernels_paxos2_per_channel")

    launches_sym = symmetry_phases(dev, smi)
    lap("symmetry")
    # -- kernels at 2pc-15 symmetry shapes, L2-cold ---------------------------
    gs15 = TwoPhaseSys(15).checker().symmetry().target_states(
        SYM_2PC15_KERNEL_TARGET).spawn_gpu().join()
    kernels_sym = check_kernels(gs15, gs15._final_carry, cold=True, sym=True)
    for name, k in kernels_sym.items():
        emit(f"kernel_{name}_2pc15_symmetry", k)
    del gs15
    lap("kernels_2pc15_symmetry")

    launches_ckpt = checkpoint_phase(dev, smi, sc4_ref)
    del sc4_ref
    lap("checkpoint_sc4")
    launches_auto = auto_phase(dev, smi)
    lap("auto_2pc7")
    launches_orl, kernels_orl = orl_phase(dev, smi)
    lap("orl")

    bad = [f"{k['name']} at {shape}"
           for shape, ks in (("2pc-7", kernels), ("2pc-10", kernels10),
                             ("paxos-3", kernels_p3),
                             ("paxos-3 prededup", kernels_p3f),
                             ("single-copy-4", kernels_sc4),
                             ("per-channel paxos-2", kernels_p2pc),
                             ("2pc-15 symmetry", kernels_sym),
                             ("orl", kernels_orl))
           for k in ks.values() if not k["matched"]]
    if bad:
        raise AssertionError(f"kernel disagrees with plain: {bad}")

    line = []
    for name, k in kernels.items():
        k["launches"] = launches[name]
        entry = {key: k[key] for key in KERNEL_KEYS}
        for tag, ks in (("at_2pc10", kernels10), ("at_paxos3", kernels_p3),
                        ("at_singlecopy4", kernels_sc4),
                        ("at_paxos2_per_channel", kernels_p2pc)):
            entry[tag] = {key: ks[name][key] for key in KERNEL_KEYS
                          if key not in ("name", "route", "source",
                                         "replaces", "launches")}
        entry["at_singlecopy4"]["launches"] = launches_sc4[name]
        entry["at_paxos2_per_channel"]["launches"] = launches_p2pc[name]
        # the slice's main path: 2pc-15 under symmetry, its own launches
        entry["at_2pc15_symmetry"] = dict(
            {key: kernels_sym[name][key] for key in KERNEL_KEYS
             if key not in ("route", "source", "launches")},
            launches=launches_sym[name])
        for tag, leg in (("at_checkpoint_sc4", launches_ckpt),
                         ("at_auto_2pc7", launches_auto)):
            entry[tag] = {"launches": leg[name]}
        entry["at_orl"] = dict(
            {key: kernels_orl[name][key] for key in KERNEL_KEYS
             if key not in ("name", "route", "source", "replaces",
                            "launches")},
            launches=launches_orl[name])
        # the pre-dedup: paxos-3 under .prededup() with its kernel cell,
        # and the other prededup legs' launches
        entry["at_paxos3_prededup"] = dict(
            {key: kernels_p3f[name][key] for key in KERNEL_KEYS
             if key not in ("name", "route", "source", "replaces",
                            "launches")},
            launches=launches_p3f[name])
        for leg, ls in launches_p2f.items():
            entry[f"at_{leg}"] = {"launches": ls[name]}
        entry["at_2pc7_symmetry_prededup"] = {"launches": launches_sym7f[name]}
        line.append(entry)
    gen = kernels_sym["bucket_plan"]  # the new mode, as a kernel of its own
    line.append(dict({key: gen[key] for key in KERNEL_KEYS
                      if key != "launches"},
                     launches=launches_sym["bucket_plan"]))
    emit("total", {"seconds": time.monotonic() - start,
                   "phase_seconds": PHASES})
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(RECORD, indent=1))
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
