"""Chip smoke test of the PyTorch/CUDA port (``stateright_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``stateright_tpu_torch/csrc``
(``cand_prep``, ``row_hash``, ``bucket_plan`` with its two entries, the
fused one of the engines' step, ``bucket_plan_fused``, and the
pre-gathered one of the sharded engine, ``insert_commit``), holds each
against its plain PyTorch version on the card (integer outputs: they must
be equal on every lane), times both, and drives the port's main path
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
   launched), and bounded at 4,000 unique on ``cuda`` and ``cpu`` with
   identical counts, table bytes and queue rows; ABD(2,2,put_count=2)
   (2,980 unique) and the write-once register
   wo(2,1) (71 unique) on ``cuda`` and ``cpu``, identical likewise;
 - kernels at per-channel paxos-2 shapes (W = 83): the next batch of a run
   bounded at 8,000 unique, L2 flushed before every timed call;
 - symmetry reduction (``.symmetry().spawn_gpu()``: canonical keys through
   ``representative_rows``, ``bucket_plan_fused`` in generation order, two
   launches a step): 2pc-15 complete on ``cuda`` (654,198 classes,
   10,982,530 states, both agreement discoveries replayed through the
   class-matching walk, ``consistent`` never violated, every kernel
   launched, with its wall time, states/s, steps and launches per step);
   2pc-7 (2,326 / 19,758) and raft-3 (2,926 / 7,917, the compiler's
   mechanical symmetry) on ``cuda`` and on ``cpu``, with identical table
   bytes and queue rows; the ``two_phase_commit check-sym-gpu 5`` verb
   (508 classes);
 - the generation-order ``bucket_plan_fused`` at 2pc-15 symmetry shapes: the next
   batch of a 2pc-15 symmetry run bounded at 300,000 classes (canonical
   rows through ``cand_prep``), L2 flushed before every timed call, and the
   table-order plan on the same batch beside it.

The block graph (``ops/block_loop.py``, ``csrc/block_loop.cu``): on the
card every single-device block above is one launch of a CUDA graph whose
conditional WHILE node the ``block_cond`` kernel stops, so each leg's
record gives ``steps_executed`` beside ``steps`` (blocks times
``steps_per_call``) and its block graphs (capture seconds, node counts,
pool bytes).  ``block_graph``, right after the 2pc-10 kernel cell: for
2pc-5, paxos-2, 2pc-4 under symmetry, 2pc-5 under ``.prededup()``,
``.cartography()``, ``.checked()`` and ``.spill()`` (its Bloom words all
ones, so every candidate defers), per-channel paxos-1 under ``.por()``,
and 2pc-5 stopped by a target and by a discovery, a complete run (its
executed and issued steps) and then, from a fresh engine's init carry,
complete and at capacities that stop on a growth status, block after
block the graph block against the eager loop ``_Engine._run_steps`` on
the same carry, bit for bit (every carry entry, the stats and the
executed steps ``k``), with each leg's capture seconds and the host's
operations a block on both paths; then ``block_cond`` against its plain
version on every leg's last carry at every ``k`` (the ``block_cond``
entry of the kernels line, with the 2pc-7 leg's launches).

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

The sharded engine (``spawn_gpu(devices=N)``, ``parallel/sharded.py``;
each leg's launch counts reset just before it and read just after), after
the service legs:

 - ``sharded_2pc7``: ``TwoPhaseSys(7)`` over 8 shards on ``cuda``: the
   plain 2pc-7 leg's 296,448 unique, state count and discoveries, and its
   visited set (every parent present); the wall, the growth events, each
   shard's load and the imbalance summary, the launches (``row_hash``,
   ``bucket_plan``, ``insert_commit``; ``cand_prep`` is not on this
   path), and the operations a step at 1, 4 and 8 shards (2pc-7 bounded
   at 20,000);
 - the kernel cells of a sharded step: the next step of a 2pc-7 run over
   8 shards bounded at 100,000 unique, ``row_hash`` on its source batch,
   ``bucket_plan`` and ``insert_commit``'s table write on its owners'
   batch, each against its plain version (``at_sharded_2pc7``);
 - ``sharded_2pc5_parity``: 2pc-5 over 4 shards on ``cuda`` and ``cpu``,
   equal snapshots (tables and frontiers shard for shard);
 - ``sharded_paxos3``: paxos-3 (W = 33) over 4 shards bounded at 200,000
   unique: every fingerprint in the shard ``lshr(fp, 32) % 4``, none
   twice, every parent present;
 - ``nccl_one_rank``: an NCCL process group of one rank holding 4 shards
   (the collectives' path: ``all_to_all_single``, ``all_reduce``,
   ``all_gather``): 2pc-5 at 8,832.  The machine has one card, and NCCL
   refuses two ranks on one device, so no leg runs two ranks here.

The pre-dedup (``.prededup()``, through the CLI's ``--prededup``; each
leg's launch counts reset just before it and read just after), right
after the plain paxos legs:

 - ``paxos3_prededup``: paxos-3 under ``.prededup()`` (the dedup's
   ``row_hash`` launch every step, ``window_unique``), bounded at 600,000
   unique (its complete counts are the plain paxos-3 leg's and the
   telemetry leg's): the plain leg's discoveries, the share of valid lanes
   the pre-dedup took out and the launches per step; then, against the
   plain run bounded at the same target that the paxos-3 kernel cells
   take their batch from, the same unique and state counts, steps, table
   bytes and queue rows;
 - paxos-2 complete under the flag on ``cuda`` and ``cpu``: identical
   table bytes and queue rows ``[0, tail)``; per-channel paxos-2
   (``capacity=1 << 16``, ``batch=512``) complete on ``cuda``: 16,668 /
   32,971;
 - 2pc-7 under ``.symmetry().prededup()`` on ``cuda`` and ``cpu``: 2,326 /
   19,758, identical likewise;
 - the paxos-3 kernel cell's batch again as a prededup step gives it
   (``row_hash`` on the step's valid rows, ``cand_prep`` on their first
   occurrences), every kernel against its plain version.

The telemetry slice (``stateright_tpu_torch/telemetry/``, the
cartography counters in the step), right after the plain paxos legs, each
leg's launch counts reset just before it and read just after:

 - ``telemetry_paxos3``: paxos-3 complete under ``.telemetry(capacity=
   2048, cartography=True, memory=True, roofline=True).report(PATH)
   .runs(DIR)`` (the JAX package's bench configuration,
   ``bench.py:767-771``): 1,194,428 / 2,420,477; ``sum(depth_hist) == unique``,
   ``sum(action_hist) == states - 1`` and every property evaluated
   ``unique`` times; the memory ledger's analytic bytes equal to the live
   tensors' ``nbytes`` at the final rung, and each growth's forecast
   transient at least the peak measured across it (in tensor bytes
   against ``requested_bytes``, and the allocator's bound against
   ``max_memory_allocated``), for every growth that raised the process's
   peak, and at least one did (the engine never resets the counters);
   every
   kernel launched; its wall, stages, growth seconds and the
   ``torch.cuda.memory_stats`` peak beside the plain paxos-3 leg's wall,
   and the dispatched operations a step with cartography off and on
   (bounded paxos-3 runs); then the same bounded paxos-3 run with
   telemetry on at two block lengths under ``torch.profiler``: one
   ``cudaStreamSynchronize`` a block;
 - ``roofline_paxos3``: that run's roofline ledger
   (``telemetry/roofline.py``): the spec taken from the card's name (the
   env override unset), each stage's static bytes and FLOPs a step and
   the side of its ridge, the achieved share of the memory and FLOP
   ceilings from the recorder's device seconds, and the ``property`` and
   ``expand`` stages' own shares from the twin's kernels timed on a
   batch of the run's queue; the counts are the plain leg's, and the
   dispatched operations a step are equal with the roofline on and off;
 - ``telemetry_2pc7``: 2pc-7 with ``.report()`` twice on ``cuda`` and
   once on ``cpu``: the two ``cuda`` bodies byte-equal outside
   ``VOLATILE_KEYS``, and the ``cpu``/``cuda`` pair diffing
   ``IDENTICAL`` or ``PERF-ONLY`` with no violation;
 - ``profile_2pc7``: 2pc-7 under ``.telemetry(profile_steps=2)`` (blocks
   of 8 steps): the ``torch.profiler`` trace is written and, the blocks
   being block graphs, traces the CPU only, its ``start`` event giving
   the reason (``ops.block_loop.CUPTI_FAULT``).

Checked mode and the spill tier (``.checked()``, ``.spill()``), right
after the pre-dedup legs, each leg's launch counts reset just before it
and read just after:

 - ``checked_2pc7``: 2pc-7 complete under ``.checked()`` (the guard around
   the twin's kernels): 296,448 unique with the plain leg's state count
   and discoveries, its wall beside the plain leg's, and one
   ``cudaStreamSynchronize`` a block (2pc-7 bounded at 100,000 under the
   profiler at two block lengths);
 - ``checked_paxos2``: paxos-2 under ``.checked()`` on ``cuda`` and
   ``cpu``: 16,668 / 32,971, identical table bytes and queue rows (no
   false flag through ``PaxosTensor``'s gathers);
 - ``checked_oob``: the JAX sanitizer tests' out-of-range twin under
   ``.skip_audit().checked()`` (the preflight would refuse it) raises ``CheckedExecutionError`` naming state 4 and
   "out-of-bounds", and a 2pc-3 run afterwards in the same process still
   gives 288: no device-side assert fired;
 - ``spill_2pc5``: the JAX 2pc-5 spill runs (``tests/test_spill.py:
   259-296`` and :376-424: capacity 2^12, batch 128, queue 4,096, a
   2^14-bit Bloom filter, blocks of 8, cartography and the memory ledger)
   under a budget of ``tot(2^13) + tot(2^14) - 1`` from the port's own
   analytic buffers: 8,832 / 58,146 (the JAX pins), the plain 2pc-5 leg's
   state count and discoveries, at least one eviction, hot + spilled =
   unique, cartography reconciled; the same run on ``cpu`` (its own
   budget) with identical tables, queue rows, store and tallies; a live
   ``checkpoint()`` after the first eviction resumed on ``cuda`` to the
   uninterrupted run's tables and store;
 - ``spill_paxos3``: paxos-3 under ``.spill()`` with a budget that blocks
   the 2^21 -> 2^22 table growth: 1,194,428 / 2,420,477, "value chosen"
   replayed, "linearizable" never violated, at least one eviction, with
   its tallies, inject calls and wall beside the plain paxos-3 leg's;
 - on the first spill inject of each spill leg's ``cuda`` run that
   inserts something (its inputs kept by :func:`first_inject`: the hot
   table before it and the ``pend_cap`` lanes), ``bucket_plan_fused`` and
   ``insert_commit`` against their plain versions, L2-cold, with their
   times and bounds (``kernel_*_spill_2pc5_inject``,
   ``kernel_*_spill_paxos3_inject``);
 - the dispatched operations a step at 2pc-7 and paxos-3 with each flag
   off and on.

Partial-order reduction (``.por()``, through the CLI's ``--por``: the
footprint pass on the captured step graph, the plan, the ample round and
the proviso round), right after the per-channel legs, each leg's launch
counts reset just before it and read just after:

 - ``por_pc_paxos2``: the plan of per-channel paxos-2 (W = 83, A = 82:
   1,092 independent pairs, conflict sum 4,540, 38 visible actions, two
   conjuncts, and the digest ``tests/test_torch_por_wide.py`` recomputes
   from the JAX plan) with its host seconds; the run under
   ``.por()`` at the JAX pin's capacity and batch (2^15, 256; the reduced
   count depends on where the batches break): 16,258 unique, 31,435
   states, the discoveries of a full run at the same capacity and batch
   (whose wall it is compared with) replayed, "linearizable" never
   violated, rows reduced; the dispatched operations a step with the flag off and on (the
   first 8 steps of runs bounded at 4,000); ``ample_mask``'s device time
   on the next batch of a run bounded at 8,000;
 - the proviso round that inserts the most in a POR run bounded at 8,000
   (its inputs kept by :func:`proviso_round`): ``cand_prep``,
   ``bucket_plan_fused`` and ``insert_commit`` against their plain versions,
   L2-cold (``at_por_proviso`` in the kernels line);
 - ``por_2pc7``: 2pc-7 under ``.por()``: nothing reduces, and the tables,
   queue rows, state count and discoveries are the plain 2pc-7 leg's;
 - ``por_pc_paxos1``: per-channel paxos-1 under ``.por()`` on ``cuda`` and
   ``cpu``: 250 / 437, the same tables, queue rows and tallies.

The supervisor, the fault layer and the audit, last, each leg's launch
counts reset just before it and read just after:

 - ``supervise_2pc7_kill``: ``TwoPhaseSys(7)`` under ``supervise`` on the
   card, autosaving at every sync into a temp dir, killed by a
   ``host_sync`` fault at sync 8 of 18: one restart (``preemption``), the
   ``fault`` and ``restart`` records, and 296,448 with the plain 2pc-7
   leg's state count, discoveries, table bytes and queue rows; the
   restart's seconds from the failure to the resumed run's first block;
 - ``supervise_oom_real``: in a child process (``--oom-child``), so no
   other leg sees the limit, 2pc-7 at batch 512 under
   ``torch.cuda.set_per_process_memory_fraction`` set between the memory
   ledger's footprint of the last table rung and its growth's transient:
   a real ``torch.OutOfMemoryError`` classified ``oom``, the spill tier
   armed under a pinned budget, at least one eviction, 296,448; the child
   prints one JSON line, every trial wall in it;
 - ``supervise_sigkill``: ``python -m
   stateright_tpu_torch.models.two_phase_commit supervise 7 --autosave=D
   --runs=R --every=0 --fault-plan=P`` dies by SIGKILL at sync 8;
   ``python -m stateright_tpu_torch.models._cli status D`` prints the
   heartbeat it left; the same command without the plan resumes, archives
   the parent's stub and ends at 296,448 with its ``parent_run_id``; and
   ``compare PARENT CHILD --registry=R --expect=IDENTICAL`` exits 0;
 - ``audit``: the fleet audit and the fleet sanitizer are clean, and
   the light preflight's host seconds per spawn (the kernel audit, the
   static sanitizer, the handler lint and the config rules) at 2pc-7,
   paxos-3, single-copy-4 and per-channel paxos-2, uncached and cached;
 - ``preflight_oob``: the out-of-range twin spawned on ``cuda`` without
   ``skip_audit()``: the preflight raises ``AuditError`` naming JX201
   before any kernel launches (every count 0), and a 2pc-3 run
   afterwards in the same process gives 288.

Each kernel cell also holds ``row_hash`` on that model's init rows, the
only rows an unflagged main path gives it (``init_rows`` in its record),
and the ``total`` record gives each phase's wall seconds.  Each bound is
the kernel's count (``analysis/costmodel.py::kernel_cost``, the count the
cost model charges the stages) over the card's rates in
``telemetry/roofline.py``'s spec table (H100 SXM).

Any failure raises (non-zero exit).  The second-to-last line of standard
output is the ``{"kernels": [...]}`` record (2pc-7 shapes, with the 2pc-10
numbers under ``at_2pc10``, the paxos-3 ones under ``at_paxos3``, the
single-copy-4 ones, with that run's launches, under ``at_singlecopy4``,
and the per-channel paxos-2 ones, with that run's launches, under
``at_paxos2_per_channel``; every kernel entry also gives the launches of the last
three legs under ``at_checkpoint_sc4``, ``at_auto_2pc7`` and ``at_orl``,
the last with the ORL kernel records beside them, and the prededup legs'
under ``at_paxos3_prededup`` (with the prededup kernel cell's records),
``at_paxos2_prededup``, ``at_paxos2_per_channel_prededup`` and
``at_2pc7_symmetry_prededup``, and the telemetry legs' under
``at_telemetry_paxos3``, ``at_telemetry_2pc7`` and ``at_profile_2pc7``,
and the checked and spill legs' under ``at_checked_2pc7``,
``at_checked_paxos2``, ``at_spill_2pc5`` and ``at_spill_paxos3``, the spill
inject's own launches beside them as ``inject_launches``, and for
``bucket_plan_fused`` and ``insert_commit`` the inject cells' records, with the
inject's launches, under ``at_spill_2pc5_inject`` and
``at_spill_paxos3_inject``; and the supervisor's and the audit's legs'
under ``at_supervise_2pc7_kill``, ``at_supervise_oom_real``,
``at_supervise_sigkill``, the resumed run's, the killed run's being lost
with its process, ``at_audit`` and ``at_preflight_oob`` (all 0); and
the POR legs' under
``at_por_pc_paxos2``, ``at_por_2pc7`` and ``at_por_pc_paxos1``, with the
proviso round's cells for ``cand_prep``, ``bucket_plan_fused`` and
``insert_commit`` under ``at_por_proviso``, and the sweep legs' under
``at_sweep_2pc7_seeds``, ``at_sweep_paxos_family`` and ``at_sweep_lifted``,
and the service legs' under ``at_explorer_2pc7``, ``at_fleet_canned`` and
``at_fleet_2pc7_pack`` (summed over the fleet's slots);
then two more entries, ``cand_prep_namespace`` and ``insert_commit_tags``,
the sweep's kernel modes, with the 2pc-7 seed sweep's launches; then
``bucket_plan_fused`` in generation order at 2pc-15 symmetry shapes, with
the 2pc-15 symmetry run's launches; then the pre-gathered ``bucket_plan``
entry, the sharded engine's, with the sharded step's cell and the
sharded legs' launches; the insert's window mode follows)
and the last line is ``{"ok": true, "device": {...}}``.  The plan a
step ran before the fused entry (the sort's tail and the pre-gathered
launch) is timed beside it by ``kernel_ab.py``, not here.

The sweep legs (``stateright_tpu_torch/sweep/``; each leg's launch counts
reset just before it and read just after), last:

 - ``sweep_2pc7_seeds``: ``TwoPhaseSys(7)`` under 8 table seeds in one
   table (``.sweep(spec).spawn_gpu()``, batch 16,384, a 2^24-slot table):
   2,371,584 unique, every member at the plain 2pc-7 leg's unique and
   state counts and discovery names, every member's traces replayed
   through the object model; the wall against 8 times the plain leg's,
   operations a step over the first 8 steps, growth events, peak memory;
   ``cand_prep``'s namespace mode and ``insert_commit``'s tag column
   against their plain versions on its first inserting batch;
 - ``sweep_paxos_family``: ``python -m stateright_tpu_torch.models.paxos
   sweep 8`` on ``cuda`` (8 instances over 2 cohorts, at 265 / 482 / 13
   and 2,378 / 8,197 / 14), and ``sweep_family(4)`` on ``cuda`` and
   ``cpu`` with equal tables, queue rows and instance tags;
 - ``sweep_lifted``: the bounded-counter cohort, bounds 1-8, on ``cuda``
   and ``cpu``: one unified cohort, ``(b + 1)^2`` unique and depth ``2b``
   per member, equal tables, and the ``vmap`` fallback warnings the lifted
   cohort raised on ``cuda``.

The service legs (``explorer.py``, ``fleet/``; each leg's launch counts
reset just before it and read just after, a fleet's summed over its
slots), after the sweep legs:

 - ``explorer_2pc7``: 2pc-7 served by the Explorer
   (``.telemetry(metrics=True, cartography=True).serve(addr,
   strategy="gpu")``, the plain 2pc-7 leg's spawn arguments) while a
   client polls ``/.status``, ``/.metrics`` and ``/metrics`` about 20
   times a second until the run is done: the plain leg's counts and
   launches, both agreement paths answered by ``/.states`` with 200, no
   poll past the 5 s snapshot timeout; the wall against the plain leg's,
   the polls, the ``/.status`` latency (median, maximum) and the seconds
   to the first live discovery;
 - ``fleet_canned``: ``python -m stateright_tpu_torch.models._cli fleet``
   in process (six tenants over two slots, the stall injected into 2pc-5
   at step 5): every tenant at its pin, one packed cohort of three, one
   preemption, the lineage ``IDENTICAL``, exit 0;
 - ``fleet_2pc7_pack``: two slots; four packable ``TwoPhaseSys(7)``
   tenants in one cohort on the sweep engine (a 2^23-slot table, batch
   16,384), each at the plain 2pc-7 leg's counts, beside
   a paxos-2 singleton that a stall at its fifth step preempts and that
   resumes once at 16,668 / 32,971, its parent and child comparing
   ``IDENTICAL``; the wall against the sum of the plain legs' walls (four
   2pc-7, one paxos-2), the seconds to resume and the launches.

The sharded, mesh, native and UDP legs follow (:func:`sharded_phases`,
:func:`mesh_phases`), and last engine prewarm and the compile cache
(:func:`prewarm_phases`): ``prewarm_2pc7``, 2pc-7 under ``.prewarm()`` at
the plain leg's defaults, equal to the plain leg with every growth rung
built by the prewarm thread, each rung's wait beside the cold run's and
the peak device memory of both; ``compile_cache_2pc3``, a cold ``nvcc``
build of the kernel library into a fresh directory in one child process
and a load from it in a second.

Everything printed is
also written to ``chiprun_out/chip_smoke.json``.  Exits non-zero without a result when no
CUDA device is available.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from stateright_tpu_torch import checkpoint as ckpt
from stateright_tpu_torch import convert
from stateright_tpu_torch.checker.bfs import BfsChecker
from stateright_tpu_torch.ops import _cuda
from stateright_tpu_torch.ops.buckets import (
    SLOTS,
    PlanBuffers,
    bucket_bits,
    bucket_plan,
    bucket_plan_fused,
    bucket_plan_fused_plain,
    bucket_plan_plain,
    key_buckets,
    sort_keys,
    window_unique,
)
from stateright_tpu_torch.ops.cand_prep import (
    PrepBuffers,
    cand_prep,
    cand_prep_plain,
)
from stateright_tpu_torch.ops.block_loop import (
    CUPTI_FAULT, block_cond, block_cond_plain,
)
from stateright_tpu_torch.ops.hashing import EMPTY, row_hash, row_hash_plain
from stateright_tpu_torch.ops.insert_commit import (
    QueueAppend,
    insert_commit,
    insert_commit_plain,
    insert_commit_window,
    insert_commit_window_plain,
)
from stateright_tpu_torch.actor import Network
from stateright_tpu_torch.models.dining import HAS_LEFT, dining_model
from stateright_tpu_torch.models.linearizable_register import abd_model
from stateright_tpu_torch.models.orl import ORL_UNIQUE, orl_model
from stateright_tpu_torch.models.paxos import paxos_model
from stateright_tpu_torch.models.raft import LEADER, raft_model
from stateright_tpu_torch.models import two_phase_commit
from stateright_tpu_torch.models._cli import (
    fleet_audit, fleet_sanitize, with_step_flags,
)
from stateright_tpu_torch.models.single_copy_register import single_copy_model
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.models.write_once_register import wo_register_model
from stateright_tpu_torch.analysis import AuditError, CheckedExecutionError
from stateright_tpu_torch.analysis.costmodel import kernel_cost
from stateright_tpu_torch.core import Model, Property
from stateright_tpu_torch.parallel.tensor_model import (
    BitPacker, TensorBackedModel, TensorModel,
)
from stateright_tpu_torch.parallel.wavefront import GpuChecker, _Engine
from stateright_tpu_torch.profile_run import host_sync_counts
from stateright_tpu_torch.supervisor import supervise
from stateright_tpu_torch.telemetry.diff import (
    IDENTICAL, PERF_ONLY, diff_reports,
)
from stateright_tpu_torch.telemetry.memory import device_memory_stats
from stateright_tpu_torch.telemetry.report import VOLATILE_KEYS
from stateright_tpu_torch.telemetry.roofline import (
    ENV_DEVICE_SPEC, spec_for_name,
)
from stateright_tpu_torch.testing.block_legs import (
    BLOCK_LEGS,
    BLOCK_TARGET,
    OpCount,
    per_channel_paxos,
)
from stateright_tpu_torch.testing.faults import Fault, FaultPlan

# the bound's rates: the H100 SXM entry of the roofline's spec table
# (NVIDIA data sheet): device memory 3.35e12 B/s, and the card's
# non-tensor-core rate (67 TFLOP/s fp32) standing in for its integer rate,
# which the data sheet does not list
H100_SXM = spec_for_name("NVIDIA H100 SXM")
HBM_BYTES_PER_S = H100_SXM["hbm_bytes_per_sec"]
OPS_PER_S = H100_SXM["vpu_peak"]
TPC10_TARGET = 4_000_000
PAXOS3_UNIQUE = 1_194_428  # the JAX engine's complete paxos-3 count
PAXOS3_STATES = 2_420_477
# the step flag of the prededup legs (models/_cli.py's STEP_FLAGS)
PREDEDUP = ("--prededup",)
# the bound of the plain paxos-3 run whose batch the kernel cells take, and
# of the paxos-3 prededup leg (the cut that pays for the service legs: the
# complete prededup run took 19.71 s, and the plain paxos-3 and telemetry
# legs pin the complete counts), which must stop where the plain run does
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
# partial-order reduction: per-channel paxos-2 under por() (unique,
# states) at the JAX pin's capacity and batch (tests/test_per_channel.py:
# 54-61; the reduced count depends on where the batches break, so the
# plain leg's 2^16 slots and 512 rows give another), its plan as the JAX
# package derives it (independent pairs, conflict sum, visible actions,
# conjuncts) and that plan's digest (analysis/independence.plan_digest),
# which tests/test_torch_por_wide.py recomputes from the JAX plan
P2_PER_CHANNEL_POR = (16_258, 31_435)
P2_POR_KW = dict(capacity=1 << 15, batch=256)
PC_PAXOS2_PLAN = dict(independent_pairs=1_092, conflict_sum=4_540,
                      visible=38, conjuncts=2)
PC_PAXOS2_PLAN_DIGEST = "26a0daddf94a1dde"
# per-channel paxos-1 (unique, states) in full and under por()
# (tests/test_per_channel.py:49-50)
P1_PER_CHANNEL = (265, 482)
P1_PER_CHANNEL_POR = (250, 437)
POR = ("--por",)  # the step flag of the POR legs (models/_cli.py)
# the POR operation counts' bound: 8 steps at the leg's batch stay under it
P2_OPS_TARGET = 4_000
P2_PER_CHANNEL_KERNEL_TARGET = 8_000
# the per-channel paxos-2 leg's cuda = cpu bound (the cut that makes room
# for the sharded legs: the cpu run of the complete space took 42.0 s
# beside an H100; the complete cuda run keeps the 16,668 / 32,971 pin)
P2_PER_CHANNEL_CPU_TARGET = 4_000
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
# the supervised 2pc-7 legs: the host sync (of 18 at the default
# capacities) that the kill fires at, mid-run
SUPERVISE_KILL_AT = 8
# where between a rung's footprint and its growth's transient the OOM leg
# puts its wall, in the order tried, and its batch: the spill tier's
# pending and inject buffers grow with the batch, and at the default 2,048
# the armed tier's own buffers outweigh the growth it replaces at 2pc-7
# (65.4 MB against 26.8 MB at the 2^20 rung, the allocator's bound).  At
# batch 512 the degraded run peaked at 53.5 MB allocated against the
# growth's 58.7 MB, and walls at 0.75 and 0.5 of the gap stopped it with
# a second OOM (chip_smoke's first run on an H100): 0.9 goes first
OOM_WALL_SHARES = (0.9, 0.75, 0.5)
OOM_BATCH = 512
# the telemetry legs: the JAX package's bench configuration of the
# recorder (bench.py:767-771, without the roofline), the bounded paxos-3
# runs that count operations a step, and the sync count's paxos-3 runs
# (a table that holds them with no growth event)
TELEMETRY_KW = dict(capacity=2048, cartography=True, memory=True,
                    roofline=True)
OPS_TARGET = 20_000
OPS_STEPS = 8
P3_SYNC_TARGET = 100_000
P3_SYNC_CAPACITY = 1 << 21
# checked mode and the spill tier: the step flags (models/_cli.py's
# STEP_FLAGS), the JAX 2pc-5 spill tests' settings (tests/test_spill.py:
# 53-89: capacity 2^12, batch 128, queue 4,096, a 2^14-bit Bloom filter,
# blocks of 8; the budget admits the 2^13 rung), and paxos-3's queue,
# sized so it never grows
CHECKED = ("--checked",)
SPILL = ("--spill",)
SPILL_BLOOM = 1 << 14
SPILL_2PC5_KW = dict(capacity=1 << 12, batch=128, queue_capacity=4096,
                     spill_bloom_bits=SPILL_BLOOM, steps_per_call=8)
SPILL_2PC5_FIT = 1 << 13
TPC5 = (8_832, 58_146)  # 2pc-5's unique and total states (the JAX pins)
SPILL_P3_QCAP = 1 << 20
SPILL_P3_BLOOM = 1 << 23  # the engine's default width
# the checked sync count's 2pc-7 runs: a candidate budget no batch of
# theirs overflows, so they never grow
CHECKED_SYNC_CAND = 1 << 15
EMPTY_KEY = (1 << 63) - 1  # an EMPTY lane's sorted key, the largest
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
    """The least milliseconds for ``nbytes`` and ``ops`` on the card: the
    larger of the two times, and which one it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


KERNELS = (cand_prep, row_hash, bucket_plan_fused, bucket_plan,
           insert_commit, block_cond)
# the kernels of the engines' step (and init): the pre-gathered
# ``bucket_plan`` entry is the sharded engine's alone
STEP_KERNELS = ("cand_prep", "row_hash", "bucket_plan_fused",
                "insert_commit")
# the single-device engine on the card: its step's kernels and the block
# graph's cond (the mesh, sweep and sharded engines run the eager loop)
GRAPH_KERNELS = STEP_KERNELS + ("block_cond",)


def all_launched(launches: dict, names=GRAPH_KERNELS) -> bool:
    return all(launches[k] > 0 for k in names)


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
    # the engine's order: cand_prep, one stable sort, then the fused plan
    fused = (prep[0], prep[1], *torch.sort(prep[3], stable=True), prep[2],
             prep[5])
    plan = bucket_plan_fused_plain(tfp, *fused, tfp.shape[0] // SLOTS,
                                   generation_order=sym)
    n_new = int(plan[4])
    if n_new == 0:
        raise AssertionError(f"captured batch wrote nothing (overflow="
                             f"{bool(plan[5])}, cand_overflow={bool(prep[5])})")
    queue = QueueAppend(
        carry[convert.QROWS], carry[convert.QFP], carry[convert.QEBITS],
        carry[convert.QDEPTH], carry[convert.TAIL], plan[3], crows,
        carry[convert.QEBITS][span], carry[convert.QDEPTH][span], arity,
    )
    return dict(crows=crows, krows=krows, cvalid=cvalid, hvalid=hvalid,
                pfp=pfp, arity=arity, cb=cb, prep=prep, tfp=tfp, tpl=tpl,
                fused=fused, plan=plan, queue=queue, n_new=n_new)


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


def plan_errors(got, want, nslots: int) -> tuple[int, int]:
    """Disagreements of a plan with its plain version (the planned lanes,
    blocked or not, and both scalars), and the planned count."""
    planned = int((want[0] != nslots).sum())
    errs = [int((g[:planned] != p[:planned]).sum())
            for g, p in zip(got[:4], want[:4])]
    errs += [abs(int(got[4]) - int(want[4])), int(bool(got[5]) != bool(want[5]))]
    return sum(errs), planned


def fused_record(x: dict, cold: bool, stream, sym: bool = False) -> dict:
    """``bucket_plan_fused`` (the engines' plan; in generation order with
    ``sym``) against its plain version on the batch ``x`` of
    :func:`next_batch`."""
    tfp, fused, want = x["tfp"], x["fused"], x["plan"]
    skey, cidx = fused[2], fused[4]
    nb = tfp.shape[0] // SLOTS
    m = skey.shape[0]
    pbuf = PlanBuffers(m, skey.device, sym)
    got = bucket_plan_fused(tfp, *fused, nb, out=pbuf, generation_order=sym)
    err, planned = plan_errors(got, want, tfp.shape[0])
    live = skey != EMPTY_KEY
    nlive = int(live.sum())
    lines = int(torch.unique(key_buckets(skey, bucket_bits(nb))[live]).numel())
    p_ms, p_by = bound(*kernel_cost("bucket_plan_fused", {
        "lanes": m, "valid": nlive, "lines": lines, "novel": planned,
        "cidx": cidx is not None}))
    return dict(
        name=("bucket_plan_fused_generation_order" if sym
              else "bucket_plan_fused"),
        route="cuda", source="stateright_tpu_torch/csrc/bucket_plan.cu",
        replaces=("stateright_tpu/ops/buckets.py:282" if sym
                  else "stateright_tpu/ops/buckets.py:202"),
        shape=(f"cand {m} ({nlive} valid, {lines} lines, {planned} novel), "
               f"table {tfp.shape[0]} slots"),
        matched=err == 0, max_abs_err=err,
        bound_ms=p_ms, bound_by=p_by, library_ms=None,
        **timings(lambda: bucket_plan_fused(tfp, *fused, nb, out=pbuf,
                                            generation_order=sym),
                  lambda: bucket_plan_fused_plain(tfp, *fused, nb,
                                                  generation_order=sym),
                  cold,
                  lambda: bucket_plan_fused(tfp, *fused, nb, out=pbuf,
                                            generation_order=sym, check=False,
                                            stream=stream)),
    )


def prep_record(x: dict, cold: bool, stream) -> dict:
    """``cand_prep`` against its plain version on the batch ``x`` of
    :func:`next_batch` (or of :func:`proviso_batch`)."""
    rows, valid = x["krows"], x["cvalid"]
    pfp, arity, cb, want = x["pfp"], x["arity"], x["cb"], x["prep"]
    n, w = rows.shape
    qbuf = PrepBuffers(n, cb, rows.device)
    got = cand_prep(rows, valid, pfp, arity, cb, out=qbuf)
    errs = sum(int((g != p).sum()) for g, p in zip(got, want))
    nv = int(want[4])
    parents = int(torch.unique(want[2] // arity).numel())
    q_ms, q_by = bound(*kernel_cost("cand_prep", {
        "lanes": n, "width": w, "valid": nv, "budget": cb,
        "parents": parents}))
    return dict(
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
    out["cand_prep"] = prep_record(x, cold, stream)
    rows = x["krows"]
    n, w = rows.shape
    nv = int(x["prep"][4])

    # -- B: row_hash over the same rows (under prededup: the step's own
    # call, on the valid rows before the dedup), and over the run's init
    # rows (without prededup, the only rows the main path gives it) -------
    init = torch.from_numpy(np.asarray(checker.tensor.init_rows(), np.uint64)
                            .view(np.int64).copy()).to(rows.device)
    if sym:
        init = checker.tensor.representative_rows(init).contiguous()
    ni, wi = init.shape
    got_i, want_i = row_hash(init), row_hash_plain(init)
    bi_ms, bi_by = bound(*kernel_cost("row_hash", {"rows": ni, "width": wi}))
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
    b_ms, b_by = bound(*kernel_cost("row_hash", {"rows": n, "width": w,
                                                 "valid": nh}))
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

    # -- the fused plan over the sorted candidate budget -------------------
    out["bucket_plan_fused"] = fused_record(x, cold, stream, sym)
    if sym:  # what the second launch costs: table order on the same batch
        nb = x["tfp"].shape[0] // SLOTS
        tab = dict(x, plan=bucket_plan_fused_plain(x["tfp"], *x["fused"], nb))
        out["bucket_plan_fused_table_order"] = fused_record(tab, cold, stream)

    # -- insert_commit of the batch's novel candidates -----------------------
    out["insert_commit"] = commit_record(x, cold, stream)
    return out


def commit_record(x: dict, cold: bool, stream) -> dict:
    """``insert_commit`` against its plain version on the batch ``x`` of
    :func:`next_batch` (or :func:`inject_batch`): each on its own copy of
    the table and the queue."""
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
    c_ms, c_by = bound(*kernel_cost("insert_commit", {
        "novel": nn, "width": width, "parents": parents}))
    return dict(
        name="insert_commit", route="cuda",
        source="stateright_tpu_torch/csrc/insert_commit.cu",
        replaces="stateright_tpu/ops/pallas_insert.py:85",
        shape=(f"cand {tgt.shape[0]}, n_new {nn} ({parents} parents), "
               f"table {tfp.shape[0]} slots, queue {q.fps.shape[0]} rows"),
        matched=c_err == 0, max_abs_err=c_err,
        bound_ms=c_ms, bound_by=c_by, library_ms=None,
        **timings(lambda: insert_commit(*kt, tgt, wfp, wpl, n_new_t, kq),
                  lambda: insert_commit_plain(*pt, tgt, wfp, wpl, n_new_t, pq),
                  cold,
                  lambda: insert_commit(*kt, tgt, wfp, wpl, n_new_t, kq,
                                        check=False, stream=stream)),
    )


@contextlib.contextmanager
def first_inject(into: dict):
    """Keep, in ``into``, the inputs of the first spill inject (JAX
    ``_build_inject``) of the runs inside the block that inserts
    something: copies of the hot table before it and of its ``pend_cap``
    lanes, the queue's tail, the queue buffers' shapes (the append reads
    nothing of the queue) and the count it inserted.  The copies are device-to-device and
    launch no kernel of the four."""
    run = _Engine.inject

    def inject(eng, carry, *lanes):
        if into:
            return run(eng, carry, *lanes)
        before = dict(
            tfp=carry[convert.TFP].clone(), tpl=carry[convert.TPL].clone(),
            tail=carry[convert.TAIL].clone(), sym=eng.sym,
            lanes=[a.clone() for a in lanes],
            queue=[(carry[i].shape, carry[i].dtype) for i in (
                convert.QROWS, convert.QFP, convert.QEBITS,
                convert.QDEPTH)])
        carry, io = run(eng, carry, *lanes)
        n_new, overflow = io.tolist()
        if n_new > 0 and not overflow:
            into.update(before, n_new=n_new)
        return carry, io

    _Engine.inject = inject
    try:
        yield into
    finally:
        _Engine.inject = run


def inject_kernels(kept: dict, leg: str) -> dict:
    """``bucket_plan_fused`` and ``insert_commit`` against their plain
    versions, L2-cold, on the inject batch :func:`first_inject` kept: the
    inject's sort, its plan (generation order under symmetry) and its
    queue append (arity 1: each lane is its own parent)."""
    if not kept:
        raise AssertionError(f"{leg}: no spill inject inserted anything")
    ifp, irows, ipar, iebt, ipdep = kept["lanes"]
    tfp, sym = kept["tfp"], kept["sym"]
    fused = (ifp, ipar, *sort_keys(ifp), None,
             torch.zeros((), dtype=torch.bool, device=ifp.device))
    plan = bucket_plan_fused_plain(tfp, *fused, tfp.shape[0] // SLOTS,
                                   generation_order=sym)
    queue = QueueAppend(
        *(torch.zeros(shape, dtype=dt, device=tfp.device)
          for shape, dt in kept["queue"]),
        kept["tail"], plan[3], irows, iebt, ipdep, 1)
    x = dict(tfp=tfp, tpl=kept["tpl"], fused=fused, plan=plan, queue=queue,
             crows=irows, n_new=int(plan[4]))
    if x["n_new"] != kept["n_new"]:
        raise AssertionError(f"{leg}: the kept inject inserted "
                             f"{kept['n_new']}, its plain plan {x['n_new']}")
    stream = torch.cuda.current_stream().cuda_stream
    return {"bucket_plan_fused": fused_record(x, True, stream, sym),
            "insert_commit": commit_record(x, True, stream)}


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
    if not all_launched(launches3):
        raise AssertionError(f"a kernel never launched on paxos-3: {launches3}")
    return g3.discovery_fps(), paths3, {"sec": g3_s, "steps": g3.steps_run,
                                        "peak_device_mib": peak / 2**20}


def flag_phases(dev, smi: str, p3_ref) -> tuple:
    """The pre-dedup on the card: paxos-3 under ``.prededup()`` bounded at
    :data:`PAXOS3_KERNEL_TARGET`, with the plain leg's discoveries
    ``p3_ref``; paxos-2 and
    per-channel paxos-2 under the flag on ``cuda`` and ``cpu``; 2pc-7
    under ``.symmetry().prededup()`` on both.  Returns each leg's
    launches, and the paxos-3 leg's counts and final snapshot, which the
    plain run bounded at the same target must equal
    (:func:`check_prededup_stop`)."""
    # -- paxos-3, prededup, bounded --------------------------------------------
    g, g_s, peak, launches = compiled_leg(dev, lambda: paxos_model(3),
                                          flags=PREDEDUP,
                                          target=PAXOS3_KERNEL_TARGET)
    paths = check_discoveries(g.model, g, {"value chosen"})
    g.assert_properties()  # "linearizable" never violated
    removed = g.prededup_removed()
    rec = dict(leg_record(g, g_s, peak, launches, smi), path_lengths=paths,
               flags=list(PREDEDUP),
               unique_per_sec=g.unique_state_count() / g_s,
               prededup_removed=removed,
               prededup_removed_share=removed / g.state_count(),
               launches_per_step={k: v / g.steps_executed
                                  for k, v in launches.items()},
               discoveries_identical=(g.discovery_fps() == p3_ref[0]
                                      and paths == p3_ref[1]))
    rec["target"] = PAXOS3_KERNEL_TARGET
    emit("paxos3_prededup", rec)
    p3f_stop = {"unique": g.unique_state_count(), "states": g.state_count(),
                "steps": g.steps_run, "snapshot": g.final_snapshot()}
    if not rec["discoveries_identical"]:
        raise AssertionError("paxos-3 prededup: discoveries differ from the "
                             "plain leg's")
    # the step hashes its candidates once more under prededup
    if launches["row_hash"] < g.steps_executed:
        raise AssertionError(f"paxos-3 prededup: row_hash {launches}")
    del g

    # -- paxos-2 in both packings, prededup --------------------------------------
    # the hand-written packing on cuda and cpu; the per-channel packing
    # complete on cuda alone, against the 16,668 / 32,971 pin (its cpu run,
    # about 40 s of host time beside an H100, is cut: the per-channel
    # packing's cuda = cpu tables are the per_channel_and_histories legs')
    leg_launches = {}
    for name, build, kw, on_cpu in (
        ("paxos2_prededup", lambda: paxos_model(2), dict(batch=256), True),
        ("paxos2_per_channel_prededup", per_channel_paxos2,
         P2_PER_CHANNEL_KW, False),
    ):
        g, g_s, peak, leg_launches[name] = compiled_leg(
            dev, build, flags=PREDEDUP, **kw)
        paths = check_discoveries(g.model, g, {"value chosen"})
        g.assert_properties()
        rec = dict(leg_record(g, g_s, peak, leg_launches[name], smi),
                   path_lengths=paths,
                   network_encoding=getattr(g.tensor, "network_encoding",
                                            "hand-written"),
                   prededup_removed=g.prededup_removed(), **kw)
        runs = [g]
        if on_cpu:
            t0 = time.monotonic()
            c = with_step_flags(build().checker(), PREDEDUP).spawn_gpu(
                device="cpu", **kw).join()
            same, tail = same_tables_and_queue(g, c)
            rec.update(unique_cpu=c.unique_state_count(),
                       states_cpu=c.state_count(),
                       sec_cpu=time.monotonic() - t0, tail=tail,
                       tables_and_queue_identical=same,
                       prededup_removed_cpu=c.prededup_removed())
            runs.append(c)
            if not same or g.prededup_removed() != c.prededup_removed():
                raise AssertionError(f"{name}: cuda and cpu disagree")
        emit(name, rec)
        for x in runs:  # paxos-2's counts are the same in both packings
            if (x.unique_state_count(), x.state_count()) != P2_PER_CHANNEL:
                raise AssertionError(f"{name}: not {P2_PER_CHANNEL}")
        del g, runs

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
    if sym_launches["bucket_plan_fused"] != 2 * sym_launches["insert_commit"]:
        raise AssertionError(f"2pc-7 symmetry prededup: {sym_launches}")
    return launches, leg_launches, sym_launches, p3f_stop


def check_prededup_stop(plain, stop: dict, smi: str) -> None:
    """The paxos-3 prededup leg against the plain run bounded at the same
    target: the same unique and state counts, steps, table bytes, cursors
    and queue rows (the pre-dedup takes out only lanes the insert would
    have found again)."""
    same, tail = same_snapshots(plain.final_snapshot(), stop["snapshot"])
    got = (stop["unique"], stop["states"], stop["steps"])
    want = (plain.unique_state_count(), plain.state_count(), plain.steps_run)
    emit("paxos3_prededup_vs_plain", {
        "target": PAXOS3_KERNEL_TARGET, "prededup": list(got),
        "plain": list(want), "tail": tail,
        "tables_and_queue_identical": same, "card": smi})
    if got != want or not same:
        raise AssertionError(f"paxos-3 prededup stopped at {got} with "
                             f"identical tables {same}, the plain run at "
                             f"{want}")


def ops_per_step(dev, cartography: bool, flags=(),
                 build=lambda: paxos_model(3), target: int = OPS_TARGET,
                 roofline: bool = False, **kw) -> dict:
    """Dispatched operations per step, over the first :data:`OPS_STEPS`
    steps of a run of ``build()`` (default paxos-3) bounded at ``target``
    with the step ``flags`` on (a ``TorchDispatchMode`` count around
    ``_Engine.step``), and those of the block's stats packing on the run's
    final carry; ``kw`` goes to ``spawn_gpu``."""
    from stateright_tpu_torch.parallel import wavefront

    counts = []
    step = wavefront._Engine.step

    def counted(self, c):
        if len(counts) >= OPS_STEPS:
            return step(self, c)
        probe = OpCount()
        with probe:
            out = step(self, c)
        counts.append(probe.n)
        return out

    wavefront._Engine.step = counted
    try:
        b = with_step_flags(build().checker().target_states(target), flags)
        if roofline:
            b = b.roofline()
        c = (b.cartography() if cartography else b).spawn_gpu(
            **dict(dict(device=dev, steps_per_call=4), **kw)).join()
    finally:
        wavefront._Engine.step = step
    probe = OpCount()
    with probe:
        wavefront.stats_of(c._final_carry, c._layout)
    return {"ops_per_step": sum(counts) / len(counts), "steps": len(counts),
            "stats_ops_per_block": probe.n}


def telemetry_phases(dev, smi: str, p3_ref) -> dict:
    """The telemetry legs (module docstring): returns each leg's
    launches."""
    tmp = tempfile.mkdtemp(prefix="chip-smoke-telemetry-")
    legs = {}
    # -- paxos-3 complete under the bench telemetry configuration -----------
    report = os.path.join(tmp, "paxos3.json")
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    c = (paxos_model(3).checker().telemetry(**TELEMETRY_KW).report(report)
         .runs(os.path.join(tmp, "runs")).spawn_gpu())
    c._done.wait()
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    c.join()  # writes the report and the registry entry
    report_sec = time.monotonic() - t0 - sec
    legs["telemetry_paxos3"] = launches = kernel_launches()
    rec = c.flight_recorder
    cart = c.cartography()
    states, unique = c.state_count(), c.unique_state_count()
    live = {n: t.nbytes for n, t in c.live_buffers().items()}
    spec = {b.name: b.nbytes for b in c._memory_spec_fn()(c._memory_caps())}
    off, on = ops_per_step(dev, False), ops_per_step(dev, True)
    emit("telemetry_paxos3", {
        "unique": unique, "states": states, "sec": sec,
        "report_and_registry_sec": report_sec,
        "plain_paxos3_sec": p3_ref[2]["sec"], "wall_over_plain": sec
        / p3_ref[2]["sec"], "steps": c.steps_run,
        "plain_paxos3_steps": p3_ref[2]["steps"],
        "ops_per_step_off": off, "ops_per_step_cartography": on,
        "stages": rec.stages(), "growth_secs": c.growth_secs,
        "growth_host_sec": sum(c.growth_secs),
        "growth_memory": c.growth_memory,
        "peak_allocated_mib": torch.cuda.max_memory_allocated(dev) / 2**20,
        "plain_paxos3_peak_device_mib": p3_ref[2]["peak_device_mib"],
        "memory_stats": device_memory_stats(dev),
        "analytic_bytes": sum(spec.values()), "live_bytes": sum(live.values()),
        "buffers": spec, "health": c.health(),
        "summary": {k: v for k, v in rec.summary().items()
                    if k not in ("cartography", "memory", "stages")},
        "cartography": cart, "launches": launches, "card": smi})
    if (unique, states) != (PAXOS3_UNIQUE, PAXOS3_STATES):
        raise AssertionError(f"telemetry paxos-3: {(unique, states)}")
    if c.discovery_fps() != p3_ref[0]:
        raise AssertionError("telemetry paxos-3: discoveries differ")
    if not (sum(cart["depth_hist"]) == unique
            and sum(cart["action_hist"]) == states - 1
            and all(p["evaluated"] == unique for p in cart["props"])):
        raise AssertionError(f"telemetry paxos-3: cartography {cart}")
    if live != spec:
        raise AssertionError(f"memory ledger: analytic {spec} != live {live}")
    measured = [g for g in c.growth_memory
                if g["peak_requested_bytes"] is not None
                or g["peak_bytes"] is not None]
    if not measured or any(
            g["transient_bytes"] < (g["peak_requested_bytes"] or 0)
            or g["transient_alloc_bytes"] < (g["peak_bytes"] or 0)
            for g in measured):
        raise AssertionError(f"growth forecast below the measured peak: "
                             f"{c.growth_memory}")
    if not all_launched(launches):
        raise AssertionError(f"a kernel never launched: {launches}")
    with open(report) as f:
        body = json.load(f)
    if body["totals"]["unique"] != PAXOS3_UNIQUE:
        raise AssertionError("telemetry paxos-3: report totals")
    lap("telemetry_paxos3")
    roofline_leg(dev, smi, c, body, launches, off, on)
    del c
    lap("roofline_paxos3")

    # -- one stream sync a block with telemetry on ----------------------------
    sync_runs = {}
    for spc in SYNC_STEPS_PER_CALL:
        def run(spc=spc):
            return (paxos_model(3).checker()
                    .telemetry(**dict(TELEMETRY_KW, roofline=False))
                    .target_states(P3_SYNC_TARGET)
                    .spawn_gpu(capacity=P3_SYNC_CAPACITY,
                               steps_per_call=spc).join())
        g, syncs = profiled_sync_count(dev, run)
        if g.growth_events:
            raise AssertionError("the sync count's run grew: it must not")
        sync_runs[spc] = {"unique": g.unique_state_count(),
                          "steps": g.steps_run,
                          "blocks": -(-g.steps_run // spc),
                          "stream_syncs": syncs.get("cudaStreamSynchronize", 0),
                          "calls": syncs}
        del g
    a, b = (sync_runs[spc] for spc in SYNC_STEPS_PER_CALL)
    per_block = ((b["stream_syncs"] - a["stream_syncs"])
                 / (b["blocks"] - a["blocks"]))
    emit("telemetry_paxos3_host_syncs", {
        "target": P3_SYNC_TARGET, "capacity": P3_SYNC_CAPACITY,
        "runs": {str(k): v for k, v in sync_runs.items()},
        "stream_syncs_per_block": per_block, "card": smi})
    if per_block != 1.0:
        raise AssertionError(f"telemetry on: {per_block} stream syncs a block")
    lap("telemetry_paxos3_host_syncs")

    # -- 2pc-7 reports: cuda twice, cpu once ----------------------------------
    paths = [os.path.join(tmp, f"2pc7-{tag}.json")
             for tag in ("cuda0", "cuda1", "cpu")]
    reset_launches()
    t0 = time.monotonic()
    for p in paths[:2]:
        TwoPhaseSys(7).checker().report(p).spawn_gpu().join()
    cuda_sec = (time.monotonic() - t0) / 2
    legs["telemetry_2pc7"] = kernel_launches()
    t0 = time.monotonic()
    TwoPhaseSys(7).checker().report(paths[2]).spawn_gpu(device="cpu").join()
    cpu_sec = time.monotonic() - t0
    docs = []
    for p in paths:
        with open(p) as f:
            docs.append(json.load(f))
    bodies = [json.dumps({k: v for k, v in d.items()
                          if k not in VOLATILE_KEYS}) for d in docs]
    d = diff_reports(docs[2], docs[0])
    emit("telemetry_2pc7", {
        "unique": [x["totals"]["unique"] for x in docs],
        "cuda_bodies_byte_equal": bodies[0] == bodies[1],
        "verdict": d["verdict"], "violations": d["violations"],
        "config_delta": d["config_delta"], "sec_cuda": cuda_sec,
        "sec_cpu": cpu_sec, "launches": legs["telemetry_2pc7"],
        "card": smi})
    if bodies[0] != bodies[1]:
        raise AssertionError("2pc-7: the two cuda report bodies differ")
    if d["verdict"] not in (IDENTICAL, PERF_ONLY) or d["violations"]:
        raise AssertionError(f"2pc-7 cpu/cuda diff: {d['verdict']} "
                             f"{d['violations']}")
    if any(x["totals"]["unique"] != TPC7_UNIQUE for x in docs):
        raise AssertionError("2pc-7 reports: unique counts")
    lap("telemetry_2pc7")

    # -- 2pc-7 profiled: a block-graph engine is traced on the CPU only -------
    # (blocks of 8 steps keep the two profiled blocks' trace small)
    reset_launches()
    c = (TwoPhaseSys(7).checker()
         .telemetry(profile_steps=2, profile_dir=os.path.join(tmp, "prof"))
         .spawn_gpu(steps_per_call=8).join())
    legs["profile_2pc7"] = kernel_launches()
    events = c.flight_recorder.records("profile")
    start = [e for e in events if e["event"] == "start"]
    stop = [e for e in events if e["event"] == "stop"]
    if not (start and stop):
        raise AssertionError(f"2pc-7 profile: no trace written: {events}")
    with open(stop[0]["trace"]) as f:
        trace = json.load(f)["traceEvents"]
    kernels = [e for e in trace if e.get("cat") == "kernel"]
    emit("profile_2pc7", {"unique": c.unique_state_count(),
                          "profiled_steps": stop[0]["profiled_steps"],
                          "cuda": start[0]["cuda"],
                          "cuda_off": start[0].get("cuda_off"),
                          "trace_events": len(trace),
                          "kernel_events": len(kernels),
                          "trace_bytes": os.path.getsize(stop[0]["trace"]),
                          "launches": legs["profile_2pc7"], "card": smi})
    if start[0]["cuda"] or start[0].get("cuda_off") != CUPTI_FAULT:
        raise AssertionError(f"2pc-7 profile: a block-graph engine traced "
                             f"on the device: {start[0]}")
    if kernels or not trace:
        raise AssertionError(f"2pc-7 profile: {len(trace)} trace events, "
                             f"{len(kernels)} of them kernels")
    if c.unique_state_count() != TPC7_UNIQUE:
        raise AssertionError("2pc-7 profile: unique count")
    lap("profile_2pc7")
    return legs


def roofline_leg(dev, smi: str, c, body: dict, launches: dict, off: dict,
                 on: dict) -> None:
    """``roofline_paxos3`` (module docstring), on the telemetry leg's
    paxos-3 run ``c`` (its report ``body``, its ``launches``, and the
    operations a step with cartography off and on, ``off``/``on``)."""
    if os.environ.get(ENV_DEVICE_SPEC):
        raise AssertionError(f"{ENV_DEVICE_SPEC} is set: the leg reads the "
                             "card's own spec")
    roof = c.roofline()
    if roof is None:
        raise AssertionError("roofline paxos-3: no ledger")
    spec, verdicts = roof.get("device_spec"), roof["verdicts"]
    name = torch.cuda.get_device_name(dev)
    if spec is None or spec["src"] != "device" or spec != spec_for_name(name):
        raise AssertionError(f"roofline paxos-3: spec {spec} for {name}")
    # the twin's two kernels, timed on the first batch of the final queue:
    # their device time (the profiler's, else CUDA events behind a busy
    # stream), and the events figure beside it
    tensor, batch = c.tensor, int(roof["batch"])
    rows = c._final_carry[convert.QROWS][:batch].contiguous()
    timed = {"property": device_ms(lambda: tensor.property_masks(rows)),
             "expand": device_ms(lambda: tensor.step_rows(rows))}
    stage_ms = {k: v[0] for k, v in timed.items()}
    stages = {}
    for st, v in roof["stages"].items():
        nbytes = v["bytes_read"] + v["bytes_written"]
        entry = {"bytes": nbytes, "flops": v["flops"],
                 "intensity": v.get("intensity"),
                 "verdict": verdicts[st]["verdict"],
                 "ridge": verdicts[st].get("ridge"),
                 "ridge_kind": verdicts[st].get("ridge_kind")}
        if st in stage_ms:
            sec = stage_ms[st] / 1e3
            entry["ms"], entry["ms_by"], entry["events_ms"] = timed[st]
            entry["achieved_bytes_per_sec"] = nbytes / sec
            entry["frac_of_hbm_ceiling"] = (nbytes / sec
                                            / spec["hbm_bytes_per_sec"])
            entry["frac_of_flops_ceiling"] = (v["flops"] / sec
                                              / spec["vpu_peak"])
        stages[st] = entry
    roof_on = ops_per_step(dev, True, roofline=True)
    out = {"spec": spec, "card": smi, "batch": batch,
           "totals": roof["totals"], "stages": stages,
           "achieved": roof.get("achieved"),
           "reconciliation": roof["reconciliation"],
           "report_block_is_static": "device_spec" not in body["roofline"],
           "unique": c.unique_state_count(), "states": c.state_count(),
           "ops_per_step_roofline_off": on, "ops_per_step_roofline_on":
           roof_on, "ops_per_step_plain": off, "launches": launches,
           "candidates": [{k: x[k] for k in ("rank", "stage", "op", "bytes",
                                             "rule")}
                          for x in roof["mxu_candidates"]]}
    emit("roofline_paxos3", out)
    for st, e in stages.items():
        print(f"roofline paxos-3 {st}: {e['bytes']} bytes, {e['flops']} "
              f"FLOPs a step, {e['verdict']}"
              + (f", {100 * e['frac_of_hbm_ceiling']:.4f}% of memory"
                 if "ms" in e else "") + f" ({smi})", flush=True)
    if (c.unique_state_count(), c.state_count()) != (PAXOS3_UNIQUE,
                                                     PAXOS3_STATES):
        raise AssertionError("roofline paxos-3: counts")
    if (roof_on["ops_per_step"], roof_on["stats_ops_per_block"]) != (
            on["ops_per_step"], on["stats_ops_per_block"]):
        raise AssertionError(f"roofline on: {roof_on} operations, off: {on}")
    if not roof["reconciliation"]["ok"] or not out["report_block_is_static"]:
        raise AssertionError(f"roofline paxos-3: {roof['reconciliation']}")
    if roof.get("achieved") is None or set(verdicts) != set(stages):
        raise AssertionError(f"roofline paxos-3: {roof.get('achieved')}")


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
            "steps_executed": checker.steps_executed,
            "block_graphs": block_graph_summary(checker),
            "growth_events": [
                {"status": st, "unique": u, "host_sec": g}
                for (st, u), g in zip(checker.growth_events,
                                      checker.growth_secs)],
            "growth_host_sec": sum(checker.growth_secs),
            "peak_device_mib": peak / 2**20, "launches": launches,
            "card": smi}


def compiled_leg(dev, build, sym: bool = False, flags=(), target=None,
                 **kw):
    """One ``spawn_gpu(**kw)`` run of ``build()``'s model (under
    ``.symmetry()`` with ``sym``, with the step ``flags`` on, bounded at
    ``target`` unique states when given) with the launch counts reset
    just before it and read just after; returns the checker, its wall
    seconds (the twin's host-side compile included), peak device memory
    and launches."""
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    builder = build().checker()
    if target is not None:
        builder = builder.target_states(target)
    if sym:
        builder = builder.symmetry()
    builder = with_step_flags(builder, flags)
    checker = builder.spawn_gpu(**kw).join()
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    launches = kernel_launches()
    if not all_launched(launches):
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
    if (pg.unique_state_count(), pg.state_count()) != P2_PER_CHANNEL:
        raise AssertionError(f"per-channel paxos-2: not {P2_PER_CHANNEL}")
    # cuda = cpu at a bound (the cut: see P2_PER_CHANNEL_CPU_TARGET)
    bounded = []
    for d in (dev, "cpu"):
        t0 = time.monotonic()
        bounded.append((per_channel_paxos2().checker().target_states(
            P2_PER_CHANNEL_CPU_TARGET).spawn_gpu(
                device=d, **P2_PER_CHANNEL_KW).join(),
            time.monotonic() - t0))
    (gb, gb_s), (pc, pc_s) = bounded
    same, tail = same_tables_and_queue(gb, pc)
    counts = [(c.unique_state_count(), c.state_count()) for c in (gb, pc)]
    emit("paxos2_per_channel", dict(
        leg_record(pg, pg_s, peak, launches, smi),
        cpu_target=P2_PER_CHANNEL_CPU_TARGET, bounded_counts=counts,
        sec_bounded_cuda=gb_s, sec_cpu=pc_s, tail=tail,
        tables_and_queue_identical=same, path_lengths=paths,
        **P2_PER_CHANNEL_KW))
    if not (same and counts[0] == counts[1]
            and counts[0][0] >= P2_PER_CHANNEL_CPU_TARGET):
        raise AssertionError("per-channel paxos-2: cuda and cpu disagree")
    del pg, gb, pc

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


@contextlib.contextmanager
def proviso_round(into: dict):
    """Keep, in ``into``, the inputs of the POR proviso round (the step's
    second insert, appended at ``tail + n_new1``) that inserts the most of
    the runs inside the block: copies of the table after the ample round,
    of the round's candidate rows, mask, parents and cursors, and of the
    queue.  The copies are device-to-device and launch no kernel of the
    four.  Its blocks run the eager loop (``_Engine._run_steps``), so the
    step's Python runs every step and the kept count is read there."""
    run, block = _Engine._insert_round, _Engine.run

    def insert_round(eng, c, krows, kept, fps, tail, cand_rows, ebits,
                     depths, prep_out, plan_out):
        second = tail is not c[convert.TAIL]
        if second:
            before = dict(
                tfp=c[convert.TFP].clone(), tpl=c[convert.TPL].clone(),
                krows=krows.clone(), cvalid=kept.clone(), pfp=fps.clone(),
                tail=tail.clone(), crows=cand_rows.clone(),
                ebits=ebits.clone(), depths=depths.clone(),
                arity=eng.arity, cb=eng.eff_cand, sym=eng.sym,
                queue=[c[i].clone() for i in (
                    convert.QROWS, convert.QFP, convert.QEBITS,
                    convert.QDEPTH)])
        out = run(eng, c, krows, kept, fps, tail, cand_rows, ebits, depths,
                  prep_out, plan_out)
        if second and int(out[2]) > into.get("n_new_kept", 0):
            into.update(before, n_new_kept=int(out[2]))
        return out

    _Engine._insert_round = insert_round
    _Engine.run = _Engine._run_steps
    try:
        yield into
    finally:
        _Engine._insert_round, _Engine.run = run, block


def proviso_kernels(kept: dict) -> dict:
    """``cand_prep``, ``bucket_plan_fused`` and ``insert_commit`` against
    their plain versions, L2-cold, on the proviso round :func:`proviso_round`
    kept: its candidate mask through the budget compaction, the stable
    key sort, the plan on the table the ample round left, and the append
    after the ample round's rows."""
    if not kept:
        raise AssertionError("por: no proviso round inserted anything")
    k = kept
    tfp = k["tfp"]
    prep = cand_prep_plain(k["krows"], k["cvalid"], k["pfp"], k["arity"],
                           k["cb"])
    fused = (prep[0], prep[1], *torch.sort(prep[3], stable=True), prep[2],
             prep[5])
    plan = bucket_plan_fused_plain(tfp, *fused, tfp.shape[0] // SLOTS,
                                   generation_order=k["sym"])
    queue = QueueAppend(*k["queue"], k["tail"], plan[3], k["crows"],
                        k["ebits"], k["depths"], k["arity"])
    x = dict(k, prep=prep, fused=fused, plan=plan, queue=queue,
             n_new=int(plan[4]))
    if x["n_new"] == 0:
        raise AssertionError("por: the kept proviso round's plain plan "
                             "inserts nothing")
    stream = torch.cuda.current_stream().cuda_stream
    return {"cand_prep": prep_record(x, True, stream),
            "bucket_plan_fused": fused_record(x, True, stream, k["sym"]),
            "insert_commit": commit_record(x, True, stream)}


def por_phases(dev, smi: str, ref7: dict) -> tuple:
    """The partial-order-reduction legs (module docstring); returns each
    leg's launches and the proviso round's kernel records."""
    from stateright_tpu_torch.analysis.footprint import conjunct_eval_fn
    from stateright_tpu_torch.analysis.independence import (
        plan_digest, por_plan, run_independence,
    )
    from stateright_tpu_torch.ops.por import PorConstants, ample_mask

    legs = {}
    # -- per-channel paxos-2 under por(): the plan, then the run -------------
    m = per_channel_paxos2()
    tm = m._tensor_cached()
    t0 = time.monotonic()
    rep = run_independence(tm, list(m.properties()))
    plan = por_plan(tm, list(m.properties()))
    plan_s = time.monotonic() - t0
    got = dict(independent_pairs=rep.independent_pairs,
               conflict_sum=int(plan.conflict.sum()),
               visible=int(plan.visible.sum()),
               conjuncts=int(plan.enablers.shape[1]))
    digest = plan_digest(plan)
    if ((tm.width, tm.max_actions) != (83, 82) or got != PC_PAXOS2_PLAN
            or digest != PC_PAXOS2_PLAN_DIGEST):
        raise AssertionError(f"per-channel paxos-2 plan {got} {digest}: "
                             f"not {PC_PAXOS2_PLAN} {PC_PAXOS2_PLAN_DIGEST}")
    # the same twin in full at the same capacity and batch, for the wall
    gp, gp_s, _, _ = compiled_leg(dev, lambda: m, **P2_POR_KW)
    if (gp.unique_state_count(), gp.state_count()) != P2_PER_CHANNEL:
        raise AssertionError(f"per-channel paxos-2: not {P2_PER_CHANNEL}")
    plain_disc = sorted(gp.discoveries())
    del gp
    g, g_s, peak, launches = compiled_leg(dev, lambda: m, flags=POR,
                                          **P2_POR_KW)
    paths = check_discoveries(g.model, g, set(plain_disc))
    g.assert_properties()  # "linearizable" never violated
    st = g.por_status()
    rec = dict(leg_record(g, g_s, peak, launches, smi), path_lengths=paths,
               flags=list(POR), por=st, plan=dict(got, digest=digest),
               plan_host_sec=plan_s, plain_sec_same_caps=gp_s,
               **P2_POR_KW)
    if (g.unique_state_count(), g.state_count()) != P2_PER_CHANNEL_POR:
        raise AssertionError(f"por per-channel paxos-2: not "
                             f"{P2_PER_CHANNEL_POR}: {rec}")
    if not (st["enabled"] and st["rows_reduced"] > 0):
        raise AssertionError(f"por per-channel paxos-2 reduced nothing: {st}")
    del g
    # operations a step, POR off and on, the first steps at the leg's batch
    ops = {tag: ops_per_step(dev, False, flags, build=lambda: m,
                             target=P2_OPS_TARGET, **P2_POR_KW)
           for tag, flags in (("off", ()), ("on", POR))}
    # a bounded POR run (its proviso rounds' inputs kept; the copies and
    # the host reads of the kept count are outside every timed leg), then
    # ample_mask's device time on its next batch
    kept = {}
    with proviso_round(kept):
        gb = with_step_flags(m.checker().target_states(
            P2_PER_CHANNEL_KERNEL_TARGET), POR).spawn_gpu(**P2_POR_KW).join()
    kernels = proviso_kernels(kept)
    del kept
    carry = gb._final_carry
    head, tail = int(carry[convert.HEAD]), int(carry[convert.TAIL])
    batch = gb._batch
    lanes = torch.arange(batch, device=dev)
    span = (head + lanes).clamp_(max=carry[convert.QROWS].shape[0] - 1)
    rows = carry[convert.QROWS][span]
    _, valid = tm.step_rows(rows)
    valid = valid & (lanes < tail - head)[:, None]
    consts, kernel = PorConstants(plan, dev), conjunct_eval_fn(tm)
    amp = ample_mask(valid, rows, consts, kernel)
    dev_ms, dev_by, ev_ms = device_ms(
        lambda: ample_mask(valid, rows, consts, kernel))
    rec["ample_mask"] = dict(
        rows=batch, live=int(min(tail - head, batch)),
        enabled=int(valid.sum()), ample=int(amp.sum()),
        reduced_rows=int((amp != valid).any(dim=1).sum()),
        ms=time_ms(lambda: ample_mask(valid, rows, consts, kernel), 20),
        device_ms=dev_ms, device_ms_by=dev_by, events_device_ms=ev_ms,
        host_ms=host_ms(lambda: ample_mask(valid, rows, consts, kernel), 20))
    rec["ops_per_step"] = ops
    emit("por_pc_paxos2", rec)
    del gb, carry, rows, valid
    legs["por_pc_paxos2"] = launches

    # -- 2pc-7 under por(): nothing reduces, the plain leg's tables ----------
    g, g_s, peak, launches = compiled_leg(dev, lambda: TwoPhaseSys(7),
                                          flags=POR)
    same, tail = same_snapshots(ref7["snap"], g.final_snapshot())
    st = g.por_status()
    emit("por_2pc7", dict(leg_record(g, g_s, peak, launches, smi),
                          flags=list(POR), por=st, tail=tail,
                          plain_sec=ref7["sec"],
                          tables_and_queue_identical_to_plain=same))
    if not (same and g.state_count() == ref7["states"]
            and g.discovery_fps() == ref7["disc"]
            and st["enabled"] and st["rows_reduced"] == 0
            and st["candidates_masked"] == 0):
        raise AssertionError(f"por 2pc-7: not the plain leg's run ({st})")
    del g
    legs["por_2pc7"] = launches

    # -- per-channel paxos-1 under por() on cuda and cpu ---------------------
    def p1(device):
        return with_step_flags(per_channel_paxos(1).checker(), POR).spawn_gpu(
            device=device, batch=64).join()

    g, g_s, peak, launches = compiled_leg(
        dev, lambda: per_channel_paxos(1), flags=POR, batch=64)
    c = p1("cpu")
    same, tail = same_tables_and_queue(g, c)
    emit("por_pc_paxos1", dict(
        leg_record(g, g_s, peak, launches, smi), flags=list(POR),
        por=g.por_status(), por_cpu=c.por_status(), tail=tail,
        unique_cpu=c.unique_state_count(), states_cpu=c.state_count(),
        tables_and_queue_identical=same))
    for x in (g, c):
        if (x.unique_state_count(), x.state_count()) != P1_PER_CHANNEL_POR:
            raise AssertionError(f"por per-channel paxos-1: not "
                                 f"{P1_PER_CHANNEL_POR}")
    if not (same and g.por_status() == c.por_status()):
        raise AssertionError("por per-channel paxos-1: cuda and cpu disagree")
    legs["por_pc_paxos1"] = launches
    return legs, kernels


# -- the block graph ---------------------------------------------------------

BLOCK_STEPS = 8  # the block_graph legs' steps_per_call: several blocks a leg
BLOCK_GROW_CAPS = (1 << 10, 1 << 9, 256)  # (cap, qcap, cand): a growth stop


def block_leg(dev, name: str, grow: bool) -> tuple:
    """One ``block_graph`` leg: a complete ``spawn_gpu`` run (its
    ``steps_executed``/``steps_run`` and block graphs), then a fresh engine
    at that run's capacities (``grow``: at :data:`BLOCK_GROW_CAPS`, so the
    blocks stop on a growth status) whose blocks run from the init carry
    as the graph block and as the eager loop on a copy, compared bit for
    bit: every carry entry, the stats and ``k``.  Under ``.spill()`` the
    Bloom words are all ones, so every candidate defers.  Returns the
    record and the cond inputs of the first block's carry (a copy: the
    graph block adopts that carry) and of the last block's."""
    from stateright_tpu_torch.parallel import wavefront

    build, kw = BLOCK_LEGS[name]
    t0 = time.monotonic()
    c = build().spawn_gpu(device=dev, batch=64, steps_per_call=BLOCK_STEPS,
                          **kw).join()
    run_s = time.monotonic() - t0
    eng = (c._engine(BLOCK_GROW_CAPS[0], BLOCK_GROW_CAPS[1], 64,
                     BLOCK_GROW_CAPS[2]) if grow
           else c._engine(c._cap, c._qcap, c._batch, c._cand))
    carry, _ = eng.init()
    if eng.spill:
        sp = eng.layout.spill_start + wavefront._SP_BLOOM
        carry[sp] = torch.full_like(carry[sp], -1)
    first = eng.cond_inputs(carry)
    first = first._replace(**{f: getattr(first, f).clone() for f in (
        "head", "tail", "unique", "status", "disc", "err")
        if getattr(first, f) is not None})
    blocks = executed = 0
    graph_ops, eager_ops, identical = [], [], True
    while blocks < 400:
        ref = [t.clone() for t in carry]
        with OpCount() as oe:
            want, wstats = eng._run_steps(ref)
        with OpCount() as og:
            got, gstats = eng.run(carry)
        identical &= (len(got) == len(want) and torch.equal(gstats, wstats)
                      and all(torch.equal(a, b) for a, b in zip(got, want)))
        k = int(gstats[-1])
        eng.account(k)
        if blocks:  # the first graph block holds the warm step and capture
            graph_ops.append(og.n + 1)  # + the graph's own launch
            eager_ops.append(oe.n)
        blocks += 1
        executed += k
        carry = got
        st = gstats[:-1].cpu().numpy()
        if not k or int(st[wavefront._ST_STATUS]) != 0 or st[1] <= st[0]:
            break
    cap = eng.block.record()
    rec = {"unique": c.unique_state_count(), "states": c.state_count(),
           "run_sec": run_s, "run_steps_executed": c.steps_executed,
           "run_steps_run": c.steps_run,
           "run_block_graphs": block_graph_summary(c),
           "engine_caps": [eng.cap, eng.qcap, eng.batch, eng.eff_cand],
           "blocks": blocks, "steps_executed": executed,
           "steps_run": blocks * eng.steps, "stop_status": int(st[5]),
           "bit_identical": bool(identical),
           "host_ops_per_graph_block": (sum(graph_ops) / len(graph_ops)
                                        if graph_ops else None),
           "host_ops_per_eager_block": (sum(eager_ops) / len(eager_ops)
                                        if eager_ops else None),
           "capture_secs": cap["capture_secs"],
           "warm_secs": cap["warm_secs"],
           "instantiate_secs": cap["instantiate_secs"],
           "graph_nodes": cap["nodes"], "pool_bytes": cap["pool_bytes"]}
    last = eng.cond_inputs(carry)
    del c, eng, carry, ref, want, got
    return rec, (first, last)


def block_graph_summary(checker) -> Optional[dict]:
    """A run's block graphs (``GpuChecker.block_graphs``) in sum: one per
    engine key, the seconds of their warm steps, captures and
    instantiations, the node counts and the largest private pool."""
    gs = getattr(checker, "block_graphs", None)
    if not gs:
        return None
    return {"graphs": len(gs),
            "warm_secs": sum(g["warm_secs"] for g in gs),
            "capture_secs": sum(g["capture_secs"] for g in gs),
            "instantiate_secs": sum(g["instantiate_secs"] for g in gs),
            "nodes": [g["nodes"] for g in gs],
            "pool_bytes_max": max(g["pool_bytes"] for g in gs)}


def block_cond_cell(xs: list) -> dict:
    """``srt_block_cond`` against ``block_cond_plain`` on every leg's first
    and last block's cond inputs at each ``k`` from 0 to the steps, with
    and without the reset (the largest disagreement in ``go`` or ``k``;
    the cases with ``go`` true and false counted by the plain version),
    and the kernel's cell at the first input with ``go`` true: times, its
    bound and the plain version's."""
    err = n_go = n_stop = 0
    timed = None
    for x in xs:
        for k0 in range(BLOCK_STEPS + 1):
            k = torch.tensor([k0], dtype=torch.int64, device=x.head.device)
            for reset in (False, True):
                go, k1 = block_cond(x, k, BLOCK_STEPS, reset=reset)
                pg, pk = block_cond_plain(
                    x, torch.zeros_like(k) if reset else k, BLOCK_STEPS)
                err = max(err, int((go.long() - pg.long()).abs().max()),
                          int((k1 - pk).abs().max()))
                if bool(pg.all()):
                    n_go += 1
                    if timed is None and not reset:
                        timed = (x, k)
                else:
                    n_stop += 1
    x, k = timed if timed is not None else (xs[0], torch.zeros(
        1, dtype=torch.int64, device=xs[0].head.device))
    n_disc = x.disc.numel() if x.disc is not None else 0
    # each input read once (head, tail, unique, status, disc, err, k), k
    # and go written once; a compare and an and a term
    nbytes = 8 * (4 + n_disc + 2) + (1 if x.err is not None else 0) + 1
    b_ms, b_by = bound(nbytes, 2 * (6 + n_disc))
    go = bool(block_cond_plain(x, k, BLOCK_STEPS)[0].all())
    cell = dict(name="block_cond", route="cuda",
                source="stateright_tpu_torch/csrc/block_loop.cu",
                replaces="stateright_tpu/parallel/wavefront.py:701",
                max_abs_err=err, matched=err == 0, bound_ms=b_ms,
                bound_by=b_by, library_ms=None,
                shape={"disc": n_disc, "steps": BLOCK_STEPS,
                       "checked": x.err is not None,
                       "target": x.target, "k": int(k[0]), "go": go,
                       "go_true_cases": n_go, "go_false_cases": n_stop})
    cell.update(timings(lambda: block_cond(x, k, BLOCK_STEPS),
                        lambda: block_cond_plain(x, k, BLOCK_STEPS),
                        cold=False))
    return cell


def block_graph_phase(dev, smi: str) -> dict:
    """``block_graph``: every :data:`BLOCK_LEGS` leg, complete and stopped
    on growth (:func:`block_leg`), must be bit-identical to the eager
    loop; then the ``block_cond`` cell.  Returns the cell."""
    legs, xs = {}, []
    for name in BLOCK_LEGS:
        for grow in (False, True):
            rec, x = block_leg(dev, name, grow)
            leg = f"{name}_growth" if grow else name
            legs[leg] = rec
            xs.extend(x)
            print(json.dumps({"block_graph_leg": leg, **{
                k: rec[k] for k in ("steps_executed", "steps_run",
                                    "run_steps_executed", "run_steps_run",
                                    "capture_secs", "host_ops_per_graph_block",
                                    "host_ops_per_eager_block",
                                    "bit_identical")}}), flush=True)
    bad = [leg for leg, r in legs.items() if not r["bit_identical"]]
    cell = block_cond_cell(xs)
    emit("block_graph", {"legs": legs, "block_cond": cell, "card": smi})
    if bad:
        raise AssertionError(f"block graph differs from the eager loop: {bad}")
    if not cell["matched"]:
        raise AssertionError(f"block_cond disagrees with plain: {cell}")
    if not (cell["shape"]["go_true_cases"] and cell["shape"]["go"]):
        raise AssertionError(f"block_cond: no case with go true: {cell}")
    if legs["2pc5_target"]["unique"] < BLOCK_TARGET:
        raise AssertionError("block graph: the target leg stopped short")
    if legs["2pc5_discovery"]["unique"] >= 8832:
        raise AssertionError("block graph: no discovery stop")
    return cell


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
    if launches["bucket_plan_fused"] != 2 * launches["insert_commit"]:
        raise AssertionError(f"2pc-15 symmetry: launches {launches}")
    emit("2pc15_symmetry", dict(
        leg_record(g, g_s, peak, launches, smi), path_lengths=paths,
        unique_per_sec=g.unique_state_count() / g_s,
        launches_per_step={k: v / g.steps_executed for k, v in launches.items()}))
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
        if not all_launched(launches):
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
                       ("cand_prep", "bucket_plan_fused", "insert_commit")):
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
    if not all_launched(launches):
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


class OOBTwin(TensorModel):
    """The JAX sanitizer tests' out-of-range gather twin
    (``tests/test_sanitizer.py:64-80``): a 3-bit count indexes a 4-entry
    table, so counts 4..7 escape it."""

    width, max_actions = 1, 1
    pk = BitPacker([("count", 3)])

    def __init__(self, model):
        self.model = model
        self._tables: dict = {}

    def init_rows(self):
        return np.zeros((1, 1), np.uint64)

    def encode_state(self, s):
        return (int(s),)

    def decode_state(self, row):
        return int(row[0])

    def property_masks(self, rows):
        return torch.ones((rows.shape[0], 1), dtype=torch.bool,
                          device=rows.device)

    def table(self, device) -> torch.Tensor:
        """The 4-entry table on ``device``, built at the first step there
        (a step issues no host-to-device copy, so the block graph can
        capture it)."""
        t = self._tables.get(device)
        if t is None:
            t = self._tables[device] = torch.tensor(
                [1, 2, 3, 4], dtype=torch.int64, device=device)
        return t

    def step_rows(self, rows):
        c = self.pk.get(rows, "count")
        tbl = self.table(rows.device)
        succ = rows.clone()
        succ[..., 0] = tbl[c]
        return succ[:, None, :], (c < 7)[:, None]


class OOBModel(TensorBackedModel, Model):
    """A counter 0..7 whose twin is :class:`OOBTwin`."""

    def tensor_model(self):
        return OOBTwin(self)

    def init_states(self):
        return [0]

    def actions(self, s):
        return [0] if s < 7 else []

    def next_state(self, s, a):
        return s + 1

    def properties(self):
        return [Property.always("ok", lambda m, s: True)]


@contextlib.contextmanager
def device_bytes(budget: int):
    """``STATERIGHT_TPU_DEVICE_BYTES`` (the memory ledger's budget, which
    the spill tier evicts on) set for the block, the capacity guard off."""
    keys = ("STATERIGHT_TPU_DEVICE_BYTES", "STATERIGHT_TPU_CAPACITY_GUARD")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(zip(keys, (str(budget), "off")))
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def spill_budget(model, cuda: bool, fit: int, qcap: int, batch: int,
                 cartography: bool = False, bits: int = SPILL_BLOOM) -> int:
    """The device budget that takes the ``fit`` table rung's growth from
    ``fit / 2`` but not the growth to ``2 * fit``: ``tot(fit) + tot(2 *
    fit) - 1`` on the port's own analytic buffers (on the card, the
    kernels' scratch included) at the run's first candidate budget."""
    from stateright_tpu_torch.parallel.wavefront import memory_spec_fn
    from stateright_tpu_torch.telemetry.memory import total_bytes

    tensor = model.tensor_model()
    m = batch * tensor.max_actions
    spec = memory_spec_fn(tensor, len(model.properties()),
                          cartography=cartography, cuda=cuda,
                          spill=(bits, 4 * m))

    def tot(cap):
        return total_bytes(spec(dict(cap=cap, qcap=qcap, batch=batch,
                                     cand=min(max(4 * batch, 4096), m))))

    return tot(fit) + tot(2 * fit) - 1


def spill_2pc5_builder():
    """2pc-5 under ``.spill()`` with cartography and the memory ledger
    (the configuration its budget is computed for: a run without the
    counters would fit the growth by their bytes)."""
    return (TwoPhaseSys(5).checker().spill()
            .telemetry(cartography=True, memory=True))


def spill_run(device, budget: int, **kw):
    """:func:`spill_2pc5_builder`'s run at :data:`SPILL_2PC5_KW` and
    ``budget``; joined."""
    with device_bytes(budget):
        return spill_2pc5_builder().spawn_gpu(
            device=device, **dict(SPILL_2PC5_KW, **kw)).join()


def reconciles(c, n_init: int = 1) -> bool:
    cart = c.cartography()
    return (sum(cart["depth_hist"]) == c.unique_state_count()
            == cart["fresh_inserts"]
            and sum(cart["action_hist"]) == c.state_count() - n_init)


def spill_2pc5_leg(dev, smi: str, ref5: dict) -> tuple:
    """``spill_2pc5`` (module docstring), against the plain 2pc-5 leg's
    run ``ref5``; returns its launches (the inject's apart, under
    ``inject``) and its inject kernel cell."""
    kw5 = SPILL_2PC5_KW
    budgets = {
        kind: spill_budget(TwoPhaseSys(5), on_card, SPILL_2PC5_FIT,
                           kw5["queue_capacity"], kw5["batch"],
                           cartography=True)
        for kind, on_card in (("cuda", dev.type == "cuda"), ("cpu", False))}
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with first_inject({}) as kept:
        g = spill_run(dev, budgets["cuda"])
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    launches = kernel_launches()
    leg = dict(launches, inject=dict(g.inject_launches))
    cell = inject_kernels(kept, "spill 2pc-5")
    del kept
    sp = g.spill_status()
    hot = int((g._final_carry[convert.TFP] != EMPTY).sum())
    live = {n: t.nbytes for n, t in g.live_buffers().items()}
    spec = {b.name: b.nbytes for b in g._memory_spec_fn()(g._memory_caps())}
    t0 = time.monotonic()
    c = spill_run("cpu", budgets["cpu"])
    c_s = time.monotonic() - t0
    gs, cs = g.final_snapshot(), c.final_snapshot()
    same, tail = same_snapshots(gs, cs)
    same_store = all(np.array_equal(gs[k], cs[k])
                     for k in ("spill_fp", "spill_parent"))
    # a live checkpoint after the first eviction, resumed on the card
    with device_bytes(budgets["cuda"]):
        running = spill_2pc5_builder().spawn_gpu(device=dev, **SPILL_2PC5_KW)
        snap = None
        while not running.is_done():
            s = running.checkpoint(timeout=600.0)
            if int(s.get("spill_base", 0)) > 0 and int(s["tail"]) > int(
                    s["head"]):
                snap = s
                break
        running.stop().join()
        if snap is None:
            raise AssertionError("spill 2pc-5: no checkpoint after an "
                                 "eviction")
        r = spill_2pc5_builder().spawn_gpu(device=dev, resume=snap,
                                           **SPILL_2PC5_KW).join()
    rs = r.final_snapshot()
    resumed_same, _ = same_snapshots(gs, rs)
    resumed_store = all(np.array_equal(gs[k], rs[k])
                        for k in ("spill_fp", "spill_parent"))
    emit("spill_2pc5", {
        "unique": g.unique_state_count(), "states": g.state_count(),
        "sec": sec, "plain_2pc5_sec": ref5["sec"],
        "wall_over_plain": sec / ref5["sec"], "steps": g.steps_run,
        "budget_bytes": budgets, "spill": sp, "hot_fps": hot,
        "inject_calls": g.inject_calls, "launches": leg,
        "growth_events": g.growth_events, "stages": g.flight_recorder.stages(),
        "cpu": {"unique": c.unique_state_count(), "sec": c_s,
                "spill": c.spill_status()},
        "tables_and_queue_identical": same, "store_identical": same_store,
        "analytic_equals_live_bytes": live == spec,
        "resume": {"snap_unique": int(snap["unique"]),
                   "snap_spill_base": int(snap["spill_base"]),
                   "unique": r.unique_state_count(),
                   "tables_and_queue_identical": resumed_same,
                   "store_identical": resumed_store},
        "card": smi})
    if ((g.unique_state_count(), g.state_count()) != TPC5
            or (ref5["unique"], ref5["states"]) != TPC5
            or g.discovery_fps() != ref5["disc"]):
        raise AssertionError("spill 2pc-5: not the plain leg's run")
    if sp["evictions"] < 1 or hot + sp["spilled_fps"] != TPC5[0]:
        raise AssertionError(f"spill 2pc-5: tiers do not partition: {sp}")
    if live != spec:
        raise AssertionError("spill 2pc-5: analytic bytes are not the live "
                             "tensors'")
    if not (reconciles(g) and reconciles(c)):
        raise AssertionError("spill 2pc-5: cartography does not reconcile")
    if not (same and same_store and c.spill_status() == sp):
        raise AssertionError("spill 2pc-5: cuda and cpu disagree")
    if not (resumed_same and resumed_store
            and r.unique_state_count() == TPC5[0]):
        raise AssertionError("spill 2pc-5: the resumed run differs")
    if not all_launched(launches):
        raise AssertionError(f"a kernel never launched: {launches}")
    if not all(g.inject_launches.values()):
        raise AssertionError(f"the inject never ran: {g.inject_launches}")
    return leg, cell


def checked_spill_phases(dev, smi: str, ref5: dict, ref7: dict,
                         p3_ref) -> tuple:
    """Checked mode and the spill tier on the card (module docstring);
    returns each leg's launches (the spill legs' inject launches apart,
    under ``inject``) and each spill leg's inject kernel cell."""
    legs, cells = {}, {}
    # -- checked_2pc7: 2pc-7 complete under .checked() -------------------------
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    g = TwoPhaseSys(7).checker().checked().spawn_gpu().join()
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    legs["checked_2pc7"] = launches = kernel_launches()
    paths = check_discoveries(g.model, g, {"abort agreement",
                                           "commit agreement"})
    g.assert_properties()
    if (g.unique_state_count() != TPC7_UNIQUE
            or g.state_count() != ref7["states"]
            or g.discovery_fps() != ref7["disc"]):
        raise AssertionError("checked 2pc-7: not the plain leg's run")
    if not all_launched(launches):
        raise AssertionError(f"a kernel never launched: {launches}")
    sync_runs = {}
    for spc in SYNC_STEPS_PER_CALL:
        def run(spc=spc):
            return (TwoPhaseSys(7).checker().checked()
                    .target_states(SC4_SYNC_TARGET)
                    .spawn_gpu(capacity=SC4_SYNC_CAPACITY,
                               cand=CHECKED_SYNC_CAND,
                               steps_per_call=spc).join())
        gs, syncs = profiled_sync_count(dev, run)
        if gs.growth_events:
            raise AssertionError("the sync count's run grew: it must not")
        sync_runs[spc] = {"unique": gs.unique_state_count(),
                          "steps": gs.steps_run,
                          "blocks": -(-gs.steps_run // spc),
                          "stream_syncs": syncs.get("cudaStreamSynchronize", 0)}
    a, b = (sync_runs[spc] for spc in SYNC_STEPS_PER_CALL)
    per_block = ((b["stream_syncs"] - a["stream_syncs"])
                 / (b["blocks"] - a["blocks"]))
    emit("checked_2pc7", {
        "unique": g.unique_state_count(), "states": g.state_count(),
        "sec": sec, "plain_2pc7_sec": ref7["sec"],
        "wall_over_plain": sec / ref7["sec"], "steps": g.steps_run,
        "plain_2pc7_steps": ref7["steps"], "path_lengths": paths,
        "launches": launches, "host_syncs": {str(k): v for k, v in
                                             sync_runs.items()},
        "stream_syncs_per_block": per_block, "card": smi})
    if per_block != 1.0:
        raise AssertionError(f"checked: {per_block} stream syncs a block")
    del g
    lap("checked_2pc7")

    # -- checked_paxos2: cuda and cpu, PaxosTensor's gathers guarded ---------
    def p2(device):
        t0 = time.monotonic()
        c = paxos_model(2).checker().checked().spawn_gpu(
            device=device, batch=256).join()
        if device != "cpu":
            torch.cuda.synchronize()
        return c, time.monotonic() - t0

    reset_launches()
    (g2, g2_s) = p2(dev)
    legs["checked_paxos2"] = kernel_launches()
    c2, c2_s = p2("cpu")
    same, tail = same_tables_and_queue(g2, c2)
    emit("checked_paxos2", {
        "unique_cuda": g2.unique_state_count(),
        "unique_cpu": c2.unique_state_count(), "states": g2.state_count(),
        "tables_and_queue_identical": same, "tail": tail,
        "sec_cuda": g2_s, "sec_cpu": c2_s,
        "launches": legs["checked_paxos2"], "card": smi})
    if not (same and (g2.unique_state_count(), g2.state_count())
            == P2_PER_CHANNEL == (c2.unique_state_count(), c2.state_count())):
        raise AssertionError("checked paxos-2: not 16,668 / 32,971 on both")
    del g2, c2
    lap("checked_paxos2")

    # -- checked_oob: the out-of-range twin raises; the context survives -----
    try:
        OOBModel().checker().skip_audit().checked().spawn_gpu(
            batch=8, capacity=1 << 10).join()
    except CheckedExecutionError as e:
        err = e
    else:
        raise AssertionError("checked OOB twin: no CheckedExecutionError")
    torch.cuda.synchronize()
    after = TwoPhaseSys(3).checker().spawn_gpu().join()
    emit("checked_oob", {"state": err.state, "row_index": err.row_index,
                         "message": str(err).splitlines()[-1],
                         "unique_2pc3_after": after.unique_state_count()})
    if err.state != 4 or "out-of-bounds" not in str(err):
        raise AssertionError(f"checked OOB twin: {err}")
    if after.unique_state_count() != 288:
        raise AssertionError("2pc-3 after the OOB twin: not 288")
    lap("checked_oob")

    legs["spill_2pc5"], cells["spill_2pc5"] = spill_2pc5_leg(dev, smi, ref5)
    lap("spill_2pc5")

    # -- spill_paxos3: the benchmark model, the 2^21 -> 2^22 growth blocked --
    budget3 = spill_budget(paxos_model(3), dev.type == "cuda", 1 << 21,
                           SPILL_P3_QCAP, 2048, bits=SPILL_P3_BLOOM)
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with device_bytes(budget3), first_inject({}) as kept:
        g3 = paxos_model(3).checker().spill().spawn_gpu(
            queue_capacity=SPILL_P3_QCAP,
            spill_bloom_bits=SPILL_P3_BLOOM).join()
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    launches = kernel_launches()
    peak = torch.cuda.max_memory_allocated(dev)  # before the kernel cell
    legs["spill_paxos3"] = dict(launches, inject=dict(g3.inject_launches))
    cells["spill_paxos3"] = inject_kernels(kept, "spill paxos-3")
    del kept
    paths3 = check_discoveries(g3.model, g3, {"value chosen"})
    g3.assert_properties()  # "linearizable" never violated
    sp3 = g3.spill_status()
    emit("spill_paxos3", {
        "unique": g3.unique_state_count(), "states": g3.state_count(),
        "sec": sec, "plain_paxos3_sec": p3_ref[2]["sec"],
        "wall_over_plain": sec / p3_ref[2]["sec"], "steps": g3.steps_run,
        "plain_paxos3_steps": p3_ref[2]["steps"], "budget_bytes": budget3,
        "table_slots": g3._cap, "spill": sp3,
        "inject_calls": g3.inject_calls, "launches": legs["spill_paxos3"],
        "growth_events": g3.growth_events,
        "peak_device_mib": peak / 2**20, "path_lengths": paths3,
        "card": smi})
    if (g3.unique_state_count(), g3.state_count()) != (PAXOS3_UNIQUE,
                                                       PAXOS3_STATES):
        raise AssertionError("spill paxos-3: not 1,194,428 / 2,420,477")
    if sp3["evictions"] < 1 or g3._cap != 1 << 21:
        raise AssertionError(f"spill paxos-3: {sp3['evictions']} evictions, "
                             f"{g3._cap} slots (the budget pins 2^21)")
    if not all_launched(launches):
        raise AssertionError(f"a kernel never launched: {launches}")
    del g3
    lap("spill_paxos3")

    # -- dispatched operations a step under the two flags --------------------
    ops = {}
    for model, build in (("2pc7", lambda: TwoPhaseSys(7)),
                         ("paxos3", lambda: paxos_model(3))):
        for tag, flags in (("off", ()), ("checked", CHECKED),
                           ("spill", SPILL)):
            ops[f"{model}_{tag}"] = ops_per_step(dev, False, flags, build)
    emit("checked_spill_ops_per_step", dict(ops, card=smi))
    lap("checked_spill_ops")
    for leg, cell in cells.items():
        for name, k in cell.items():
            emit(f"kernel_{name}_{leg}_inject", k)
    return legs, cells


# -- the supervisor, the fault layer and the audit ----------------------------


class StampedPlan(FaultPlan):
    """A fault plan that notes when its fault fired (the start of a
    restart's seconds)."""

    failed_at: Optional[float] = None

    def _fire(self, site, recorder=None, **ctx):
        try:
            super()._fire(site, recorder=recorder, **ctx)
        except BaseException:
            self.failed_at = time.monotonic()
            raise


def first_block_secs(checker, failed_at: float) -> float:
    """Seconds from a failure to the end of the resumed run's first block:
    its second ``step`` record (the first is the resume's own sync, before
    any block), on the recorder's clock."""
    rec = checker.flight_recorder
    steps = rec.records("step")
    if len(steps) < 2:
        raise AssertionError("the resumed run ran no block")
    return steps[1]["t"] - rec.rel(failed_at)


def supervise_kill_leg(dev, smi: str, ref7: dict, n: int = 7,
                       kill_at: int = SUPERVISE_KILL_AT) -> dict:
    """``supervise_2pc7_kill``: 2pc-7 under ``supervise`` on the card,
    autosaving every sync into a temp dir, killed by a ``host_sync`` fault;
    it must restart once (``preemption``) and end with the plain 2pc-7
    leg's counts, discoveries, table bytes and queue rows.  Returns the
    leg's launches."""
    plan = StampedPlan([Fault(site="host_sync", action="kill",
                              at=kill_at)])
    recorders = []  # each attempt's recorder: the fault record is the first's

    def spawn(b, resume=None, **kw):
        c = b.spawn_gpu(resume=resume, **kw)
        recorders.append(c.flight_recorder)
        return c

    with tempfile.TemporaryDirectory(prefix="supervise-2pc7-") as root:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        with plan:
            res = supervise(TwoPhaseSys(n).checker().telemetry(),
                            autosave_dir=root, every_secs=0.0,
                            max_restarts=2, sleep=lambda s: None,
                            spawn=spawn, device=dev)
        torch.cuda.synchronize()
        sec = time.monotonic() - t0
        launches = kernel_launches()
        gens = len(ckpt.list_generations(root))
    c = res.checker
    restart = c.flight_recorder.records("restart")
    fault = recorders[0].records("fault")
    same, tail = same_snapshots(c.final_snapshot(), ref7["snap"])
    out = {
        "unique": c.unique_state_count(), "states": c.state_count(),
        "restarts": res.restarts,
        "attempts": [a.outcome for a in res.attempts],
        "fired": plan.fired, "fault_records": fault,
        "restart_records": restart,
        "resumed_from_gen": res.attempts[-1].resumed_from_gen,
        "restart_secs": first_block_secs(c, plan.failed_at),
        "sec": sec, "plain_sec": ref7["sec"], "generations_left": gens,
        "tables_and_queue_identical": same, "tail": tail,
        "device": str(c.device), "launches": launches, "card": smi}
    emit("supervise_2pc7_kill", out)
    print(f"supervise_2pc7_kill: restart took {out['restart_secs']:.3f} s "
          f"from the failure to the resumed run's first block ({smi})",
          flush=True)
    if not (plan.fired and res.restarts == 1 and restart
            and restart[0]["reason"] == "preemption"):
        raise AssertionError(f"supervise_2pc7_kill: {out}")
    if c.device.type != torch.device(dev).type or not (
            0 < res.attempts[-1].resumed_from_gen):
        raise AssertionError("supervise_2pc7_kill: not resumed on the card "
                             "from a mid-run generation")
    if (c.unique_state_count(), c.state_count()) != (ref7["unique"],
                                                    ref7["states"]):
        raise AssertionError(f"supervise_2pc7_kill: {out['unique']} / "
                             f"{out['states']}")
    if not same or c.discovery_fps() != ref7["disc"]:
        raise AssertionError("supervise_2pc7_kill: the resumed run differs "
                             "from the plain 2pc-7 leg")
    if [(r["site"], r["at"]) for r in fault] != [("host_sync", kill_at)]:
        raise AssertionError(f"supervise_2pc7_kill: fault records {fault}")
    if not all_launched(launches):
        raise AssertionError(f"supervise_2pc7_kill: a kernel never launched: "
                             f"{launches}")
    return launches


def oom_child(n: int = 7, device: str = "cuda") -> int:
    """``supervise_oom_real``, run in a process of its own (the allocator
    limit must not reach any other leg), at batch :data:`OOM_BATCH`.  A
    first, unlimited 2pc-7 run finds the last table growth and its
    capacities; the port's memory
    ledger gives that rung's footprint (the allocator's bound) and the
    growth's transient; ``torch.cuda.set_per_process_memory_fraction``
    puts a wall between the two; and 2pc-7 under ``supervise`` must then
    meet a real ``torch.OutOfMemoryError``, classify it ``oom``, arm the
    spill tier, evict and end with the first run's counts.  The allocator
    keeps tensors of 1-10 MB in 20 MB segments, so at these sizes a wall's
    effect is known only to a segment: the leg tries the walls of
    :data:`OOM_WALL_SHARES` of the gap in turn, and reports every trial
    with the measured peaks; it passes when one trial does all of the
    above.  The ledger's bytes are the carry's and the kernels' buffers;
    the engine's block graph holds its private pool besides (the largest
    the first run's graphs reserved), which each wall adds.
    Prints one JSON line."""
    from stateright_tpu_torch.parallel.wavefront import (
        _STATUS_TABLE_FULL as TABLE_FULL,
    )
    from stateright_tpu_torch.telemetry.memory import (
        alloc_bytes,
        transient_block,
    )

    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    if dev.type == "cuda":
        _cuda.library()
    regrow = GpuChecker._regrow
    seen = {}

    def probe(self, carry, cap, qcap, batch, status, cand, at=None,
              evict=False):
        if at != "growth" or status != TABLE_FULL:
            return regrow(self, carry, cap, qcap, batch, status, cand,
                          at=at, evict=evict)
        torch.cuda.synchronize(dev)
        pre = torch.cuda.max_memory_allocated(dev)
        out = regrow(self, carry, cap, qcap, batch, status, cand, at=at,
                     evict=evict)
        torch.cuda.synchronize(dev)
        spec = self._memory_spec_fn()
        before = self._memory_caps(cap, qcap, batch, cand)
        after = self._memory_caps(out[0], out[1], batch, cand)
        seen.update(cap=cap, pre=pre,
                    post=torch.cuda.max_memory_allocated(dev),
                    footprint=alloc_bytes(spec(before)),
                    transient=transient_block(spec, before, after)[
                        "transient_alloc_bytes"])
        return out

    GpuChecker._regrow = probe
    try:
        g = TwoPhaseSys(n).checker().spawn_gpu(device=dev,
                                               batch=OOM_BATCH).join()
    finally:
        GpuChecker._regrow = regrow
    unique, states = g.unique_state_count(), g.state_count()
    pool = max((b["pool_bytes"] for b in g.block_graphs), default=0)
    del g
    gc.collect()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(dev).total_memory
    low, high = seen["footprint"], seen["transient"]
    result = {"n": n, "growth_from_cap": seen["cap"],
              "ledger_footprint_alloc_bytes": low,
              "ledger_transient_alloc_bytes": high,
              "measured_peak_before_growth": seen["pre"],
              "measured_peak_across_growth": seen["post"],
              "graph_pool_bytes": pool, "device_bytes": total, "trials": []}
    ok = False
    for share in OOM_WALL_SHARES:
        wall = int(low + share * (high - low)) + pool
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.set_per_process_memory_fraction(wall / total, dev)
        reset_launches()
        trial = {"share": share, "wall_bytes": wall,
                 "fraction": wall / total}
        with tempfile.TemporaryDirectory(prefix="supervise-oom-") as root:
            t0 = time.monotonic()
            try:
                res = supervise(TwoPhaseSys(n).checker().telemetry(),
                                autosave_dir=root, every_secs=0.0,
                                max_restarts=2, sleep=lambda s: None,
                                batch=OOM_BATCH,
                                **({} if dev.type == "cuda"
                                   else {"device": dev}))
            except Exception as e:  # noqa: BLE001 - the trial's result
                trial["error"] = f"{type(e).__name__}: {e}"
                res = None
            torch.cuda.synchronize(dev)
            trial["sec"] = time.monotonic() - t0
        torch.cuda.set_per_process_memory_fraction(1.0, dev)
        if res is not None:
            c, first = res.checker, res.attempts[0]
            trial.update({
                "unique": c.unique_state_count(), "states": c.state_count(),
                "restarts": res.restarts, "degradations": res.degradations,
                "attempts": [a.outcome for a in res.attempts],
                "first_error": first.error,
                "evictions": (c.spill_status() or {}).get("evictions", 0),
                "peak_allocated": torch.cuda.max_memory_allocated(dev),
                "peak_reserved": torch.cuda.max_memory_reserved(dev),
                "launches": kernel_launches(), "device": str(c.device)})
            trial["ok"] = bool(
                first.outcome == "oom" and res.restarts == 1
                and (first.error or "").startswith("OutOfMemoryError")
                and len(res.degradations) == 1
                and res.degradations[0].startswith("spill_armed(budget=")
                and trial["evictions"] >= 1 and c.device.type == dev.type
                and (c.unique_state_count(), c.state_count()) == (unique,
                                                                  states)
                and all_launched(trial["launches"]))
            del c, res
        gc.collect()
        torch.cuda.empty_cache()
        result["trials"].append(trial)
        if trial.get("ok"):
            ok = True
            result.update({k: trial[k] for k in (
                "wall_bytes", "fraction", "unique", "states", "restarts",
                "degradations", "first_error", "evictions", "launches",
                "sec")})
            break
    result["ok"] = ok
    print(json.dumps({"supervise_oom_real": result}), flush=True)
    return 0 if ok else 1


def supervise_oom_leg(smi: str) -> dict:
    """Run :func:`oom_child` in a child process and read its JSON line;
    the leg fails unless the child says ok.  Returns its launches."""
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--oom-child"], capture_output=True, text=True,
                         timeout=600)
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith('{"supervise_oom_real"')]
    if not lines:
        raise AssertionError(f"supervise_oom_real: no result (exit "
                             f"{out.returncode}): {out.stderr[-4000:]}")
    result = json.loads(lines[-1])["supervise_oom_real"]
    result["card"] = smi
    result["child_exit"] = out.returncode
    emit("supervise_oom_real", result)
    if out.returncode != 0 or not result.get("ok"):
        raise AssertionError(f"supervise_oom_real failed: {result}; "
                             f"{out.stderr[-4000:]}")
    return result["launches"]


# the supervise verb, run as ``python -m`` would run it, with the kernel
# launch counts printed at exit (they are lost with a SIGKILLed process)
VERB_RUNNER = (
    "import atexit, json, runpy, sys\n"
    "from stateright_tpu_torch.ops import buckets, cand_prep, hashing, "
    "insert_commit\n"
    "ks = (cand_prep.cand_prep, hashing.row_hash, "
    "buckets.bucket_plan_fused, buckets.bucket_plan, "
    "insert_commit.insert_commit)\n"
    "atexit.register(lambda: print(json.dumps({'launches': {k.__name__: "
    "k.launches for k in ks}})))\n"
    "sys.argv = ['two_phase_commit'] + sys.argv[1:]\n"
    "runpy.run_module('stateright_tpu_torch.models.two_phase_commit', "
    "run_name='__main__', alter_sys=True)\n"
)


def supervise_sigkill_leg(smi: str, n: int = 7, kill_at: int =
                          SUPERVISE_KILL_AT, extra=()) -> dict:
    """``supervise_sigkill``: the ``supervise`` verb SIGKILLed by a fault
    plan at a mid-run host sync; ``_cli status`` prints the heartbeat it
    left; the same command without the plan resumes, archives the dead
    parent's stub and ends at 296,448 with a ``parent_run_id``; ``compare
    PARENT CHILD --expect=IDENTICAL`` exits 0.  Returns the resumed run's
    launches."""
    def run(*args, module=None, timeout=300):
        cmd = ([sys.executable, "-c", VERB_RUNNER] if module is None
               else [sys.executable, "-m", module])
        return subprocess.run([*cmd, *args], capture_output=True, text=True,
                              timeout=timeout)

    with tempfile.TemporaryDirectory(prefix="supervise-sigkill-") as tmp:
        auto, runs = os.path.join(tmp, "auto"), os.path.join(tmp, "runs")
        plan = os.path.join(tmp, "plan.json")
        with open(plan, "w") as f:
            json.dump(FaultPlan([Fault(site="host_sync", action="sigkill",
                                       at=kill_at)]).to_json(), f)
        args = ["supervise", str(n), f"--autosave={auto}", f"--runs={runs}",
                "--every=0", *extra]
        t0 = time.monotonic()
        dead = run(*args, f"--fault-plan={plan}")
        dead_s = time.monotonic() - t0
        status = run("status", auto,
                     module="stateright_tpu_torch.models._cli", timeout=120)
        parent = ckpt.latest_generation(auto)[1]
        t1 = time.monotonic()
        done = run(*args)
        done_s = time.monotonic() - t1
        line = [ln for ln in done.stdout.splitlines()
                if ln.startswith("supervised:")]
        launches = [json.loads(ln)["launches"] for ln in done.stdout.splitlines()
                    if ln.startswith('{"launches"')]
        child = line[-1].split("run_id=")[1].split()[0] if line else None
        cmp = run("compare", parent["run_id"], str(child),
                  f"--registry={runs}", "--expect=IDENTICAL",
                  module="stateright_tpu_torch.models.two_phase_commit",
                  timeout=120)
    out = {"killed_exit": dead.returncode, "killed_sec": dead_s,
           "status_exit": status.returncode,
           "status": status.stdout.strip().splitlines(),
           "parent_run_id": parent["run_id"],
           "parent_totals": parent["totals"], "resumed_exit":
               done.returncode, "resumed_sec": done_s,
           "resumed": line[-1] if line else None,
           "compare_exit": cmp.returncode,
           "compare": cmp.stdout.strip().splitlines()[:3],
           "launches": launches[-1] if launches else None, "card": smi}
    emit("supervise_sigkill", out)
    if dead.returncode != -9:
        raise AssertionError(f"supervise_sigkill: the run did not die by "
                             f"SIGKILL: {out} {dead.stderr[-3000:]}")
    if status.returncode != 0 or not any(
            w in status.stdout for w in ("RUNNING", "DEAD")):
        raise AssertionError(f"supervise_sigkill: status: {out}")
    if done.returncode != 0 or not line or not (
            f"unique={TPC7_UNIQUE} " in line[-1]
            and "done=True" in line[-1]
            and f"parent_run_id={parent['run_id']}" in line[-1]):
        raise AssertionError(f"supervise_sigkill: the resume: {out} "
                             f"{done.stderr[-3000:]}")
    if cmp.returncode != 0:
        raise AssertionError(f"supervise_sigkill: compare: {out} "
                             f"{cmp.stdout[-3000:]}")
    if not launches or not all_launched(launches[-1], STEP_KERNELS[:1]
                                        + STEP_KERNELS[2:]):
        raise AssertionError(f"supervise_sigkill: the resumed run's "
                             f"launches: {launches}")
    return launches[-1]


def audit_leg(smi: str) -> dict:
    """``audit``: the port's fleet audit and fleet sanitizer are clean,
    and the light preflight a spawn runs (the kernel audit and the static
    sanitizer included) takes these seconds, uncached (a fresh
    configuration) and cached (a respawn)."""
    from stateright_tpu_torch.analysis import audit as audit_mod

    buf, sbuf = io.StringIO(), io.StringIO()
    reset_launches()
    t0 = time.monotonic()
    rc = fleet_audit(stream=buf)
    fleet_s = time.monotonic() - t0
    t0 = time.monotonic()
    src = fleet_sanitize(stream=sbuf)
    sanitize_s = time.monotonic() - t0
    per_spawn = {}
    for name, build in (("2pc7", lambda: TwoPhaseSys(7)),
                        ("paxos3", lambda: paxos_model(3)),
                        ("singlecopy4", lambda: single_copy_model(4)),
                        ("paxos2_per_channel", per_channel_paxos2)):
        audit_mod._SHARED_REPORTS.clear()
        b = build().checker()
        t1 = time.monotonic()
        b._preflight_audit()
        cold = time.monotonic() - t1
        t2 = time.monotonic()
        for _ in range(100):
            build().checker()._preflight_audit()
        per_spawn[name] = {"uncached_secs": cold,
                           "cached_secs": (time.monotonic() - t2) / 100}
    out = {"fleet_exit": rc, "fleet_secs": fleet_s,
           "fleet": buf.getvalue().strip().splitlines()[-1],
           "sanitize_exit": src, "sanitize_secs": sanitize_s,
           "sanitize": sbuf.getvalue().strip().splitlines()[-1],
           "preflight_secs_per_spawn": per_spawn,
           "launches": kernel_launches(), "card": smi}
    emit("audit", out)
    for name, v in per_spawn.items():
        print(f"audit: light preflight {name}: {v['uncached_secs']:.6f} s "
              f"uncached, {v['cached_secs']:.6f} s cached per spawn ({smi})",
              flush=True)
    if rc != 0 or out["fleet"] != "audit fleet: CLEAN":
        raise AssertionError(f"audit: the fleet is not clean: "
                             f"{buf.getvalue()[-3000:]}")
    if src != 0 or out["sanitize"] != "sanitize fleet: CLEAN":
        raise AssertionError(f"sanitize: the fleet is not clean: "
                             f"{sbuf.getvalue()[-3000:]}")
    return out["launches"]


def preflight_oob_leg(smi: str) -> dict:
    """``preflight_oob``: the out-of-range twin spawned on the card with
    the preflight on is refused with JX201 before any launch, and the
    process's CUDA context serves a 2pc-3 run after it."""
    reset_launches()
    try:
        OOBModel().checker().spawn_gpu(batch=8, capacity=1 << 10).join()
    except AuditError as e:
        err = e
    else:
        raise AssertionError("preflight: the out-of-range twin was spawned")
    launches = kernel_launches()
    torch.cuda.synchronize()
    after = TwoPhaseSys(3).checker().spawn_gpu().join()
    out = {"rule_ids": list(err.rule_ids),
           "finding": [f.format() for f in err.report.errors],
           "launches": launches,
           "unique_2pc3_after": after.unique_state_count(), "card": smi}
    emit("preflight_oob", out)
    if "JX201" not in err.rule_ids or any(launches.values()):
        raise AssertionError(f"preflight OOB: {out}")
    if after.unique_state_count() != 288:
        raise AssertionError("2pc-3 after the refused twin: not 288")
    return launches


def supervise_phases(dev, smi: str, ref7: dict) -> dict:
    """The four legs of the supervisor and the audit, each timed into
    ``PHASES``; returns each leg's launches."""
    out = {"supervise_2pc7_kill": supervise_kill_leg(dev, smi, ref7)}
    lap("supervise_2pc7_kill")
    out["supervise_oom_real"] = supervise_oom_leg(smi)
    lap("supervise_oom_real")
    out["supervise_sigkill"] = supervise_sigkill_leg(smi)
    lap("supervise_sigkill")
    out["audit"] = audit_leg(smi)
    lap("audit")
    out["preflight_oob"] = preflight_oob_leg(smi)
    lap("preflight_oob")
    return out


# the sweep legs (stateright_tpu_torch/sweep/): 2pc-7 under 8 table seeds
# in one table, at a batch 8 times the plain leg's (the same steps, each
# eight members wide), and a candidate budget that takes a step's valid
# lanes; the paxos family; the lifted bounded-counter cohort
SWEEP_SEEDS = 8
SWEEP_2PC7_KW = dict(capacity=1 << 24, batch=1 << 14, cand=1 << 18)
SWEEP_OPS_TARGET = 20_000
SWEEP_PAXOS_KW = dict(capacity=1 << 14, batch=256)
SWEEP_BOUNDS = (1, 2, 3, 4, 5, 6, 7, 8)
SWEEP_LIFTED_KW = dict(capacity=1 << 12, batch=32, steps_per_call=4)
FALLBACK_WARNING = "have not yet implemented the batching rule for "


def seed_spec(n: int = 7, target=None):
    """2pc-``n`` under :data:`SWEEP_SEEDS` table seeds (seed 0 first)."""
    from stateright_tpu_torch.sweep import SweepInstance, SweepSpec

    return SweepSpec([
        SweepInstance(f"2pc{n}-seed{i}", TwoPhaseSys(n),
                      params={"rm": n, "seed": i}, seed=i, target=target)
        for i in range(SWEEP_SEEDS)])


@contextlib.contextmanager
def first_sweep_insert(into: dict):
    """Keep, in ``into``, the inputs of the sweep step's first
    ``cand_prep`` (namespace mode) and ``insert_commit`` (tag column): the
    first step inserts the init rows' successors, so it is an inserting
    batch.  Device-to-device copies taken before each launch (the commit
    writes the table and the queue in place); no host read."""
    from stateright_tpu_torch.sweep import engine

    prep, commit = engine.cand_prep, engine.insert_commit

    def keep_prep(rows, valid, pfps, arity, cb, out=None, **kw):
        if "prep" not in into:
            ns = kw["ns"]
            into["prep"] = dict(rows=rows.clone(), valid=valid.clone(),
                                pfps=pfps.clone(), arity=arity, cb=cb,
                                ns=type(ns)(ns.tags.clone(), ns.low.clone(),
                                            ns.xor.clone(), ns.bits))
        return prep(rows, valid, pfps, arity, cb, out, **kw)

    def keep_commit(tfp, tpl, tgt, cfp, cpl, n_new, queue=None, **kw):
        if "commit" not in into:
            into["commit"] = dict(
                tfp=tfp.clone(), tpl=tpl.clone(), tgt=tgt.clone(),
                cfp=cfp.clone(), cpl=cpl.clone(), n_new=n_new.clone(),
                queue=queue._replace(**{
                    k: getattr(queue, k).clone()
                    for k in ("rows", "fps", "ebits", "depths", "tail", "sel",
                              "src_rows", "parent_ebits", "parent_depths",
                              "tags", "parent_tags")}))
        return commit(tfp, tpl, tgt, cfp, cpl, n_new, queue, **kw)

    engine.cand_prep, engine.insert_commit = keep_prep, keep_commit
    try:
        yield into
    finally:
        engine.cand_prep, engine.insert_commit = prep, commit


def sweep_kernels(kept: dict, k: int) -> dict:
    """``cand_prep`` in its namespace mode and ``insert_commit`` with the
    tag column against their plain versions on the first inserting batch
    of ``sweep_2pc7_seeds`` (``k`` members), L2-warm as the step finds
    them, each with its bound from ``kernel_cost``."""
    stream = torch.cuda.current_stream().cuda_stream
    x = kept["prep"]
    rows, valid, pfps, arity, cb, ns = (x[n] for n in (
        "rows", "valid", "pfps", "arity", "cb", "ns"))
    n, w = rows.shape
    qbuf = PrepBuffers(n, cb, rows.device)
    got = cand_prep(rows, valid, pfps, arity, cb, out=qbuf, ns=ns)
    want = cand_prep_plain(rows, valid, pfps, arity, cb, ns)
    errs = sum(int((g != p).sum()) for g, p in zip(got, want))
    nv = int(want[4])
    parents = int(torch.unique(want[2][:nv] // arity).numel())
    q_ms, q_by = bound(*kernel_cost("cand_prep", {
        "lanes": n, "width": w, "valid": nv, "budget": cb,
        "parents": parents, "ns": k}))
    out = {"cand_prep_namespace": dict(
        name="cand_prep_namespace", route="cuda",
        source="stateright_tpu_torch/csrc/cand_prep.cu",
        replaces=("stateright_tpu/sweep/engine.py:234 (ns_hash of row_hash) "
                  "with stateright_tpu/ops/buckets.py:181"),
        shape=(f"rows int64[{n}, {w}], {nv} valid, budget {cb}, "
               f"{parents} parents, {k} instance tags"),
        matched=errs == 0, max_abs_err=errs,
        bound_ms=q_ms, bound_by=q_by, library_ms=None,
        **timings(lambda: cand_prep(rows, valid, pfps, arity, cb, out=qbuf,
                                    ns=ns),
                  lambda: cand_prep_plain(rows, valid, pfps, arity, cb, ns),
                  False,
                  lambda: cand_prep(rows, valid, pfps, arity, cb, qbuf,
                                    check=False, stream=stream, ns=ns)))}
    x = kept["commit"]
    q = x["queue"]
    nn = int(x["n_new"])
    plan = (x["tgt"], x["cfp"], x["cpl"], x["n_new"])

    def copy():
        return ((x["tfp"].clone(), x["tpl"].clone()),
                q._replace(rows=q.rows.clone(), fps=q.fps.clone(),
                           ebits=q.ebits.clone(), depths=q.depths.clone(),
                           tags=q.tags.clone()))

    (kt, kq), (pt, pq) = copy(), copy()
    insert_commit(*kt, *plan, kq)
    insert_commit_plain(*pt, *plan, pq)
    c_err = sum(int((a != b).sum()) for a, b in zip(
        kt + tuple(kq[:4]) + (kq.tags,), pt + tuple(pq[:4]) + (pq.tags,)))
    parents = int(torch.unique(q.sel[:nn] // q.arity).numel())
    c_ms, c_by = bound(*kernel_cost("insert_commit", {
        "novel": nn, "width": q.rows.shape[1], "parents": parents,
        "tags": True}))
    out["insert_commit_tags"] = dict(
        name="insert_commit_tags", route="cuda",
        source="stateright_tpu_torch/csrc/insert_commit.cu",
        replaces=("stateright_tpu/ops/pallas_insert.py:85 with "
                  "stateright_tpu/sweep/engine.py:250"),
        shape=(f"cand {x['tgt'].shape[0]}, n_new {nn} ({parents} parents), "
               f"table {x['tfp'].shape[0]} slots, queue {q.fps.shape[0]} "
               "rows, tag column"),
        matched=c_err == 0, max_abs_err=c_err,
        bound_ms=c_ms, bound_by=c_by, library_ms=None,
        **timings(lambda: insert_commit(*kt, *plan, kq),
                  lambda: insert_commit_plain(*pt, *plan, pq), False,
                  lambda: insert_commit(*kt, *plan, kq, check=False,
                                        stream=stream)))
    return out


def sweep_ops_per_step(dev) -> dict:
    """Dispatched operations per sweep step over the first
    :data:`OPS_STEPS` steps (a ``TorchDispatchMode`` count around
    ``_SweepEngine.step``) of the 2pc-7 seed family with every member's
    target at :data:`SWEEP_OPS_TARGET`."""
    from stateright_tpu_torch.sweep import engine

    counts = []
    step = engine._SweepEngine.step

    def counted(self, c):
        if len(counts) >= OPS_STEPS:
            return step(self, c)
        probe = OpCount()
        with probe:
            out = step(self, c)
        counts.append(probe.n)
        return out

    engine._SweepEngine.step = counted
    try:
        spec = seed_spec(7, target=SWEEP_OPS_TARGET)
        spec.instances[0].model.checker().sweep(spec).spawn_gpu(
            device=dev, steps_per_call=4, **SWEEP_2PC7_KW).join()
    finally:
        engine._SweepEngine.step = step
    return {"ops_per_step": sum(counts) / len(counts),
            "ops_steps": len(counts)}


@contextlib.contextmanager
def stderr_lines(into: list):
    """The process's standard error lines written inside the block (the
    file descriptor, so C++ warnings are caught), copied back after."""
    sys.stderr.flush()
    saved = os.dup(2)
    with tempfile.TemporaryFile(mode="w+b") as tmp:
        os.dup2(tmp.fileno(), 2)
        try:
            yield into
        finally:
            sys.stderr.flush()
            os.dup2(saved, 2)
            os.close(saved)
            tmp.seek(0)
            text = tmp.read().decode(errors="replace")
            sys.stderr.write(text)
            into.extend(text.splitlines())


def same_sweep_state(a: dict, b: dict) -> bool:
    """Two sweep snapshots' tables, per-instance counters, and queue rows
    ``[0, tail)`` with their tags, equal."""
    tail = int(a["tail"])
    return (all(np.array_equal(np.asarray(a[k]), np.asarray(b[k]))
                for k in ("table_fp", "table_parent", "unique_k", "scount_k",
                          "disc", "maxdepth_k", "tail"))
            and all(np.array_equal(np.asarray(a[k])[:tail],
                                   np.asarray(b[k])[:tail])
                    for k in ("q_rows", "q_fp", "q_tag", "q_ebits",
                              "q_depth")))


def sweep_phases(dev, smi: str, ref7: dict) -> tuple:
    """The sweep legs: ``sweep_2pc7_seeds`` (2pc-7 under 8 seeds in one
    table: every member at the plain 2pc-7 leg's counts and discoveries,
    traces replayed; wall against 8 times the plain leg's, operations a
    step, growth events, peak memory), ``sweep_paxos_family`` (the
    ``paxos sweep 8`` verb on ``cuda``; ``sweep_family(4)`` on ``cuda``
    and ``cpu``, equal) and ``sweep_lifted`` (the bounded-counter cohort
    on ``cuda`` and ``cpu``, one unified cohort, equal, with the ``vmap``
    fallback warnings it raised).  Returns each leg's launches and the
    two kernel-mode cells."""
    from stateright_tpu_torch.models import paxos
    from stateright_tpu_torch.testing.sweep_fixtures import (
        bounded_counter_spec,
    )

    launches = {}
    # -- sweep_2pc7_seeds ----------------------------------------------------
    spec = seed_spec(7)
    kept: dict = {}
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with first_sweep_insert(kept):
        c = spec.instances[0].model.checker().sweep(spec).spawn_gpu(
            **SWEEP_2PC7_KW).join()
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    launches["sweep_2pc7_seeds"] = kernel_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    members = {}
    for inst in spec.instances:
        r = c.results[inst.key]
        paths = c.instance_discoveries(inst.key)
        for name, path in paths.items():
            if not inst.model.property_by_name(name).condition(
                    inst.model, path.final_state()):
                raise AssertionError(f"{inst.key} {name}: replayed path "
                                     "does not satisfy it")
        members[inst.key] = dict(unique=r.unique, states=r.states,
                                 depth=r.max_depth,
                                 path_lengths={k: len(v)
                                               for k, v in paths.items()})
        if (r.unique, r.states) != (ref7["unique"], ref7["states"]) or (
                set(paths) != set(ref7["disc"])):
            raise AssertionError(f"sweep_2pc7_seeds: {inst.key} at "
                                 f"{members[inst.key]}, not the plain "
                                 "2pc-7 leg's")
    ops = sweep_ops_per_step(dev)
    emit("sweep_2pc7_seeds", {
        "instances": SWEEP_SEEDS, "cohorts": len(c.cohorts),
        "engine_compiles": c.engine_compiles,
        "unique": c.unique_state_count(), "states": c.state_count(),
        "sec": sec, "sec_plain_2pc7": ref7["sec"],
        "wall_over_8x_plain": sec / (SWEEP_SEEDS * ref7["sec"]),
        "states_per_sec": c.state_count() / sec,
        "cohort_build_sec": c.cohort_build_secs, "steps": c.steps_run,
        "growth_events": c.growth_events, "peak_device_mib": peak / 2**20,
        "launches": launches["sweep_2pc7_seeds"], "members": members,
        **ops, **SWEEP_2PC7_KW, "card": smi})
    if c.unique_state_count() != SWEEP_SEEDS * TPC7_UNIQUE:
        raise AssertionError("sweep_2pc7_seeds: not 8 x 296,448 unique")
    if not all_launched(launches["sweep_2pc7_seeds"], STEP_KERNELS):
        raise AssertionError(f"a kernel never launched in the sweep: "
                             f"{launches['sweep_2pc7_seeds']}")
    kernels = sweep_kernels(kept, SWEEP_SEEDS)
    del c, kept

    # -- sweep_paxos_family --------------------------------------------------
    reset_launches()
    buf = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(buf):
        rc = paxos.main(["sweep", "8"])
    verb_sec = time.monotonic() - t0
    launches["sweep_paxos_family"] = kernel_launches()
    out = buf.getvalue()
    print(out, end="")
    lines = [ln.strip() for ln in out.splitlines() if ": unique=" in ln]
    pins = {False: "unique=265 states=482 depth=13",
            True: "unique=2378 states=8197 depth=14"}
    ok_lines = len(lines) == 8 and all(
        pins["lossy" in ln.split(":")[0]] in ln for ln in lines)
    snaps, secs = [], []
    for d in (dev, "cpu"):
        t0 = time.monotonic()
        spec = paxos.sweep_family(4)
        pc = spec.instances[0].model.checker().sweep(spec).spawn_gpu(
            device=d, **SWEEP_PAXOS_KW).join()
        secs.append(time.monotonic() - t0)
        snaps.append(pc.final_snapshot())
    same = same_sweep_state(*snaps)
    emit("sweep_paxos_family", {
        "verb_rc": rc, "verb_sec": verb_sec, "verb_lines": lines,
        "summary": [ln for ln in out.splitlines() if ln.startswith("sweep:")],
        "family4_sec_cuda": secs[0], "family4_sec_cpu": secs[1],
        "family4_tables_queue_tags_identical": same,
        "launches": launches["sweep_paxos_family"], "card": smi})
    if rc != 0 or "8 instances over 2 cohort(s)" not in out or not ok_lines:
        raise AssertionError(f"sweep_paxos_family: the verb printed {out!r}")
    if not same:
        raise AssertionError("sweep_paxos_family: cuda and cpu disagree")

    # -- sweep_lifted --------------------------------------------------------
    reset_launches()
    warn: list = []
    snaps, res, secs = [], [], []
    for d in (dev, "cpu"):
        spec = bounded_counter_spec(SWEEP_BOUNDS)
        t0 = time.monotonic()
        with stderr_lines(warn if d is dev else []):
            lc = spec.instances[0].model.checker().sweep(spec).spawn_gpu(
                device=d, **SWEEP_LIFTED_KW).join()
        secs.append(time.monotonic() - t0)
        co = lc.cohorts
        if not (len(co) == 1 and co[0].unified and co[0].lifted > 0):
            raise AssertionError(f"sweep_lifted: not one unified cohort on {d}")
        for b in SWEEP_BOUNDS:
            r = lc.results[f"bc-b{b}"]
            if (r.unique, r.max_depth) != ((b + 1) ** 2, 2 * b):
                raise AssertionError(f"sweep_lifted: bc-b{b} on {d} at "
                                     f"{(r.unique, r.max_depth)}")
        snaps.append(lc.final_snapshot())
        res.append({k: (r.unique, r.states, r.max_depth)
                    for k, r in lc.results.items()})
        if d is dev:
            launches["sweep_lifted"] = kernel_launches()
            lifted = co[0].lifted
    fallbacks = [ln for ln in warn if FALLBACK_WARNING in ln]
    ops = sorted({ln.split(FALLBACK_WARNING)[1].split(".")[0]
                  for ln in fallbacks})
    same = same_sweep_state(*snaps) and res[0] == res[1]
    emit("sweep_lifted", {
        "bounds": list(SWEEP_BOUNDS), "lifted_inputs": lifted,
        "members": res[0], "sec_cuda": secs[0], "sec_cpu": secs[1],
        "tables_queue_tags_identical": same,
        "vmap_fallback_warnings": len(fallbacks), "vmap_fallback_ops": ops,
        "launches": launches["sweep_lifted"], **SWEEP_LIFTED_KW,
        "card": smi})
    if not same:
        raise AssertionError("sweep_lifted: cuda and cpu disagree")
    return launches, kernels


# the service legs (explorer.py, fleet/): the Explorer over the plain
# 2pc-7 leg's run with a client polling every endpoint; the canned fleet
# verb; four packable 2pc-7 tenants in one cohort beside a paxos-2
# singleton that an injected stall preempts
EXPLORER_POLL_SECS = 0.05  # a round of three endpoints at about 20 Hz
SNAPSHOT_TIMEOUT_SECS = 5.0  # live_discoveries' checkpoint wait
PACK_2PC7_JOBS = 4
# the cohort's table holds its 4 x 296,448 unique without a growth event
PACK_2PC7_KW = dict(capacity=1 << 23, batch=1 << 14)
PACK_PAXOS2_KW = dict(capacity=1 << 12, batch=256, steps_per_call=8)
PACK_STALL_AT = 5  # the paxos-2 job's step record the stall lands on
PAXOS2 = (16_668, 32_971)
# the fleet verb's tenants (unique, states): JAX tests/test_fleet.py's
# pins and the models' own
FLEET_CANNED_PINS = {"2pc-a": (288, 1_146), "2pc-b": (288, 1_146),
                     "2pc-c": (288, 1_146), "2pc-4": (1_568, 8_258),
                     "2pc-5": (8_832, 58_146), "paxos-1": (265, 482)}


def _http(addr: str, path: str) -> tuple:
    """``(status, body bytes, milliseconds)`` of one GET."""
    import urllib.error
    import urllib.request

    t0 = time.monotonic()
    try:
        with urllib.request.urlopen(f"http://{addr}{path}") as r:
            code, body = r.status, r.read()
    except urllib.error.HTTPError as e:
        code, body = e.code, e.read()
    return code, body, (time.monotonic() - t0) * 1e3


def _sync(device) -> None:
    if torch.device(device or "cuda").type == "cuda":
        torch.cuda.synchronize()


def explorer_leg(smi: str, ref7: dict, device=None) -> dict:
    """``explorer_2pc7``: 2pc-7 served with ``.telemetry(metrics=True,
    cartography=True)`` and ``strategy="gpu"`` at the plain leg's spawn
    arguments, a client polling ``/.status``, ``/.metrics`` and
    ``/metrics`` about 20 times a second until the run is done: the plain
    leg's counts and launches, both agreement paths through ``/.states``,
    no poll past the snapshot timeout; the wall against the plain leg's,
    the polls, the ``/.status`` latency and the seconds to the first live
    discovery."""
    from stateright_tpu_torch.explorer import serve

    reset_launches()
    _sync(device)
    t0 = time.monotonic()
    server = serve(
        TwoPhaseSys(7).checker().telemetry(metrics=True, cartography=True),
        "localhost:0", block=False, strategy="gpu",
        **({} if device is None else {"device": device}))
    status_ms, other_ms, codes = [], [], set()
    first_disc = None
    first_live = False
    sec = None
    try:
        while True:
            done = server.checker.is_done()
            if done and sec is None:
                sec = time.monotonic() - t0
            for path in ("/.status", "/.metrics", "/metrics"):
                code, body, ms = _http(server.addr, path)
                codes.add(code)
                if path != "/.status":
                    other_ms.append(ms)
                    continue
                status_ms.append(ms)
                st = json.loads(body)
                if first_disc is None and any(
                        d for _, _, d in st["properties"]):
                    first_disc = time.monotonic() - t0
                    first_live = not st["done"]
            if done:
                break
            time.sleep(EXPLORER_POLL_SECS)
        c = server.checker.join()
        _sync(device)
        launches = kernel_launches()
        st = json.loads(_http(server.addr, "/.status")[1])
        disc = {n: d for _, n, d in st["properties"] if d is not None}
        views = {n: _http(server.addr, f"/.states/{d}")[0]
                 for n, d in disc.items()}
        metrics_text = _http(server.addr, "/metrics")[1].decode()
    finally:
        server.shutdown()
    out = {
        "unique": c.unique_state_count(), "states": c.state_count(),
        "sec": sec, "sec_plain_2pc7": ref7["sec"],
        "wall_over_plain": sec / ref7["sec"],
        "polls": len(status_ms) + len(other_ms), "status_polls":
        len(status_ms), "status_ms_median": float(np.median(status_ms)),
        "status_ms_max": max(status_ms), "other_ms_max": max(other_ms),
        "http_codes": sorted(codes),
        "first_discovery_sec": first_disc,
        "first_discovery_live": first_live, "states_views": views,
        "metrics_states_total": next(
            (ln for ln in metrics_text.splitlines()
             if ln.startswith("stateright_states_total{")), None),
        "launches": launches, "launches_plain_2pc7": ref7["launches"],
        "card": smi}
    emit("explorer_2pc7", out)
    if (out["unique"], out["states"]) != (ref7["unique"], ref7["states"]):
        raise AssertionError(f"explorer_2pc7: {out['unique']} / "
                             f"{out['states']}, not the plain leg's")
    if set(views) != {"abort agreement", "commit agreement"} or set(
            views.values()) != {200}:
        raise AssertionError(f"explorer_2pc7: discovery views {views}")
    if max(status_ms + other_ms) > SNAPSHOT_TIMEOUT_SECS * 1e3:
        raise AssertionError("explorer_2pc7: a poll outlasted the snapshot "
                             "timeout")
    if codes != {200}:
        raise AssertionError(f"explorer_2pc7: poll codes {codes}")
    if launches != ref7["launches"]:
        raise AssertionError(f"explorer_2pc7: launches {launches} != the "
                             f"plain leg's {ref7['launches']}")
    return launches


def _resume_secs(rec, key: str) -> Optional[float]:
    """Seconds from the job's ``preempt`` record to its ``resume``."""
    t = {r["event"]: r["t"] for r in rec.records("job")
         if r.get("key") == key and r["event"] in ("preempt", "resume")}
    return (t["resume"] - t["preempt"]) if len(t) == 2 else None


def fleet_canned_leg(smi: str, device=None) -> dict:
    """``fleet_canned``: the ``fleet`` verb in process (JAX's six tenants
    over two slots, the stall in 2pc-5 at step 5): every pin, one packed
    cohort of three, the preempted job's lineage ``IDENTICAL``, exit 0."""
    from stateright_tpu_torch.models._cli import canned_fleet

    root = tempfile.mkdtemp(prefix="chip-smoke-fleet-")
    buf = io.StringIO()
    reset_launches()
    _sync(device)
    t0 = time.monotonic()
    rc, res = canned_fleet([f"--root={root}"] + (
        [] if device is None else [f"--device={device}"]), stream=buf)
    _sync(device)
    sec = time.monotonic() - t0
    launches = kernel_launches()
    text = buf.getvalue()
    print(text, end="")
    jobs = {r.key: r for r in res.results.values()}
    out = {"rc": rc, "sec": sec, "fleet_secs": res.secs,
           "completed": res.completed, "preemptions": res.preemptions,
           "engine_compiles": res.engine_compiles, "packed": res.packed,
           "jobs": {k: [r.unique, r.states, r.preemptions, r.slot,
                        round(r.secs, 3)] for k, r in jobs.items()},
           "resume_secs_2pc5": _resume_secs(res.recorder, "2pc-5"),
           "lineage_identical": "IDENTICAL (contract: lineage)" in text,
           "launches": launches, "card": smi}
    emit("fleet_canned", out)
    wrong = {k: (jobs[k].unique, jobs[k].states)
             for k, pin in FLEET_CANNED_PINS.items()
             if (jobs[k].unique, jobs[k].states) != pin}
    if rc != 0 or wrong or res.preemptions != 1 or not out[
            "lineage_identical"]:
        raise AssertionError(f"fleet_canned: rc {rc}, off the pins {wrong}, "
                             f"{res.preemptions} preemption(s)")
    if [len(p["jobs"]) for p in res.packed] != [3]:
        raise AssertionError(f"fleet_canned: packed {res.packed}")
    return launches


def fleet_pack_leg(smi: str, ref7: dict, device=None) -> dict:
    """``fleet_2pc7_pack``: two slots; four packable 2pc-7 tenants form one
    cohort on the sweep engine, each at the plain leg's counts, while a
    paxos-2 singleton is stall-preempted and resumes once, its lineage
    ``IDENTICAL``; the wall against the sum of the plain legs' walls, the
    engine builds, the seconds to resume, the launches summed over both
    slots."""
    from stateright_tpu_torch.fleet import (
        FleetSpec, Job, PreemptionPlan, run_fleet,
    )
    from stateright_tpu_torch.models._cli import compare_reports_cmd

    runs = tempfile.mkdtemp(prefix="chip-smoke-fleet-runs-")
    jobs = [Job(key=f"2pc7-{i}", packable=True, build=lambda: TwoPhaseSys(
                7).checker().runs(runs), **PACK_2PC7_KW)
            for i in range(PACK_2PC7_JOBS)]
    jobs.append(Job(key="paxos-2", build=lambda: paxos_model(
        2).checker().runs(runs), **PACK_PAXOS2_KW))
    reset_launches()
    _sync(device)
    t0 = time.monotonic()
    res = run_fleet(FleetSpec(jobs=jobs, slots=2),
                    root=tempfile.mkdtemp(prefix="chip-smoke-pool-"),
                    preemption=PreemptionPlan({"paxos-2": PACK_STALL_AT}),
                    stream=sys.stdout, device=device)
    _sync(device)
    sec = time.monotonic() - t0
    launches = kernel_launches()
    px = res["paxos-2"]
    buf = io.StringIO()
    rc = compare_reports_cmd([px.parent_run_id or "-", px.run_id or "-",
                              f"--registry={runs}", "--expect=IDENTICAL"],
                             buf) if px.parent_run_id else 1
    plain = PACK_2PC7_JOBS * ref7["sec"] + RECORD["paxos2"]["sec_cuda"]
    cohort_builds = [p["engine_compiles"] for p in res.packed]
    out = {"sec": sec, "fleet_secs": res.secs, "sum_plain_sec": plain,
           "wall_over_sum_plain": sec / plain,
           "packed": res.packed, "engine_compiles": res.engine_compiles,
           "cohort_engine_builds": cohort_builds,
           "preemptions": res.preemptions,
           "jobs": {r.key: [r.unique, r.states, r.preemptions, r.slot,
                            round(r.secs, 3)] for r in res.results.values()},
           "resume_secs_paxos2": _resume_secs(res.recorder, "paxos-2"),
           "lineage_rc": rc,
           "lineage_identical": "IDENTICAL (contract: lineage)"
           in buf.getvalue(),
           "launches": launches, **{f"pack_{k}": v for k, v in
                                    PACK_2PC7_KW.items()}, "card": smi}
    emit("fleet_2pc7_pack", out)
    wrong = [r.key for r in res.results.values() if r.key != "paxos-2"
             and (r.unique, r.states) != (ref7["unique"], ref7["states"])]
    if res.completed != len(jobs) or wrong:
        raise AssertionError(f"fleet_2pc7_pack: off the plain leg {wrong}, "
                             f"{res.completed} completed")
    if [len(p["jobs"]) for p in res.packed] != [PACK_2PC7_JOBS]:
        raise AssertionError(f"fleet_2pc7_pack: packed {res.packed}")
    if (px.unique, px.states) != PAXOS2 or px.preemptions != 1:
        raise AssertionError(f"fleet_2pc7_pack: paxos-2 at "
                             f"{(px.unique, px.states)} after "
                             f"{px.preemptions} preemption(s)")
    if rc != 0 or not out["lineage_identical"]:
        raise AssertionError(f"fleet_2pc7_pack: lineage {buf.getvalue()}")
    # the cohort's builds (one per candidate-budget rung: the fleet hands
    # a packed cohort only its members' capacity and batch, as JAX's does)
    # and one per spawn of the singleton (the preempted attempt, the resume)
    if res.engine_compiles != sum(cohort_builds) + 2:
        raise AssertionError(f"fleet_2pc7_pack: engine builds "
                             f"{res.engine_compiles} (cohort {cohort_builds})")
    return launches


def service_phases(smi: str, ref7: dict, device=None) -> dict:
    """The three service legs; returns each one's launches."""
    out = {"explorer_2pc7": explorer_leg(smi, ref7, device)}
    lap("explorer_2pc7")
    out["fleet_canned"] = fleet_canned_leg(smi, device)
    lap("fleet_canned")
    out["fleet_2pc7_pack"] = fleet_pack_leg(smi, ref7, device)
    lap("fleet_2pc7_pack")
    return out


# -- the sharded engine (parallel/sharded.py, spawn_gpu(devices=N)) --------

SHARDED_DEVICES = 8
TPC7_UNIQUE = 296_448  # the plain 2pc-7 leg's pin
# the bounded 2pc-7 run whose next step the sharded kernel cells take, and
# the bound of the runs that count operations a step
SHARDED_KERNEL_TARGET = 100_000
SHARDED_OPS_TARGET = 20_000
SHARDED_OPS_DEVICES = (1, 4, 8)
SHARDED_PAXOS3_TARGET = 200_000
NCCL_SHARDS = 4


def sharded_ops_per_step(dev, n: int) -> dict:
    """Dispatched operations per sharded step over ``n`` shards (a
    ``TorchDispatchMode`` count around ``_ShardedEngine.step``, the first
    :data:`OPS_STEPS` steps of 2pc-7 bounded at
    :data:`SHARDED_OPS_TARGET`): the shards are stacked, so the count does
    not grow with ``n``."""
    from stateright_tpu_torch.parallel import sharded

    counts = []
    step = sharded._ShardedEngine.step

    def counted(self, c):
        if len(counts) >= OPS_STEPS:
            return step(self, c)
        probe = OpCount()
        with probe:
            out = step(self, c)
        counts.append(probe.n)
        return out

    sharded._ShardedEngine.step = counted
    try:
        TwoPhaseSys(7).checker().target_states(SHARDED_OPS_TARGET).spawn_gpu(
            n_devices=n, device=dev, steps_per_call=4, sync=True)
    finally:
        sharded._ShardedEngine.step = step
    return {"ops_per_step": sum(counts) / len(counts), "steps": len(counts)}


def sharded_batch(c) -> dict:
    """The next step of a sharded run's final carry, pushed through the
    step's plain stages (the engine's own route and plan inputs, which
    launch none of the kernels): the source batch ``row_hash`` takes and
    the owners' batch ``bucket_plan`` and ``insert_commit`` take."""
    from stateright_tpu_torch.parallel import sharded

    carry, _, caps = c._final_state
    # the step the engine would run next: a run stopped at its target sits
    # near the 25 % load where a whole frontier's inserts would overflow a
    # bucket, so the table doubles first, as the engine's replay does
    *caps, carry = c._grow(list(carry), *caps, sharded._TABLE_OVERFLOW)
    eng = c._engine_for(*caps)
    rows, fps, ebits = (carry[convert.SH_ROWS], carry[convert.SH_FPS],
                        carry[convert.SH_EBITS])
    succ, valid = eng.tensor.step_rows(rows)
    valid = valid & (fps != EMPTY)[:, None]
    krows, hvalid = succ.reshape(-1, eng.width), valid.reshape(-1)
    cand = row_hash_plain(krows, hvalid).view(eng.L, eng.m)
    recv = eng.route(cand, eng._payload(cand, fps, ebits, succ))[0]
    inputs, _ = eng.plan_inputs(recv, eng.geo)
    return dict(krows=krows, hvalid=hvalid, inputs=inputs + (eng.no_cov,),
                tfp=carry[convert.SH_TFP], tpl=carry[convert.SH_TPL],
                shards=eng.L, width=eng.width)


def sharded_kernels(x: dict, cold: bool = False) -> dict:
    """``row_hash`` on the sharded source batch, ``bucket_plan`` on the
    owners' batch (every shard's candidates in one plan) and the table
    write of ``insert_commit`` (no queue: the sharded engine compacts its
    frontier from the plan), each against its plain version."""
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    rows, hvalid = x["krows"], x["hvalid"]
    n, w = rows.shape
    nh = int(hvalid.sum())
    got, want = row_hash(rows, hvalid), row_hash_plain(rows, hvalid)
    b_ms, b_by = bound(*kernel_cost("row_hash", {"rows": n, "width": w,
                                                 "valid": nh}))
    out["row_hash"] = dict(
        name="row_hash", route="cuda",
        source="stateright_tpu_torch/csrc/row_hash.cu",
        replaces="stateright_tpu/ops/hashing.py:105",
        shape=(f"{x['shards']} shards' successor rows int64[{n}, {w}], "
               f"{nh} valid"),
        matched=bool(torch.equal(got, want)),
        max_abs_err=int((got != want).sum()),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        **timings(lambda: row_hash(rows, hvalid),
                  lambda: row_hash_plain(rows, hvalid), cold))
    tfp, tpl, inputs = x["tfp"], x["tpl"], x["inputs"]
    sfp, bucket, cidx = inputs[0], inputs[2], inputs[4]
    m = sfp.shape[0]
    pbuf = PlanBuffers(m, sfp.device, False)
    got = bucket_plan(tfp, *inputs, out=pbuf)
    want = bucket_plan_plain(tfp, *inputs)
    planned = int((want[0] != tfp.shape[0]).sum())
    errs = [int((g[:planned] != p[:planned]).sum())
            for g, p in zip(got[:4], want[:4])]
    errs += [abs(int(got[4]) - int(want[4])), int(bool(got[5]) != bool(want[5]))]
    live = sfp != EMPTY
    nlive = int(live.sum())
    lines = int(torch.unique(bucket[live]).numel())
    p_ms, p_by = bound(*kernel_cost("bucket_plan", {
        "lanes": m, "valid": nlive, "lines": lines, "novel": planned,
        "cidx": cidx is not None}))
    out["bucket_plan"] = dict(
        name="bucket_plan", route="cuda",
        source="stateright_tpu_torch/csrc/bucket_plan.cu",
        replaces="stateright_tpu/ops/buckets.py:202",
        shape=(f"{x['shards']} shards' owner lanes {m} ({nlive} valid, "
               f"{lines} lines, {planned} novel), table {tfp.shape[0]} "
               "slots"),
        matched=sum(errs) == 0, max_abs_err=sum(errs),
        bound_ms=p_ms, bound_by=p_by, library_ms=None,
        **timings(lambda: bucket_plan(tfp, *inputs, out=pbuf),
                  lambda: bucket_plan_plain(tfp, *inputs), cold,
                  lambda: bucket_plan(tfp, *inputs, out=pbuf, check=False,
                                      stream=stream)))
    tgt, cfp, cpl, _, n_new, _ = want
    nn = int(n_new)
    if nn == 0:
        raise AssertionError(f"the sharded owner batch planned nothing "
                             f"(overflow={bool(want[5])})")
    kt, pt = (tfp.clone(), tpl.clone()), (tfp.clone(), tpl.clone())
    insert_commit(*kt, tgt, cfp, cpl, n_new)
    insert_commit_plain(*pt, tgt, cfp, cpl, n_new)
    c_err = sum(int((a != b).sum()) for a, b in zip(kt, pt))
    from stateright_tpu_torch.analysis.costmodel import insert_commit_parts

    r, wr = insert_commit_parts({"novel": nn, "width": x["width"],
                                 "parents": 0})["table"]
    c_ms, c_by = bound(r + wr, 0)
    out["insert_commit"] = dict(
        name="insert_commit", route="cuda",
        source="stateright_tpu_torch/csrc/insert_commit.cu",
        replaces="stateright_tpu/ops/pallas_insert.py:85",
        shape=(f"{x['shards']} shards' plan {tgt.shape[0]}, n_new {nn}, "
               f"table {tfp.shape[0]} slots, no queue"),
        matched=c_err == 0, max_abs_err=c_err,
        bound_ms=c_ms, bound_by=c_by, library_ms=None,
        **timings(lambda: insert_commit(*kt, tgt, cfp, cpl, n_new),
                  lambda: insert_commit_plain(*pt, tgt, cfp, cpl, n_new),
                  cold,
                  lambda: insert_commit(*kt, tgt, cfp, cpl, n_new,
                                        check=False, stream=stream)))
    return out


def shard_loads(c) -> list:
    """Each shard's occupied table slots (the final table, shard after
    shard)."""
    tfp = c._table_np()[0].reshape(c.ndev, -1)
    return [int(v) for v in (tfp != np.uint64(2 ** 64 - 1)).sum(1)]


def sharded_snapshots_equal(a: dict, b: dict) -> tuple:
    """Two sharded snapshots key for key (the frontier's rows and ebits at
    its live lanes); returns ``(equal, keys compared)``."""
    live = np.asarray(a["fps"]) != np.uint64(2 ** 64 - 1)
    keys = [k for k in a if k != "run_id"]
    for k in keys:
        x, y = np.asarray(a[k]), np.asarray(b.get(k))
        if k in ("rows", "ebits"):
            x, y = x[live], y[live]
        if x.shape != y.shape or not np.array_equal(x, y):
            return False, k
    return True, len(keys)


def sharded_phases(smi: str, ref7: dict, device=None) -> tuple:
    """The sharded legs: ``sharded_2pc7`` (2pc-7 over 8 shards on the card:
    the plain leg's 296,448 unique, state count, discoveries and visited
    set; wall, operations a step at 1, 4 and 8 shards, launches, growth
    events, shard imbalance) with the kernel cells on the next step of a
    run bounded at :data:`SHARDED_KERNEL_TARGET`; ``sharded_2pc5_parity``
    (4 shards on ``cuda`` and on ``cpu``: equal snapshots);
    ``sharded_paxos3`` (4 shards, bounded at 200,000 unique: every
    fingerprint in its owner's shard, none twice, every parent present);
    ``nccl_one_rank`` (one NCCL rank holding 4 shards: 2pc-5 at 8,832).
    Returns each leg's launches and the kernel cells."""
    import socket

    import torch.distributed as dist

    from stateright_tpu_torch.ops.cartography import shard_imbalance

    dev = device or "cuda"
    out = {}
    # -- sharded_2pc7 -------------------------------------------------------
    reset_launches()
    c7, c7_s = timed_run(7, devices=SHARDED_DEVICES, device=dev)
    launches = out["sharded_2pc7"] = kernel_launches()
    paths = check_discoveries(c7.model, c7,
                              {"abort agreement", "commit agreement"})
    c7.assert_properties()
    plain = ref7["snap"]
    pfp = np.asarray(plain["table_fp"])
    visited_plain = set(pfp[pfp != np.uint64(2 ** 64 - 1)].tolist())
    parents = c7._parents()
    same_visited = set(parents) == visited_plain
    parents_ok = all(p == 0 or p in parents for p in parents.values())
    loads = shard_loads(c7)
    ops = {n: sharded_ops_per_step(dev, n) for n in SHARDED_OPS_DEVICES}
    emit("sharded_2pc7", {
        "devices": SHARDED_DEVICES, "unique": c7.unique_state_count(),
        "states": c7.state_count(), "depth": c7.max_depth(), "sec": c7_s,
        "plain_sec": ref7["sec"], "states_per_sec": c7.state_count() / c7_s,
        "steps": c7.steps_run, "growth_events": c7.growth_events,
        "cap_local": c7._cap_local, "fcap_local": c7._fcap_local,
        "shard_load": loads, "shard_imbalance": shard_imbalance(loads),
        "visited_equals_plain": same_visited, "parents_present": parents_ok,
        "path_lengths": paths, "launches": launches,
        "ops_per_step": {str(n): v for n, v in ops.items()},
        "card": smi})
    if (c7.unique_state_count(), c7.state_count()) != (
            ref7["unique"], ref7["states"]) or ref7["unique"] != TPC7_UNIQUE:
        raise AssertionError("sharded 2pc-7: counts differ from the plain leg")
    if set(c7.discovery_fps()) != set(ref7["disc"]):
        raise AssertionError("sharded 2pc-7: discoveries differ")
    if not (same_visited and parents_ok):
        raise AssertionError("sharded 2pc-7: visited set or parents differ")
    for k in ("row_hash", "bucket_plan", "insert_commit"):
        if launches[k] <= 0:
            raise AssertionError(f"sharded 2pc-7: {k} never launched")
    if launches["cand_prep"]:
        raise AssertionError("sharded 2pc-7: cand_prep is not on its path")
    del c7
    lap("sharded_2pc7")
    # -- the kernel cells on a sharded step ---------------------------------
    cb, _ = timed_run(7, target=SHARDED_KERNEL_TARGET,
                      devices=SHARDED_DEVICES, device=dev)
    kernels = sharded_kernels(sharded_batch(cb))
    for name, k in kernels.items():
        emit(f"kernel_{name}_sharded_2pc7", k)
    del cb
    lap("kernels_sharded_2pc7")
    # -- sharded_2pc5_parity: cuda = cpu ------------------------------------
    reset_launches()
    g5, g5_s = timed_run(5, devices=4, device=dev)
    out["sharded_2pc5_parity"] = kernel_launches()
    c5 = TwoPhaseSys(5).checker().spawn_gpu(devices=4, device="cpu",
                                            sync=True)
    same, keys = sharded_snapshots_equal(g5.final_snapshot(),
                                         c5.final_snapshot())
    emit("sharded_2pc5_parity", {
        "unique_cuda": g5.unique_state_count(),
        "unique_cpu": c5.unique_state_count(), "sec_cuda": g5_s,
        "snapshots_equal": same, "keys": keys,
        "launches": out["sharded_2pc5_parity"], "card": smi})
    if not (same and g5.unique_state_count() == 8832):
        raise AssertionError(f"sharded 2pc-5: cuda and cpu differ at {keys}")
    del g5, c5
    lap("sharded_2pc5_parity")
    # -- sharded_paxos3: the shards' structure ------------------------------
    reset_launches()
    p3, p3_s = timed_run(3, target=SHARDED_PAXOS3_TARGET, model=paxos_model,
                         devices=4, device=dev)
    out["sharded_paxos3"] = kernel_launches()
    tfp, tpl = p3._table_np()
    occ = tfp != np.uint64(2 ** 64 - 1)
    shard = np.repeat(np.arange(4), tfp.size // 4)
    owner = ((tfp >> np.uint64(32)) % np.uint64(4)).astype(np.int64)
    fps = tfp[occ]
    par = tpl[occ]
    fp_set = set(fps.tolist())
    in_owner = bool((owner[occ] == shard[occ]).all())
    no_repeat = len(fp_set) == fps.size == p3.unique_state_count()
    parents_ok = all(p == 0 or p in fp_set for p in par.tolist())
    emit("sharded_paxos3", {
        "target": SHARDED_PAXOS3_TARGET, "unique": p3.unique_state_count(),
        "states": p3.state_count(), "sec": p3_s,
        "width": p3.tensor.width, "growth_events": p3.growth_events,
        "shard_load": shard_loads(p3), "fps_in_owner_shard": in_owner,
        "no_repeat": no_repeat, "parents_present": parents_ok,
        "launches": out["sharded_paxos3"], "card": smi})
    if not (in_owner and no_repeat and parents_ok
            and p3.unique_state_count() >= SHARDED_PAXOS3_TARGET):
        raise AssertionError("sharded paxos-3: the shards' structure is wrong")
    del p3
    lap("sharded_paxos3")
    # -- nccl_one_rank: the collectives' path, one rank ---------------------
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl" if dev != "cpu" else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        reset_launches()
        n1, n1_s = timed_run(5, devices=NCCL_SHARDS, device=dev)
        out["nccl_one_rank"] = kernel_launches()
        collectives = n1._xch.dist is not None
        emit("nccl_one_rank", {
            "backend": dist.get_backend(), "ranks": dist.get_world_size(),
            "shards": NCCL_SHARDS, "unique": n1.unique_state_count(),
            "sec": n1_s, "collectives": collectives,
            "launches": out["nccl_one_rank"], "card": smi})
        if not (collectives and n1.unique_state_count() == 8832):
            raise AssertionError("nccl one rank: 2pc-5 is not 8,832")
        del n1
    finally:
        dist.destroy_process_group()
    lap("nccl_one_rank")
    return out, kernels


MESH_PIECES = 4  # the mesh legs' pieces, all on the one card
# the bounded 2pc-7 mesh run whose next step the mesh kernel cells take,
# the bound of the runs that count operations a step, and the paxos-3
# mesh leg's bound (the sharded paxos-3 leg's)
MESH_KERNEL_TARGET = 100_000
MESH_OPS_TARGET = 20_000
MESH_PAXOS3_TARGET = 200_000
# the native legs: seeded register histories (tests/test_torch_native.py's
# generator) and the compiled-CPU baseline's batch
NATIVE_SEED, NATIVE_HISTORIES = 42, 400
BASELINE_BATCH = 1024


def mesh_builder(model, dev, pieces: int = MESH_PIECES):
    """``model.checker().mesh()`` over ``pieces`` pieces on ``dev``."""
    return model.checker().mesh(devices=[dev] * pieces)


def mesh_ops_per_step(dev, pieces: int) -> dict:
    """Dispatched operations per step of 2pc-7 bounded at
    :data:`MESH_OPS_TARGET` (the first :data:`OPS_STEPS` steps, a
    ``TorchDispatchMode`` count around ``_Engine.step``), on a mesh of
    ``pieces`` pieces (1: the single-device step)."""
    counts = []
    step = _Engine.step

    def counted(self, c):
        if len(counts) >= OPS_STEPS:
            return step(self, c)
        probe = OpCount()
        with probe:
            out = step(self, c)
        counts.append(probe.n)
        return out

    _Engine.step = counted
    try:
        mesh_builder(TwoPhaseSys(7), dev, pieces).target_states(
            MESH_OPS_TARGET).spawn_gpu(steps_per_call=4, sync=True)
    finally:
        _Engine.step = step
    return {"ops_per_step": sum(counts) / len(counts), "steps": len(counts)}


def mesh_batch(c) -> dict:
    """The next step of a finished mesh run, through the step's plain
    stages (:func:`next_batch` on the joined carry), then split as the
    mesh step splits it: the table piece with the most candidates, its
    window of the sorted lanes (the engine's own ``piece_bounds``), and
    the queue piece that holds the tail."""
    from stateright_tpu_torch.parallel.mesh import QUEUE

    eng = c._last_engine
    fin = c._final_carry
    x = next_batch(c, c._whole(fin))
    bounds = eng.piece_bounds(x["fused"][2])
    # each piece's live candidates (the EMPTY lanes sort past the last
    # bound)
    runs = (bounds[1:] - bounds[:-1]).tolist()
    k = int(np.argmax(runs))
    # the queue piece that takes the most of the rows [tail, tail + n_new)
    tail, na = int(fin[convert.TAIL]), x["n_new"]
    q = int(np.argmax([min(tail + na, (j + 1) * eng.qrows)
                       - max(tail, j * eng.qrows)
                       for j in range(len(eng.qdevs))]))
    return dict(x, piece=k, runs=runs, win=bounds[k:k + 2].clone(),
                boff=k * eng.nbp, nb=x["tfp"].shape[0] // SLOTS,
                tfp_k=fin[convert.TFP].parts[k],
                tpl_k=fin[convert.TPL].parts[k], q=q, qlo=q * eng.qrows,
                qpiece=[fin[i].parts[q] for i in QUEUE],
                pieces=len(eng.tdevs))


def mesh_kernels(x: dict) -> dict:
    """``bucket_plan_fused`` (a piece's window) and the table half of
    ``insert_commit`` on one table piece of a mesh step, and
    ``insert_commit``'s window mode on the queue piece that holds the
    tail, each against its plain version."""
    from stateright_tpu_torch.analysis.costmodel import insert_commit_parts

    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    tfp, tpl, fused = x["tfp_k"], x["tpl_k"], x["fused"]
    skey = fused[2]
    win, boff, nb = x["win"], x["boff"], x["nb"]
    m = skey.shape[0]
    pbuf = PlanBuffers(m, skey.device, False)
    got = bucket_plan_fused(tfp, *fused, nb, out=pbuf, win=win, boff=boff)
    want = bucket_plan_fused_plain(tfp, *fused, nb, win=win, boff=boff)
    err, planned = plan_errors(got, want, tfp.shape[0])
    lo, hi = win.tolist()
    bits = bucket_bits(nb)
    lines = int(torch.unique(key_buckets(skey[lo:hi], bits)).numel())
    p_ms, p_by = bound(*kernel_cost("bucket_plan_fused", {
        "lanes": m, "keys": hi - lo, "valid": hi - lo, "lines": lines,
        "novel": planned, "cidx": True, "win": True}))
    where = (f"piece {x['piece']} of {x['pieces']} (runs {x['runs']}), "
             f"table piece {tfp.shape[0]} slots")
    out["bucket_plan_fused"] = dict(
        name="bucket_plan_fused", route="cuda",
        source="stateright_tpu_torch/csrc/bucket_plan.cu",
        replaces="stateright_tpu/ops/buckets.py:202",
        shape=(f"cand {m} (window [{lo}, {hi}), {lines} lines, {planned} "
               "novel), " + where),
        matched=err == 0, max_abs_err=err,
        bound_ms=p_ms, bound_by=p_by, library_ms=None,
        **timings(lambda: bucket_plan_fused(tfp, *fused, nb, out=pbuf,
                                            win=win, boff=boff),
                  lambda: bucket_plan_fused_plain(tfp, *fused, nb, win=win,
                                                  boff=boff), False,
                  lambda: bucket_plan_fused(tfp, *fused, nb, out=pbuf,
                                            win=win, boff=boff, check=False,
                                            stream=stream)))
    tgt, cfp, cpl, _, n_new, _ = want
    nn = int(n_new)
    if nn == 0:
        raise AssertionError("the mesh piece's batch planned nothing")
    kt, pt = (tfp.clone(), tpl.clone()), (tfp.clone(), tpl.clone())
    insert_commit(*kt, tgt, cfp, cpl, n_new)
    insert_commit_plain(*pt, tgt, cfp, cpl, n_new)
    c_err = sum(int((a != b).sum()) for a, b in zip(kt, pt))
    r, wr = insert_commit_parts({"novel": nn, "width": x["crows"].shape[1],
                                 "parents": 0})["table"]
    c_ms, c_by = bound(r + wr, 0)
    out["insert_commit"] = dict(
        name="insert_commit", route="cuda",
        source="stateright_tpu_torch/csrc/insert_commit.cu",
        replaces="stateright_tpu/ops/pallas_insert.py:85",
        shape=f"plan {tgt.shape[0]}, n_new {nn}, {where}, no queue",
        matched=c_err == 0, max_abs_err=c_err,
        bound_ms=c_ms, bound_by=c_by, library_ms=None,
        **timings(lambda: insert_commit(*kt, tgt, cfp, cpl, n_new),
                  lambda: insert_commit_plain(*pt, tgt, cfp, cpl, n_new),
                  False,
                  lambda: insert_commit(*kt, tgt, cfp, cpl, n_new,
                                        check=False, stream=stream)))
    # the window append: the whole step's novel lanes (the whole-table
    # plan's, in table order, as the merge gives them) into one queue piece
    plan, q = x["plan"], x["queue"]
    sel, wfp, n_all = plan[3], plan[1], plan[4]
    na = int(n_all)
    qlo, rows = x["qlo"], x["qpiece"][0].shape[0]
    tail = int(q.tail)
    lanes = np.arange(na)
    inside = (tail + lanes >= qlo) & (tail + lanes < qlo + rows)
    nin = int(inside.sum())
    par = int(torch.unique(sel[:na][torch.from_numpy(inside).to(sel.device)]
                           // q.arity).numel())

    def window_queue():
        return q._replace(rows=x["qpiece"][0].clone(),
                          fps=x["qpiece"][1].clone(),
                          ebits=x["qpiece"][2].clone(),
                          depths=x["qpiece"][3].clone())

    kq, pq = window_queue(), window_queue()
    insert_commit_window(kq, wfp, n_all, qlo)
    insert_commit_window_plain(pq, wfp, n_all, qlo)
    w_err = sum(int((a != b).sum()) for a, b in zip(kq[:4], pq[:4]))
    w_ms, w_by = bound(*kernel_cost("insert_commit_window", {
        "lanes": na, "novel": nin, "width": x["crows"].shape[1],
        "parents": par}))
    out["insert_commit_window"] = dict(
        name="insert_commit_window", route="cuda",
        source="stateright_tpu_torch/csrc/insert_commit.cu",
        replaces=("stateright_tpu/parallel/wavefront.py:369 (append_novel, "
                  "on the mesh's queue pieces)"),
        shape=(f"n_new {na}, {nin} rows in queue piece {x['q']} "
               f"({rows} rows from {qlo}), tail {tail}"),
        matched=w_err == 0, max_abs_err=w_err,
        bound_ms=w_ms, bound_by=w_by, library_ms=None,
        **timings(lambda: insert_commit_window(kq, wfp, n_all, qlo),
                  lambda: insert_commit_window_plain(pq, wfp, n_all, qlo),
                  False,
                  lambda: insert_commit_window(kq, wfp, n_all, qlo,
                                               check=False, stream=stream)))
    return out


def mesh_launches() -> dict:
    return dict(kernel_launches(),
                insert_commit_window=insert_commit_window.launches)


def reset_mesh_launches() -> None:
    reset_launches()
    insert_commit_window.launches = 0


def native_histories(seed: int, n: int):
    """Seeded register histories for both testers (the generator of
    ``tests/test_torch_native.py``)."""
    import random

    from stateright_tpu_torch.semantics import (
        LinearizabilityTester, Register, SequentialConsistencyTester,
    )
    from stateright_tpu_torch.semantics.register import READ, write

    rng = random.Random(seed)
    for _ in range(n):
        for cls in (LinearizabilityTester, SequentialConsistencyTester):
            t = cls(Register("\0"))
            threads = list(range(rng.randint(1, 3)))
            pending = {}
            register = "\0"
            for _ in range(rng.randint(0, 8)):
                th = rng.choice(threads)
                if th in pending:
                    op = pending.pop(th)
                    if op[0] == "write":
                        register = op[1] if rng.random() < 0.8 else register
                        t = t.on_return(th, ("write_ok",))
                    else:
                        value = (register if rng.random() < 0.6
                                 else rng.choice("ABC\0"))
                        t = t.on_return(th, ("read_ok", value))
                else:
                    op = write(rng.choice("ABC")) if rng.random() < 0.5 \
                        else READ
                    pending[th] = op
                    t = t.on_invoke(th, op)
            yield t


def udp_register_leg(smi: str) -> None:
    """``udp_register``: a single-copy register server spawned on a free
    localhost port answers a put and a get over UDP."""
    import socket

    from stateright_tpu_torch.actor import Id
    from stateright_tpu_torch.models._cli import udp_spawn
    from stateright_tpu_torch.models.single_copy_register import (
        SingleCopyServer,
    )

    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as p:
        p.bind(("127.0.0.1", 0))
        port = p.getsockname()[1]
    t0 = time.monotonic()
    handles = udp_spawn([], [(Id.from_addr("127.0.0.1", port),
                              SingleCopyServer())], background=True)
    replies = []
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as cs:
            cs.bind(("127.0.0.1", 0))
            cs.settimeout(5.0)
            for req in (["put", 1, "X"], ["get", 2]):
                cs.sendto(json.dumps(req).encode(), ("127.0.0.1", port))
                replies.append(json.loads(cs.recvfrom(65536)[0]))
    finally:
        for h in handles:
            h.stop()
        for h in handles:
            h.join(2.0)
    emit("udp_register", {"port": port, "replies": replies,
                          "sec": time.monotonic() - t0,
                          "threads_stopped": not any(
                              h.thread.is_alive() for h in handles),
                          "card": smi})
    if replies != [["put_ok", 1], ["get_ok", 2, "X"]]:
        raise AssertionError(f"udp register: replies {replies}")


def mesh_phases(smi: str, ref7: dict, device=None) -> tuple:
    """The mesh engine's legs (``.mesh()``, ``parallel/mesh.py``; every
    piece on the one card), then the native and UDP legs:

     - ``mesh_2pc7``: 2pc-7 on :data:`MESH_PIECES` pieces: the plain leg's
       296,448 unique and state count, discoveries, table bytes and queue
       rows, every kernel and the window mode launched, the wall beside the
       plain leg's, and the operations a step at 1 and 4 pieces;
     - the kernel cells of a mesh step (``at_mesh_2pc7``): the next step of
       a 2pc-7 mesh run bounded at :data:`MESH_KERNEL_TARGET`, on its
       busiest table piece and the queue piece at the tail;
     - ``mesh_2pc5_parity``: 2pc-5 under symmetry on 4 pieces, ``cuda``
       and ``cpu``: 508 classes, equal snapshots;
     - ``mesh_paxos3``: paxos-3 (W = 33) on 4 pieces bounded at
       :data:`MESH_PAXOS3_TARGET`, equal to a plain run bounded there;
     - ``native_lin``: the native module built with ``g++`` from the
       port's sources, its verdicts equal to the Python search's;
     - ``native_baseline_2pc7``: ``compiled_cpu_bfs`` over 2pc-7, complete:
       the plain leg's counts and its states/s;
     - ``udp_register``: put and get over UDP.

    Returns each mesh leg's launches and the mesh kernel cells."""
    dev = device or "cuda"
    out = {}
    # -- mesh_2pc7 -----------------------------------------------------------
    reset_mesh_launches()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    m7 = mesh_builder(TwoPhaseSys(7), dev).spawn_gpu(sync=True)
    torch.cuda.synchronize()
    m7_s = time.monotonic() - t0
    launches = out["mesh_2pc7"] = mesh_launches()
    paths = check_discoveries(m7.model, m7,
                              {"abort agreement", "commit agreement"})
    m7.assert_properties()
    same, tail = same_snapshots(ref7["snap"], m7.final_snapshot())
    ops = {n: mesh_ops_per_step(dev, n) for n in (1, MESH_PIECES)}
    emit("mesh_2pc7", {
        "pieces": MESH_PIECES, "placement": m7.pieces(),
        "unique": m7.unique_state_count(), "states": m7.state_count(),
        "depth": m7.max_depth(), "sec": m7_s, "plain_sec": ref7["sec"],
        "states_per_sec": m7.state_count() / m7_s, "steps": m7.steps_run,
        "growth_events": m7.growth_events, "mesh_stats": m7.mesh_stats(),
        "tables_and_queue_equal_plain": same, "tail": tail,
        "path_lengths": paths, "launches": launches,
        "ops_per_step": {str(n): v for n, v in ops.items()}, "card": smi})
    if (m7.unique_state_count(), m7.state_count()) != (
            ref7["unique"], ref7["states"]) or ref7["unique"] != TPC7_UNIQUE:
        raise AssertionError("mesh 2pc-7: counts differ from the plain leg")
    if set(m7.discovery_fps()) != set(ref7["disc"]) or not same:
        raise AssertionError("mesh 2pc-7: discoveries, tables or queue "
                             "differ from the plain leg")
    if not all_launched(launches, STEP_KERNELS):
        raise AssertionError(f"mesh 2pc-7: a kernel never launched: "
                             f"{launches}")
    del m7
    lap("mesh_2pc7")
    # -- the kernel cells on a mesh step ---------------------------------------
    mb = mesh_builder(TwoPhaseSys(7), dev).target_states(
        MESH_KERNEL_TARGET).spawn_gpu(sync=True)
    kernels = mesh_kernels(mesh_batch(mb))
    for name, k in kernels.items():
        emit(f"kernel_{name}_mesh_2pc7", k)
    del mb
    lap("kernels_mesh_2pc7")
    # -- mesh_2pc5_parity: cuda = cpu under symmetry -----------------------------
    reset_mesh_launches()
    g5 = mesh_builder(TwoPhaseSys(5), dev).symmetry().spawn_gpu(sync=True)
    out["mesh_2pc5_parity"] = mesh_launches()
    c5 = mesh_builder(TwoPhaseSys(5), "cpu").symmetry().spawn_gpu(sync=True)
    same5, tail5 = same_snapshots(g5.final_snapshot(), c5.final_snapshot())
    emit("mesh_2pc5_parity", {
        "unique_cuda": g5.unique_state_count(),
        "unique_cpu": c5.unique_state_count(), "tail": tail5,
        "snapshots_equal": same5, "launches": out["mesh_2pc5_parity"],
        "card": smi})
    if not (same5 and g5.unique_state_count() == SYM_2PC5_UNIQUE):
        raise AssertionError("mesh 2pc-5 symmetry: cuda and cpu differ")
    del g5, c5
    lap("mesh_2pc5_parity")
    # -- mesh_paxos3: equal to the plain run at the same bound -------------------
    reset_mesh_launches()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    p3 = mesh_builder(paxos_model(3), dev).target_states(
        MESH_PAXOS3_TARGET).spawn_gpu(sync=True)
    torch.cuda.synchronize()
    p3_s = time.monotonic() - t0
    out["mesh_paxos3"] = mesh_launches()
    ref3, ref3_s = timed_run(3, target=MESH_PAXOS3_TARGET, model=paxos_model)
    same3, tail3 = same_snapshots(ref3.final_snapshot(), p3.final_snapshot())
    emit("mesh_paxos3", {
        "target": MESH_PAXOS3_TARGET, "unique": p3.unique_state_count(),
        "states": p3.state_count(), "sec": p3_s, "plain_sec": ref3_s,
        "width": p3.tensor.width, "growth_events": p3.growth_events,
        "tables_and_queue_equal_plain": same3, "tail": tail3,
        "launches": out["mesh_paxos3"], "card": smi})
    if not (same3 and (p3.unique_state_count(), p3.state_count()) == (
            ref3.unique_state_count(), ref3.state_count())):
        raise AssertionError("mesh paxos-3: differs from the plain run")
    del p3, ref3
    lap("mesh_paxos3")
    # -- native_lin: the module built on this machine ----------------------------
    from stateright_tpu_torch import native
    from stateright_tpu_torch.native import build as nbuild

    t0 = time.monotonic()
    path = nbuild.build()  # raises with the compiler's output
    build_s = time.monotonic() - t0
    mod = native.load()
    if mod is None:
        raise AssertionError("native: built but not loaded")
    n = bad = 0
    t0 = time.monotonic()
    for t in native_histories(NATIVE_SEED, NATIVE_HISTORIES):
        nat = t._native_verdict()
        py = t.valid and t.serialized_history() is not None
        n += 1
        bad += int(nat is None or nat != py)
    emit("native_lin", {"module": str(path),
                        "build_sec": build_s, "histories": n,
                        "mismatches": bad, "sec": time.monotonic() - t0,
                        "card": smi})
    if bad:
        raise AssertionError(f"native: {bad} verdicts differ from Python")
    lap("native_lin")
    # -- native_baseline_2pc7: the compiled-CPU BFS ---------------------------------
    from stateright_tpu_torch.native.baseline import compiled_cpu_bfs

    base = compiled_cpu_bfs(TwoPhaseSys(7), batch=BASELINE_BATCH)
    emit("native_baseline_2pc7", dict(
        base, batch=BASELINE_BATCH, torch_threads=torch.get_num_threads(),
        gpu_states_per_sec=ref7["states"] / ref7["sec"], card=smi))
    if base is None or (base["unique"], base["states"]) != (
            ref7["unique"], ref7["states"]):
        raise AssertionError(f"native baseline: {base} is not the plain "
                             "2pc-7 leg's counts")
    lap("native_baseline_2pc7")
    udp_register_leg(smi)
    lap("udp_register")
    return out, kernels


# the compile cache leg's child: 2pc-3 on the card with the kernel library
# built into, or loaded from, the directory it is given (the preflight
# audit, which builds nothing, is skipped: the child's seconds are its
# import, the card's start and the build or load)
CACHE_CHILD = """
import json, sys, time
t0 = time.monotonic()
import torch
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.ops import _cuda
from stateright_tpu_torch.parallel.prewarm import compile_counters
t1 = time.monotonic()
c = (TwoPhaseSys(3).checker().compile_cache(sys.argv[1]).telemetry()
     .skip_audit().spawn_gpu(sync=True))
print(json.dumps({"unique": c.unique_state_count(),
                  "init": c.flight_recorder.records("compile")[0],
                  "counters": compile_counters(),
                  "library": str(_cuda.library_path()),
                  "import_sec": t1 - t0, "run_sec": time.monotonic() - t1}))
"""


def compile_leg_record(c) -> list:
    """Each ``compile`` event of a run: its rung, capacities, source, the
    seconds the run thread waited and the build's seconds."""
    return [{k: e[k] for k in ("rung", "cap", "qcap", "cand", "source",
                               "prewarm_ready", "duration", "build_secs")}
            for e in c.flight_recorder.records("compile")]


def peak_run(dev, builder) -> tuple:
    """``builder.spawn_gpu()`` at the plain leg's defaults, joined, with
    the launch counts reset just before it and read just after; returns
    the checker, its wall seconds, the bytes its allocations raised the
    device's peak above what was live before it, and the launches."""
    reset_launches()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    c = builder.spawn_gpu().join()
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    return (c, sec, torch.cuda.max_memory_allocated(dev) - base,
            kernel_launches())


def prewarm_phases(smi: str, ref7: dict) -> dict:
    """Engine prewarm and the compile cache (``parallel/prewarm.py``):

     - ``prewarm_2pc7``: 2pc-7 ``.prewarm().telemetry()`` at the plain
       leg's defaults: the plain leg's counts, steps, discoveries, table
       bytes and queue rows, every growth rung served by the
       ``stateright-prewarm`` thread (``source="prewarm"``), every kernel
       launched; each rung's wait (``duration``) and build seconds beside
       those of the same run built cold (``.telemetry()`` alone), and the
       wall and the peak device memory of both;
     - ``compile_cache_2pc3``: 2pc-3 in two child processes over one fresh
       compile cache directory: the first builds the kernel library with
       ``nvcc`` (a miss: the init rung's ``source`` is ``fresh``), the
       second loads it (``persistent``); the seconds of each.

    Returns the prewarm leg's launches."""
    dev = torch.device("cuda", 0)
    cold, cold_s, cold_peak, _ = peak_run(
        dev, TwoPhaseSys(7).checker().telemetry())
    warm, warm_s, warm_peak, launches = peak_run(
        dev, TwoPhaseSys(7).checker().prewarm().telemetry())
    paths = check_discoveries(warm.model, warm,
                              {"abort agreement", "commit agreement"})
    same, tail = same_snapshots(ref7["snap"], warm.final_snapshot())
    rungs = compile_leg_record(warm)
    counters = warm.flight_recorder.counters()
    emit("prewarm_2pc7", {
        "unique": warm.unique_state_count(), "states": warm.state_count(),
        "steps": warm.steps_run, "growth_events": warm.growth_events,
        "tables_and_queue_equal_plain": same, "tail": tail,
        "path_lengths": paths, "rungs": rungs,
        "cold_rungs": compile_leg_record(cold),
        "prewarm_scheduled": counters.get("prewarm_scheduled", 0),
        "prewarm_consumed": counters.get("prewarm_consumed", 0),
        "compile_secs": warm.flight_recorder.stages()["compile_secs"],
        "cold_compile_secs": cold.flight_recorder.stages()["compile_secs"],
        "sec": warm_s, "cold_sec": cold_s, "plain_sec": ref7["sec"],
        "peak_device_mib": warm_peak / 2**20,
        "cold_peak_device_mib": cold_peak / 2**20,
        "launches": launches, "card": smi})
    if ((warm.unique_state_count(), warm.state_count(), warm.steps_run)
            != (ref7["unique"], ref7["states"], ref7["steps"])
            or set(warm.discovery_fps()) != set(ref7["disc"]) or not same):
        raise AssertionError("prewarm 2pc-7: counts, steps, discoveries, "
                             "tables or queue differ from the plain leg")
    if not warm.growth_events or rungs[0]["rung"] != "init" or any(
            r["source"] != "prewarm" for r in rungs[1:]) or len(rungs) < 2:
        raise AssertionError(f"prewarm 2pc-7: a growth rung was not "
                             f"prewarmed: {rungs}")
    if not all_launched(launches):
        raise AssertionError(f"prewarm 2pc-7: a kernel never launched: "
                             f"{launches}")
    del cold, warm
    lap("prewarm_2pc7")
    # -- compile_cache_2pc3: a cold nvcc build, then a hit ----------------------
    runs = []
    with tempfile.TemporaryDirectory(prefix="srt-compile-cache-") as d:
        for _ in range(2):
            out = subprocess.run(
                [sys.executable, "-c", CACHE_CHILD, d],
                cwd=Path(__file__).resolve().parent, capture_output=True,
                text=True, timeout=600)
            if out.returncode != 0:
                raise AssertionError(f"compile cache child failed:\n"
                                     f"{out.stderr[-4000:]}")
            runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        in_dir = all(Path(r["library"]).parent == Path(d) for r in runs)
    miss, hit = runs
    emit("compile_cache_2pc3", {
        "unique": [r["unique"] for r in runs],
        "cold_build_secs": miss["init"]["build_secs"],
        "hit_build_secs": hit["init"]["build_secs"],
        "sources": [r["init"]["source"] for r in runs],
        "counters": [r["counters"] for r in runs],
        "child_import_secs": [r["import_sec"] for r in runs],
        "child_run_secs": [r["run_sec"] for r in runs],
        "library_in_dir": in_dir,
        "card": smi})
    if not (in_dir and [r["unique"] for r in runs] == [288, 288]
            and miss["init"]["source"] == "fresh"
            and miss["counters"]["persistent_cache_misses"] == 1
            and hit["init"]["source"] == "persistent"
            and hit["counters"]["persistent_cache_hits"] == 1):
        raise AssertionError(f"compile cache: not a miss then a hit: {runs}")
    lap("compile_cache_2pc3")
    return {"prewarm_2pc7": launches}


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
    nvcc = subprocess.run([_cuda._nvcc(), "--version"], check=True,
                          capture_output=True, text=True, timeout=60)
    emit("card", {"nvidia_smi": smi, "torch": torch.__version__,
                  "cuda": torch.version.cuda,
                  "nvcc": nvcc.stdout.strip().splitlines()[-1],
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
    # what the spill 2pc-5 leg must give
    ref5 = {"sec": g5_s, "unique": g5.unique_state_count(),
            "states": g5.state_count(), "disc": g5.discovery_fps()}
    del g5, c5
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
    if not all_launched(launches):
        raise AssertionError(f"a kernel never launched on 2pc-7: {launches}")
    # what the checked and supervised 2pc-7 legs must give
    ref7 = {"sec": g7_s, "unique": g7.unique_state_count(),
            "states": g7.state_count(), "steps": g7.steps_run,
            "disc": g7.discovery_fps(), "snap": g7.final_snapshot(),
            "launches": launches}
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
    if not all_launched(launches10):
        raise AssertionError(f"a kernel never launched on 2pc-10: {launches10}")
    lap("2pc10")

    # -- kernels at 2pc-10 shapes, L2-cold -----------------------------------
    kernels10 = check_kernels(g10, g10._final_carry, cold=True)
    for name, k in kernels10.items():
        emit(f"kernel_{name}_2pc10", k)
    del g10
    lap("kernels_2pc10")

    # -- the block graph against the eager loop, and block_cond's cell ------
    block_cell = block_graph_phase(dev, smi)
    lap("block_graph")

    p3_ref = paxos_phases(dev, smi)
    lap("paxos2_and_paxos3")
    launches_tel = telemetry_phases(dev, smi, p3_ref)
    launches_p3f, launches_p2f, launches_sym7f, p3f_stop = flag_phases(
        dev, smi, p3_ref)
    lap("step_flags")
    launches_cs, kernels_inject = checked_spill_phases(dev, smi, ref5,
                                                       ref7, p3_ref)
    # -- kernels at paxos-3 shapes, L2-cold: plain, and the same batch as a
    # .prededup() step gives it (the queue holds the same rows with the
    # flag on or off) ---------------------------------------------------------
    gp, _ = timed_run(3, target=PAXOS3_KERNEL_TARGET, model=paxos_model)
    check_prededup_stop(gp, p3f_stop, smi)
    del p3f_stop
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
    launches_por, kernels_por = por_phases(dev, smi, ref7)
    lap("por")
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
    launches_sup = supervise_phases(dev, smi, ref7)
    launches_sweep, kernels_sweep = sweep_phases(dev, smi, ref7)
    lap("sweep")
    launches_svc = service_phases(smi, ref7)
    launches_sh, kernels_sh = sharded_phases(smi, ref7)
    launches_mesh, kernels_mesh = mesh_phases(smi, ref7)
    launches_pw = prewarm_phases(smi, ref7)

    bad = [f"{k['name']} at {shape}"
           for shape, ks in (("2pc-7", kernels), ("2pc-10", kernels10),
                             ("block graph", {"block_cond": block_cell}),
                             ("paxos-3", kernels_p3),
                             ("paxos-3 prededup", kernels_p3f),
                             ("single-copy-4", kernels_sc4),
                             ("per-channel paxos-2", kernels_p2pc),
                             ("2pc-15 symmetry", kernels_sym),
                             ("orl", kernels_orl),
                             ("por proviso", kernels_por),
                             ("sweep_2pc7_seeds", kernels_sweep),
                             ("sharded 2pc-7", kernels_sh),
                             ("mesh 2pc-7", kernels_mesh),
                             *((f"{leg} inject", cell) for leg, cell
                               in kernels_inject.items()))
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
        # the supervisor and the audit (supervise_sigkill: the resumed
        # run's, the killed run's being lost with its process)
        for leg, ls in launches_sup.items():
            entry[f"at_{leg}"] = {"launches": ls[name]}
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
        for leg, ls in launches_tel.items():
            entry[f"at_{leg}"] = {"launches": ls[name]}
        # checked mode and the spill tier: the step's launches, and the
        # spill inject's apart
        for leg, ls in launches_cs.items():
            entry[f"at_{leg}"] = {"launches": ls[name]}
            if "inject" in ls:
                entry[f"at_{leg}"]["inject_launches"] = ls["inject"].get(
                    name, 0)
            if name in kernels_inject.get(leg, {}):
                entry[f"at_{leg}_inject"] = dict(
                    {key: kernels_inject[leg][name][key]
                     for key in KERNEL_KEYS
                     if key not in ("name", "route", "source", "replaces",
                                    "launches")},
                    launches=ls["inject"][name])
        # partial-order reduction: each leg's launches (the ample and
        # the proviso rounds), and the proviso round's kernel cells
        for leg, ls in launches_por.items():
            entry[f"at_{leg}"] = {"launches": ls[name]}
        if name in kernels_por:
            entry["at_por_proviso"] = dict(
                {key: kernels_por[name][key] for key in KERNEL_KEYS
                 if key not in ("name", "route", "source", "replaces",
                                "launches")},
                launches=launches_por["por_pc_paxos2"][name])
        # the sweep legs: every kernel of the main path runs there too
        for leg, ls in launches_sweep.items():
            entry[f"at_{leg}"] = {"launches": ls[name]}
        # the service legs: the served run, and the fleets (launches summed
        # over both slots)
        for leg, ls in launches_svc.items():
            entry[f"at_{leg}"] = {"launches": ls[name]}
        # the sharded engine: each leg's launches, and the cells on a
        # sharded step (cand_prep is not on its path)
        for leg, ls in launches_sh.items():
            entry[f"at_{leg}"] = {"launches": ls[name]}
        if name in kernels_sh:
            entry["at_sharded_2pc7"] = dict(
                {key: kernels_sh[name][key] for key in KERNEL_KEYS
                 if key not in ("name", "route", "source", "replaces",
                                "launches")},
                launches=launches_sh["sharded_2pc7"][name])
        # the mesh engine: each leg's launches, and the cells on one piece
        # of a mesh step (bucket_plan, insert_commit's table half)
        for leg, ls in launches_mesh.items():
            entry[f"at_{leg}"] = {"launches": ls[name]}
        # engine prewarm: the prewarmed 2pc-7 run's launches
        for leg, ls in launches_pw.items():
            entry[f"at_{leg}"] = {"launches": ls[name]}
        if name in kernels_mesh:
            entry["at_mesh_2pc7"] = dict(
                {key: kernels_mesh[name][key] for key in KERNEL_KEYS
                 if key not in ("name", "route", "source", "replaces",
                                "launches")},
                launches=launches_mesh["mesh_2pc7"][name])
        line.append(entry)
    # the block loop's cond: the 2pc-7 leg's launches (one a block and one
    # an executed step), and each single-device leg's beside them
    cond = dict({key: block_cell[key] for key in KERNEL_KEYS
                 if key != "launches"}, launches=launches["block_cond"])
    for tag, ls in (("at_2pc10", launches10),
                    ("at_singlecopy4", launches_sc4),
                    ("at_paxos2_per_channel", launches_p2pc),
                    ("at_2pc15_symmetry", launches_sym),
                    ("at_paxos3_prededup", launches_p3f),
                    ("at_checkpoint_sc4", launches_ckpt),
                    ("at_auto_2pc7", launches_auto),
                    ("at_orl", launches_orl)):
        cond[tag] = {"launches": ls["block_cond"]}
    for group in (launches_p2f, launches_tel, launches_cs, launches_por,
                  launches_pw):
        for leg, ls in group.items():
            if "block_cond" in ls:
                cond[f"at_{leg}"] = {"launches": ls["block_cond"]}
    line.append(cond)
    # the sweep's two kernel modes, each as a kernel of its own: launches
    # are the 2pc-7 seed sweep's (every cand_prep and insert_commit launch
    # of a sweep is in that mode)
    for mode, base in (("cand_prep_namespace", "cand_prep"),
                       ("insert_commit_tags", "insert_commit")):
        line.append(dict({key: kernels_sweep[mode][key] for key in KERNEL_KEYS
                          if key != "launches"},
                         launches=launches_sweep["sweep_2pc7_seeds"][base]))
    # generation order (the symmetry runs' plan), as a kernel of its own
    gen = kernels_sym["bucket_plan_fused"]
    line.append(dict({key: gen[key] for key in KERNEL_KEYS
                      if key != "launches"},
                     launches=launches_sym["bucket_plan_fused"]))
    # the pre-gathered plan, the sharded engine's: its cell and launches
    # are the sharded 2pc-7 leg's, and each leg's launches beside them
    pre = dict({key: kernels_sh["bucket_plan"][key] for key in KERNEL_KEYS
                if key != "launches"},
               launches=launches_sh["sharded_2pc7"]["bucket_plan"])
    for leg, ls in launches_sh.items():
        pre[f"at_{leg}"] = {"launches": ls["bucket_plan"]}
    line.append(pre)
    # insert_commit's window mode (the mesh's queue pieces): launches are
    # the complete mesh 2pc-7 leg's
    win = kernels_mesh["insert_commit_window"]
    line.append(dict({key: win[key] for key in KERNEL_KEYS
                      if key != "launches"},
                     launches=launches_mesh["mesh_2pc7"][
                         "insert_commit_window"]))
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
    sys.exit(oom_child() if sys.argv[1:] == ["--oom-child"] else main())
