"""The mesh engine: the single-device wavefront program, its table and
queue held as row pieces over a device mesh.

The port's counterpart of ``stateright_tpu/parallel/mesh.py``
(``MeshTpuChecker``, :69-229).  JAX hands its global wavefront program to
GSPMD with the carry's placement as ``NamedSharding`` partition rules and
lets the compiler insert the collectives.  PyTorch has no partitioner, so
this engine places the buffers itself, by the same rules
(``parallel/partition.py``), and keeps the single-device engine's step
(``parallel/wavefront.py::_Engine.step``), overriding only its seams:

 - **Placement.**  The visited table (``table_fp``, ``table_parent``) is
   ``D`` contiguous row pieces: piece ``k`` lives on ``mesh.devices[k]``
   and holds rows ``[k*cap/D, (k+1)*cap/D)``, the buckets ``[k*nb/D,
   (k+1)*nb/D)``, so a bucket's owner is a layout fact (JAX :14-21).  The
   queue buffers (``q_*``) are ``D`` row pieces the same way.  Counters,
   status, discoveries, flags and every optional tail stay whole on the
   lead device, ``devices[0]``.  A buffer whose leading dimension ``D``
   does not divide (the table counted in buckets) is held whole on the
   lead device, as JAX replicates it.
 - **The pop** (:meth:`MeshEngine._pop`) gathers the window ``[head,
   head + batch)`` from every queue piece and keeps each lane's value from
   the piece that holds it.
 - **The insert** (:meth:`MeshEngine._insert_round`): ``cand_prep`` and
   the key sort run once, on the lead device, over the whole batch.
   Sorted by key means sorted by bucket, so each owner's candidates are one
   contiguous run, found by a ``searchsorted`` of the sorted keys for the
   first key of each piece's first bucket.  The unsorted lanes, the
   sorted keys, the permutation and the run's two bounds go to the
   piece's device, where ``bucket_plan_fused`` plans the run as a window
   (its lanes read as lanes ``0..`` of a ``cand``-wide batch) against the
   piece with the buckets rebased by ``k*nb/D``.  An overflow in any piece blocks the
   commit of all (the counts are zeroed before the write, so nothing is
   written), and each piece's ``insert_commit`` writes its table piece.
   The novel lanes are then merged on the lead device at global queue
   offsets (piece ``k``'s first at ``tail`` plus the novel counts of the
   pieces before it, computed on the device), in table order, or under
   symmetry in generation order (a sort of the merged candidate indices),
   and each queue piece appends the rows that fall in its window with
   ``insert_commit``'s window mode.  No host read, no copy of a table.
 - **The rollback** (:meth:`MeshEngine._rollback`, POR's second round)
   undoes every piece's writes.

So the program is the single-device engine's, step for step: counts,
verdicts, discovery traces, the final table bytes and queue rows, and
snapshots equal the single-device ``GpuChecker``'s and both JAX engines'.
``.mesh(devices=1)`` (or any mesh whose table and queue both stay whole)
runs the single-device step itself and dispatches exactly its operations.

Symmetry, ``.prededup()``, ``.por()`` (both insert rounds through the
piece-aware insert), ``.checked()``, ``.cartography()`` (the depth
histogram reads the queue's depth pieces gathered on the lead device once
a block) and telemetry run here, with the engine tag ``"mesh"``;
``.spill()`` is refused (the inherited ``_init_common`` rejection, JAX
:43-44).  The host loop is the single-device engine's: growth, checkpoints
and resumes go through the host, which joins the pieces into whole
buffers, and the next block splits them again.  The engine is
single-controller, as JAX's: under a ``torch.distributed`` group of more
than one rank it refuses to run (the multi-controller form is the sharded
engine's, ``parallel/sharded.py``).  Pieces may share a device; on one card
every piece path runs, with no peer copy.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from ..convert import QDEPTH, QEBITS, QFP, QROWS, TFP, TPL
from ..ops.buckets import (
    SLOTS, PlanBuffers, bucket_bits, bucket_of, bucket_plan_fused,
)
from ..ops.cand_prep import cand_prep
from ..ops.hashing import EMPTY, EMPTY_U64
from ..ops.insert_commit import QueueAppend, insert_commit, insert_commit_window
from .partition import (
    WAVEFRONT_CARRY_RULES, Mesh, build_mesh, match_partition_rules,
    wavefront_carry_names,
)
from .wavefront import BASE, GpuChecker, _Engine, stats_of

TABLE = (TFP, TPL)
QUEUE = (QROWS, QFP, QEBITS, QDEPTH)
_MAX_LANE = (1 << 63) - 1


class Pieces:
    """One carry buffer held as row pieces: ``parts[k]`` holds the rows
    ``[k * rows, (k + 1) * rows)``, on its own device."""

    __slots__ = ("parts",)

    def __init__(self, parts: list):
        self.parts = parts

    @classmethod
    def split(cls, t: torch.Tensor, devices: list) -> "Pieces":
        """``t`` cut into ``len(devices)`` row pieces, each a tensor of its
        own on its device (never a view of ``t``)."""
        r = t.shape[0] // len(devices)
        return cls([t[k * r:(k + 1) * r].to(d, copy=True)
                    for k, d in enumerate(devices)])

    @property
    def rows(self) -> int:
        """Rows per piece."""
        return self.parts[0].shape[0]

    def whole(self, device) -> torch.Tensor:
        """The buffer as one tensor on ``device``."""
        if len(self.parts) == 1:
            return self.parts[0].to(device)
        return torch.cat([p.to(device) for p in self.parts])


def whole(x, device):
    return x.whole(device) if isinstance(x, Pieces) else x


def _on(dev: torch.device):
    """The CUDA device context for a piece's launches (the runtime
    launches on the current device), a no-op on the CPU."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


class _MeshPlan:
    """One insert round's buffers: a :class:`PlanBuffers` per table piece
    (CUDA only; table order, the merge gives generation order) and the
    merged novel lanes on the lead device, ``cand`` lanes and one dump
    lane the dead lanes of the merge write to."""

    def __init__(self, m: int, devices: list, lead, cuda: bool):
        self.bufs = ([PlanBuffers(m, d, False) for d in devices] if cuda
                     else [None] * len(devices))
        i64 = dict(dtype=torch.int64, device=lead)
        self.sel = torch.zeros(m + 1, **i64)
        self.cfp = torch.zeros(m + 1, **i64)


class MeshEngine(_Engine):
    """The single-device engine with its table and queue in pieces over
    ``mesh`` (:class:`Pieces`); the seams :meth:`_pop`,
    :meth:`_insert_round` and :meth:`_rollback` are piece-aware, and
    :meth:`run`/:meth:`init` place the carry.  When neither the table nor
    the queue is in pieces (one device, or sizes the mesh does not
    divide), every seam is the single-device engine's."""

    # the eager loop (``_Engine._run_steps``) runs its blocks: the pieces
    # may sit on several devices, which one captured graph does not span
    graph_block = False

    def __init__(self, *args, mesh: Mesh, **kw):
        super().__init__(*args, **kw)
        d, lead = mesh.size, self.device
        nb = self.cap // SLOTS
        names = wavefront_carry_names(BASE)
        shapes = [(nb, SLOTS), (nb, SLOTS), (self.qalloc, self.width)] + [
            (self.qalloc,)] * 3 + [()] * (BASE - 6)
        place = match_partition_rules(WAVEFRONT_CARRY_RULES, names, shapes,
                                      mesh)
        self.tpieces = d > 1 and place[TFP].pieces
        self.qpieces = d > 1 and place[QFP].pieces
        self.meshed = self.tpieces or self.qpieces
        self.tdevs = list(mesh.devices) if self.tpieces else [lead]
        self.qdevs = list(mesh.devices) if self.qpieces else [lead]
        self.nbp = nb // len(self.tdevs)  # buckets per table piece
        self.qrows = self.qalloc // len(self.qdevs)  # rows per queue piece
        if not self.meshed:
            return
        cuda = self.device.type == "cuda"
        m = self.eff_cand
        self.plan_out = _MeshPlan(m, self.tdevs, lead, cuda)
        if self.por:
            self.plan_out2 = _MeshPlan(m, self.tdevs, lead, cuda)
        # each table piece's first sorted key (its first bucket's, as
        # ``bucket_key ^ SIGN``), then the largest key, EMPTY's, which the
        # last window leaves out (dead lanes either way); the lanes on each
        # table device, and each device's stream
        bits = bucket_bits(nb)
        firsts = [((k * self.nbp) << (64 - bits)) ^ (1 << 63)
                  for k in range(len(self.tdevs))]
        self.key_starts = torch.tensor(
            [f - (1 << 64) if f >> 63 else f for f in firsts]
            + [(1 << 63) - 1], dtype=torch.int64, device=lead)
        self.cand_lanes_lead = torch.arange(m, device=lead)
        self.piece_lanes = [self.cand_lanes_lead.to(dv) for dv in self.tdevs]
        self.streams = {str(dv): (torch.cuda.current_stream(dv).cuda_stream
                                  if cuda else None)
                        for dv in set(self.tdevs) | set(self.qdevs)}

    # -- placement -------------------------------------------------------------

    def place(self, carry: list) -> list:
        """The carry with its table and queue in this engine's pieces:
        whole buffers (after the init, a growth or a resume, which go
        through the host) are split; placed ones pass through, since an
        engine of new capacities only ever gets a carry the host grew."""
        if not self.meshed:
            return carry
        carry = list(carry)
        for idx, devs in ((TABLE, self.tdevs), (QUEUE, self.qdevs)):
            for i in idx:
                if not isinstance(carry[i], Pieces):
                    carry[i] = Pieces.split(carry[i], devs)
        return carry

    def run(self, carry: list):
        return super().run(self.place(carry))

    def init(self):
        carry, stats = super().init()
        return self.place(carry), stats

    def _stats(self, carry: list) -> torch.Tensor:
        if self.meshed and self.cart:
            # the queue-derived depth histogram reads the depth column
            carry = list(carry)
            carry[QDEPTH] = whole(carry[QDEPTH], self.device)
        return stats_of(carry, self.layout)

    # -- the step's seams ------------------------------------------------------

    def _pop(self, c, pos):
        if not self.meshed:
            return super()._pop(c, pos)
        bufs = [c[i] for i in QUEUE]
        if len(self.qdevs) == 1:
            return tuple(b.parts[0][pos] for b in bufs)
        out = [None] * len(QUEUE)
        for q, dv in enumerate(self.qdevs):
            lo = q * self.qrows
            local = (pos - lo).clamp_(0, self.qrows - 1).to(dv)
            inside = (pos >= lo) & (pos < lo + self.qrows)
            for i, b in enumerate(bufs):
                v = b.parts[q][local].to(self.device)
                if out[i] is None:
                    out[i] = v
                else:
                    mask = inside.view(-1, *([1] * (v.dim() - 1)))
                    out[i] = torch.where(mask, v, out[i])
        return tuple(out)

    def piece_bounds(self, skey):
        """Each table piece's run of the sorted keys ``skey``: lanes
        ``bounds[k]`` to ``bounds[k + 1]`` (one ``searchsorted``, on the
        device; the EMPTY lanes past the last bound); None for a whole
        table."""
        if len(self.tdevs) == 1:
            return None
        return torch.searchsorted(skey, self.key_starts)

    def _insert_round(self, c, krows, kept, fps, tail, cand_rows, ebits,
                      depths, prep_out, plan_out):
        """One insert round over the pieces (module docstring): returns
        ``(plans, sel, n_new, n_kept, toverflow, coverflow)``, ``plans``
        each table piece's ``(tgt, committed count)``, which
        :meth:`_rollback` takes, and ``sel`` the merged novel candidates
        in queue order."""
        if not self.meshed:
            return super()._insert_round(c, krows, kept, fps, tail,
                                         cand_rows, ebits, depths, prep_out,
                                         plan_out)
        lead, m = self.device, self.eff_cand
        lanes = self.cand_lanes_lead
        pfp, ppl, cidx, key, n_kept, coverflow = cand_prep(
            krows, kept, fps, self.arity, m, prep_out, check=False,
            stream=self.stream,
        )
        skey, order = torch.sort(key, stable=True)
        tfp, tpl = c[TFP], c[TPL]
        plans = []
        bounds = self.piece_bounds(skey)
        for k, dv in enumerate(self.tdevs):
            args = [a.to(dv) for a in (pfp, ppl, skey, order, cidx,
                                       coverflow)]
            win = None if bounds is None else bounds[k:k + 2].to(dv)
            with _on(dv):
                plans.append(bucket_plan_fused(
                    tfp.parts[k], *args, self.cap // SLOTS,
                    plan_out.bufs[k], win=win, boff=k * self.nbp,
                    check=False, stream=self.streams[str(dv)]))
        # an overflow in any piece blocks every piece's commit
        toverflow = torch.stack([p[5].to(lead) for p in plans]).any()
        committed = []
        for k, dv in enumerate(self.tdevs):
            tgt, cfp, cpl, _, n_new, _ = plans[k]
            n_k = torch.where(toverflow.to(dv), 0, n_new)
            with _on(dv):
                insert_commit(tfp.parts[k], tpl.parts[k], tgt, cfp, cpl, n_k,
                              check=False, stream=self.streams[str(dv)])
            committed.append((tgt, n_k))
        # the novel lanes at their global queue offsets, on the lead device
        counts = torch.stack([n.to(lead) for _, n in committed])
        n_new = counts.sum()
        if len(plans) == 1:
            sel, cfp = plans[0][3].to(lead), plans[0][1].to(lead)
        else:
            offs = torch.cumsum(counts, 0) - counts
            for k, p in enumerate(plans):
                pos = torch.where(lanes < counts[k], offs[k] + lanes, m)
                plan_out.sel.index_copy_(0, pos, p[3].to(lead))
                plan_out.cfp.index_copy_(0, pos, p[1].to(lead))
            sel, cfp = plan_out.sel[:m], plan_out.cfp[:m]
        if self.sym:
            # generation order: the candidates' own order, which the
            # compaction index keeps, so ascending candidate index
            _, perm = torch.sort(torch.where(lanes < n_new, sel, _MAX_LANE),
                                 stable=True)
            sel, cfp = sel[perm], cfp[perm]
        for q, dv in enumerate(self.qdevs):
            qa = QueueAppend(c[QROWS].parts[q], c[QFP].parts[q],
                             c[QEBITS].parts[q], c[QDEPTH].parts[q],
                             tail.to(dv), sel.to(dv), cand_rows.to(dv),
                             ebits.to(dv), depths.to(dv), self.arity)
            with _on(dv):
                insert_commit_window(qa, cfp.to(dv), n_new.to(dv),
                                     q * self.qrows, check=False,
                                     stream=self.streams[str(dv)])
        return committed, sel, n_new, n_kept, toverflow, coverflow

    def _rollback(self, c, overflow, tgt, n_new) -> None:
        if not self.meshed:
            return super()._rollback(c, overflow, tgt, n_new)
        # ``tgt``: each table piece's (slots, committed count)
        for k, (slots, n_k) in enumerate(tgt):
            dv = self.tdevs[k]
            undo = overflow.to(dv) & (self.piece_lanes[k] < n_k)
            idx = torch.where(undo, slots, 0)
            tfp, tpl = c[TFP].parts[k], c[TPL].parts[k]
            fp = tfp.index_select(0, idx)
            pl = tpl.index_select(0, idx)
            tfp.index_add_(0, idx, torch.where(undo, EMPTY - fp, 0))
            tpl.index_add_(0, idx, torch.where(undo, -pl, 0))


class MeshGpuChecker(GpuChecker):
    """Wavefront BFS with the table and queue in pieces over a device mesh.

    Spelled ``CheckerBuilder.mesh()`` / ``--mesh`` /
    ``STATERIGHT_TPU_MESH=1`` (the sharded engine keeps the
    ``devices=``/``n_devices=`` spawn keywords).  ``mesh`` is a
    :class:`~.partition.Mesh` (default :func:`~.partition.build_mesh` of
    ``n_devices`` on ``device``'s platform); every other keyword is
    ``GpuChecker``'s.  Everything but placement is the single-device
    engine."""

    _engine_tag = "mesh"
    _telemetry_tag = _report_engine = "mesh"

    def __init__(self, options, mesh: Optional[Mesh] = None,
                 n_devices: Optional[int] = None, device=None, **kw):
        self._mesh = (mesh if mesh is not None
                      else build_mesh(n_devices, device=device))
        self._mesh_stats_cache = None
        super().__init__(options, device=self._mesh.devices[0], **kw)

    @property
    def mesh(self) -> Mesh:
        return self._mesh

    @property
    def n_devices(self) -> int:
        return self._mesh.size

    def _engine(self, cap, qcap, batch, cand) -> MeshEngine:
        return MeshEngine(self.tensor, self._props, cap, qcap, batch,
                          self._steps, self._target, cand, self.device,
                          sym=self._symmetry is not None,
                          prededup=self._prededup, removed=self._removed,
                          cartography=self._cartography,
                          checked=self._checked, spill=None,
                          por=self._por_plan if self._por else None,
                          mesh=self._mesh)

    def _engine_key(self, cap, qcap, batch, cand) -> tuple:
        # mesh entries never collide with the single-device engine's or
        # another mesh's (JAX :107-113)
        return super()._engine_key(cap, qcap, batch, cand) + (
            ("mesh",) + tuple(str(d) for d in self._mesh.devices),)

    def _pre_run_validate(self) -> None:
        super()._pre_run_validate()
        from .sharded import controllers

        n = controllers()
        if n > 1:
            raise NotImplementedError(
                f"the mesh engine is single-controller: this process is one "
                f"of {n} torch.distributed ranks, and the mesh spans only "
                "the devices this controller addresses; the multi-controller "
                "form is the sharded engine's (spawn_gpu(devices=N)), or "
                "run the mesh engine in one process"
            )

    # -- the host side sees whole buffers ---------------------------------------

    def _whole(self, carry: list, only=None) -> list:
        return [whole(x, self.device) if only is None or i in only else x
                for i, x in enumerate(carry)]

    def _stats_of(self, carry, layout, exact: bool = False):
        return stats_of(self._whole(carry, QUEUE), layout, exact=exact)

    def _regrow(self, carry, *args, **kw):
        return super()._regrow(self._whole(carry), *args, **kw)

    def _snapshot(self, carry, *args):
        return super()._snapshot(self._whole(carry), *args)

    def _raise_on_checked_error(self, carry, *args) -> None:
        super()._raise_on_checked_error(self._whole(carry), *args)

    def _telemetry_occupancy(self, table_fp, **kw) -> None:
        super()._telemetry_occupancy(whole(table_fp, self.device), **kw)

    def _table_np(self):
        return tuple(whole(self._final_carry[i], self.device).cpu().numpy()
                     .view(np.uint64) for i in TABLE)

    def pieces(self) -> dict:
        """The finished run's table and queue pieces: buffer name -> the
        device of each piece."""
        self.join()
        names = ("table_fp", "table_parent", "q_rows", "q_fp", "q_ebits",
                 "q_depth")
        return {n: [str(p.device) for p in x.parts] if isinstance(x, Pieces)
                else [str(x.device)]
                for n, x in zip(names, [self._final_carry[i]
                                        for i in TABLE + QUEUE])}

    # -- per-piece load and routing (the A/B readout) ---------------------------

    def mesh_stats(self) -> Optional[dict]:
        """Per-piece visited-table load, the parent-owner -> child-owner
        route matrix and the imbalance summary
        (``ops/cartography.shard_imbalance``); None while the run is in
        flight (JAX :159-208).

        Ownership is derived from the final table as the partition rules
        place it: position ``p`` belongs to piece ``p // (cap/D)``; a
        parent's position is its bucket (``ops/buckets.bucket_of``) times
        ``SLOTS``.  ``route[s][d]`` counts unique states owned by piece
        ``d`` whose parent piece ``s`` owns (init states, parent 0, are in
        ``shard_load`` but route nowhere)."""
        if not self._done.is_set() or self._final_carry is None:
            return None
        return self._mesh_stats_now()

    def _mesh_stats_now(self) -> dict:
        cached = self._mesh_stats_cache
        if cached is not None and cached[0] is self._final_carry:
            return dict(cached[1])
        from ..ops.cartography import shard_imbalance

        tfp, tpl = self._table_np()
        d = self.n_devices
        cap = tfp.shape[0]
        rows_per_shard = cap // d if cap % d == 0 else cap
        if rows_per_shard == cap and d > 1:
            shards_of = np.zeros(cap, np.int64)  # a whole table: one owner
        else:
            shards_of = np.arange(cap, dtype=np.int64) // rows_per_shard
        occupied = tfp != EMPTY_U64
        load = np.bincount(shards_of[occupied], minlength=d)[:d]
        routed = occupied & (tpl != np.uint64(0))
        child = shards_of[np.nonzero(routed)[0]]
        parent_pos = bucket_of(tpl[routed], cap // SLOTS) * SLOTS
        parent = parent_pos // rows_per_shard
        route = np.zeros((d, d), np.int64)
        np.add.at(route, (parent, child), 1)
        out = {
            "devices": d,
            "axes": dict(self._mesh.shape),
            "shard_load": [int(v) for v in load],
            "imbalance": shard_imbalance(load),
            "route_matrix": [[int(v) for v in row] for row in route],
            "routed_states": int(route.sum()),
        }
        self._mesh_stats_cache = (self._final_carry, out)
        return out

    def _run(self) -> None:
        super()._run()
        # the imbalance readout rides the results and the cartography
        # block (the sharded engine's key names there)
        try:
            stats = (self._mesh_stats_now() if self._results is not None
                     else None)
        except Exception:  # noqa: BLE001 - a readout never fails a run
            stats = None
        if stats is None:
            return
        self._results["mesh"] = stats
        cart = self._results.get("cartography")
        if isinstance(cart, dict):
            cart.setdefault("shard_load", stats["shard_load"])
            cart.setdefault("shard_imbalance", stats["imbalance"])
            cart.setdefault("route_matrix", stats["route_matrix"])
        if self.flight_recorder is not None:
            self.flight_recorder.record(
                "mesh", devices=stats["devices"],
                shard_load=stats["shard_load"],
                imbalance=stats["imbalance"],
                routed_states=stats["routed_states"],
            )
