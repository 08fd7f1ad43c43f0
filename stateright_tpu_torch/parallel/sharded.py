"""The sharded wavefront BFS — ``spawn_gpu(devices=N)``.

The port's counterpart of ``stateright_tpu/parallel/sharded.py``
(``_build_sharded_run`` :90-631 and ``ShardedTpuChecker`` :647-1476).
The visited set is split over ``N`` shards by fingerprint ownership: a
fingerprint's owner is ``lshr(fp, 32) % N`` (the high bits, independent of
the low bits that pick its bucket inside the owner's table).  Each step

 1. evaluates the property masks on every shard's frontier, recording the
    smallest hit fingerprint over all shards (unsigned order, so the
    witness does not depend on how the shards are laid out);
 2. expands every frontier row through the twin's ``step_rows`` and
    fingerprints the successors (kernel ``row_hash``; under
    ``.symmetry()`` the canonical rows', under ``.prededup()`` then
    deduplicated inside each shard, ``ops/buckets.window_unique``);
 3. routes every candidate to its owner (``route``, JAX :235-275): a
    stable sort by owner, the rank within each destination, send buffers
    of ``bucket_cap`` lanes per (destination, source) pair whose overflow
    is a replayable status, and the exchange;
 4. inserts the received candidates at their owner (JAX
    ``insert_and_compact``, :276-312): the budget compaction and the key
    sort per shard, then one ``bucket_plan`` and one ``insert_commit``
    launch for all co-located shards, and the novel rows compacted into
    exactly ``fcap_local`` rows of each shard's next frontier.

**Placement.**  Without a process group (one controller) all ``N``
shards live on the one device, held stacked: the tables as one
``[N * cap_local]`` table whose shard ``k`` owns the buckets ``k *
nbuckets_local ..``, the frontiers as ``[N * fcap_local, W]``.  The
source side runs once over the stacked frontier, so host issue does not
grow with ``N``; the exchange is an index operation (the send buffers'
destination-major layout is already the owners' source-major receive
layout, as ``all_to_all(..., tiled=False)`` gives it); every reduction
(JAX ``psum``/``pmin``/``pmax``) is one over the stacked shards.  Under an
initialized ``torch.distributed`` group of ``P`` ranks (the multi-card
form, one process per card: JAX's ``jax.distributed`` run) each rank holds
``N / P`` stacked shards on its own device, the exchange is
``all_to_all_single`` of fixed-size send buffers, and every replicated
value (counts, status, discoveries, the cartography tallies) comes from
one ``all_reduce`` per kind.

**The shared insert.**  The co-located shards' candidates are sorted by
``(shard, key)`` (one batched sort along the shard's lanes), their buckets
offset by ``shard * nbuckets_local``, and planned in one launch: a shard's
novel lanes are a contiguous run of the plan's compacted list, in table
or (under symmetry) generation order, so each shard's count and
frontier come from the plan's slots.  The budget overflow is judged per
shard, as in JAX, and not handed to the kernel: the plan then holds every
shard's novelty and the host-visible semantics stay per shard (a blocked
shard counts 0).  Each step is atomic, as JAX's rolled-back carry: the
commit's count is 0 unless the step advances, and under POR, where the
proviso round must see the ample round's inserts, a step that does not
advance writes its slots back to empty (``_undo``).

**Growth without lost work**, JAX's protocol: an overflowing step changes
nothing but the status; at the block's sync the host rehashes each shard's
table (``host_bucket_rehash``) or pads each shard's frontier, or doubles
the route bucket or the candidate budget, and replays.  Under a process
group every rank grows its own shards at the same boundary: the status is
replicated (lockstep growth, not fenced).

**No host read inside a block**: a step after the stop is a no-op, and
the host reads one packed stats tensor per block of ``steps_per_call``
steps.  Checkpoints, stop, resume and autosave are single-controller, as
in JAX; a snapshot has the JAX keys (``convert.SHARDED_SNAPSHOT_KEYS``)
and either package resumes the other's at the same ``N``.

``.symmetry()`` (the generation-order plan), ``.prededup()``,
``.cartography()`` (with the per-shard load and the route matrix) and
``.por()`` (JAX :398-470: the ample mask at the source, the owner's
novelty sent back by the reverse exchange, the proviso's second route and
insert in the same step) run here; ``.checked()``, ``.spill()`` and,
under a process group, ``timeout()`` are refused with JAX's words.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .. import convert
from ..convert import (
    SH_DEPTH as DEPTH, SH_DISC as DISC, SH_EBITS as EBITS, SH_FPS as FPS,
    SH_ROWS as ROWS, SH_SCOUNT as SCOUNT, SH_STATUS as STATUS, SH_TFP as TFP,
    SH_TPL as TPL, SH_UNIQUE as UNIQUE,
)
from ..core import Expectation
from ..ops import _cuda
from ..ops.buckets import (
    SLOTS, PlanBuffers, bucket_key, bucket_plan, host_bucket_rehash,
    window_unique,
)
from ..ops.cartography import DEPTH_BINS, action_hist_delta, prop_tally_delta
from ..ops.hashing import EMPTY, EMPTY_U64, SIGN, lshr, row_hash
from ..ops.insert_commit import insert_commit
from ..telemetry.spans import span as tel_span
from ..testing import faults
from ._base import WavefrontChecker
from .prewarm import CompileWatch, build_site
from .wavefront import _pow2, resolve_device

_OK = 0
_FRONTIER_OVERFLOW = 1
_TABLE_OVERFLOW = 2
_BUCKET_OVERFLOW = 3
_CAND_OVERFLOW = 4  # valid candidates exceeded the compaction budget
_POISON = 5  # a compiled-twin transition crossed its compile bound

_STATUS_NAMES = {
    _OK: "ok", _FRONTIER_OVERFLOW: "frontier_full",
    _TABLE_OVERFLOW: "table_full", _BUCKET_OVERFLOW: "bucket_full",
    _CAND_OVERFLOW: "cand_full", _POISON: "poison",
}

# the carry: the ten snapshot buffers, then the live frontier rows over
# every shard (replicated), then the POR pair and the cartography counters
FCOUNT = 10
BASE = 11
_MAX = (1 << 63) - 1  # ``EMPTY ^ SIGN``: the largest unsigned key
# packed stats: [unique, scount, depth, status, more, fcount, disc...],
# then the POR tallies and the cartography counters under their flags
_ST_DISC = 6


def process_group_world() -> int:
    """The ranks of the initialized default process group, or 0 when there
    is none (one controller)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 0


def controllers() -> int:
    """How many controller processes drive the run (JAX
    ``jax.process_count()``): the process group's size, else 1."""
    return max(process_group_world(), 1)


class Exchange:
    """The collectives of one run over ``ndev`` shards: with no process
    group, identities over the stacked shards; under one, ``P`` ranks with
    ``ndev / P`` shards each, ``all_to_all_single`` for the route and
    ``all_reduce`` for the replicated values."""

    def __init__(self, ndev: int):
        import torch.distributed as dist

        self.world = process_group_world()
        self.dist = dist if self.world else None
        ranks = max(self.world, 1)
        if ndev % ranks:
            raise ValueError(f"devices={ndev} does not split over {ranks} "
                             "ranks: each rank holds devices / ranks shards")
        self.ranks = ranks
        self.rank = dist.get_rank() if self.world else 0
        self.nlocal = ndev // ranks
        self.first = self.rank * self.nlocal  # the first local shard's index

    def forward(self, send: torch.Tensor) -> torch.Tensor:
        """The route's exchange: ``send`` is ``[ndev_dst, L_src, bc, C]``
        laid out flat, destination-major; returns the local owners'
        receive buffers ``[L_dst, ndev_src * bc, C]``, source-major."""
        L, C = self.nlocal, send.shape[-1]
        if self.dist is None:
            return send.view(L, -1, C)
        out = torch.empty_like(send)
        self.dist.all_to_all_single(out, send)
        return (out.view(self.ranks, L, L, -1, C).permute(1, 0, 2, 3, 4)
                .reshape(L, -1, C))

    def backward(self, recv: torch.Tensor) -> torch.Tensor:
        """The reverse exchange (the collective is an involution on the
        layout): an owner-side ``[L_dst, ndev_src * bc]`` tensor back to
        each source's send layout, flat."""
        if self.dist is None:
            return recv.reshape(-1)
        L = self.nlocal
        x = (recv.view(L, self.ranks, L, -1).permute(1, 0, 2, 3)
             .contiguous().view(-1))
        out = torch.empty_like(x)
        self.dist.all_to_all_single(out, x)
        return out

    def sum(self, parts: list) -> list:
        """The replicated sums of ``parts`` (int64 tensors)."""
        if self.dist is None:
            return parts
        flat = torch.cat([p.reshape(-1) for p in parts])
        self.dist.all_reduce(flat)
        out, o = [], 0
        for p in parts:
            out.append(flat[o:o + p.numel()].view(p.shape))
            o += p.numel()
        return out

    def min(self, x: torch.Tensor) -> torch.Tensor:
        if self.dist is None:
            return x
        x = x.clone()
        self.dist.all_reduce(x, op=self.dist.ReduceOp.MIN)
        return x

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` (its shards' block), concatenated in shard
        order on every rank."""
        if self.dist is None:
            return x
        parts = [torch.empty_like(x) for _ in range(self.ranks)]
        self.dist.all_gather(parts, x.contiguous())
        return torch.cat(parts)


class _Geometry:
    """The owner-side insert's constants for one receive width ``mr`` and
    candidate budget ``cb`` over ``L`` co-located shards."""

    def __init__(self, L: int, mr: int, cb: int, nb: int, device):
        i64 = dict(dtype=torch.int64, device=device)
        self.mr, self.cb = mr, cb
        self.compact = cb < mr
        self.m = L * cb  # the plan's lanes
        sh = torch.arange(L, **i64)[:, None]
        self.want = torch.arange(1, cb + 1, dtype=torch.int32,
                                 device=device).expand(L, cb).contiguous()
        self.cb_lanes = torch.arange(cb, **i64)
        self.bucket_off = sh * nb
        self.cb_off = sh * cb
        self.mr_off = sh * mr
        self.lanes = torch.arange(self.m, **i64)
        self.ones = torch.ones(self.m, **i64)


class _ShardedEngine:
    """The device program for fixed capacities (JAX ``_build_sharded_run``):
    :meth:`init` builds the initial carry, :meth:`run` advances it by up to
    ``steps`` whole-frontier expansions."""

    def __init__(self, tensor, props, xch: Exchange, ndev: int, cap: int,
                 fcap: int, bucket_cap: int, cand_local: int,
                 target: Optional[int], steps: int, device, sym: bool = False,
                 prededup: bool = False, cartography: bool = False, por=None):
        self.tensor, self.props, self.xch = tensor, props, xch
        self.ndev, self.cap, self.fcap, self.bc = ndev, cap, fcap, bucket_cap
        self.target, self.steps, self.device = target, steps, device
        self.sym, self.prededup, self.cart = sym, prededup, cartography
        self.por = por is not None
        self.key = (cap, fcap, bucket_cap, cand_local)
        L = self.L = xch.nlocal
        self.width, self.arity = tensor.width, tensor.max_actions
        self.m = fcap * self.arity  # candidate lanes a shard sends
        self.S = ndev * L * bucket_cap  # send lanes of this rank
        self.nb = cap // SLOTS
        self.bits = self.nb.bit_length() - 1
        i64 = dict(dtype=torch.int64, device=device)
        # JAX :168-169: the budget is at most the receive width, and the
        # insert compacts only below it
        self.geo = _Geometry(L, ndev * bucket_cap,
                             min(cand_local, ndev * bucket_cap), self.nb,
                             device)
        self.n_props = len(props)
        self.ev_idx = [i for i, p in enumerate(props)
                       if p.expectation is Expectation.EVENTUALLY]
        if len(self.ev_idx) > 32:
            raise ValueError("at most 32 eventually properties are supported")
        self.init_ebits = ((1 << len(self.ev_idx)) - 1) & 0xFFFFFFFF
        if self.init_ebits >= 1 << 31:
            self.init_ebits -= 1 << 32
        kinds = [p.expectation for p in props]
        self.first_cols = torch.tensor(
            [k is not Expectation.EVENTUALLY for k in kinds], dtype=torch.bool,
            device=device)
        self.always_cols = torch.tensor(
            [k is Expectation.ALWAYS for k in kinds], dtype=torch.bool,
            device=device)
        if self.ev_idx:
            self.ev_t = torch.tensor(self.ev_idx, **i64)
            self.ev_bits = torch.tensor([1 << e for e in range(len(
                self.ev_idx))], **i64)
            self.ev_shift = torch.arange(len(self.ev_idx), dtype=torch.int32,
                                         device=device)
        self.boundary_fn = (tensor.boundary_rows
                            if getattr(tensor, "has_boundary", False) else None)
        self.poison_fn = getattr(tensor, "poison_rows", None)
        self.lanes_m = torch.arange(self.m, **i64)
        self.dest_ids = torch.arange(ndev, **i64).expand(L, ndev).contiguous()
        self.src_off = torch.arange(L, **i64)[:, None] * bucket_cap
        self.f_lanes = torch.arange(fcap, **i64)
        self.gshards = xch.first + torch.arange(L, **i64)
        if self.cart:
            self.ones_m = torch.ones((L, self.m), **i64)
        if self.por:
            from ..analysis.footprint import conjunct_eval_fn
            from ..ops.por import PorConstants

            self.por_consts = PorConstants(por, device)
            self.conj_kernel = conjunct_eval_fn(tensor)
            if self.conj_kernel is not None:
                self.conj_kernel.build(L * fcap, device)  # outside any step
        # the plan's buffers and the stream its kernels go to; under POR a
        # second set, whose launch must leave the ample round's plan as it
        # was
        self.plan_out = self.plan_out2 = self.stream = None
        self.no_cov = torch.zeros((), dtype=torch.bool, device=device)
        if self.device.type == "cuda":
            self.plan_out = PlanBuffers(self.geo.m, device, sym)
            self.stream = _cuda.stream_of(self.plan_out.tgt)
            if self.por:
                self.plan_out2 = PlanBuffers(self.geo.m, device, sym)

    # -- properties (JAX :203-231): the smallest hit fingerprint ------------

    def _record_min(self, cur, hit, fps):
        """First-wins discovery per column of ``hit`` ``[R, k]``: the
        smallest hit fingerprint (unsigned) over every shard, where ``cur``
        is still 0 (JAX ``record_first``: ``min`` then ``pmin``)."""
        vals = torch.where(hit, (fps ^ SIGN)[:, None], _MAX).amin(0)
        glob = self.xch.min(vals) ^ SIGN
        return torch.where((cur == 0) & (glob != EMPTY), glob, cur)

    def eval_props(self, masks, fps, live, ebits, disc):
        if not self.props:
            return ebits, disc
        hit = (torch.where(self.always_cols, ~masks, masks) & live[:, None]
               & self.first_cols)
        disc = self._record_min(disc, hit, fps)
        if self.ev_idx:
            held = masks.index_select(1, self.ev_t).to(torch.int64)
            ebits = ebits & ~(held * self.ev_bits).sum(1).to(torch.int32)
        return ebits, disc

    def flush_terminal(self, terminal, fps, ebits, disc):
        if not self.ev_idx:
            return disc
        pending = ((ebits[:, None] >> self.ev_shift) & 1) == 1
        cur = disc.index_select(0, self.ev_t)
        new = self._record_min(cur, pending & terminal[:, None], fps)
        return disc.index_copy(0, self.ev_t, new)

    def all_discovered(self, disc):
        if not self.props:
            return torch.zeros((), dtype=torch.bool, device=self.device)
        return (disc != 0).all()

    # -- the route (JAX :235-275) --------------------------------------------

    def _payload(self, cand, fps, ebits, succ):
        """The lanes the route moves, ``[L * m, W + 3]``: the candidate's
        fingerprint, its parent's fingerprint and ebits, its row."""
        r, a = succ.shape[0], self.arity
        return torch.cat([
            cand.view(r, a, 1), fps.view(r, 1, 1).expand(r, a, 1),
            ebits.to(torch.int64).view(r, 1, 1).expand(r, a, 1), succ,
        ], dim=-1).view(r * a, self.width + 3)

    def route(self, cand, payload):
        """Route each shard's candidates ``cand`` ``[L, m]`` to their owners.
        Returns the owners' receive buffers ``[L, ndev * bc, W + 3]``, each
        lane's send index (the scratch lane ``S`` for a dropped one), the
        local bucket-overflow flag and the route key (owner, or ``ndev``
        for an empty lane)."""
        ndev, L, bc = self.ndev, self.L, self.bc
        key = torch.where(cand != EMPTY, lshr(cand, 32) % ndev, ndev)
        so, order = torch.sort(key, dim=1, stable=True)
        starts = torch.searchsorted(so, self.dest_ids)
        rank = self.lanes_m - starts.gather(1, so.clamp(max=ndev - 1))
        inb = so < ndev
        ok = inb & (rank < bc)
        bovf = (inb & ~ok).any()
        # no drop mode: a dropped lane goes to the scratch row S, cut off
        # before the exchange
        sidx = torch.where(ok, so * (L * bc) + self.src_off + rank, self.S)
        sidx = torch.empty_like(sidx).scatter_(1, order, sidx).view(-1)
        send = torch.full((self.S + 1, self.width + 3), EMPTY,
                          dtype=torch.int64, device=self.device)
        send[sidx] = payload
        return self.xch.forward(send[:self.S]), sidx, bovf, key

    # -- the owner's insert (JAX :276-312) ------------------------------------

    def plan_inputs(self, recv, geo: _Geometry):
        """The shared plan's inputs from the received lanes ``recv``
        ``[L, mr, C]`` of every local shard: each shard's budget compaction
        and key sort, the buckets offset by shard.  Returns ``(sfp, spl,
        bucket, order, cidx)``, flat over the shards, and the per-shard
        budget overflow (None with no compaction)."""
        rfp, rpl = recv[:, :, 0], recv[:, :, 1]
        covf = cidx = None
        if geo.compact:
            vsum = torch.cumsum((rfp != EMPTY).to(torch.int32), 1,
                                dtype=torch.int32)
            nval = vsum[:, -1]
            covf = nval > geo.cb
            cidx = torch.searchsorted(vsum, geo.want).clamp_(max=geo.mr - 1)
            rfp = torch.where(geo.cb_lanes < nval[:, None],
                              rfp.gather(1, cidx), EMPTY)
            rpl = rpl.gather(1, cidx)
            cidx = (cidx + geo.mr_off).view(-1)
        skey, order = torch.sort(bucket_key(rfp) ^ SIGN, dim=1, stable=True)
        sfp = rfp.gather(1, order).view(-1)
        spl = rpl.gather(1, order).view(-1)
        bucket = (lshr(skey ^ SIGN, 64 - self.bits) + geo.bucket_off).view(-1)
        return (sfp, spl, bucket, (order + geo.cb_off).view(-1), cidx), covf

    def insert(self, tfp, recv, geo: _Geometry, plan_out):
        """Plan the insert of the received lanes ``recv`` ``[L, mr, C]`` of
        every local shard in one ``bucket_plan``.  Returns the plan
        ``(tgt, cfp, cpl, sel, n_new, tovf)``, the per-shard budget
        overflow (None with no compaction), each shard's count in the plan
        and its count as the step sees it (0 on a blocked shard), and the
        plan lanes' shard (``L`` past ``n_new``)."""
        L = self.L
        inputs, covf = self.plan_inputs(recv, geo)
        tgt, cfp, cpl, sel, n_new, tovf = bucket_plan(
            tfp, *inputs, self.no_cov, plan_out, generation_order=self.sym,
            check=False, stream=self.stream,
        )
        shard = torch.where(geo.lanes < n_new,
                            torch.div(tgt, self.cap, rounding_mode="floor"), L)
        cnt = torch.zeros(L + 1, dtype=torch.int64, device=self.device)
        cnt = cnt.scatter_add_(0, shard, geo.ones)[:L]
        n_k = cnt if covf is None else torch.where(covf, 0, cnt)
        return (tgt, cfp, cpl, sel, n_new, tovf), covf, cnt, n_k, shard

    def _picked(self, recv, sel, geo, cnt, j):
        """The received lanes behind plan position ``off_k + j`` of each
        shard ``k`` (``j`` ``[L, F]``, clamped in range)."""
        off = (torch.cumsum(cnt, 0) - cnt)[:, None]
        pos = (off + j).clamp_(0, geo.m - 1).view(-1)
        return recv.view(-1, self.width + 3).index_select(
            0, sel.index_select(0, pos))

    def _frontier(self, picked, flive):
        """The next frontier from the picked lanes: rows, fingerprints
        (EMPTY past each shard's count) and ebits."""
        nfps = torch.where(flive, picked[:, 0], EMPTY)
        nebt = torch.where(flive, picked[:, 2], 0).to(torch.int32)
        nrows = torch.where(flive[:, None], picked[:, 3:], 0)
        return nrows, nfps, nebt

    def _undo(self, c, plan, mask) -> None:
        """Write the slots of the plan lanes ``mask`` back to empty (an
        add, so a masked-off lane adds 0; no host read, no table copy)."""
        tgt = plan[0]
        idx = torch.where(mask, tgt, 0)
        fp = c[TFP].index_select(0, idx)
        pl = c[TPL].index_select(0, idx)
        c[TFP].index_add_(0, idx, torch.where(mask, EMPTY - fp, 0))
        c[TPL].index_add_(0, idx, torch.where(mask, -pl, 0))

    # -- the step (JAX ``expand``, :369-569) --------------------------------

    def step(self, c: list) -> list:
        L, F, W = self.L, self.fcap, self.width
        disc0 = c[DISC]
        go = (c[STATUS] == _OK) & (c[FCOUNT] > 0) & ~self.all_discovered(disc0)
        if self.target is not None:
            go &= c[UNIQUE] < self.target
        rows, fps = c[ROWS], c[FPS]
        live = (fps != EMPTY) & go
        masks = self.tensor.property_masks(rows)  # [L*F, P] bool
        ebits, disc = self.eval_props(masks, fps, live, c[EBITS], disc0)
        # mid-block early exit: mask the expansion, never branch
        elive = live & ~self.all_discovered(disc)
        succ, valid = self.tensor.step_rows(rows)  # [L*F, A, W], [L*F, A]
        if self.boundary_fn is not None:
            valid = valid & self.boundary_fn(succ)
        valid = valid & elive[:, None]
        terminal = elive & ~valid.any(dim=-1)
        disc = self.flush_terminal(terminal, fps, ebits, disc)
        # symmetry: route and dedup on the canonical key, the frontier
        # keeps the original rows
        krows = (self.tensor.representative_rows(succ).reshape(L * self.m, -1)
                 .contiguous() if self.sym else succ.reshape(L * self.m, W))
        if self.por:
            return self._step_por(c, go, rows, live, masks, valid, krows,
                                  succ, ebits, disc)
        cand = row_hash(krows, valid.reshape(-1)).view(L, self.m)
        if self.prededup:
            # duplicate lanes drop out of the route and the owner's insert
            cand = window_unique(cand)
        recv, _, bovf, key = self.route(cand, self._payload(cand, fps, ebits,
                                                            succ))
        plan, covf, cnt, n_k, _ = self.insert(c[TFP], recv, self.geo,
                                              self.plan_out)
        picked = self._picked(recv, plan[3], self.geo, cnt, self.f_lanes)
        nrows, nfps, nebt = self._frontier(
            picked, (self.f_lanes < n_k[:, None]).view(-1))
        return self._finish(c, go, live, masks, rows, valid, disc, n_k,
                            (plan[5], bovf, (n_k > F).any(),
                             None if covf is None else covf.any()),
                            [key], (nrows, nfps, nebt),
                            lambda adv: insert_commit(
                                c[TFP], c[TPL], *plan[:3],
                                torch.where(adv, plan[4], 0), check=False,
                                stream=self.stream))

    def _step_por(self, c, go, rows, live, masks, valid, krows, succ, ebits,
                  disc) -> list:
        """The step under POR (JAX :396-491): the ample successors are
        routed and inserted; each owner's per-candidate novelty travels
        back along the route, and every reduced row none of whose ample
        successors was novel has its other successors routed and inserted
        in a second round of the same step.  A step that does not advance
        writes both rounds' slots back to empty."""
        from ..ops.por import ample_mask

        L, F, A, m = self.L, self.fcap, self.arity, self.m
        ps = BASE
        boost = c[ps]
        amp = ample_mask(valid, rows, self.por_consts, self.conj_kernel)
        amp = torch.where(boost > 0, valid, amp)
        all_fp = row_hash(krows, valid.reshape(-1)).view(L, m)
        fps = c[FPS]

        def cands(mask):
            x = torch.where(mask.view(L, m), all_fp, EMPTY)
            return window_unique(x) if self.prededup else x

        cand1 = cands(amp)
        recv1, sidx1, bovf1, key1 = self.route(
            cand1, self._payload(cand1, fps, ebits, succ))
        plan1, covf1, cnt1, n1, shard1 = self.insert(c[TFP], recv1, self.geo,
                                                     self.plan_out)
        insert_commit(c[TFP], c[TPL], *plan1[:3], plan1[4], check=False,
                      stream=self.stream)
        live1 = self.geo.lanes < plan1[4]
        if covf1 is not None:
            # a shard over its budget inserts nothing (JAX: its n_new is
            # 0), so the proviso round must not see its lanes
            blocked = torch.cat([covf1, covf1.new_zeros(1)])[shard1]
            self._undo(c, plan1, blocked)
            live1 = live1 & ~blocked
        # the owner's novelty per received lane, back along the route
        novel = torch.zeros(L * self.geo.mr, dtype=torch.int64,
                            device=self.device)
        novel = novel.index_add_(0, plan1[3], live1.to(torch.int64)) > 0
        back = self.xch.backward(novel.view(L, -1).to(torch.uint8))
        back = torch.cat([back, back.new_zeros(1)]) > 0
        fresh_row = back[sidx1].view(L * F, A).any(dim=1)
        reduced_row = (valid & ~amp).any(dim=1)
        need_full = reduced_row & ~fresh_row
        v2 = valid & ~amp & need_full[:, None]
        cand2 = cands(v2)
        recv2, _, bovf2, key2 = self.route(
            cand2, self._payload(cand2, fps, ebits, succ))
        plan2, covf2, cnt2, n2, _ = self.insert(c[TFP], recv2, self.geo,
                                                self.plan_out2)
        insert_commit(c[TFP], c[TPL], *plan2[:3], plan2[4], check=False,
                      stream=self.stream)
        # the merged frontier: each shard's ample-round rows, then its
        # proviso-round rows
        j = self.f_lanes
        in1 = j < n1[:, None]
        p1 = self._picked(recv1, plan1[3], self.geo, cnt1, j)
        p2 = self._picked(recv2, plan2[3], self.geo, cnt2, j - n1[:, None])
        picked = torch.where(in1.view(-1, 1), p1, p2)
        flive = (j < (n1 + n2)[:, None]).view(-1)
        gen_mask = amp | v2
        gen = gen_mask.sum()
        d_por = torch.stack([(reduced_row & ~need_full).sum(),
                             need_full.sum(), valid.sum() - gen])
        flags = (plan1[5] | plan2[5], bovf1 | bovf2, (n1 + n2 > F).any(),
                 None if covf1 is None else covf1.any() | covf2.any())

        def commit(adv):
            # the rounds wrote in place: a step that does not advance
            # takes its slots back
            self._undo(c, plan1, live1 & ~adv)
            self._undo(c, plan2, (self.geo.lanes < plan2[4]) & ~adv)

        return self._finish(c, go, live, masks, rows, gen_mask, disc,
                            n1 + n2, flags, [key1, key2],
                            self._frontier(picked, flive), commit,
                            gen=gen, d_por=d_por)

    def _finish(self, c, go, live, masks, rows, gen_mask, disc, n_k, flags,
                keys, frontier, commit, gen=None, d_por=None) -> list:
        """The step's replicated counters, its status (JAX :479-529), the
        commit or the take-back, and the carry's advance: an overflowing
        step changes nothing but the status (JAX's rolled-back carry).
        ``flags`` are the local (table, route bucket, frontier, budget)
        overflows, the budget's None with no compaction."""
        ndev, L = self.ndev, self.L
        if gen is None:
            gen = gen_mask.sum()
        parts = [n_k.sum(), gen] + [f.to(torch.int64) for f in flags
                                    if f is not None]
        if self.poison_fn is not None:
            parts.append((self.poison_fn(rows) & live).any().to(torch.int64))
        if self.por:
            parts.append(d_por)
        if self.cart:
            d_evals, d_hits = prop_tally_delta(live, masks, self.n_props)
            route = 0
            for key in keys:
                route = route + torch.zeros(
                    (L, ndev + 1), dtype=torch.int64, device=self.device,
                ).scatter_add_(1, key, self.ones_m)[:, :ndev]
            load = n_k
            if L != ndev:  # this rank's rows of the replicated counters
                pad = (self.xch.first, ndev - self.xch.first - L)
                load = torch.nn.functional.pad(load, pad)
                route = torch.nn.functional.pad(route, (0, 0) + pad)
            parts += [action_hist_delta(gen_mask), d_evals, d_hits, load,
                      route]
        red = self.xch.sum(parts)
        n_new_g, gen_g, tovf, bovf, fovf = red[:5]
        o = 5
        covf = None
        if flags[3] is not None:
            covf, o = red[5], 6
        unique = c[UNIQUE] + n_new_g
        # proactive growth at 25% global load (JAX :495-501)
        toverflow = (tovf > 0) | (unique * 4 > ndev * self.cap)
        st = torch.where(bovf > 0, _BUCKET_OVERFLOW,
                         torch.where(fovf > 0, _FRONTIER_OVERFLOW, _OK))
        if covf is not None:
            st = torch.where(covf > 0, _CAND_OVERFLOW, st)
        st = torch.where(toverflow, _TABLE_OVERFLOW, st)
        if self.poison_fn is not None:
            st = torch.where(red[o] > 0, _POISON, st)
            o += 1
        adv = go & (st == _OK)
        commit(adv)
        nrows, nfps, nebt = frontier
        c[ROWS] = torch.where(adv, nrows, c[ROWS])
        c[FPS] = torch.where(adv, nfps, c[FPS])
        c[EBITS] = torch.where(adv, nebt, c[EBITS])
        c[UNIQUE] = torch.where(adv, unique, c[UNIQUE])
        c[SCOUNT] = torch.where(adv, c[SCOUNT] + gen_g, c[SCOUNT])
        c[DISC] = torch.where(adv, disc, c[DISC])
        c[DEPTH] = torch.where(adv & (n_new_g > 0), c[DEPTH] + 1, c[DEPTH])
        c[FCOUNT] = torch.where(adv, n_new_g, c[FCOUNT])
        c[STATUS] = torch.where(go, st, c[STATUS])
        t = BASE
        if self.por:
            c[t] = torch.where(adv, 0, c[t])  # a committed step consumes it
            c[t + 1] = c[t + 1] + torch.where(adv, red[o], 0)
            t, o = t + 2, o + 1
        if self.cart:
            dh = c[t].index_add(
                0, c[DEPTH].clamp(max=DEPTH_BINS - 1).reshape(1),
                torch.where(adv, n_new_g, 0).reshape(1))
            c[t] = dh
            for i in range(5):
                c[t + 1 + i] = c[t + 1 + i] + torch.where(adv, red[o + i], 0)
        return c

    # -- programs --------------------------------------------------------------

    def more(self, c):
        """JAX ``keep_going``: status OK, a live frontier, a property
        undiscovered and the target not reached."""
        go = (c[STATUS] == _OK) & (c[FCOUNT] > 0) & ~self.all_discovered(c[DISC])
        if self.target is not None:
            go &= c[UNIQUE] < self.target
        return go

    def stats(self, c, more=None) -> torch.Tensor:
        """Every value the host loop reads, packed in one int64 tensor."""
        if more is None:
            more = self.more(c)
        head = torch.stack([c[UNIQUE], c[SCOUNT], c[DEPTH], c[STATUS],
                            more.to(torch.int64), c[FCOUNT]])
        return torch.cat([head, c[DISC]] + [t.reshape(-1) for t in c[BASE:]
                                            if t.dim()])

    def run(self, carry: list):
        """Up to ``steps`` steps (no-ops once the run must stop); returns
        ``(carry, stats)``."""
        carry = list(carry)
        for _ in range(self.steps):
            carry = self.step(carry)
        return carry, self.stats(carry)

    def init(self):
        """JAX ``device_init`` (:313-351): each shard claims the init
        states it owns."""
        dev, L, F, W = self.device, self.L, self.fcap, self.width
        i64 = dict(dtype=torch.int64, device=dev)
        init_np = np.asarray(self.tensor.init_rows(), np.uint64)
        n_init = init_np.shape[0]
        irows = torch.from_numpy(init_np.view(np.int64).copy()).to(dev)
        ifp = row_hash(self.tensor.representative_rows(irows).contiguous()
                       if self.sym else irows)
        mine = (lshr(ifp, 32) % self.ndev)[None, :] == self.gshards[:, None]
        cand = torch.where(mine, ifp[None, :], EMPTY)
        recv = torch.cat([
            cand[:, :, None], torch.zeros((L, n_init, 1), **i64),
            torch.full((L, n_init, 1), self.init_ebits, **i64),
            irows[None].expand(L, n_init, W),
        ], dim=-1)
        geo = _Geometry(L, n_init, n_init, self.nb, dev)
        plan_out = (PlanBuffers(geo.m, dev, self.sym)
                    if dev.type == "cuda" else None)
        tfp = torch.full((L * self.cap,), EMPTY, **i64)
        tpl = torch.zeros((L * self.cap,), **i64)
        plan, _, cnt, n_k, _ = self.insert(tfp, recv, geo, plan_out)
        insert_commit(tfp, tpl, *plan[:3], plan[4], stream=self.stream)
        rows, fps, ebits = self._frontier(
            self._picked(recv, plan[3], geo, cnt, self.f_lanes),
            (self.f_lanes < n_k[:, None]).view(-1))
        parts = [n_k.sum(), plan[5].to(torch.int64),
                 (n_k > F).any().to(torch.int64)]
        if self.cart:
            load = n_k
            if L != self.ndev:
                load = torch.nn.functional.pad(
                    load, (self.xch.first, self.ndev - self.xch.first - L))
            parts.append(load)
        red = self.xch.sum(parts)
        unique = red[0]
        status = torch.where(red[1] > 0, _TABLE_OVERFLOW,
                             torch.where(red[2] > 0, _FRONTIER_OVERFLOW, _OK))
        zero = torch.zeros((), **i64)
        carry = [tfp, tpl, rows, fps, ebits, unique,
                 torch.tensor(n_init, **i64),  # state_count counts all inits
                 torch.zeros((max(self.n_props, 1),), **i64), zero,
                 status, unique.clone()]
        if self.por:
            # the init wavefront is not a growth or resume boundary
            carry += [torch.zeros((), dtype=torch.int32, device=dev),
                      torch.zeros((3,), **i64)]
        if self.cart:
            carry += cart_zero(self.arity, self.n_props, self.ndev, dev)
            carry[-6][0] = unique
            carry[-2] = red[3]
        return carry, self.stats(carry)


def cart_zero(arity: int, n_props: int, ndev: int, device) -> list:
    """Fresh cartography counters (JAX ``cart_init``, :189-201): the depth,
    action and property tallies, the per-shard load and the route
    matrix, all replicated."""
    p = max(n_props, 1)
    shapes = ((DEPTH_BINS,), (max(arity, 1),), (p,), (p,), (ndev,),
              (ndev, ndev))
    return [torch.zeros(s, dtype=torch.int64, device=device) for s in shapes]


class ShardedGpuChecker(WavefrontChecker):
    """Wavefront BFS over ``n_devices`` shards (JAX ``ShardedTpuChecker``):
    the same result surface and work-preserving growth as
    :class:`~.wavefront.GpuChecker`, with ``checkpoint()`` and
    ``spawn_gpu(devices=N, resume=snapshot)`` at the same ``N``.

    ``capacity`` and ``frontier_capacity`` are global and split into
    per-shard sizes (``cap_local`` a power of two); ``bucket_factor`` sizes
    the route's send buffers (``bucket_cap = max(64, fcap_local * arity *
    bucket_factor // N)``), ``cand_factor`` the owner's candidate budget
    (``cand_factor * fcap_local``); all four double on demand.
    ``device=None`` means ``cuda`` and raises without a card; under an
    initialized process group each rank holds ``N / ranks`` shards on its
    own ``device``."""

    _engine_tag = "sharded"  # the snapshot's engine word, as JAX writes it
    _telemetry_tag = _report_engine = "sharded"

    def __init__(self, options, n_devices: Optional[int] = None,
                 capacity: int = 1 << 17, frontier_capacity: int = 1 << 13,
                 bucket_factor: int = 2, cand_factor: int = 4,
                 sync: bool = False, steps_per_call: int = 16, device=None,
                 resume: Optional[dict] = None):
        if getattr(options, "checked_mode", False):
            raise NotImplementedError(
                "checked mode (CheckerBuilder.checked()) is single-device "
                "only for now: run spawn_gpu() without devices to "
                "reproduce with the sanitizer's guard"
            )
        if options.timeout_secs is not None:
            # timers fire per process at slightly different instants: one
            # controller would break the lockstep collectives
            self._require_single_controller("timeout()")
        self.device = resolve_device(device)
        self.ndev = int(n_devices or controllers())
        self._xch = Exchange(self.ndev)
        self._resume = resume
        self._cap_local = max(64, _pow2(capacity // self.ndev))
        self._fcap_local = max(16, frontier_capacity // self.ndev)
        self._bucket_factor = bucket_factor
        self._cand_factor = cand_factor
        self._steps = steps_per_call
        self.growth_events: list = []
        self.steps_run = 0
        self._final_state = None
        self._engine_cache: Optional[_ShardedEngine] = None
        self._init_common(options, sync)

    # -- multi-controller fences (JAX :879-904) --------------------------------

    @staticmethod
    def _require_single_controller(what: str) -> None:
        """Checkpoint, stop, resume and timeout are single-controller: the
        sharded carry is not addressable across processes, and per-process
        control events would desynchronize the ranks' collectives.
        (Growth is not fenced: its trigger is a replicated status.)"""
        if controllers() > 1:
            raise NotImplementedError(
                f"{what} is single-controller only: the sharded carry is "
                "not addressable across hosts and per-process control "
                "events would desynchronize the controllers' collectives. "
                "Pre-size capacity/frontier_capacity and let multi-host "
                "runs complete."
            )

    def checkpoint(self, timeout=60.0) -> dict:
        self._require_single_controller("checkpoint()")
        return super().checkpoint(timeout=timeout)

    def stop(self):
        self._require_single_controller("stop()")
        return super().stop()

    def _pre_run_validate(self) -> None:
        if self._resume is not None:
            self._require_single_controller("resume=")
            self._check_snapshot_sig(self._resume)
            if int(self._resume["ndev"]) != self.ndev:
                raise ValueError(
                    f"snapshot was taken on a {self._resume['ndev']}-device "
                    f"mesh; this mesh has {self.ndev} (table shards are "
                    "partitioned by fingerprint ownership)"
                )

    # -- accounting hooks -------------------------------------------------------

    def _memory_spec_fn(self):
        """The analytic buffers of the global carry at ``caps``
        (``telemetry/memory.sharded_specs``); ``cap`` is the global slot
        count, which a table growth doubles."""
        from ..telemetry.memory import sharded_specs

        width, arity = self.tensor.width, self.tensor.max_actions
        n_props, ndev = len(self._props), self.ndev
        cart, por, fcap0 = self._cartography, self._por, self._fcap_local

        def spec_fn(caps):
            return sharded_specs(width, arity, n_props, ndev,
                                 max(int(caps["cap"]) // ndev, 1),
                                 int(caps.get("fcap_local", fcap0)),
                                 cartography=cart, por=por)

        return spec_fn

    def _memory_caps(self) -> dict:
        return {"cap": self._cap_local * self.ndev,
                "fcap_local": self._fcap_local}

    def _roofline_cost_fn(self):
        from ..analysis.costmodel import sharded_costs

        tensor, cap, fcap, ndev = (self.tensor, self._cap_local,
                                   self._fcap_local, self.ndev)
        sym, cf = self._symmetry is not None, self._cand_factor

        def cost_fn():
            return sharded_costs(tensor, cap, fcap, ndev, sym=sym,
                                 cand_local=max(64, cf * fcap))

        return cost_fn

    # -- the host loop (JAX :1090-1474) -----------------------------------------

    def _engine_for(self, cap, fcap, bf, cf) -> _ShardedEngine:
        arity = self.tensor.max_actions
        bucket_cap = max(64, (fcap * arity * bf) // self.ndev)
        cand_local = max(64, cf * fcap)
        eng = self._engine_cache
        if eng is None or eng.key != (cap, fcap, bucket_cap, cand_local):
            # one compile event per acquisition (JAX sharded.py:1198-1224,
            # :1356); on cuda the build loads the kernel library, so the
            # first rung carries its build or load
            first = eng is None
            watch = CompileWatch()
            t0 = time.perf_counter()
            with build_site():
                if self.device.type == "cuda":
                    _cuda.library()
                eng = self._engine_cache = _ShardedEngine(
                    self.tensor, self._props, self._xch, self.ndev, cap,
                    fcap, bucket_cap, cand_local, self._target, self._steps,
                    self.device, sym=self._symmetry is not None,
                    prededup=self._prededup, cartography=self._cartography,
                    por=self._por_plan if self._por else None)
            secs = round(time.perf_counter() - t0, 6)
            hit = watch.delta()["persistent_hits"] > 0
            self._stage("compile", secs)
            rec = self.flight_recorder
            if rec is not None:
                rec.add("compile_cache_misses")
                rec.record("compile", cap=cap * self.ndev, fcap=fcap,
                           bucket_cap=bucket_cap, cand=cand_local,
                           rung="init" if first else "growth",
                           source="persistent" if hit else "fresh",
                           cache_hit=hit, prewarm_ready=False,
                           duration=secs, build_secs=secs)
        return eng

    def _tail_from_snapshot(self, snap: dict) -> list:
        """The carry's tail for a resumed run: the live frontier count,
        the POR pair (boost 1: a resume is a boundary; the snapshot's
        tallies) and the snapshot's cartography counters (zeros for a
        snapshot taken without them)."""
        dev = self.device
        i64 = dict(dtype=torch.int64, device=dev)
        fps = np.asarray(snap["fps"]).view(np.uint64)
        tail = [torch.tensor(int((fps != EMPTY_U64).sum()), **i64)]
        if self._por:
            stats = np.asarray(snap.get("por_stats", np.zeros(3, np.int64)),
                               np.int64).reshape(3)
            tail += [torch.ones((), dtype=torch.int32, device=dev),
                     torch.from_numpy(stats.copy()).to(dev)]
        if self._cartography:
            zeros = cart_zero(self.tensor.max_actions, len(self._props),
                              self.ndev, dev)
            tail += [torch.from_numpy(np.asarray(snap[f"cart{i}"])
                                      .astype(np.int64).reshape(z.shape)
                                      .copy()).to(dev)
                     if f"cart{i}" in snap else z
                     for i, z in enumerate(zeros)]
        return tail

    def _grow(self, carry, cap, fcap, bf, cf, status):
        """Work-preserving growth of the local shards, on the host (JAX
        ``_grow_carry``/``_grow_carry_lockstep``): a table overflow rehashes
        each shard's table on its own (ownership does not depend on the
        capacity), a frontier overflow pads each shard's frontier at its
        tail, the route bucket and the candidate budget are engine
        parameters.  Returns ``(cap, fcap, bf, cf, carry)``, status OK."""
        L, dev = self._xch.nlocal, self.device
        new = list(carry)
        if status == _TABLE_OVERFLOW:
            cap2 = cap * 2
            tfp = carry[TFP].cpu().numpy().view(np.uint64).reshape(L, cap)
            tpl = carry[TPL].cpu().numpy().view(np.uint64).reshape(L, cap)
            parts = [host_bucket_rehash(tfp[k], tpl[k], cap2 // SLOTS)
                     for k in range(L)]
            new[TFP] = convert.signed_tensor(
                np.concatenate([p[0] for p in parts]), dev)
            new[TPL] = convert.signed_tensor(
                np.concatenate([p[1] for p in parts]), dev)
            cap = cap2
        elif status == _FRONTIER_OVERFLOW:
            grow = fcap
            for k, fill in ((ROWS, 0), (FPS, EMPTY), (EBITS, 0)):
                blk = carry[k].view(L, fcap, *carry[k].shape[1:])
                pad = torch.full((L, grow) + tuple(carry[k].shape[1:]), fill,
                                 dtype=blk.dtype, device=dev)
                new[k] = torch.cat([blk, pad], 1).reshape(
                    (L * 2 * fcap,) + tuple(carry[k].shape[1:]))
            fcap *= 2
        elif status == _BUCKET_OVERFLOW:
            bf *= 2
        elif status == _CAND_OVERFLOW:
            cf *= 2
        new[STATUS] = torch.zeros((), dtype=torch.int64, device=dev)
        return cap, fcap, bf, cf, new

    def _host_table(self, t: torch.Tensor) -> np.ndarray:
        """The whole table (every shard's) as host ``uint64``: under a
        process group every rank gathers the others' shards, so each
        rebuilds the same discovery paths."""
        return self._xch.gather(t).cpu().numpy().view(np.uint64).copy()

    def _run(self) -> None:
        if self._resume is not None:
            # the snapshot's capacities: its carry's shapes
            self._cap_local = int(self._resume["cap_local"])
            self._fcap_local = int(self._resume["fcap_local"])
            self._bucket_factor = int(self._resume["bucket_factor"])
            self._cand_factor = int(self._resume.get("cand_factor", 4))
        cap, fcap = self._cap_local, self._fcap_local
        bf, cf = self._bucket_factor, self._cand_factor
        ndev, dev = self.ndev, self.device
        rec = self.flight_recorder
        occ_every = int(self._telemetry_opts.get("occupancy_every") or 0)
        syncs = hs = 0
        single_controller = controllers() == 1
        if not single_controller and self._autosave is not None:
            import sys

            print("stateright-tpu-torch: autosave is single-controller only "
                  "on the sharded engine (the sharded carry is not "
                  "addressable across hosts); DISARMED for this run: no "
                  "checkpoints will be written.", file=sys.stderr)
            self._autosave = None
            self._refresh_durability()
        if rec is not None:
            rec.update_meta(devices=ndev, steps_per_call=self._steps)
        pending = finished = None
        if self._resume is not None:
            snap = self._resume
            carry0 = convert.sharded_carry_from_arrays(
                [snap[k] for k in convert.SHARDED_SNAPSHOT_KEYS], dev)
            carry0 += self._tail_from_snapshot(snap)
            st = int(carry0[STATUS])
            if st != _OK:
                # taken at a growth boundary: grow first, then run
                cap, fcap, bf, cf, pending = self._grow(carry0, cap, fcap,
                                                        bf, cf, st)
                if self._por:
                    pending[BASE] = torch.ones((), dtype=torch.int32,
                                               device=dev)
            elif int(snap["more"]):
                pending = carry0
            else:
                finished = carry0
        t_dev = time.perf_counter()
        while True:  # one pass per engine (growth rebuilds)
            eng = self._engine_for(cap, fcap, bf, cf)
            t_dev = time.perf_counter()  # the build is the compile stage's
            cand_local = max(64, cf * fcap)
            from_init = False
            if finished is not None:
                carry = finished
                stats = eng.stats(carry, more=torch.zeros((), dtype=torch.bool,
                                                          device=dev))
            elif pending is not None:
                carry, stats = eng.run(pending)
                self.steps_run += eng.steps
                pending = None
            else:
                carry, stats = eng.init()
                from_init = True
            while True:
                st = stats.cpu().numpy()  # the block's one host read
                self._stage("device", time.perf_counter() - t_dev)
                unique, scount, depth, status, more, _ = (
                    int(x) for x in st[:_ST_DISC])
                p = max(len(self._props), 1)
                disc = st[_ST_DISC:_ST_DISC + p].view(np.uint64)
                rest = st[_ST_DISC + p:]
                with self._live_lock:
                    self._live = (scount, unique, depth)
                    self._live_disc = disc.copy()
                if self._por:
                    self._live_por = self._por_stats_dict(rest[:3])
                    rest = rest[3:]
                if self._cartography:
                    self._sync_cartography(rest, states=scount, unique=unique)
                if rec is not None:
                    syncs += 1
                    rec.add_bytes(d2h=st.nbytes)
                    rec.step(engine=self._telemetry_tag, states=scount,
                             unique=unique, depth=depth, status=status,
                             cap=cap * ndev, cand=cand_local * ndev,
                             load_factor=round(unique / (cap * ndev), 6),
                             busy=bool(more))
                    if occ_every and syncs % occ_every == 0:
                        self._telemetry_occupancy(
                            self._host_table(carry[TFP]), at=f"sync{syncs}",
                            transferred=True)
                    if self._mem_ledger is not None:
                        self._mem_ledger.observe(
                            {"cap": cap * ndev, "fcap_local": fcap},
                            extra={"frontier_capacity": fcap * ndev})
                faults.fire("host_sync", recorder=rec, step=hs, unique=unique)
                hs += 1

                def snap_fn(carry=carry, more=more, caps=(cap, fcap, bf, cf)):
                    return self._carry_to_snapshot(carry, more, *caps)

                if single_controller:
                    self._at_host_sync(snap_fn)
                if status != _OK or not more or self._stop.is_set():
                    break
                if self._profiler is not None:
                    self._profiler.maybe_start()
                t_dev = time.perf_counter()
                carry, stats = eng.run(carry)
                self.steps_run += eng.steps
                from_init = False
                if self._profiler is not None:
                    self._profiler.tick()
            if status == _POISON:
                raise RuntimeError(
                    "poisoned rows reached by the device run: a compiled "
                    "transition crossed its compile-time state_bound/"
                    "env_bound, so counts would be silently wrong. Loosen "
                    "the bounds (they must cover everything the bounded "
                    "configuration actually reaches)."
                )
            if status != _OK and not self._stop.is_set():
                faults.fire("growth", recorder=rec, status=status,
                            unique=unique)
                if rec is not None:
                    rec.record("growth",
                               status=_STATUS_NAMES.get(status, str(status)),
                               unique=unique, cap=cap * ndev,
                               from_init=from_init)
                    if status == _CAND_OVERFLOW:
                        rec.add("compaction_hits")
                    if self._cartography and self._live_cart:
                        rec.record("cartography", at="growth",
                                   **self._live_cart)
                if from_init:
                    # nothing ran yet: re-init at the grown capacity
                    if status == _TABLE_OVERFLOW:
                        cap *= 2
                    elif status == _FRONTIER_OVERFLOW:
                        fcap *= 2
                    elif status == _CAND_OVERFLOW:
                        cf *= 2
                    else:
                        bf *= 2
                else:
                    self.growth_events.append((status, unique))
                    t_grow = time.monotonic()
                    with tel_span("resharding", rec,
                                  parent=self._run_span_ctx, cap=int(cap),
                                  unique=int(unique)):
                        cap, fcap, bf, cf, pending = self._grow(
                            carry, cap, fcap, bf, cf, status)
                    if self._por:
                        # a growth is a boundary: one fully expanded step
                        pending[BASE] = torch.ones((), dtype=torch.int32,
                                                   device=dev)
                    self._stage("growth", time.monotonic() - t_grow)
                t_dev = time.perf_counter()
                continue
            break
        self._cap_local, self._fcap_local = cap, fcap
        self._bucket_factor, self._cand_factor = bf, cf
        if self._profiler is not None:
            self._profiler.stop()
        self._results = {
            "unique": unique, "states": scount, "disc": disc.copy(),
            "depth": depth, "table_fp": self._host_table(carry[TFP]),
            "table_parent": self._host_table(carry[TPL]),
        }
        if self._por and self._live_por is not None:
            self._results["por"] = dict(self._live_por)
        if self._cartography and self._live_cart:
            self._results["cartography"] = self._live_cart
            if rec is not None:
                rec.record("cartography", at="final", **self._live_cart)
        if rec is not None:
            rec.add_bytes(d2h=self._results["table_fp"].nbytes
                          + self._results["table_parent"].nbytes)
            self._telemetry_occupancy(self._results["table_fp"], at="final")
        if self._mem_ledger is not None:
            self._mem_ledger.finalize()
        if rec is not None:
            rec.close_run(done=not self._timed_out)
        self._final_state = (carry, more, (cap, fcap, bf, cf))

    def _sync_cartography(self, tail, *, states: int, unique: int) -> None:
        """The cartography section of the packed stats as the live
        snapshot: the tallies, the per-shard load and the route matrix."""
        from ..ops.cartography import snapshot

        arity, p = max(self.tensor.max_actions, 1), max(len(self._props), 1)
        n = self.ndev
        cuts = np.cumsum([DEPTH_BINS, arity, p, p, n])
        dh, ah, pe, ph, load, route = np.split(np.asarray(tail), cuts)
        snap = snapshot(
            depth_hist=dh, action_hist=ah, prop_evals=pe, prop_hits=ph,
            prop_names=[pr.name for pr in self._props], states=states,
            unique=unique, shard_load=load, route_matrix=route.reshape(n, n),
            por=self._live_por if self._por else None,
        )
        self._live_cart = snap
        if self.flight_recorder is not None:
            self.flight_recorder.set_cartography(snap)

    # -- snapshots (JAX :906-949) -------------------------------------------------

    def _carry_to_snapshot(self, carry, more, cap, fcap, bf, cf) -> dict:
        snap = dict(zip(convert.SHARDED_SNAPSHOT_KEYS,
                        convert.sharded_carry_to_arrays(carry)))
        tail = carry[BASE:]
        if self._por:
            # the boost word is not kept: a resume always re-arms it
            snap["por_stats"] = tail[1].cpu().numpy().copy()
            tail = tail[2:]
        for i, t in enumerate(tail):
            snap[f"cart{i}"] = t.cpu().numpy().copy()
        snap["more"] = int(more)
        snap["ndev"] = self.ndev
        snap["cap_local"] = cap
        snap["fcap_local"] = fcap
        snap["bucket_factor"] = bf
        snap["cand_factor"] = cf
        snap["engine"] = self._engine_tag
        snap["model_sig"] = self._model_sig()
        snap["run_id"] = self.run_id
        fb = self._analytic_footprint_bytes({"cap": cap * self.ndev,
                                             "fcap_local": fcap})
        if fb is not None:
            snap["footprint_bytes"] = np.int64(fb)
        return snap

    def final_snapshot(self) -> dict:
        """The finished run's carry as a snapshot (JAX ``_final_snapshot``)."""
        self.join()
        carry, more, caps = self._final_state
        return self._carry_to_snapshot(carry, more, *caps)

    def _table_np(self):
        return self._results["table_fp"], self._results["table_parent"]
