"""Roofline cost ledger: FLOPs and bytes per engine stage, per operation.

The port's copy of ``stateright_tpu/analysis/costmodel.py``: where the
time of a wavefront step should go, so a roofline share per stage can be
read against the card's ceilings (``telemetry/roofline.py``).  A step
has the five JAX stages (JAX ``_stage_fns`` :840-978), with their names:

 - ``property`` and ``expand`` -- walks of the twin's captured
   ``property_masks`` and ``step_rows`` (+ ``boundary_rows``) graphs
   (``analysis/graph.py``: the capture the preflight and ``.por()``
   share, at batch 4), one rule per aten operation, charged per row and
   scaled to the step's batch (every charged node is per row: constants
   are not charged, as JAX's literals and constvars are not);
 - ``hash`` -- ``cand_prep`` (the fused hash, valid mask, budget
   compaction and bucket key);
 - ``dedup-insert`` -- the step's ``torch.sort`` of the keys (charged as
   a sort: ``n log2 n`` operations and its bytes), ``bucket_plan``'s
   fused entry (which reads the sorted lanes through the permutation, so
   the step has no gathers after the sort), and the table half of
   ``insert_commit``;
 - ``queue`` -- the pop of the batch and the queue half of
   ``insert_commit``.

The three engine stages are charged from :func:`kernel_cost`, one count
per hand-written kernel, the count documented beside each kernel's
source and the one ``chip_smoke.py``'s bound reads; so a stage's roofline
counts the work, not whatever implements it.  A static ledger prices the
step's static shapes, as JAX's does: every lane valid and novel.

A node's charge (JAX ``_charge_eqn``): one FLOP per output element for an
elementwise operation, ``n log2 k`` for a sort of ``n`` elements along
axes of ``k`` (JAX charges ``n log2 n``; the port's sorts are batched
along an axis), the whole read for a reduction, ``2·M·N·K`` for a
product, none for layout; bytes read and written, with the *moved window*
for an indexed read or write (a gather reads the gathered elements and its
index, an indexed write moves its update both ways), and nothing for
``functionalize``'s ``copy_`` back into an input (the in-place update).

**Reconciliation.**  JAX compares each stage with XLA's
``cost_analysis()``, which the port has no counterpart of.  Instead the
block lists, per stage, each kernel's count beside the walk of its plain
version (``cand_prep_plain``, the sort, ``bucket_plan_plain``,
``insert_commit_plain``), captured on the CPU at a small shape.  The
pinned contract: the walk of a plain version is never below the kernel's
bytes (the plain version writes every intermediate the kernel keeps in
registers), and at most :data:`BYTES_HI` times them, the band stated from
the CPU runs over the shipped twins (``tests/test_torch_costmodel.py``).

Tensor-core candidates (``JX400``-``JX402``, JAX :616-760): indexed reads
and writes and sorts moving at least :data:`MXU_MIN_BYTES` a step, ranked
by charged bytes.  The port's ``.mxu()`` has no effect, so no recast has
landed and no finding names an escape hatch: the findings are JAX's with
the flag off.

Everything here is host-side analysis: with the roofline on or off a step
dispatches the same operations (pinned by test and by ``chip_smoke.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .graph import Graph, fill_value, graph_of, op_name, shape_of
from .report import AuditFinding, Severity

# cost-model schema version (the ``roofline`` record and block ``v``)
COSTMODEL_V = 1

# the reconciliation band: the walk of a plain version over the kernel's
# count, in bytes, at plain_walks' shape (batch 4, 256 slots).  Measured
# on the CPU over the eight twin-bearing configurations of the models'
# _audit_models (tests/test_torch_costmodel.py recomputes them):
# cand_prep 23.3-51.0 (row_hash_plain writes every word's intermediate),
# the sort 1.0, bucket_plan 14.0-16.7, insert_commit 4.8-6.7.  The upper
# band leaves 2.5x room above the largest.
BYTES_LO = 1.0
BYTES_HI = 128.0

# tensor-core candidate threshold: sites below this many bytes a step are
# not worth a matmul recast
MXU_MIN_BYTES = 4096
_MXU_TOP = 8

OP_CLASSES = ("gather", "scatter", "sort", "dot", "elementwise",
              "reduce", "control")

_LAYOUT = frozenset({
    "view", "reshape", "_unsafe_view", "expand", "squeeze", "unsqueeze",
    "permute", "transpose", "t", "clone", "alias", "detach",
    "lift_fresh_copy", "contiguous", "_to_copy", "to", "select", "slice",
    "cat", "stack", "arange", "flip", "roll", "repeat", "constant_pad_nd",
    "copy", "eye", "full", "full_like", "new_full", "zeros", "zeros_like",
    "new_zeros", "ones", "ones_like", "new_ones", "empty", "empty_like",
    "new_empty", "scalar_tensor",
})
_GATHER = frozenset({"index", "index_select", "gather", "take",
                     "take_along_dim"})
_SCATTER = frozenset({
    "index_put", "_index_put_impl", "scatter", "scatter_add",
    "scatter_reduce", "index_add", "index_copy", "index_fill",
    "select_scatter", "slice_scatter", "masked_scatter",
})
_SORT = frozenset({"sort", "argsort", "topk", "msort"})
_DOT = frozenset({"mm", "bmm", "matmul", "addmm", "baddbmm", "dot",
                  "convolution", "_convolution"})
_REDUCE = frozenset({
    "sum", "any", "all", "amax", "amin", "max", "min", "prod", "mean",
    "argmax", "argmin", "cumsum", "cumprod", "cummax", "cummin",
    "logsumexp",
})
_CONTROL = frozenset({"cond", "while_loop", "scan", "map"})


def classify_op(name: str) -> str:
    """Op class of one aten operation (``OP_CLASSES``; JAX
    ``classify_primitive``)."""
    name = name[:-1] if name.endswith("_") and not name.startswith("_") \
        else name
    if name in _GATHER:
        return "gather"
    if name in _SCATTER:
        return "scatter"
    if name in _SORT:
        return "sort"
    if name in _DOT:
        return "dot"
    if name in _REDUCE:
        return "reduce"
    if name in _CONTROL:
        return "control"
    return "elementwise"


def _outs(n) -> list:
    val = n.meta.get("val")
    if isinstance(val, (tuple, list)):
        return [v for v in val if isinstance(v, torch.Tensor)]
    return [val] if isinstance(val, torch.Tensor) else []


def _t_elems(t) -> int:
    return int(np.prod(tuple(t.shape))) if t.dim() else 1


def _t_bytes(t) -> int:
    return _t_elems(t) * t.element_size()


def _node_val(x):
    v = x.meta.get("val") if isinstance(x, torch.fx.Node) else None
    return v if isinstance(v, torch.Tensor) else None


def _arg_nodes(args) -> list:
    out = []
    for a in args:
        if isinstance(a, torch.fx.Node):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(x for x in a if isinstance(x, torch.fx.Node))
    return out


def _bytes_of(x) -> int:
    if isinstance(x, (list, tuple)):
        return sum(_bytes_of(a) for a in x)
    v = _node_val(x)
    return _t_bytes(v) if v is not None else 0


def _elems_of(x) -> int:
    v = _node_val(x)
    return _t_elems(v) if v is not None else 0


def _itemsize(x) -> int:
    v = _node_val(x)
    return v.element_size() if v is not None else 8


@dataclass
class EqnCost:
    """Charged cost of one operation (or one aggregated site; JAX
    ``EqnCost``)."""

    prim: str
    op_class: str
    flops: int
    bytes_read: int
    bytes_written: int
    count: int = 1
    #: shape of the MOVED data (the roofline-relevant window)
    shape: tuple = ()
    #: shape of the indexed operand (gather/scatter only)
    operand_shape: tuple = ()

    @property
    def bytes_total(self) -> int:
        return self.bytes_read + self.bytes_written


# indexed operations: (position of the operand updated, of the update,
# of the index operands); None = none there
_SCATTER_ARGS = {
    "index_put": (2, 1), "_index_put_impl": (2, 1),
    "scatter": (3, 2), "scatter_add": (3, 2), "scatter_reduce": (3, 2),
    "index_add": (3, 2), "index_copy": (3, 2), "index_fill": (None, 2),
    "select_scatter": (1, None), "slice_scatter": (1, None),
    "masked_scatter": (2, 1),
}
_GATHER_IDX = {"index": 1, "index_select": 2, "gather": 2, "take": 1,
               "take_along_dim": 1}


def charge_node(n) -> Optional[EqnCost]:
    """FLOPs and bytes of one operation (module docstring), or None for a
    node that costs nothing (a tuple pick, a constant, a scalar fill, the
    ``copy_`` of a functionalized in-place update)."""
    if n.op != "call_function":
        return None
    name = op_name(n)
    if name == "getitem":
        return None
    if name in ("copy_",) and isinstance(n.args[0], torch.fx.Node) \
            and n.args[0].op == "placeholder":
        return None  # functionalize's write-back: the update in place
    outs = _outs(n)
    if fill_value(n) is not None and sum(_t_elems(t) for t in outs) <= 1:
        return None  # a scalar literal
    cls = classify_op(name)
    out_elems = max((_t_elems(t) for t in outs), default=0)
    out_bytes = sum(_t_bytes(t) for t in outs)
    in_bytes = sum(_bytes_of(a) for a in _arg_nodes(n.args))
    shape = tuple(outs[0].shape) if outs else ()
    operand_shape: tuple = ()
    flops = 0
    if cls == "gather":
        operand_shape = shape_of(n.args[0])
        pos = _GATHER_IDX.get(name, 1)
        idx = n.args[pos] if len(n.args) > pos else None
        in_bytes = out_elems * _itemsize(n.args[0]) + _bytes_of(idx)
    elif cls == "scatter":
        operand_shape = shape_of(n.args[0])
        upd_pos, idx_pos = _SCATTER_ARGS.get(name, (None, None))
        upd = n.args[upd_pos] if upd_pos is not None and len(
            n.args) > upd_pos else None
        idx = n.args[idx_pos] if idx_pos is not None and len(
            n.args) > idx_pos else None
        idx_bytes = _bytes_of(idx)
        if isinstance(upd, torch.fx.Node):
            upd_bytes = _bytes_of(upd)
            shape = shape_of(upd)
        else:  # a scalar update: one element per index
            k = sum(_elems_of(i) for i in (
                idx if isinstance(idx, (list, tuple)) else [idx])
                if isinstance(i, torch.fx.Node))
            upd_bytes = max(k, 1) * _itemsize(n.args[0])
            shape = (k,)
        in_bytes = upd_bytes + idx_bytes + upd_bytes
        out_bytes = upd_bytes
    elif cls == "sort":
        x = n.args[0]
        total = _elems_of(x)
        dims = shape_of(x)
        dim = n.args[1] if len(n.args) > 1 and isinstance(n.args[1], int) \
            else -1
        k = int(dims[dim]) if dims else 1
        flops = int(total * max(math.log2(max(k, 2)), 1.0))
    elif cls == "dot":
        k = shape_of(n.args[0])[-1] if shape_of(n.args[0]) else 1
        flops = 2 * out_elems * int(k)
    elif cls == "reduce":
        flops = _elems_of(n.args[0])
    elif name in _LAYOUT:
        flops = 0
    else:
        flops = out_elems
    return EqnCost(prim=name, op_class=cls, flops=int(flops),
                   bytes_read=int(in_bytes), bytes_written=int(out_bytes),
                   shape=tuple(int(s) for s in shape),
                   operand_shape=tuple(int(s) for s in operand_shape))


def _scaled(c: EqnCost, scale: float) -> EqnCost:
    if scale == 1:
        return c
    return EqnCost(prim=c.prim, op_class=c.op_class,
                   flops=int(round(c.flops * scale)),
                   bytes_read=int(round(c.bytes_read * scale)),
                   bytes_written=int(round(c.bytes_written * scale)),
                   count=c.count, shape=c.shape,
                   operand_shape=c.operand_shape)


@dataclass
class StageCost:
    """Aggregated cost of one pipeline stage (JAX ``StageCost``)."""

    name: str
    flops: int = 0
    bytes_read: int = 0
    bytes_written: int = 0
    eqns: int = 0
    classes: dict = field(default_factory=dict)  # class -> {flops, bytes}
    #: aggregated data-movement sites for the tensor-core ranking:
    #: (prim, shape, operand_shape) -> EqnCost (count accumulated)
    movement: dict = field(default_factory=dict)

    @property
    def bytes_total(self) -> int:
        return self.bytes_read + self.bytes_written

    @property
    def intensity(self) -> Optional[float]:
        """Arithmetic intensity (FLOPs per byte moved); None at 0 bytes."""
        if self.bytes_total <= 0:
            return None
        return self.flops / self.bytes_total

    def charge(self, cost: EqnCost) -> None:
        self.flops += cost.flops
        self.bytes_read += cost.bytes_read
        self.bytes_written += cost.bytes_written
        self.eqns += 1
        c = self.classes.setdefault(
            cost.op_class, {"flops": 0, "bytes": 0, "count": 0})
        c["flops"] += cost.flops
        c["bytes"] += cost.bytes_total
        c["count"] += 1
        if cost.op_class in ("gather", "scatter", "sort"):
            key = (cost.prim, cost.shape, cost.operand_shape)
            site = self.movement.get(key)
            if site is None:
                self.movement[key] = EqnCost(
                    prim=cost.prim, op_class=cost.op_class,
                    flops=cost.flops, bytes_read=cost.bytes_read,
                    bytes_written=cost.bytes_written, shape=cost.shape,
                    operand_shape=cost.operand_shape)
            else:
                site.flops += cost.flops
                site.bytes_read += cost.bytes_read
                site.bytes_written += cost.bytes_written
                site.count += 1

    def to_json(self) -> dict:
        out = {
            "flops": int(self.flops),
            "bytes_read": int(self.bytes_read),
            "bytes_written": int(self.bytes_written),
            "eqns": int(self.eqns),
            "classes": {k: dict(v) for k, v in sorted(self.classes.items())},
        }
        ai = self.intensity
        if ai is not None:
            out["intensity"] = round(ai, 6)
        return out


def walk_graph(graph: Graph, name: str = "kernel",
               scale: float = 1.0, stage: Optional[StageCost] = None
               ) -> StageCost:
    """Charge every operation of a captured graph into one
    :class:`StageCost` (JAX ``walk_jaxpr``), each scaled by ``scale``."""
    stage = stage if stage is not None else StageCost(name=name)
    for n in graph.nodes:
        c = charge_node(n)
        if c is not None:
            stage.charge(_scaled(c, scale))
    return stage


# ---------------------------------------------------------------------------
# per-action attribution (the footprint pass's action-axis decomposition)
# ---------------------------------------------------------------------------


def action_costs(graph: Graph, arity: int) -> Optional[list]:
    """Per-action ``{flops, bytes}`` of the expand kernel (JAX
    ``action_costs``): operations reachable from exactly one action's
    successor piece charge to it; those feeding several to the trailing
    ``shared`` entry.  None when the successor stack does not decompose
    (the footprint pass's ``JX302``)."""
    from .footprint import _stack_pieces

    out = graph.outputs[0]
    nd = len(shape_of(out))
    if nd < 2:
        return None
    pieces = _stack_pieces(out, nd - 2)
    if pieces is None and arity == 1:
        pieces = [out]
    if pieces is None or len(pieces) != arity:
        return None
    costs = {n: charge_node(n) for n in graph.nodes}
    memo: dict = {}

    def reach(n) -> frozenset:
        got = memo.get(n)
        if got is not None:
            return got
        memo[n] = frozenset()  # cycle guard (none expected)
        acc = {n}
        for a in _arg_nodes(n.args):
            acc |= reach(a)
        memo[n] = frozenset(acc)
        return memo[n]

    owner: dict = {}
    per_action = []
    for a, piece in enumerate(pieces):
        nodes = reach(piece) if isinstance(piece, torch.fx.Node) \
            else frozenset()
        per_action.append(nodes)
        for n in nodes:
            owner[n] = a if n not in owner else -1
    res = []
    for a in range(arity):
        fl = by = 0
        for n in per_action[a]:
            c = costs.get(n)
            if c is not None and owner.get(n) == a:
                fl += c.flops
                by += c.bytes_total
        res.append({"action": a, "flops": int(fl), "bytes": int(by)})
    fl = by = 0
    for n, c in costs.items():
        if c is not None and owner.get(n) == -1:
            fl += c.flops
            by += c.bytes_total
    res.append({"action": "shared", "flops": int(fl), "bytes": int(by)})
    return res


# ---------------------------------------------------------------------------
# the hand-written kernels' counts
# ---------------------------------------------------------------------------

SLOTS = 16  # fingerprints per bucket line (ops/buckets.py)


def kernel_rw(name: str, s: dict) -> tuple:
    """``(bytes read, bytes written, operations)`` of one launch of a
    hand-written kernel (or of the key sort) on the shapes ``s``: what
    the work must move, each input read once and each output written once,
    and the integer operations it does.  Where the work depends on the
    data, ``s`` holds this launch's counts.  The counts, by kernel:

    ``cand_prep`` (``csrc/cand_prep.cu``; ``lanes`` n, ``width`` w,
    ``valid`` nv, ``budget`` cb, ``parents`` p): the valid lanes read
    their row (8w each), every lane its valid byte, each parent read its
    fingerprint once (8); four words per output lane and the two scalars
    out (9).  About ten operations per word folded, plus two a lane.  In
    a sweep's namespace mode (``ns`` K, the instance count): each parent's
    int32 tag (4) and the two K-word tables (16K) in, and 25 operations
    more per valid lane (the namespace, ``unmix64``, the remap and the
    key's second mix).

    ``row_hash`` (``csrc/row_hash.cu``; ``rows`` n, ``width`` w, ``valid``
    nh or None for no mask): the hashed rows in, a fingerprint per row
    out, and with a mask every row's valid byte in.  Ten operations per
    word folded and one to finish.

    ``bucket_plan`` (``csrc/bucket_plan.cu``; ``lanes`` m, ``valid`` live
    lanes, ``lines`` distinct bucket lines read, ``novel`` planned lanes,
    ``cidx``: the candidate map is read too): every lane its fingerprint,
    the live lanes their bucket index, each line's 16 slots once, the
    novel lanes their payload, order (and map) entries and four output
    words; the flags in and out (10).  Two operations per slot compared.

    ``bucket_plan_fused`` (the fused entry of ``csrc/bucket_plan.cu``,
    the engines' step; the same counts, and ``keys`` the sorted keys read,
    ``lanes`` unless a window reads fewer; ``win`` a window's two bounds):
    the sorted keys, the live lanes their order entry and their
    fingerprint through it, each line once, the novel lanes their payload
    (and map) entries and four output words; nothing sorted is
    materialized (no ``sfp``, ``spl`` or ``bucket`` arrays).

    ``insert_commit`` (``csrc/insert_commit.cu``; ``novel`` nn, ``width``
    w, ``parents`` p): the plan lanes (slot, fingerprint, payload, sel)
    and count and tail in, each parent's ebits and depth, the novel rows;
    the table's two words and a queue row (8w + 16 bytes) out per novel
    lane.  It only moves data.  With a sweep's tag column (``tags``
    true): each parent's tag in (4) and a tag out per novel lane (4).

    ``insert_commit_window`` (the window mode of ``csrc/insert_commit.cu``,
    one piece of a queue held in pieces; ``lanes`` n, the step's novel
    lanes, ``novel`` nn of them in this piece's window, ``width`` w,
    ``parents`` p of those): every novel lane's fingerprint and the count
    and tail in, and for the window's lanes their ``sel`` entry, the
    parents' ebits and depth and the rows; a queue row (8w + 16 bytes) out
    per window lane.  No table half; it only moves data.

    ``sort`` (the engines' ``torch.sort`` of ``cand_prep``'s keys;
    ``lanes`` n): the keys in, sorted keys and the permutation out;
    ``n log2 n`` comparisons."""
    if name == "cand_prep":
        n, w, nv = s["lanes"], s["width"], s["valid"]
        cb, p = s["budget"], s["parents"]
        k = s.get("ns") or 0
        read = nv * w * 8 + n + p * 8 + (p * 4 + k * 16 if k else 0)
        return read, cb * 32 + 9, nv * (w + 2) * 10 + (nv * 25 if k else 0)
    if name == "row_hash":
        n, w, nh = s["rows"], s["width"], s.get("valid")
        if nh is None:
            return n * w * 8, n * 8, n * (w + 1) * 10
        return nh * w * 8 + n, n * 8, nh * (w + 1) * 10
    if name == "bucket_plan":
        m, live, lines, nov = s["lanes"], s["valid"], s["lines"], s["novel"]
        idx_words = 3 if s.get("cidx", True) else 2
        return (m * 8 + live * 8 + lines * SLOTS * 8
                + nov * 8 * idx_words + 1,
                nov * 32 + 9, live * SLOTS * 2)
    if name == "bucket_plan_fused":
        m, live, lines, nov = s["lanes"], s["valid"], s["lines"], s["novel"]
        idx_words = 2 if s.get("cidx", True) else 1
        return (s.get("keys", m) * 8 + live * 16 + lines * SLOTS * 8
                + nov * 8 * idx_words + 1 + (16 if s.get("win") else 0),
                nov * 32 + 9, live * SLOTS * 2)
    if name == "insert_commit":
        parts = insert_commit_parts(s)
        return (parts["table"][0] + parts["queue"][0],
                parts["table"][1] + parts["queue"][1], 0)
    if name == "insert_commit_window":
        n, nn, w, p = s["lanes"], s["novel"], s["width"], s["parents"]
        return n * 8 + 16 + nn * 8 + p * 8 + nn * 8 * w, nn * (8 * w + 16), 0
    if name == "sort":
        n = s["lanes"]
        return n * 8, n * 16, int(n * max(math.log2(max(n, 2)), 1.0))
    raise KeyError(f"no count for kernel {name!r}")


def insert_commit_parts(s: dict) -> dict:
    """``insert_commit``'s bytes split into the table half (the JAX
    ``_insert_kernel``'s write: the dedup-insert stage) and the queue half
    (the append: the queue stage), each ``(read, written)``."""
    nn, w, p = s["novel"], s["width"], s["parents"]
    t = 4 if s.get("tags") else 0  # a sweep's tag column
    return {
        "table": (nn * 24 + 8, nn * 16),
        "queue": (nn * 8 + 8 + p * (8 + t) + nn * 8 * w,
                  nn * (8 * w + 16 + t)),
    }


def kernel_cost(name: str, shapes: dict) -> tuple:
    """``(bytes, operations)`` of one launch of a hand-written kernel on
    these shapes (:func:`kernel_rw`): the work a bound is taken from."""
    r, w, ops = kernel_rw(name, shapes)
    return r + w, ops


_KERNEL_CLASS = {"cand_prep": "elementwise", "bucket_plan": "gather",
                 "bucket_plan_fused": "gather",
                 "insert_commit": "scatter", "sort": "sort"}


def _kernel_eqn(name: str, read: int, written: int, ops: int,
                lanes: int, operand=()) -> EqnCost:
    return EqnCost(prim=name, op_class=_KERNEL_CLASS.get(name, "elementwise"),
                   flops=int(ops), bytes_read=int(read),
                   bytes_written=int(written), shape=(int(lanes),),
                   operand_shape=tuple(operand))


def step_shapes(batch: int, arity: int, width: int, cap: int,
                cand: Optional[int]) -> dict:
    """The static step's kernel shapes: every lane valid and novel."""
    m = batch * arity
    cb = min(cand, m) if cand else m
    return {
        "cand_prep": {"lanes": m, "width": width, "valid": m, "budget": cb,
                      "parents": batch},
        "sort": {"lanes": cb},
        "bucket_plan": {"lanes": cb, "valid": cb,
                        "lines": min(cb, max(cap // SLOTS, 1)), "novel": cb},
        "insert_commit": {"novel": cb, "width": width, "parents": batch},
    }


def engine_stages(batch: int, arity: int, width: int, cap: int,
                  cand: Optional[int]) -> dict:
    """The ``hash``, ``dedup-insert`` and ``queue`` stages of one static
    step, charged from the kernels' counts."""
    sh = step_shapes(batch, arity, width, cap, cand)
    cb = sh["sort"]["lanes"]
    hash_ = StageCost(name="hash")
    r, w, ops = kernel_rw("cand_prep", sh["cand_prep"])
    hash_.charge(_kernel_eqn("cand_prep", r, w, ops, batch * arity))
    dedup = StageCost(name="dedup-insert")
    r, w, ops = kernel_rw("sort", sh["sort"])
    dedup.charge(_kernel_eqn("sort", r, w, ops, cb))
    r, w, ops = kernel_rw("bucket_plan_fused", sh["bucket_plan"])
    dedup.charge(_kernel_eqn("bucket_plan_fused", r, w, ops, cb, (cap,)))
    parts = insert_commit_parts(sh["insert_commit"])
    dedup.charge(_kernel_eqn("insert_commit", *parts["table"], 0, cb,
                             (cap,)))
    queue = StageCost(name="queue")
    # the pop: four gathers of the batch's queue lanes (rows, fingerprint,
    # ebits, depth) at one index vector each
    queue.charge(EqnCost(prim="index", op_class="gather", flops=0,
                         bytes_read=batch * (8 * width + 16) + 4 * batch * 8,
                         bytes_written=batch * (8 * width + 16),
                         shape=(batch, width)))
    queue.charge(_kernel_eqn("insert_commit", *parts["queue"], 0, cb))
    return {"hash": hash_, "dedup-insert": dedup, "queue": queue}


# ---------------------------------------------------------------------------
# reconciliation: each kernel's count beside the walk of its plain version
# ---------------------------------------------------------------------------


def plain_walks(tensor, batch: int = 4, cap: int = 256) -> dict:
    """``{kernel: (kernel bytes, plain-walk bytes, kernel ops, plain
    flops)}`` at a small shape on the CPU: the twin's example rows
    expanded, every lane valid, an empty table of ``cap`` slots."""
    from ..ops.buckets import bucket_plan_fused_plain, bucket_plan_plain
    from ..ops.cand_prep import cand_prep_plain, sort_prepared
    from ..ops.hashing import EMPTY
    from ..ops.insert_commit import QueueAppend, insert_commit_plain
    from .graph import capture, example_rows

    arity, width = int(tensor.max_actions), int(tensor.width)
    rows = example_rows(tensor, batch)
    succ, _ = tensor.step_rows(rows)
    krows = succ.reshape(batch * arity, width).contiguous()
    m = krows.shape[0]
    valid = torch.ones(m, dtype=torch.bool)
    pfps = torch.arange(batch, dtype=torch.int64) * 7919 + 1
    out = {}

    def rec(name, graph, shapes):
        st = walk_graph(graph, name)
        r, w, ops = kernel_rw(name, shapes)
        out[name] = {"kernel_bytes": int(r + w), "kernel_ops": int(ops),
                     "plain_bytes": int(st.bytes_total),
                     "plain_flops": int(st.flops)}

    prep = cand_prep_plain(krows, valid, pfps, arity, m)
    rec("cand_prep",
        Graph(capture(lambda r, v, p: cand_prep_plain(r, v, p, arity, m),
                      krows, valid, pfps)),
        {"lanes": m, "width": width, "valid": m, "budget": m,
         "parents": batch})
    rec("sort", Graph(capture(lambda k: torch.sort(k, stable=True),
                              prep[3])), {"lanes": m})
    nb = cap // SLOTS
    sort = sort_prepared(prep[0], prep[1], prep[3], nb)
    tfp = torch.full((cap,), EMPTY, dtype=torch.int64)
    tpl = torch.zeros(cap, dtype=torch.int64)
    plan = bucket_plan_plain(tfp, *sort, prep[2], prep[5])
    lines = int(torch.unique(sort[2]).numel())
    rec("bucket_plan",
        Graph(capture(lambda *a: bucket_plan_plain(*a), tfp, *sort,
                      prep[2], prep[5])),
        {"lanes": m, "valid": m, "lines": lines, "novel": m})
    skey, order = torch.sort(prep[3], stable=True)
    rec("bucket_plan_fused",
        Graph(capture(lambda *a: bucket_plan_fused_plain(*a, nb), tfp,
                      prep[0], prep[1], skey, order, prep[2], prep[5])),
        {"lanes": m, "valid": m, "lines": lines, "novel": m})
    qrows = torch.zeros((m + 4, width), dtype=torch.int64)
    qfp = torch.zeros(m + 4, dtype=torch.int64)
    qeb = torch.zeros(m + 4, dtype=torch.int32)
    qdp = torch.zeros(m + 4, dtype=torch.int32)
    tail = torch.zeros((), dtype=torch.int64)
    peb = torch.zeros(batch, dtype=torch.int32)
    pdp = torch.zeros(batch, dtype=torch.int32)
    n_new = plan[4]

    def commit(tfp, tpl, tgt, cfp, cpl, n_new, qr, qf, qe, qd, tl, sel,
               src, pe, pd):
        return insert_commit_plain(
            tfp, tpl, tgt, cfp, cpl, n_new,
            QueueAppend(qr, qf, qe, qd, tl, sel, src, pe, pd, arity))

    rec("insert_commit",
        Graph(capture(commit, tfp.clone(), tpl.clone(), plan[0], plan[1],
                      plan[2], n_new, qrows, qfp, qeb, qdp, tail, plan[3],
                      krows, peb, pdp)),
        {"novel": int(n_new), "width": width, "parents": batch})
    return out


def reconcile_kernels(walks: dict) -> dict:
    """Per-stage verdicts: each kernel's bytes beside its plain version's
    walk, the ratio inside ``[BYTES_LO, BYTES_HI]`` (module docstring)."""
    stage_of = {"cand_prep": "hash", "sort": "dedup-insert",
                "bucket_plan": "dedup-insert",
                "bucket_plan_fused": "dedup-insert", "insert_commit": "queue"}
    stages: dict = {}
    for name, w in walks.items():
        ratio = w["plain_bytes"] / max(w["kernel_bytes"], 1)
        entry = dict(w, bytes_ratio=round(ratio, 4),
                     ok=BYTES_LO <= ratio <= BYTES_HI)
        stages.setdefault(stage_of[name], {})[name] = entry
    return stages


# ---------------------------------------------------------------------------
# tensor-core candidates (JX4xx)
# ---------------------------------------------------------------------------

_RECAST = {
    "gather": ("JX400", "blocked one-hot x table matmul (a [B, K] one-hot "
                        "selector against the [K, V] table block)"),
    "scatter": ("JX400", "blocked scatter-as-matmul accumulate (one-hot^T x "
                         "updates onto the table block)"),
    "sort": ("JX401", "bitonic / blocked compare-exchange stages (the "
                      "tensor-core-shaped dedup-rank move)"),
}


def mxu_candidates(stages: dict) -> list:
    """Indexed reads/writes and sorts whose shapes admit a blocked-matmul
    recast, ranked by charged bytes (JAX ``mxu_candidates`` with no recast
    landed: the port's ``.mxu()`` has none)."""
    out = []
    for sname, stage in stages.items():
        for (prim, shape, op_shape), site in stage.movement.items():
            total = site.bytes_total
            if total < MXU_MIN_BYTES:
                continue
            rule, recast = _RECAST[site.op_class]
            out.append({
                "stage": sname, "op": prim, "op_class": site.op_class,
                "shape": list(shape), "operand_shape": list(op_shape),
                "count": int(site.count), "bytes": int(total),
                "flops": int(site.flops), "rule": rule, "recast": recast,
            })
    out.sort(key=lambda c: (-c["bytes"], c["stage"], c["op"]))
    for rank, c in enumerate(out, 1):
        c["rank"] = rank
    return out[:_MXU_TOP]


def mxu_findings(candidates: list, stages: dict) -> list:
    """The ranking as ``JX4xx`` informational findings (JAX
    ``mxu_findings`` with the flag off)."""
    findings = []
    for c in candidates:
        findings.append(AuditFinding(
            c["rule"], Severity.INFO, f"stage:{c['stage']}",
            f"tensor-core candidate #{c['rank']}: {c['op']} moving "
            f"{c['bytes']} bytes/step (shape {c['shape']}"
            + (f" over operand {c['operand_shape']}"
               if c["operand_shape"] else "")
            + f", x{c['count']}) admits a {c['recast']}",
        ))
    if candidates:
        by_stage: dict = {}
        for c in candidates:
            by_stage[c["stage"]] = by_stage.get(c["stage"], 0) + c["bytes"]
        top = max(by_stage, key=by_stage.get)
        total = sum(s.bytes_total for s in stages.values()) or 1
        findings.append(AuditFinding(
            "JX402", Severity.INFO, "costmodel",
            f"top tensor-core candidate stage is '{top}' with "
            f"{by_stage[top]} candidate bytes/step "
            f"({100.0 * by_stage[top] / total:.1f}% of all charged bytes)",
        ))
    return findings


# ---------------------------------------------------------------------------
# the report + the engine entry point
# ---------------------------------------------------------------------------


@dataclass
class CostReport:
    """The cost ledger of one engine configuration (JAX ``CostReport``)."""

    engine: str
    shapes: dict
    stages: dict  # name -> StageCost
    reconciliation: dict  # stage -> {kernel -> verdict}
    actions: Optional[list]
    candidates: list
    findings: list = field(default_factory=list)

    @property
    def total_flops(self) -> int:
        return sum(s.flops for s in self.stages.values())

    @property
    def total_bytes(self) -> int:
        return sum(s.bytes_total for s in self.stages.values())

    def static_block(self) -> dict:
        """The DETERMINISTIC block (the run report's ``roofline``): the
        analytic counts only, no device spec, no wall clock."""
        totals = {"flops": int(self.total_flops),
                  "bytes": int(self.total_bytes)}
        if totals["bytes"]:
            totals["intensity"] = round(totals["flops"] / totals["bytes"], 6)
        out = {
            "v": COSTMODEL_V,
            "engine": self.engine,
            **{k: int(v) for k, v in sorted(self.shapes.items())},
            "stages": {name: s.to_json() for name, s in self.stages.items()},
            "totals": totals,
            "mxu_candidates": [dict(c) for c in self.candidates],
        }
        if self.actions is not None:
            out["actions"] = [dict(a) for a in self.actions]
        return out

    def recon_block(self) -> dict:
        """The reconciliation verdict: per stage, each kernel's count
        beside the walk of its plain version."""
        ok = all(v.get("ok", False) for st in self.reconciliation.values()
                 for v in st.values())
        return {
            "ok": ok,
            "bands": {"bytes": [BYTES_LO, BYTES_HI]},
            "stages": {k: {n: dict(v) for n, v in st.items()}
                       for k, st in self.reconciliation.items()},
        }


def _cost_cache(tensor) -> Optional[dict]:
    cache = getattr(tensor, "_cost_cache", None)
    if cache is None:
        cache = {}
        try:
            tensor._cost_cache = cache
        except Exception:  # noqa: BLE001 - __slots__ twins
            return None
    return cache


# the batch of the shared capture (``analysis/graph.py``'s default)
CAPTURE_BATCH = 4


def wavefront_costs(tensor, cap: int, qcap: int, batch: int,
                    cand: Optional[int] = None, *,
                    sym: bool = False) -> Optional[CostReport]:
    """The wavefront engine's cost ledger at these capacities (JAX
    ``wavefront_costs``), cached on the twin.  None when the twin has no
    usable width/arity or a kernel does not capture (the kernel audit
    reports those).  ``sym`` prices the generation-order plan (the same
    bytes; the canonicalizer's own walk is not charged)."""
    width = getattr(tensor, "width", None)
    arity = getattr(tensor, "max_actions", None)
    if not isinstance(width, int) or not isinstance(arity, int):
        return None
    cand = cand or max(4 * batch, 4096)
    eff = min(cand, batch * arity)
    key = ("wavefront", cap, qcap, batch, eff, bool(sym))
    cache = _cost_cache(tensor)
    if cache is not None and key in cache:
        return cache[key]
    scale = batch / CAPTURE_BATCH
    try:
        gp = graph_of(tensor, "property_masks", CAPTURE_BATCH)
        gs = graph_of(tensor, "step_rows", CAPTURE_BATCH)
        gb = (graph_of(tensor, "boundary_rows", CAPTURE_BATCH)
              if getattr(tensor, "has_boundary", False) else None)
    except Exception:  # noqa: BLE001 - the kernel audit's JX000
        return None
    stages = {"property": walk_graph(gp, "property", scale)}
    expand = walk_graph(gs, "expand", scale)
    if gb is not None:
        walk_graph(gb, "expand", scale, stage=expand)
    stages["expand"] = expand
    stages.update(engine_stages(batch, arity, width, cap, eff))
    try:
        recon = reconcile_kernels(plain_walks(tensor, CAPTURE_BATCH))
    except Exception as e:  # noqa: BLE001 - a verdict, never a crash
        recon = {"error": {"plain_walks": {
            "ok": False, "problem": f"{type(e).__name__}: {e}"}}}
    try:
        actions = action_costs(gs, arity)
        if actions is not None and scale != 1:
            actions = [dict(a, flops=int(round(a["flops"] * scale)),
                            bytes=int(round(a["bytes"] * scale)))
                       for a in actions]
    except Exception:  # noqa: BLE001 - attribution only, never fatal
        actions = None
    candidates = mxu_candidates(stages)
    out = CostReport(
        engine="gpu-wavefront",
        shapes={"batch": batch, "capacity": cap, "queue_capacity": qcap,
                "cand": eff},
        stages=stages, reconciliation=recon, actions=actions,
        candidates=candidates, findings=mxu_findings(candidates, stages),
    )
    if cache is not None:
        cache[key] = out
    return out


def sharded_costs(tensor, cap_local: int, fcap_local: int, ndev: int, *,
                  sym: bool = False, cand_local: Optional[int] = None,
                  bucket_factor: int = 2) -> Optional[CostReport]:
    """The sharded engine's cost ledger for one shard's step (JAX
    ``sharded_costs``, analysis/costmodel.py:1075): the property and
    expand stages at the shard's frontier width, the ``row_hash`` launch
    over its candidates, and, where JAX has none (its insert and exchange
    are collectives its walk does not price), the route (the send
    buffers' scatter, an index operation on one device) and the owner's
    insert (the key sort, ``bucket_plan`` and the table half of
    ``insert_commit`` at the candidate budget), charged from the kernels'
    counts.  Cached on the twin; None where a kernel does not capture."""
    width = getattr(tensor, "width", None)
    arity = getattr(tensor, "max_actions", None)
    if not isinstance(width, int) or not isinstance(arity, int):
        return None
    m = fcap_local * arity
    bucket_cap = max(64, m * bucket_factor // ndev)
    cb = min(cand_local or max(64, 4 * fcap_local), ndev * bucket_cap)
    key = ("sharded", cap_local, fcap_local, ndev, cb, bool(sym))
    cache = _cost_cache(tensor)
    if cache is not None and key in cache:
        return cache[key]
    scale = fcap_local / CAPTURE_BATCH
    try:
        gp = graph_of(tensor, "property_masks", CAPTURE_BATCH)
        gs = graph_of(tensor, "step_rows", CAPTURE_BATCH)
    except Exception:  # noqa: BLE001 - the kernel audit's JX000
        return None
    stages = {"property": walk_graph(gp, "property", scale),
              "expand": walk_graph(gs, "expand", scale)}
    hash_ = StageCost(name="hash")
    r, w, ops = kernel_rw("row_hash", {"rows": m, "width": width,
                                       "valid": m})
    hash_.charge(_kernel_eqn("row_hash", r, w, ops, m))
    stages["hash"] = hash_
    route = StageCost(name="route")
    words = width + 3  # fingerprint, parent, ebits, row
    route.charge(EqnCost(prim="index_put", op_class="scatter", flops=0,
                         bytes_read=m * (words + 1) * 8,
                         bytes_written=m * words * 8, shape=(m, words),
                         operand_shape=(ndev * bucket_cap, words)))
    stages["route"] = route
    dedup = StageCost(name="dedup-insert")
    r, w, ops = kernel_rw("sort", {"lanes": cb})
    dedup.charge(_kernel_eqn("sort", r, w, ops, cb))
    r, w, ops = kernel_rw("bucket_plan", {
        "lanes": cb, "valid": cb, "novel": cb,
        "lines": min(cb, max(cap_local // SLOTS, 1))})
    dedup.charge(_kernel_eqn("bucket_plan", r, w, ops, cb, (cap_local,)))
    parts = insert_commit_parts({"novel": cb, "width": width,
                                 "parents": fcap_local})
    dedup.charge(_kernel_eqn("insert_commit", *parts["table"], 0, cb,
                             (cap_local,)))
    stages["dedup-insert"] = dedup
    candidates = mxu_candidates(stages)
    out = CostReport(
        engine="sharded",
        shapes={"batch": fcap_local, "capacity": cap_local * ndev,
                "devices": ndev},
        stages=stages, reconciliation={}, actions=None,
        candidates=candidates, findings=mxu_findings(candidates, stages),
    )
    if cache is not None:
        cache[key] = out
    return out


def fold_into_report(cost: CostReport, report) -> None:
    """Merge the JX4xx findings and the summary metrics into an
    ``AuditReport`` (JAX ``fold_into_report``): the audit tiers do not run
    the cost walk; this is for callers that want it merged."""
    report.extend(cost.findings)
    report.metrics["costmodel"] = {
        "engine": cost.engine,
        "flops": int(cost.total_flops),
        "bytes": int(cost.total_bytes),
        "stages": sorted(cost.stages),
        "mxu_candidates": len(cost.candidates),
        "reconciled": cost.recon_block()["ok"],
    }
