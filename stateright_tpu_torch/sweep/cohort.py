"""Shape cohorts: one program per family of compatible instances.

The port's counterpart of ``stateright_tpu/sweep/cohort.py``.  The sweep
engine runs many instances of one model family as a single wavefront.
The twins' kernels are pure functions of the row words and of their
closed-over constants (bounds, tables, seeds fixed when the twin is
built), so two instances of one family capture to aten graphs that are
structurally identical and differ only in constant values:

 1. each member's ``step_rows`` and ``property_masks`` are captured at a
    one-row batch on the engine's device (``analysis/graph.py::graph_of``,
    cached on the twin), where JAX traces a jaxpr at ``[1, W]`` (:42-231);
 2. the graphs are unified (:func:`unify_graphs`, JAX ``unify_jaxprs``
    :104): the same node targets in the same order, the same argument
    structure by node ordinal, equal non-tensor arguments.  Equal
    ``get_attr`` constants stay shared; a ``get_attr`` constant or a
    scalar argument that differs across members is lifted into a new
    input, stacked ``[K, ...]``.  A lifted scalar's node takes its
    ``.Tensor`` overload (``lt.Scalar`` becomes ``lt.Tensor``), and its
    0-d tensor has the dtype that keeps the ``.Scalar`` overload's type
    promotion; where no such overload exists the group does not unify;
 3. the cohort kernel (JAX ``_unified_kernel`` :236) evaluates the unified
    graph per row under ``torch.func.vmap``, each row's lifted constants
    gathered by its instance tag, so one program serves every member.

Instances whose kernels do not unify split into separate cohorts
(grouping changes how many programs run, never the result), and a
build-time check (:meth:`CohortProgram._verify`, JAX :350) holds the
cohort kernel against each member's own kernels on its init rows; a
mismatch splits the group rather than run a wrong program.  A singleton
cohort, or one where nothing is lifted (a seed-only family), runs member
0's own kernels directly (JAX :318-345).
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

import numpy as np
import torch

from ..fingerprint import sweep_ns_bits, sweep_ns_xor
from ..ops.hashing import to_i64

_KERNELS = ("step_rows", "property_masks")


class CohortSplit(Exception):
    """Internal: a candidate group cannot share one program."""


def shape_signature(instance) -> tuple:
    """The coarse cohort key (JAX :42): twin class, row layout and the
    property list.  Instances that disagree here never share a program."""
    tensor = instance.model._tensor_cached()
    props = tuple(
        (p.name, getattr(p.expectation, "name", str(p.expectation)))
        for p in instance.model.properties()
    )
    return (type(tensor).__name__, int(tensor.width),
            int(tensor.max_actions), props)


def _is_scalar(x) -> bool:
    return isinstance(x, (bool, int, float))


def _lift_dtype(vals: list) -> torch.dtype:
    """The dtype of a lifted scalar's 0-d tensor that promotes as the
    Python scalar did: a 0-d tensor of a category no higher than the other
    operand's takes that operand's dtype, as a scalar does; a float scalar
    takes the default float dtype."""
    if all(isinstance(v, bool) for v in vals):
        return torch.bool
    if all(isinstance(v, int) for v in vals):
        return torch.int64
    return torch.get_default_dtype()


def _tensor_position(target, pos, name: Optional[str]):
    """The overload of ``target`` that takes a tensor at argument ``pos``
    (or keyword ``name``): ``target`` itself when its schema already
    types that argument ``Tensor`` (a Python scalar passed there is a
    wrapped number), else its ``.Tensor`` sibling; None when there is
    none."""
    def arg_type(op):
        args = op._schema.arguments
        if name is not None:
            hit = [a for a in args if a.name == name]
            return str(hit[0].type) if hit else None
        return str(args[pos].type) if pos < len(args) else None

    if not hasattr(target, "_schema"):
        return None
    if arg_type(target) == "Tensor":
        return target
    pkt = target.overloadpacket
    over = target._overloadname.replace("Scalar", "Tensor")
    alt = getattr(pkt, over, None) if over != target._overloadname else None
    if alt is None and target._overloadname == "Scalar":
        alt = getattr(pkt, "Tensor", None)
    if alt is None or arg_type(alt) != "Tensor":
        return None
    if len(alt._schema.arguments) != len(target._schema.arguments):
        return None
    return alt


def _val_sig(node) -> tuple:
    v = node.meta.get("val") if isinstance(node, torch.fx.Node) else None
    if isinstance(v, torch.Tensor):
        return (tuple(v.shape), v.dtype)
    if isinstance(v, (tuple, list)):
        return tuple(_val_sig_of(x) for x in v)
    return ()


def _val_sig_of(x) -> tuple:
    return (tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor) else ()


class _Lift:
    """One lifted input of the unified graph: where it goes, and the
    member values stacked ``[K, ...]``."""

    def __init__(self, node_index: int, where, values: torch.Tensor):
        self.node_index = node_index
        self.where = where  # "attr", or ("arg", pos) / ("kwarg", name)
        self.values = values


def _compare(xs: list, ords: list, lifts: list, ni: int, where) -> bool:
    """Whether the members' argument values ``xs`` (one per member) agree
    by node ordinal, recursing into lists; a top-level scalar that differs
    is recorded in ``lifts``."""
    x0 = xs[0]
    if isinstance(x0, torch.fx.Node):
        return all(isinstance(x, torch.fx.Node) and o[x] == ords[0][x0]
                   for x, o in zip(xs, ords))
    if isinstance(x0, (list, tuple)):
        if not all(isinstance(x, (list, tuple)) and len(x) == len(x0)
                   for x in xs):
            return False
        return all(_compare([x[i] for x in xs], ords, lifts, ni, None)
                   for i in range(len(x0)))
    if _is_scalar(x0):
        if not all(_is_scalar(x) for x in xs):
            return False
        if all(type(x) is type(x0) and x == x0 for x in xs):
            return True
        if where is None:
            return False  # a scalar inside a list (a shape, a dims list)
        lifts.append(_Lift(ni, where, torch.tensor(
            xs, dtype=_lift_dtype(xs))))
        return True
    try:
        return all(type(x) is type(x0) and bool(x == x0) for x in xs)
    except Exception:  # noqa: BLE001 - an odd __eq__: not equal
        return False


def unify_graphs(graphs: list):
    """Unify structurally identical captured graphs (``analysis/graph.
    Graph``, one per member) into one ``GraphModule`` whose differing
    constants are inputs after the rows: ``(gm, stacked)``, ``stacked``
    the lifted values, each ``[K, ...]`` on the constants' device, in
    input order.  None when the graphs do not unify (JAX
    ``unify_jaxprs``, cohort.py:104)."""
    g0 = graphs[0]
    if any(len(g.nodes) != len(g0.nodes) for g in graphs[1:]):
        return None
    ords = [{n: i for i, n in enumerate(g.nodes)} for g in graphs]
    lifts: list = []
    for ni, n0 in enumerate(g0.nodes):
        ns = [g.nodes[ni] for g in graphs]
        if any(n.op != n0.op or n.target != n0.target
               and n0.op != "get_attr" for n in ns):
            return None
        if any(_val_sig(n) != _val_sig(n0) for n in ns):
            return None
        if n0.op == "get_attr":
            vals = [getattr(g.gm, n.target) for g, n in zip(graphs, ns)]
            if not all(isinstance(v, torch.Tensor) for v in vals):
                return None
            if any(v.dtype != vals[0].dtype or v.shape != vals[0].shape
                   or v.device != vals[0].device for v in vals):
                return None
            if not all(torch.equal(vals[0], v) for v in vals[1:]):
                lifts.append(_Lift(ni, "attr", torch.stack(vals)))
            continue
        if n0.op == "placeholder":
            continue
        if len(set(len(n.args) for n in ns)) != 1 or any(
                set(n.kwargs) != set(n0.kwargs) for n in ns):
            return None
        for pos in range(len(n0.args)):
            if not _compare([n.args[pos] for n in ns], ords, lifts, ni,
                            ("arg", pos)):
                return None
        for key in n0.kwargs:
            if not _compare([n.kwargs[key] for n in ns], ords, lifts, ni,
                            ("kwarg", key)):
                return None
    return _build_unified(g0, lifts)


def _build_unified(g0, lifts: list):
    """A copy of member 0's graph with each lift an input after the rows."""
    graph = torch.fx.Graph()
    vmap_ = {}
    out = graph.graph_copy(g0.gm.graph, vmap_)
    graph.output(out)
    nodes = list(graph.nodes)
    last = [n for n in nodes if n.op == "placeholder"][-1]
    dev = None
    stacked = []
    for li, lift in enumerate(lifts):
        node = nodes[lift.node_index]
        with graph.inserting_after(last):
            ph = graph.placeholder(f"lifted_{li}")
        last = ph
        if lift.where == "attr":
            dev = lift.values.device
            node.replace_all_uses_with(ph)
            graph.erase_node(node)
        else:
            kind, key = lift.where
            alt = _tensor_position(node.target, key if kind == "arg" else 0,
                                   key if kind == "kwarg" else None)
            if alt is None:
                return None
            node.target = alt
            if kind == "arg":
                args = list(node.args)
                args[key] = ph
                node.args = tuple(args)
            else:
                node.kwargs = dict(node.kwargs, **{key: ph})
        stacked.append(lift.values)
    if dev is None:
        dev = _graph_device(g0)
    stacked = [s.to(dev) for s in stacked]
    gm = torch.fx.GraphModule(g0.gm, graph)
    return gm, stacked


def _graph_device(g) -> torch.device:
    v = g.inputs[0].meta.get("val") if g.inputs else None
    return getattr(v, "device", torch.device("cpu"))


def _unified_kernel(gm, stacked: list, single: bool):
    """The cohort kernel over a unified graph (JAX ``_unified_kernel``
    :236): per-row evaluation under ``torch.func.vmap``, each row's lifted
    constants gathered by its tag with ``index_select``."""
    def one(row, *consts):
        out = gm(row.unsqueeze(0), *consts)
        if single:
            return out[0]
        return tuple(o[0] for o in out)

    batched = torch.func.vmap(one)

    def kernel(rows, tags):
        t = tags.to(torch.int64)
        return batched(rows, *(s.index_select(0, t) for s in stacked))

    return kernel


class CohortProgram:
    """One shape cohort: the cohort kernels and what the sweep engine
    reads per instance (JAX :267).  ``instances`` keep their spec order;
    a row's tag is its local index (0..K-1), and ``global_index[i]``, the
    instance's position in the whole spec, is its namespace tag (with its
    seed), so cohort grouping never changes an instance's fingerprints."""

    def __init__(self, instances: Sequence, global_index: Sequence[int],
                 ns_bits: int, device="cpu"):
        self.instances = list(instances)
        self.global_index = [int(g) for g in global_index]
        self.K = len(self.instances)
        self.device = torch.device(device)
        self.twins = [i.model._tensor_cached() for i in self.instances]
        t0 = self.twins[0]
        self.width = int(t0.width)
        self.max_actions = int(t0.max_actions)
        self.props = list(self.instances[0].model.properties())
        self.n_props = len(self.props)
        # the namespace (fingerprint.ns_fingerprint): the low ns_bits key
        # bits carry the GLOBAL tag, a nonzero seed scrambles the high bits
        self.ns_bits = int(ns_bits)
        self.ns_low_np = np.asarray(self.global_index, np.uint64)
        self.ns_xor_np = np.asarray(
            [sweep_ns_xor(inst.seed) for inst in self.instances], np.uint64)
        self.ns_low = torch.tensor([to_i64(int(v)) for v in self.ns_low_np],
                                   dtype=torch.int64, device=self.device)
        self.ns_xor = torch.tensor([to_i64(int(v)) for v in self.ns_xor_np],
                                   dtype=torch.int64, device=self.device)
        # per-instance target (unique-count early termination); -1 = none
        self.targets_np = np.asarray(
            [-1 if inst.target is None else int(inst.target)
             for inst in self.instances], np.int64)
        self.unified = True  # False when member 0's own kernels run
        self.lifted = 0  # inputs lifted out of the captured graphs
        self._step = self._masks = None
        self._build()

    # -- kernel construction -------------------------------------------------

    def _own(self) -> None:
        t = self.twins[0]
        self._step = lambda rows, tags: t.step_rows(rows)
        self._masks = lambda rows, tags: t.property_masks(rows)

    def _build(self) -> None:
        if self.K == 1:
            # a singleton runs its twin's own kernels: the sequential program
            self._own()
            return
        from ..analysis.graph import graph_of

        unified = {}
        for name in _KERNELS:
            graphs = [graph_of(t, name, 1, self.device) for t in self.twins]
            u = unify_graphs(graphs)
            if u is None:
                raise CohortSplit(f"{name} does not unify")
            unified[name] = u
        self.lifted = sum(len(u[1]) for u in unified.values())
        if self.lifted == 0:
            # every constant is shared: the members' programs are the same
            # (a seed-only family), so member 0's own kernels serve all
            self._own()
        else:
            sgm, sst = unified["step_rows"]
            pgm, pst = unified["property_masks"]
            self._step = _unified_kernel(sgm, sst, single=False)
            self._masks = _unified_kernel(pgm, pst, single=True)
        self._verify()

    def _verify(self) -> None:
        """The build-time backstop (JAX :350): the cohort kernel must give
        each member's own kernels' outputs on that member's init rows:
        validity and property masks exactly, successors on valid lanes,
        dtypes too.  A mismatch raises :class:`CohortSplit`."""
        for tag, twin in enumerate(self.twins):
            key = self.instances[tag].key
            init = np.asarray(twin.init_rows(), np.uint64)
            rows = torch.from_numpy(init.view(np.int64).copy()).to(
                self.device)
            tags = torch.full((rows.shape[0],), tag, dtype=torch.int32,
                              device=self.device)
            succ_c, valid_c = self._step(rows, tags)
            succ_t, valid_t = twin.step_rows(rows)
            if (valid_c.dtype != valid_t.dtype
                    or not torch.equal(valid_c, valid_t)):
                raise CohortSplit(f"validity mismatch for {key!r}")
            if (succ_c.dtype != succ_t.dtype
                    or not torch.equal(succ_c[valid_t], succ_t[valid_t])):
                raise CohortSplit(f"successor mismatch for {key!r}")
            mc, mt = self._masks(rows, tags), twin.property_masks(rows)
            if mc.dtype != mt.dtype or not torch.equal(mc, mt):
                raise CohortSplit(f"property mismatch for {key!r}")

    # -- engine-facing -------------------------------------------------------

    def step_rows(self, rows, tags):
        return self._step(rows, tags)

    def property_masks(self, rows, tags):
        return self._masks(rows, tags)

    def init_data(self):
        """The members' init rows concatenated in spec order, with their
        local tags (the engine inserts them as one batch; JAX :394)."""
        rows, tags = [], []
        for t, twin in enumerate(self.twins):
            r = np.asarray(twin.init_rows(), np.uint64)
            rows.append(r)
            tags.append(np.full((r.shape[0],), t, np.int32))
        return np.concatenate(rows), np.concatenate(tags)


def build_cohorts(spec, device="cpu") -> list:
    """The spec's instances grouped into shape cohorts in order of first
    appearance (JAX :409); a group whose kernels do not unify, or fail the
    check, splits into singletons, loudly, so a sweep that runs K programs
    never passes for one."""
    ns_bits = sweep_ns_bits(len(spec.instances))
    groups: dict = {}
    order: list = []
    for gi, inst in enumerate(spec.instances):
        tensor = inst.model._tensor_cached()
        if tensor is None:
            raise TypeError(
                f"sweep instance {inst.key!r}: {type(inst.model).__name__} "
                "has no tensor twin; sweeps run on the GPU engine only")
        sig = shape_signature(inst)
        if sig not in groups:
            groups[sig] = []
            order.append(sig)
        groups[sig].append((gi, inst))
    cohorts = []
    for sig in order:
        members = groups[sig]
        insts = [i for _, i in members]
        gidx = [g for g, _ in members]
        try:
            cohorts.append(CohortProgram(insts, gidx, ns_bits, device))
        except CohortSplit as e:
            print(f"stateright-tpu-torch: sweep: {len(insts)} instances of "
                  f"{sig[0]} do not share one program ({e}); running them "
                  "separately", file=sys.stderr)
            for g, inst in members:
                c = CohortProgram([inst], [g], ns_bits, device)
                c.unified = False
                cohorts.append(c)
    return cohorts
