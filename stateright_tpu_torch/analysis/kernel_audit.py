"""Kernel audit: statically check a twin's device kernels before launch.

The port's copy of ``stateright_tpu/analysis/jaxpr_audit.py`` (rules
:13-37, driver ``run_jaxpr_audit`` :400), on the kernel captured with
``make_fx`` over ``functionalize`` (``analysis/graph.py``: on the CPU, at
batch 4, cached on the twin and shared with the sanitizer, ``.por()``
and the cost model) instead of a jaxpr.  The rule ids are JAX's:

 - ``JX000`` error -- the kernel does not capture (the exception the
   engine would hit at launch, surfaced in the preflight);
 - ``JX101`` error -- a host-synchronising operation in the graph:
   ``aten._local_scalar_dense`` (``.item()``, ``int()``, ``bool()`` of a
   tensor), ``is_nonzero`` and the data-dependent-shape operations
   (``nonzero``, ``masked_select``, ``unique``, ...).  On the card each is
   a device-to-host copy and a stream sync inside the step, the set that
   ``tests/test_torch_engine.py``'s no-host-read probe catches.  (In JAX
   the rule is a host callback; an aten graph has none, so this is what
   the rule means here);
 - ``JX102`` warning -- floating-point dataflow in ``step_rows``: rows are
   64-bit words, and a float round trip truncates them to 53 bits;
 - ``JX103`` error -- the output contract: ``step_rows`` gives
   ``int64[B, A, W]`` successors and ``bool[B, A]`` validity for the
   declared ``max_actions``/``width``, ``property_masks`` ``bool[B, P]``,
   and ``init_rows`` ``uint64[I, W]``;
 - ``JX104`` error -- two captures differ, in their graph or in a
   ``get_attr`` constant: the kernel closes over mutable host state;
 - ``JX105`` info -- data-dependent gathers and scatters (an index that is
   a tensor, not a Python int): each a random-access fetch;
 - ``JX106`` info -- per-row FLOPs and bytes of the graph (also in
   ``report.metrics``);
 - ``JX107`` warning -- an int64 row word narrowed to 32 bits or fewer
   (the word reached from the rows through shape-only operations): its
   top bits are lost.

The light and deep tiers run what JAX's ``_audit_one_kernel`` (:246) runs
in each: ``step_rows`` captured twice (the ``JX104`` diff) in both,
``property_masks`` twice only in the deep tier.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .costmodel import charge_node
from .graph import capture_fresh, dtype_of, graph_of, op_name
from .report import AuditFinding, Severity
from .sanitizer import INDEX_RANGES

# host-synchronising operations (JX101): the no-host-read probe's set and
# the other data-dependent-shape operations
HOST_SYNC_OPS = frozenset({
    "_local_scalar_dense", "item", "is_nonzero", "nonzero",
    "masked_select", "_unique", "_unique2", "unique_dim",
    "unique_consecutive", "bincount", "repeat_interleave", "nonzero_static",
    "masked_scatter", "argwhere",
})

# shape-only operations a narrowing walk looks through (JAX
# _TRANSPARENT_PRIMS)
_NARROW_THROUGH = frozenset({
    "select", "slice", "squeeze", "unsqueeze", "view", "reshape",
    "_unsafe_view", "expand", "permute", "transpose", "clone", "alias",
    "detach", "contiguous", "flip", "cat", "stack",
})


def _vals(n) -> list:
    val = n.meta.get("val")
    if isinstance(val, (tuple, list)):
        return [v for v in val if isinstance(v, torch.Tensor)]
    return [val] if isinstance(val, torch.Tensor) else []


def compute_nodes(graph) -> list:
    """The graph's operations: ``call_function`` nodes, tuple picks
    (``getitem``) left out."""
    return [n for n in graph.nodes
            if n.op == "call_function" and op_name(n) != "getitem"]


def flops_bytes(graph) -> dict:
    """Rough per-capture cost (JAX ``_flops_bytes``): the cost model's
    FLOPs per operation (``costmodel.charge_node``), and bytes as the sum
    of every output written."""
    flops = out_bytes = 0
    nodes = compute_nodes(graph)
    for n in nodes:
        c = charge_node(n)
        flops += c.flops if c is not None else 0
        out_bytes += sum(t.numel() * t.element_size() for t in _vals(n))
    return {"flops": flops, "bytes": out_bytes, "eqns": len(nodes)}


def _narrow_escape_count(graph) -> int:
    """JX107: count ``int64 -> <=32-bit integer`` conversions whose input
    is a raw row word (the rows input reached through shape-only
    operations).  A masked or shifted field extraction stays quiet."""
    rows = graph.inputs[0] if graph.inputs else None
    count = 0
    for n in compute_nodes(graph):
        if op_name(n) not in ("_to_copy", "to"):
            continue
        src = n.args[0]
        new = dtype_of(n)
        if (dtype_of(src) != torch.int64 or new is None
                or new.is_floating_point or new.is_complex
                or new == torch.bool or new.itemsize > 4):
            continue
        v = src
        for _ in range(8):
            if v is rows:
                count += 1
                break
            if (not isinstance(v, torch.fx.Node)
                    or op_name(v) not in _NARROW_THROUGH):
                break
            v = v.args[0]
            if isinstance(v, (list, tuple)):
                v = v[0] if v else None
    return count


def _index_operands(n) -> list:
    """The index operand(s) of an indexed operation (the operands whose
    being tensors makes the access data-dependent), by the sanitizer's
    table of indexed operations."""
    entry = INDEX_RANGES.get(op_name(n))
    pos = None if entry is None else (2 if entry[0] == "dim" else 1)
    if pos is None or len(n.args) <= pos:
        return []
    idx = n.args[pos]
    return list(idx) if isinstance(idx, (list, tuple)) else [idx]


def _graphs_equal(g1, g2) -> Optional[str]:
    """None when two captures are the same kernel; else what differs."""
    if g1.gm.code != g2.gm.code:
        return "graph"
    c1 = [n for n in g1.nodes if n.op == "get_attr"]
    c2 = [n for n in g2.nodes if n.op == "get_attr"]
    if len(c1) != len(c2):
        return "graph"
    for a, b in zip(c1, c2):
        va, vb = g1.const_value(a), g2.const_value(b)
        if va is None or vb is None:
            if (va is None) != (vb is None):
                return "constants"
            continue
        if va.shape != vb.shape or not np.array_equal(va, vb):
            return "constants"
    return None


def _audit_one_kernel(tensor, kernel: str, batch: int, findings: list, *,
                      retrace: bool, flag_floats: bool):
    """Capture ``kernel`` (twice when ``retrace``), run the structural
    rules and return the graph (None when it does not capture)."""
    try:
        graph = graph_of(tensor, kernel, batch)
    except Exception as e:  # noqa: BLE001 - surfaced as a finding
        findings.append(AuditFinding(
            "JX000", Severity.ERROR, kernel,
            f"kernel does not capture: {type(e).__name__}: {e}",
        ))
        return None

    if retrace:
        try:
            again = capture_fresh(tensor, kernel, batch)
        except Exception as e:  # noqa: BLE001
            findings.append(AuditFinding(
                "JX104", Severity.ERROR, kernel,
                f"kernel captured once but not twice ({type(e).__name__}: "
                f"{e}); it mutates host state while running",
            ))
            again = None
        if again is not None:
            what = _graphs_equal(graph, again)
            if what == "graph":
                findings.append(AuditFinding(
                    "JX104", Severity.ERROR, kernel,
                    "retrace instability: two captures produced different "
                    "graphs -- the kernel closes over mutable host state "
                    "(the engine recaptures at every growth, forking the "
                    "transition relation mid-run)",
                ))
            elif what == "constants":
                findings.append(AuditFinding(
                    "JX104", Severity.ERROR, kernel,
                    "retrace instability: identical graph structure but "
                    "different embedded constants -- the kernel closes "
                    "over a mutated host container",
                ))

    nodes = compute_nodes(graph)
    syncs = sorted({op_name(n) for n in nodes if op_name(n) in HOST_SYNC_OPS})
    if syncs:
        findings.append(AuditFinding(
            "JX101", Severity.ERROR, kernel,
            f"host-synchronising operations in the kernel ({', '.join(syncs)}"
            "): each reads a device value on the host, a device-to-host "
            "copy and a stream sync inside every step",
        ))

    if flag_floats:
        floats = sorted({
            op_name(n) for n in nodes
            if any(t.dtype.is_floating_point for t in _vals(n))
        })
        if floats:
            findings.append(AuditFinding(
                "JX102", Severity.WARNING, kernel,
                "floating-point dataflow in a 64-bit row kernel "
                f"({', '.join(floats)}): floats silently truncate row "
                "words past 53 bits and corrupt fingerprints",
            ))
        narrows = _narrow_escape_count(graph)
        if narrows:
            findings.append(AuditFinding(
                "JX107", Severity.WARNING, kernel,
                f"{narrows} int64->32-bit cast(s) of raw row words: the top "
                "32 bits are silently dropped, corrupting fingerprints "
                "(mask or shift the field out first -- BitPacker.get -- "
                "instead of casting whole words)",
            ))

    dyn = sum(1 for n in nodes
              if any(isinstance(i, torch.fx.Node) for i in _index_operands(n)))
    if dyn:
        findings.append(AuditFinding(
            "JX105", Severity.INFO, kernel,
            f"{dyn} data-dependent gather/scatter site(s): random-access "
            "fetches (fine if intended)",
        ))
    return graph


def run_kernel_audit(tensor, report, model=None, *, deep: bool = False,
                     batch: int = 4) -> None:
    """Audit ``tensor``'s kernels into ``report`` (findings and
    ``metrics['step_rows'|'property_masks']``; JAX ``run_jaxpr_audit``).
    Cached on the twin: respawns re-enter the preflight, and the kernels
    cannot change under a fixed twin."""
    cache = getattr(tensor, "_kernel_audit_cache", None)
    if cache is not None and cache[0] >= bool(deep):
        report.extend(cache[1])
        report.metrics.update(cache[2])
        return
    findings: list = []
    metrics: dict = {}
    _run_uncached(tensor, findings, metrics, model=model, deep=deep,
                  batch=batch)
    try:
        tensor._kernel_audit_cache = (bool(deep), tuple(findings), metrics)
    except Exception:  # noqa: BLE001 - __slots__ twins: skip caching
        pass
    report.extend(findings)
    report.metrics.update(metrics)


def _per_row(graph, batch: int) -> dict:
    m = flops_bytes(graph)
    m["flops_per_row"] = m["flops"] / batch
    m["bytes_per_row"] = m["bytes"] / batch
    return m


def _run_uncached(tensor, findings, metrics, *, model, deep, batch) -> None:
    width = getattr(tensor, "width", None)
    arity = getattr(tensor, "max_actions", None)
    if not isinstance(width, int) or not isinstance(arity, int):
        findings.append(AuditFinding(
            "JX103", Severity.ERROR, type(tensor).__name__,
            "tensor model must declare integer width/max_actions "
            f"(got width={width!r}, max_actions={arity!r})",
        ))
        return
    # init_rows first: where compiled twins build their device constants,
    # outside any capture -- and its output is part of the contract too
    try:
        init = np.asarray(tensor.init_rows())
        if init.dtype != np.uint64 or init.ndim != 2 or init.shape[1] != width:
            findings.append(AuditFinding(
                "JX103", Severity.ERROR, "init_rows",
                f"init_rows must return uint64[I, {width}], got "
                f"{init.dtype}{list(init.shape)}",
            ))
    except Exception as e:  # noqa: BLE001 - surfaced as a finding
        findings.append(AuditFinding(
            "JX000", Severity.ERROR, "init_rows",
            f"init_rows failed: {type(e).__name__}: {e}",
        ))
        return

    g = _audit_one_kernel(tensor, "step_rows", batch, findings,
                          retrace=True, flag_floats=True)
    if g is not None:
        out = [o.meta.get("val") for o in g.outputs]
        if len(out) != 2:
            findings.append(AuditFinding(
                "JX103", Severity.ERROR, "step_rows",
                f"must return (succ, valid); captured {len(out)} outputs",
            ))
        else:
            succ, valid = out
            want = (batch, arity, width)
            if (tuple(getattr(succ, "shape", ())) != want
                    or getattr(succ, "dtype", None) != torch.int64):
                findings.append(AuditFinding(
                    "JX103", Severity.ERROR, "step_rows",
                    f"successors must be int64{list(want)} (B, max_actions, "
                    f"width), got {getattr(succ, 'dtype', None)}"
                    f"{list(getattr(succ, 'shape', ()))} -- a non-int64 row "
                    "dtype corrupts fingerprints; a shape mismatch breaks "
                    "the engine's static candidate layout",
                ))
            if (tuple(getattr(valid, "shape", ())) != (batch, arity)
                    or getattr(valid, "dtype", None) != torch.bool):
                findings.append(AuditFinding(
                    "JX103", Severity.ERROR, "step_rows",
                    f"validity mask must be bool[{batch}, {arity}], got "
                    f"{getattr(valid, 'dtype', None)}"
                    f"{list(getattr(valid, 'shape', ()))}",
                ))
        m = metrics["step_rows"] = _per_row(g, batch)
        findings.append(AuditFinding(
            "JX106", Severity.INFO, "step_rows",
            "perf preflight: ~{:.0f} flops/row, ~{:.0f} intermediate "
            "bytes/row over {} operations".format(
                m["flops_per_row"], m["bytes_per_row"], m["eqns"]),
        ))

    n_props = None
    if model is not None:
        try:
            n_props = len(model.properties())
        except Exception:  # noqa: BLE001 - model may be partially built
            n_props = None
    gp = _audit_one_kernel(tensor, "property_masks", batch, findings,
                           retrace=deep, flag_floats=False)
    if gp is not None:
        out = [o.meta.get("val") for o in gp.outputs]
        o0 = out[0] if len(out) == 1 else None
        bad = (
            o0 is None or getattr(o0, "dtype", None) != torch.bool
            or len(getattr(o0, "shape", ())) != 2 or o0.shape[0] != batch
            or (n_props is not None and o0.shape[1] != n_props)
        )
        if bad:
            got = (f"{getattr(o0, 'dtype', None)}"
                   f"{list(getattr(o0, 'shape', ()))}" if o0 is not None
                   else f"{len(out)} outputs")
            want_p = n_props if n_props is not None else "P"
            findings.append(AuditFinding(
                "JX103", Severity.ERROR, "property_masks",
                f"must return bool[{batch}, {want_p}] (one column per "
                f"property, in properties() order), got {got}",
            ))
        metrics["property_masks"] = _per_row(gp, batch)
