"""The mesh engine's placement decisions: the mesh, the env knob and the
partition rules.

The port's counterpart of ``stateright_tpu/parallel/partition.py``, with
JAX's names; ``parallel/mesh.py`` applies what this module decides:

 - :data:`MESH_AXES`, the ``('host', 'chip')`` axis pair.  The port's
   mesh is one host row of ``D`` pieces (the mesh engine is
   single-controller, as JAX's: its multi-controller form is the sharded
   engine's, ``parallel/sharded.py``);
 - :func:`build_mesh`, the one constructor the checker and the tests use,
   and :class:`Mesh`, a list of ``torch.device``, one per piece.  Pieces
   may share a device: the tests run 8 pieces on the CPU, and a one-card
   machine runs ``D`` pieces on ``cuda:0``;
 - :func:`match_partition_rules`, the regex-rule matcher (first match
   wins) with JAX's two guards: a rank-0 buffer stays whole, and a
   dimension that the mesh's size does not divide stays whole (on the
   lead device, ``devices[0]``; correctness never depends on a buffer
   being in pieces);
 - :data:`WAVEFRONT_CARRY_RULES`, the rule table of the wavefront carry:
   the visited table in pieces of whole buckets, the queue buffers in
   pieces of rows, every counter, flag and tail whole.

JAX's version-compatibility shims (``has_vma_collectives``,
``engine_requires_collectives`` and the ``shard_map`` import, JAX
:57-86) have no PyTorch meaning: the port's mesh engine issues no
collective and no ``shard_map`` exists here, so they are left out.
"""

from __future__ import annotations

import os
import re
import sys
from typing import NamedTuple, Optional, Sequence

import torch

MESH_AXES = ("host", "chip")
# a placement spec is one entry per dimension: the mesh axes the dimension
# is split over, or None for a dimension held whole; () is "all whole"
PIECES = (MESH_AXES,)
WHOLE = ()
# the pieces of a CPU mesh when no count is given: the JAX suite's 8
# virtual host devices, which JAX's default mesh spans there
CPU_MESH_DEVICES = 8

ENV_MESH = "STATERIGHT_TPU_MESH"


def resolve_mesh_flag(mode, devices):
    """Resolve the mesh-engine request: ``(enabled, devices)``.  An
    explicit builder setting wins (``CheckerBuilder.mesh()``); otherwise
    the ``STATERIGHT_TPU_MESH`` env knob: ``1`` arms the engine over every
    visible device, an integer ``N > 1`` bounds it to ``N`` pieces, ``0``
    or unset leaves it off.  Anything else warns loudly and is ignored: a
    typo'd knob must never pass for "the mesh engine buys nothing"."""
    if mode is not None:
        return bool(mode), devices
    raw = os.environ.get(ENV_MESH, "")
    if raw in ("", "0"):
        return False, None
    if raw == "1":
        return True, None
    try:
        n = int(raw)
        if n > 1:
            return True, n
    except ValueError:
        pass
    print(
        f"stateright-tpu-torch: ignoring malformed {ENV_MESH}={raw!r} "
        "(expected 1, 0, or a device count > 1)",
        file=sys.stderr,
    )
    return False, None


class Mesh:
    """A one-row ``('host', 'chip')`` mesh: ``devices[k]`` holds piece
    ``k`` of every buffer the rules split; ``devices[0]`` is the lead
    device, which holds every buffer kept whole."""

    def __init__(self, devices: Sequence):
        self.devices = [_device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.shape = {"host": 1, "chip": len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def build_mesh(n_devices: Optional[int] = None, devices=None,
               device=None) -> Mesh:
    """The mesh the engine places its buffers over.

    An explicit ``devices`` sequence wins outright and may repeat a device
    (the tests' ``["cpu"] * 8``; a one-card machine's ``["cuda:0"] * 4``).
    Otherwise the platform is ``device`` (default ``cuda``): on ``cuda``
    the mesh is the first ``n_devices`` visible cards (all of them when
    unset), and asking for more than are visible raises JAX's
    ``ValueError``; on the CPU any count is allowed (default
    :data:`CPU_MESH_DEVICES`), as JAX's forced host device count allows
    it in JAX's tests."""
    if devices is not None:
        return Mesh(list(devices))
    platform = torch.device(device if device is not None else "cuda")
    if platform.type == "cpu":
        n = CPU_MESH_DEVICES if n_devices is None else int(n_devices)
        return Mesh([platform] * n)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "mesh(): no CUDA device is available (the port never falls "
            "back to the CPU; pass device='cpu' to run the plain PyTorch "
            "path)"
        )
    visible = torch.cuda.device_count()
    n = visible if n_devices is None else int(n_devices)
    if n > visible:
        raise ValueError(
            f"mesh engine asked for {n_devices} devices but only "
            f"{visible} are visible (pass devices=[...] to place several "
            "pieces on one device)"
        )
    return Mesh([torch.device("cuda", i) for i in range(n)])


class Placement(NamedTuple):
    """Where one buffer lives: ``spec`` names the mesh axes each dimension
    is split over (JAX's ``NamedSharding(mesh, PartitionSpec)``)."""

    mesh: Mesh
    spec: tuple

    @property
    def pieces(self) -> bool:
        """Is the buffer held as ``mesh.size`` row pieces (dimension 0
        split), rather than whole on the lead device?"""
        return bool(self.spec) and self.spec[0] is not None


def replicated(mesh: Mesh) -> Placement:
    """The whole placement (counters, flags, packed stats): on the lead
    device."""
    return Placement(mesh, WHOLE)


# First match wins (the match_partition_rules contract).  The visited
# table goes in pieces of whole buckets; queue buffers in pieces of rows;
# the catch-all keeps counters, discovery fingerprints, status and error
# words and every optional tail (POR, cartography) whole.
WAVEFRONT_CARRY_RULES = (
    (r"^table_", PIECES),
    (r"^q_", PIECES),
    (r".*", WHOLE),
)


def match_partition_rules(rules, names: Sequence[str], shapes,
                          mesh: Mesh) -> tuple:
    """Resolve one :class:`Placement` per named buffer of the given
    shapes (tuples).

    ``rules`` is a sequence of ``(pattern, spec)`` pairs; the first
    pattern that ``re.search``-matches a buffer's name decides its spec (a
    name no rule matches is an error: rule tables end with a catch-all on
    purpose, so a miss means the table and the carry layout drifted
    apart).  Two guards override any matched spec:

     - rank-0 buffers stay whole (nothing to split);
     - a dimension whose size the product of the spec's mesh axes does not
       divide stays whole, which is always semantically equivalent.
    """
    out = []
    for name, shape in zip(names, shapes):
        spec = None
        for pat, rule_spec in rules:
            if re.search(pat, name):
                spec = rule_spec
                break
        if spec is None:
            raise ValueError(
                f"no partition rule matches carry buffer {name!r} — the "
                "rule table and the carry layout drifted apart"
            )
        shape = tuple(shape)
        if not shape:
            spec = WHOLE
        else:
            parts = list(spec)
            for dim, axes in enumerate(parts):
                if axes is None:
                    continue
                axis_names = (axes,) if isinstance(axes, str) else tuple(axes)
                size = 1
                for a in axis_names:
                    size *= mesh.shape[a]
                if dim >= len(shape) or shape[dim] % size != 0:
                    parts[dim] = None
            spec = tuple(parts)
        out.append(Placement(mesh, spec))
    return tuple(out)


# Wavefront carry buffer names, in carry order (the snapshot keys, then
# the optional tails in CarryLayout's order).  The mesh engine derives the
# names from the same flags it builds the carry with, so the two cannot
# disagree in length without tripping the zip in match_partition_rules.
_BASE_CARRY_NAMES = (
    "table_fp", "table_parent", "q_rows", "q_fp", "q_ebits",
    "q_depth", "head", "tail", "unique", "scount", "disc", "maxdepth",
    "status",
)

_SPILL_TAIL_NAMES = (
    "spill_bloom", "spill_base", "spill_pend_fp", "spill_pend_rows",
    "spill_pend_par", "spill_pend_ebt", "spill_pend_dep",
    "spill_pend_n", "spill_stats",
)


def wavefront_carry_names(n_total: int, *, checked: bool = False,
                          por: bool = False, spill: bool = False) -> tuple:
    """Names for an ``n_total``-element wavefront carry built with these
    feature flags (the cartography counter tail, whatever its length,
    fills the remainder: it is whole either way)."""
    names = list(_BASE_CARRY_NAMES)
    if checked:
        names.append("err")
    if por:
        names += ["por_boost", "por_stats"]
    if spill:
        names += list(_SPILL_TAIL_NAMES)
    if len(names) > n_total:
        raise ValueError(
            f"carry has {n_total} buffers but the flags imply at least "
            f"{len(names)} — feature flags and carry layout disagree"
        )
    names += [f"cart_{i}" for i in range(n_total - len(names))]
    return tuple(names)
