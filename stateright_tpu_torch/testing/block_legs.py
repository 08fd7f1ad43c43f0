"""The block graph's legs (``ops/block_loop.py``), shared by the card tests
(``tests/test_torch_gpu.py``), the CPU tests
(``tests/test_torch_block_loop.py``), ``chip_smoke.py``'s ``block_graph``
phase and ``profile_run.py``.

:data:`BLOCK_LEGS` runs every flag of the single-device engine and the
four stops beside the empty queue: a growth (the caller's capacities), a
discovery (:func:`abort_only`), the target (:data:`BLOCK_TARGET`) and a
failed check.  :class:`OpCount` counts the operations PyTorch dispatches,
the host's issue of a block.
"""

from __future__ import annotations

from torch.utils._python_dispatch import TorchDispatchMode

from ..models.paxos import paxos_model
from ..models.two_phase_commit import TwoPhaseSys

BLOCK_TARGET = 3_000  # the target stop's bound
BLOCK_SPILL_BLOOM = 1 << 14  # the spill leg's Bloom bits


class OpCount(TorchDispatchMode):
    """The operations PyTorch dispatches while the mode is on (``n``)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


class FirstColumnTwin:
    """A twin whose property masks keep their first column (a slice: an
    index list would copy host data to the device each step, which a CUDA
    graph cannot capture)."""

    def __init__(self, twin):
        self._twin = twin

    def __getattr__(self, name):
        return getattr(self._twin, name)

    def property_masks(self, rows):
        return self._twin.property_masks(rows)[:, :1]


def abort_only(model):
    """``model`` (either package's 2pc) with only its "abort agreement"
    property, so a run stops once it is discovered, long before its queue
    empties; the port's twin gives that mask column only.  Its checker
    needs ``skip_audit()``: the audit checks the mask columns against the
    model's full list."""
    props = model.properties()
    assert props[0].name == "abort agreement"
    twin = model.tensor_model()
    model.properties = lambda: props[:1]
    if isinstance(model, TwoPhaseSys):
        model.tensor_model = lambda: FirstColumnTwin(twin)
    return model


def per_channel_paxos(n: int):
    """Paxos over ``n`` clients on per-channel (FIFO) links."""
    m = paxos_model(n)
    m.per_channel_()
    return m


# leg: (builder, spawn_gpu arguments)
BLOCK_LEGS = {
    "2pc5": (lambda: TwoPhaseSys(5).checker(), {}),
    "paxos2": (lambda: paxos_model(2).checker(), {}),
    "2pc4_symmetry": (lambda: TwoPhaseSys(4).checker().symmetry(), {}),
    "2pc5_prededup": (lambda: TwoPhaseSys(5).checker().prededup(), {}),
    "2pc5_cartography": (lambda: TwoPhaseSys(5).checker().cartography(), {}),
    "2pc5_checked": (lambda: TwoPhaseSys(5).checker().checked(), {}),
    "2pc5_spill": (lambda: TwoPhaseSys(5).checker().spill(),
                   dict(spill_bloom_bits=BLOCK_SPILL_BLOOM)),
    "paxos1_per_channel_por": (lambda: per_channel_paxos(1).checker().por(),
                               {}),
    "2pc5_target": (lambda: TwoPhaseSys(5).checker().target_states(
        BLOCK_TARGET), {}),
    "2pc5_discovery": (lambda: abort_only(TwoPhaseSys(5)).checker()
                       .skip_audit(), {}),
}
