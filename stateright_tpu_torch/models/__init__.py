"""Models with tensor twins (``stateright_tpu/models/`` counterparts).
``__all__`` lists the model modules, each with an ``_audit_models`` hook:
the fleet audit (``python -m stateright_tpu_torch.models._cli audit``)
covers every one."""

__all__ = [
    "two_phase_commit",
    "paxos",
    "linearizable_register",
    "single_copy_register",
    "write_once_register",
    "increment",
    "increment_lock",
    "raft",
    "dining",
    "quickstart",
    "orl",
]
