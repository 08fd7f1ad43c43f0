"""Device-side linearizability verdicts for register histories.

The port's counterpart of ``stateright_tpu/parallel/history_tensor.py``,
cut to :func:`closure_verdict`, the verdict the paxos twin evaluates on
every popped row.  The history table codecs come with the actor compiler.

Why the reduction is exact (``put_count=1`` register workload): every
client invokes its write at start (so writes have no prerequisites and no
write→write real-time order), in-flight ops may always be left
unserialized, and each completed read R_i must sit immediately after its
dictating write W_d(i) (unique values).  A serialization therefore exists
iff some permutation π of the writes satisfies π(k) ≤ π(d(i)) for every
write k completed before R_i's invocation (plus k = i), and π(d(j)) ≤
π(d(i)) for every read R_j completed before R_i's invocation — strict edges
between distinct writes, so a valid π exists iff the edge graph is acyclic.
A completed read returning the null value is always a violation (its own
write precedes it).
"""

from __future__ import annotations

import torch


def closure_verdict(done: torch.Tensor, s: torch.Tensor,
                    rvals: torch.Tensor) -> torch.Tensor:
    """Plain-register (put_count=1, unique values) linearizability verdict
    as a write-precedence-graph acyclicity check.

    ``done``  [..., C] bool — thread i's read has completed;
    ``s``     [..., C, C] int — ops thread j had completed when thread i's
              read was invoked (diagonal ignored);
    ``rvals`` [..., C] int — value index thread i's read returned
              (0 = null/initial, 1.. = thread value), meaningful where done.
    Returns [...] bool.  O(C^3 log C) boolean work per state.
    """
    C = done.shape[-1]
    batch = done.shape[:-1]
    null_read = (done & (rvals == 0)).any(dim=-1)
    d = (rvals - 1).clamp(0, C - 1).long()  # dictating writer per read

    eye = torch.eye(C, dtype=torch.bool, device=done.device)
    d_oh = eye[d]  # [..., C, C]: d_oh[..., i, :] = one-hot of d(i)
    edges = torch.zeros(batch + (C, C), dtype=torch.bool, device=done.device)
    for i in range(C):
        di = d_oh[..., i, :]  # [..., C] target one-hot
        gate = done[..., i, None, None]
        # writes that must precede R_i: its own, plus every write
        # completed before R_i's invocation -> edge k -> d(i)
        pre = (s[..., i, :] >= 1) | eye[i]
        edges = edges | (gate & pre[..., :, None] & di[..., None, :])
        # reads completed before R_i's invocation: R_j < R_i forces
        # window order -> edge d(j) -> d(i)
        rr = (s[..., i, :] == 2) & done  # [..., C] over j
        src = (rr[..., :, None] & d_oh).any(dim=-2)  # [..., C]
        edges = edges | (gate & src[..., :, None] & di[..., None, :])
    edges = edges & ~eye  # k == d(i) cases are vacuous, not cycles

    # transitive closure by squaring; cycle <=> any diagonal entry
    reach = edges
    for _ in range(max(1, (C - 1).bit_length())):
        reach = reach | (reach[..., :, :, None] & reach[..., None, :, :]).any(
            dim=-2
        )
    cycle = (reach & eye).any(dim=-1).any(dim=-1)
    return ~(null_read | cycle)
