"""Worker for the port's multi-controller sharded-engine test.

Launched as ``python torch_multihost_worker.py <rank> <ranks> <port>`` by
``tests/test_torch_multihost.py``: each process joins a ``gloo`` process
group on ``tcp://localhost:<port>`` and holds 4 of the run's shards on the
CPU, so two processes run one 8-shard engine (the port's form of
``tests/multihost_worker.py``, one process per card).  Every process runs
the same program: the host loop reads only replicated values, so the
ranks make the same decisions in lockstep, and the final table is
all-gathered so each rank rebuilds the same discovery paths.  Imports
neither ``jax`` nor ``stateright_tpu``.
"""

import hashlib
import json
import os
import sys


def main() -> int:
    rank, ranks, port = (int(a) for a in sys.argv[1:4])
    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=ranks, rank=rank)
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    ndev = 4 * ranks
    c = TwoPhaseSys(3).checker().spawn_gpu(
        devices=ndev, device="cpu", sync=True, capacity=1 << 13,
        frontier_capacity=1 << 9)
    assert c.unique_state_count() == 288, c.unique_state_count()
    assert c.state_count() == 1146, c.state_count()
    discs = c.discoveries()
    assert set(discs) == {"abort agreement", "commit agreement"}, discs
    # each rank rebuilds whole paths from its all-gathered table
    for name, path in discs.items():
        c.assert_discovery(name, list(path.actions()))
    print(f"torch-multihost-worker-ok r{rank}: unique=288 "
          f"discoveries={sorted(discs)}", flush=True)

    # lockstep growth: capacities that overflow mid-run, so every rank
    # grows its own shards at the same boundary
    g = TwoPhaseSys(3).checker().cartography().spawn_gpu(
        devices=ndev, device="cpu", sync=True, capacity=1 << 7,
        frontier_capacity=1 << 5)
    assert g.unique_state_count() == 288, g.unique_state_count()
    assert len(g.growth_events) >= 1, g.growth_events
    uniq = [u for _, u in g.growth_events]
    assert uniq == sorted(uniq), uniq
    assert set(g.discoveries()) == {"abort agreement", "commit agreement"}
    print(f"torch-multihost-growth-ok r{rank}: unique=288 "
          f"growth_events={g.growth_events}", flush=True)
    # POR: the owners' novelty goes back along the route (the reverse
    # all_to_all) before the proviso's second round
    from stateright_tpu_torch.testing.por_fixtures import ToggleSys

    t = ToggleSys().checker().por().spawn_gpu(devices=2 * ranks,
                                              device="cpu", sync=True)
    # what the caller holds against a one-controller run of the same specs
    tfp, tpl = g._table_np()
    pfp, ppl = t._table_np()
    print("torch-multihost-result " + json.dumps({
        "rank": rank, "growth_events": g.growth_events,
        "table": hashlib.sha256(tfp.tobytes() + tpl.tobytes()).hexdigest(),
        "cartography": g.cartography(),
        "por": [t.unique_state_count(), t.state_count(), t.por_status(),
                hashlib.sha256(pfp.tobytes() + ppl.tobytes()).hexdigest()],
        }), flush=True)
    # the controls a multi-controller run refuses, with JAX's words
    for what, call in (("checkpoint()", c.checkpoint), ("stop()", c.stop)):
        try:
            call()
        except NotImplementedError as e:
            assert what in str(e), e
        else:
            raise AssertionError(f"{what} was not refused")
    print(f"torch-multihost-fences-ok r{rank}", flush=True)
    bad = [m for m in sys.modules
           if m == "jax" or m.startswith(("jax.", "stateright_tpu."))
           or m == "stateright_tpu"]
    assert not bad, bad
    print(f"torch-multihost-isolated r{rank}", flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
