"""A/B walls of the port's main-path legs on the card, this tree against
another tree of the port.

    python3 walls_ab.py --against _archive/parent

Runs the legs below once in each of eight processes, in the order this,
other, other, this, twice (``PAIRS``); each process imports the package
of its own tree (only the models and the builder, so any tree of the port
serves) and builds its kernels with a 2pc-3 run before the first leg:

 - ``2pc-7``: ``TwoPhaseSys(7).checker().spawn_gpu()``, complete;
 - ``2pc-10``: ``TwoPhaseSys(10)``, bounded at 4,000,000 unique (as
   ``chip_smoke.py``'s leg);
 - ``paxos-3``: ``paxos_model(3)``, complete;
 - ``single-copy-4``: ``single_copy_model(4)``, complete;
 - ``per-channel paxos-2``: ``paxos_model(2).per_channel_()`` at
   ``capacity=1 << 16, batch=512``, complete;
 - ``2pc-15 symmetry``: ``TwoPhaseSys(15).checker().symmetry()``, complete.

Each leg's wall is from ``spawn_gpu()`` to ``join()``, the device
synchronised at both ends; beside it the leg's states/s, its steps
(blocks times ``steps_per_call``), the steps it executed and its block
graphs' capture seconds (a tree without the block graph has neither) and
its peak device memory (the peak counter reset before the leg).  Prints
one JSON line per process and each leg's walls by tree, with each tree's
median; writes ``chiprun_out/walls_ab.json``.  Needs a CUDA device and
``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
OUT = Path("chiprun_out/walls_ab.json")
TPC10_TARGET = 4_000_000
# alternated pairs of this, other, other, this: four walls a leg and tree
PAIRS = 2


def legs() -> dict:
    """Runs the legs with the package on ``sys.path``; ``{leg: record}``."""
    import torch

    from stateright_tpu_torch.models.paxos import paxos_model
    from stateright_tpu_torch.models.single_copy_register import (
        single_copy_model,
    )
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    def per_channel_paxos2():
        m = paxos_model(2)
        m.per_channel_()
        return m.checker()

    # leg: (builder, spawn_gpu arguments)
    runs = {
        "2pc-7": (lambda: TwoPhaseSys(7).checker(), {}),
        "2pc-10": (lambda: TwoPhaseSys(10).checker().target_states(
            TPC10_TARGET), {}),
        "paxos-3": (lambda: paxos_model(3).checker(), {}),
        "single-copy-4": (lambda: single_copy_model(4).checker(), {}),
        "per-channel paxos-2": (per_channel_paxos2,
                                dict(capacity=1 << 16, batch=512)),
        "2pc-15 symmetry": (lambda: TwoPhaseSys(15).checker().symmetry(),
                            {}),
    }
    TwoPhaseSys(3).checker().spawn_gpu().join()
    out = {}
    for leg, (builder, kw) in runs.items():
        b = builder()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        c = b.spawn_gpu(**kw).join()
        torch.cuda.synchronize()
        sec = time.monotonic() - t0
        graphs = getattr(c, "block_graphs", None)
        out[leg] = {"sec": sec, "unique": c.unique_state_count(),
                    "states": c.state_count(),
                    "states_per_sec": c.state_count() / sec,
                    "steps": c.steps_run,
                    "steps_executed": getattr(c, "steps_executed", None),
                    "capture_secs": (sum(g["capture_secs"] + g["warm_secs"]
                                         + g["instantiate_secs"]
                                         for g in graphs)
                                     if graphs else None),
                    "graphs": ([{k: g[k] for k in (
                        "cap", "qcap", "cand", "warm_secs", "capture_secs",
                        "instantiate_secs", "nodes", "pool_bytes")}
                        for g in graphs] if graphs else None),
                    "peak_device_bytes": torch.cuda.max_memory_allocated()}
        del c
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path)
    ap.add_argument("--tree", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tree is not None:  # one process: the legs of one tree
        sys.path[0] = str(args.tree.resolve())
        print(json.dumps(legs()))
        return 0
    import torch

    if not torch.cuda.is_available() or args.against is None:
        print("walls_ab: needs a CUDA device and --against", file=sys.stderr)
        return 2
    trees = {"this": HERE, "against": args.against.resolve()}
    runs = []
    for name in ("this", "against", "against", "this") * PAIRS:
        t0 = time.monotonic()
        p = subprocess.run([sys.executable, __file__, "--tree",
                            str(trees[name])], capture_output=True,
                           text=True, cwd=trees[name])
        if p.returncode:
            print(p.stdout, p.stderr[-4000:], file=sys.stderr)
            return 1
        rec = {"tree": name, "process_sec": time.monotonic() - t0,
               "legs": json.loads(p.stdout.strip().splitlines()[-1])}
        print(json.dumps(rec), flush=True)
        runs.append(rec)
    walls = {leg: {name: [r["legs"][leg]["sec"] for r in runs
                          if r["tree"] == name] for name in trees}
             for leg in runs[0]["legs"]}
    medians = {leg: {name: statistics.median(w) for name, w in ws.items()}
               for leg, ws in walls.items()}
    same = all(r["legs"][leg]["unique"] == runs[0]["legs"][leg]["unique"]
               for r in runs for leg in walls)
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps({"card": torch.cuda.get_device_name(0),
                               "runs": runs, "walls": walls,
                               "medians": medians}, indent=1))
    print(json.dumps({"walls": walls, "medians": medians,
                      "same_unique": same}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
