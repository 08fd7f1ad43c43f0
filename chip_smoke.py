"""Chip smoke test of the PyTorch/CUDA port (``stateright_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``stateright_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card at the shapes the
2pc-7 run gives it (integer outputs: they must be equal), times both, and
drives the port's main path through the user's entry point,
``TwoPhaseSys(n).checker().spawn_gpu()``:

 - 2pc-5 on ``cuda`` and on ``cpu`` in one process: 8,832 unique and
   identical visited-table bytes on both devices;
 - 2pc-7, complete: 296,448 unique, both agreement discoveries replayed
   through the object model, ``consistent`` never violated, and every
   kernel launched (each wrapper counts its launches; the counts are reset
   just before this run and read just after it);
 - 2pc-10, bounded by ``target_states``: the visited table in the
   hundreds of MB, discoveries replayed, peak device memory.

Any failure raises (non-zero exit).  The second-to-last line of standard
output is the ``{"kernels": [...]}`` record and the last line is
``{"ok": true, "device": {...}}``.  Everything printed is also written to
``chiprun_out/chip_smoke.json``.  Exits non-zero without a result when no
CUDA device is available.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from stateright_tpu_torch import convert
from stateright_tpu_torch.ops import _cuda
from stateright_tpu_torch.ops.buckets import (
    SLOTS,
    bucket_probe,
    bucket_probe_plain,
    plan_writes,
    sort_candidates,
)
from stateright_tpu_torch.ops.hashing import EMPTY, row_hash, row_hash_plain
from stateright_tpu_torch.ops.insert_write import insert_write, insert_write_plain
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
# the card's non-tensor-core rate (67 TFLOP/s fp32), standing in for its
# integer rate, which the data sheet does not list
OPS_PER_S = 67e12
TPC10_TARGET = 4_000_000
OUT = Path("chiprun_out/chip_smoke.json")
RECORD: dict = {}


def emit(key: str, value) -> None:
    RECORD[key] = value
    print(json.dumps({key: value}), flush=True)


def time_ms(fn, iters: int = 100, warmup: int = 5) -> float:
    """Mean milliseconds per call, by CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20) -> float:
    """Mean milliseconds of DEVICE time per call (every kernel and copy the
    call enqueues, summed), from ``torch.profiler``: unlike :func:`time_ms`
    it leaves out the gaps while the host issues the next launch."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages())
    return total_us / 1e3 / iters


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_launches() -> dict:
    return {
        "insert_write": insert_write.launches,
        "row_hash": row_hash.launches,
        "bucket_probe": bucket_probe.launches,
    }


def reset_launches() -> None:
    insert_write.launches = row_hash.launches = bucket_probe.launches = 0


def check_discoveries(model, checker, expect: set) -> dict:
    """Every discovery path replays through the object model (the
    reconstruction re-executes it) and ends in a state that satisfies its
    property; ``consistent`` is never violated."""
    paths = checker.discoveries()
    if set(paths) != expect:
        raise AssertionError(f"discoveries {sorted(paths)} != {sorted(expect)}")
    for name, path in paths.items():
        if not model.property_by_name(name).condition(model, path.final_state()):
            raise AssertionError(f"{name}: replayed path does not satisfy it")
    return {name: len(path) for name, path in paths.items()}


def timed_run(n: int, target=None, **kw):
    builder = TwoPhaseSys(n).checker()
    if target is not None:
        builder = builder.target_states(target)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    checker = builder.spawn_gpu(**kw).join()
    torch.cuda.synchronize()
    return checker, time.monotonic() - t0


def kernel_inputs(dev):
    """Real 2pc-7 mid-run inputs for the three kernels: a run bounded at
    100,000 unique states, then the next batch popped from its queue and
    pushed through the insert's plain stages up to each kernel."""
    checker, _ = timed_run(7, target=100_000, device=dev)
    snap = checker.final_snapshot()
    carry = convert.carry_from_snapshot(snap, dev)
    head, tail = int(snap["head"]), int(snap["tail"])
    batch, cand = checker._batch, checker._cand
    if tail - head < batch:
        raise AssertionError("bounded run left less than one batch queued")
    rows = carry[convert.QROWS][head:head + batch]
    succ, valid = checker.tensor.step_rows(rows)
    m = succ.shape[0] * succ.shape[1]
    crows, cvalid = succ.reshape(m, -1), valid.reshape(m)
    cfp = row_hash_plain(crows, cvalid)
    cpar = carry[convert.QFP][head:head + batch][:, None].expand(
        batch, checker.tensor.max_actions).reshape(m)
    tfp, tpl = carry[convert.TFP], carry[convert.TPL]
    sfp, spl, bucket, _order, _cidx, cov = sort_candidates(
        cfp, cpar, tfp.shape[0] // SLOTS, compact=min(cand, m)
    )
    present, base = bucket_probe_plain(tfp, sfp, bucket)
    tgt, wfp, wpl, _perm, n_new, ovf = plan_writes(
        sfp, spl, bucket, present, base, tfp.shape[0], cov
    )
    if int(n_new) == 0:
        raise AssertionError(f"captured batch wrote nothing (overflow={bool(ovf)}, "
                             f"cand_overflow={bool(cov)})")
    return dict(crows=crows, cvalid=cvalid, tfp=tfp, tpl=tpl, sfp=sfp,
                bucket=bucket, tgt=tgt, wfp=wfp, wpl=wpl, n_new=n_new)


def check_kernels(dev) -> list:
    x = kernel_inputs(dev)
    out = []

    # -- B: row_hash over the batch's B*A successor rows ---------------------
    rows, valid = x["crows"], x["cvalid"]
    got, want = row_hash(rows, valid), row_hash_plain(rows, valid)
    n, w = rows.shape
    nv = int(valid.sum())
    # every lane reads its valid byte and writes its fingerprint; only the
    # valid lanes read their row (invalid ones return before it)
    b_ms, b_by = bound(nv * w * 8 + n + n * 8, nv * (w + 1) * 10)
    out.append(dict(
        name="row_hash", route="cuda",
        source="stateright_tpu_torch/csrc/row_hash.cu",
        replaces="stateright_tpu/ops/hashing.py:105",
        shape=f"rows int64[{n}, {w}], {nv} valid",
        matched=bool(torch.equal(got, want)),
        max_abs_err=int((got != want).sum()),
        ms=time_ms(lambda: row_hash(rows, valid)),
        plain_ms=time_ms(lambda: row_hash_plain(rows, valid)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    ))

    # -- C: bucket_probe over the sorted candidate budget --------------------
    tfp, sfp, bucket = x["tfp"], x["sfp"], x["bucket"]
    gp, gb = bucket_probe(tfp, sfp, bucket)
    wp, wb = bucket_probe_plain(tfp, sfp, bucket)
    m = sfp.shape[0]
    live = sfp != EMPTY
    lines = int(torch.unique(bucket[live]).numel())
    nlive = int(live.sum())
    # every lane reads its fingerprint and writes 5 bytes; only live lanes
    # read their bucket index, and each distinct line is read once
    c_ms, c_by = bound(m * 8 + nlive * 8 + lines * SLOTS * 8 + m * 5,
                       nlive * SLOTS * 2)
    out.append(dict(
        name="bucket_probe", route="cuda",
        source="stateright_tpu_torch/csrc/bucket_probe.cu",
        replaces="stateright_tpu/ops/buckets.py:229",
        shape=f"cand {m} ({nlive} valid, {lines} lines), table {tfp.shape[0]} slots",
        matched=bool(torch.equal(gp, wp) and torch.equal(gb, wb)),
        max_abs_err=int((gb - wb).abs().max()) + int((gp != wp).sum()),
        ms=time_ms(lambda: bucket_probe(tfp, sfp, bucket)),
        plain_ms=time_ms(lambda: bucket_probe_plain(tfp, sfp, bucket)),
        bound_ms=c_ms, bound_by=c_by, library_ms=None,
    ))

    # -- A: insert_write of the batch's novel candidates ---------------------
    tpl, tgt, wfp, wpl, n_new = x["tpl"], x["tgt"], x["wfp"], x["wpl"], x["n_new"]
    ka, kb = tfp.clone(), tpl.clone()
    pa, pb = tfp.clone(), tpl.clone()
    insert_write(ka, kb, tgt, wfp, wpl, n_new)
    insert_write_plain(pa, pb, tgt, wfp, wpl, n_new)
    nn = int(n_new)
    t, f, p = tgt[:nn], wfp[:nn], wpl[:nn]

    def library():
        pa.index_put_((t,), f)
        pb.index_put_((t,), p)

    a_ms, a_by = bound(nn * 24 + nn * 16 + 8, 0)
    out.append(dict(
        name="insert_write", route="cuda",
        source="stateright_tpu_torch/csrc/insert_write.cu",
        replaces="stateright_tpu/ops/pallas_insert.py:85",
        shape=f"cand {tgt.shape[0]}, n_new {nn}, table {tfp.shape[0]} slots",
        matched=bool(torch.equal(ka, pa) and torch.equal(kb, pb)),
        max_abs_err=int((ka != pa).sum() + (kb != pb).sum()),
        ms=time_ms(lambda: insert_write(ka, kb, tgt, wfp, wpl, n_new)),
        plain_ms=time_ms(lambda: insert_write_plain(pa, pb, tgt, wfp, wpl, n_new)),
        bound_ms=a_ms, bound_by=a_by, library_ms=time_ms(library),
    ))
    for k, fns in zip(out, (
        (lambda: row_hash(rows, valid), lambda: row_hash_plain(rows, valid),
         None),
        (lambda: bucket_probe(tfp, sfp, bucket),
         lambda: bucket_probe_plain(tfp, sfp, bucket), None),
        (lambda: insert_write(ka, kb, tgt, wfp, wpl, n_new),
         lambda: insert_write_plain(pa, pb, tgt, wfp, wpl, n_new), library),
    )):
        k["device_ms"], k["plain_device_ms"] = device_ms(fns[0]), device_ms(fns[1])
        k["library_device_ms"] = None if fns[2] is None else device_ms(fns[2])
    for k in out:
        k["kernel_ms"] = k["ms"]
        emit(f"kernel_{k['name']}", k)
        if not k["matched"]:
            raise AssertionError(f"{k['name']}: kernel disagrees with plain")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    emit("card", {"nvidia_smi": smi, "torch": torch.__version__,
                  "cuda": torch.version.cuda,
                  "name": torch.cuda.get_device_name(0)})
    t0 = time.monotonic()
    _cuda.library()
    emit("build", {"seconds": time.monotonic() - t0,
                   "sources": [str(s.relative_to(_cuda.CSRC.parent.parent))
                               for s in _cuda.sources()]})

    kernels = check_kernels(dev)

    # -- 2pc-5 on cuda and cpu: same counts, same table bytes ---------------
    g5, g5_s = timed_run(5)
    c5 = TwoPhaseSys(5).checker().spawn_gpu(device="cpu").join()
    gt, ct = g5._table_np(), c5._table_np()
    same = all((a == b).all() and a.shape == b.shape for a, b in zip(gt, ct))
    emit("2pc5", {"unique_cuda": g5.unique_state_count(),
                  "unique_cpu": c5.unique_state_count(),
                  "states": g5.state_count(), "table_slots": int(gt[0].size),
                  "tables_identical": bool(same), "sec_cuda": g5_s})
    if not (same and g5.unique_state_count() == c5.unique_state_count() == 8832):
        raise AssertionError("2pc-5: cuda and cpu disagree")

    # -- 2pc-7, complete: the main path's launch counts ----------------------
    reset_launches()
    g7, g7_s = timed_run(7)
    launches = kernel_launches()
    model7 = g7.model
    paths = check_discoveries(
        model7, g7, {"abort agreement", "commit agreement"}
    )
    g7.assert_properties()
    emit("2pc7", {"unique": g7.unique_state_count(),
                  "states": g7.state_count(), "depth": g7.max_depth(),
                  "sec": g7_s, "states_per_sec": g7.state_count() / g7_s,
                  "unique_per_sec": g7.unique_state_count() / g7_s,
                  "table_slots": g7._cap, "cand": g7._cand,
                  "growth_events": g7.growth_events,
                  "path_lengths": paths, "launches": launches,
                  "card": smi})
    if g7.unique_state_count() != 296_448:
        raise AssertionError("2pc-7: unique count is not 296,448")
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"a kernel never launched on 2pc-7: {launches}")

    # -- 2pc-10, target-bounded ----------------------------------------------
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    g10, g10_s = timed_run(10, target=TPC10_TARGET)
    peak = torch.cuda.max_memory_allocated(dev)
    paths10 = check_discoveries(g10.model, g10, set(g10.discovery_fps()))
    emit("2pc10", {"target": TPC10_TARGET, "unique": g10.unique_state_count(),
                   "states": g10.state_count(), "depth": g10.max_depth(),
                   "sec": g10_s, "states_per_sec": g10.state_count() / g10_s,
                   "unique_per_sec": g10.unique_state_count() / g10_s,
                   "table_slots": g10._cap,
                   "table_mib": g10._cap * 16 / 2**20,
                   "peak_device_mib": peak / 2**20, "cand": g10._cand,
                   "discoveries": paths10, "launches": kernel_launches(),
                   "card": smi})
    if g10.unique_state_count() < TPC10_TARGET:
        raise AssertionError("2pc-10: stopped short of the target")
    if "consistent" in paths10:
        raise AssertionError("2pc-10: consistent violated")

    for k in kernels:
        k["launches"] = launches[k["name"]]
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(RECORD, indent=1))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "matched",
            "kernel_ms")
    print(json.dumps({"kernels": [{k: d[k] for k in keys} for d in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
