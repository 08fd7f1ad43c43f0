"""A/B times of the insert's hand-written kernels on the card.

    python3 kernel_ab.py --against _archive/parent/stateright_tpu_torch/csrc

Builds ``csrc/bucket_plan.cu``, ``csrc/cand_prep.cu`` and
``csrc/insert_commit.cu`` of this tree and of each ``--against`` directory
(another tree's ``csrc``: a parent commit unpacked with ``git archive``,
or a copy of this one with a design choice changed), each into a library
of its own.  Then it takes the next batch of each of
``chip_smoke.py``'s six main kernel cells (2pc-7 L2-warm; 2pc-10, paxos-3,
single-copy-4, per-channel paxos-2 and 2pc-15 under symmetry L2-cold),
and two cells of ``insert_commit`` alone: the paxos-3 spill inject's shape
(``INJECT_LANES`` plan lanes, the paxos-3 batch's first ``INJECT_NOVEL``
novel rows as pending rows of arity 1, in a seeded order; L2-cold) and
the mesh step's window append (2pc-7 on 4 pieces at 100,000, the queue
piece that takes the tail; L2-warm).  It times, from every library in
turns (A, B, ..., B, A), each held against its plain version:

 - ``cand_prep``;
 - ``bucket_plan``: the pre-gathered entry on sorted lanes gathered
   beforehand;
 - ``composition``: what a step ran before the fused entry, the sort's
   tail (``fp[order]``, ``payload[order]``, the buckets of the sorted
   keys) and the pre-gathered launch;
 - ``bucket_plan_fused``: the fused entry (where the library has it);
 - ``insert_commit`` with the queue half (``insert_commit_window`` in the
   mesh cell), each library on a fresh copy of the table and the queue.

Beside the commit, before and after the libraries, it times the PyTorch
composition of the same function with ``n_new`` and the tail known on the
host (``torch composition``): two ``index_put_`` for the table, then
``index_select`` and ``index_copy_`` for the queue's rows and words.

Each with ``chip_smoke.py``'s clocks (``device_ms``: the profiler, else
CUDA events behind a busy stream; ``ms``: CUDA events around each call;
``host_ms``: 200 unchecked enqueues).  ``--kernels`` picks the families
(``prep``, ``plan``, ``commit``; default all).  Prints one line per cell
and writes every sample to ``chiprun_out/kernel_ab.json``.  Needs a CUDA
device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

import chip_smoke as cs
from stateright_tpu_torch.models.paxos import paxos_model
from stateright_tpu_torch.models.single_copy_register import single_copy_model
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.ops import _cuda, buckets
from stateright_tpu_torch.ops import cand_prep as cp
from stateright_tpu_torch.ops.insert_commit import (
    insert_commit,
    insert_commit_plain,
    insert_commit_window,
    insert_commit_window_plain,
)

SOURCES = ("bucket_plan.cu", "cand_prep.cu", "insert_commit.cu")
OUT = Path("chiprun_out/kernel_ab.json")
# scratch for any library's tiles: 256 lanes or more, 8 leading words
MIN_TILE, LEAD_WORDS = 256, 8
# the spill paxos-3 leg's first inserting inject (PERF.md §6): its plan
# lanes (the pending buffer) and novel rows
INJECT_LANES, INJECT_NOVEL = 245_760, 359
FAMILIES = ("prep", "plan", "commit")


def build(src: Path, into: Path) -> ctypes.CDLL:
    """The kernels of ``src`` built into one library under ``into``."""
    shutil.copytree(src, into)
    nvcc = _cuda._nvcc()
    objs = [into / (f[:-3] + ".o") for f in SOURCES]
    _cuda._run_all([[nvcc, *_cuda.NVCC_FLAGS, "-c", str(into / f), "-o",
                     str(o)] for f, o in zip(SOURCES, objs)])
    lib = into / "lib.so"
    subprocess.check_call([nvcc, *_cuda.NVCC_FLAGS, "-shared", "-o",
                           str(lib), *map(str, objs)])
    dll = ctypes.CDLL(str(lib))
    for name, argtypes in _cuda._SIGNATURES.items():
        fn = getattr(dll, name, None)
        if fn is not None:
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    return dll


def roomy(buf, m: int):
    """``buf`` (``PrepBuffers`` or ``PlanBuffers`` for ``m`` lanes) with
    its scratch widened to fit any library's tiles."""
    buf.scratch = torch.zeros(LEAD_WORDS + -(-m // MIN_TILE),
                              dtype=torch.int64, device=buf.device)
    buf.ptrs = buf.ptrs[:-1] + (buf.scratch.data_ptr(),)
    return buf


def inject_cell(x: dict) -> dict:
    """The spill paxos-3 inject's shape on the paxos-3 batch ``x``: its
    first :data:`INJECT_NOVEL` novel lanes (their slots, fingerprints,
    payloads and rows) as the live lanes of an :data:`INJECT_LANES`-lane
    plan over a pending buffer of as many rows, arity 1 (each row its own
    parent), the rows in a seeded order as the inject's sort leaves
    them."""
    tgt, cfp, cpl, sel, _, _ = x["plan"]
    n, m, dev = INJECT_NOVEL, INJECT_LANES, tgt.device
    if x["n_new"] < n:
        raise AssertionError(f"paxos-3 batch: {x['n_new']} novel < {n}")
    width = x["crows"].shape[1]

    def lanes(a, fill):
        out = torch.full((m,), fill, dtype=a.dtype, device=dev)
        out[:n] = a[:n]
        return out

    rows = torch.zeros((m, width), dtype=torch.int64, device=dev)
    rows[:n] = x["crows"][sel[:n]]
    order = torch.randperm(n, generator=torch.Generator().manual_seed(0))
    isel = torch.full((m,), m - 1, dtype=torch.int64, device=dev)
    isel[:n] = order.to(dev)
    q = x["queue"]
    ebits = torch.zeros(m, dtype=torch.int32, device=dev)
    depths = torch.zeros(m, dtype=torch.int32, device=dev)
    ebits[:n] = q.parent_ebits[sel[:n] // q.arity]
    depths[:n] = q.parent_depths[sel[:n] // q.arity]
    nn = torch.tensor(n, dtype=torch.int64, device=dev)
    plan = (lanes(tgt, x["tfp"].shape[0]), lanes(cfp, -1), lanes(cpl, -1),
            isel, nn)
    queue = q._replace(sel=isel, src_rows=rows, parent_ebits=ebits,
                       parent_depths=depths, arity=1)
    return dict(x, plan=plan, queue=queue, n_new=n)


def mesh_cell(dev="cuda", n: int = 7) -> dict:
    """``chip_smoke.py``'s ``at_mesh_2pc7`` window cell: the next step of
    2pc-7 on 4 pieces bounded at 100,000, its novel lanes appended to the
    queue piece that takes the tail."""
    mb = cs.mesh_builder(TwoPhaseSys(n), torch.device(dev)).target_states(
        cs.MESH_KERNEL_TARGET).spawn_gpu(sync=True)
    x = cs.mesh_batch(mb)
    q = x["queue"]
    return dict(x, queue=q._replace(rows=x["qpiece"][0], fps=x["qpiece"][1],
                                    ebits=x["qpiece"][2],
                                    depths=x["qpiece"][3]))


def cells(kinds) -> dict:
    """``{cell: (batch, sym, cold, families)}``: chip_smoke.py's six main
    cells, and with ``commit`` the inject and mesh cells."""
    out = {}
    main = set(kinds)
    c, _ = cs.timed_run(7, target=100_000)
    out["2pc-7"] = (cs.next_batch(c, c._final_carry), False, False, main)
    c, _ = cs.timed_run(10, target=cs.TPC10_TARGET)
    out["2pc-10"] = (cs.next_batch(c, c._final_carry), False, True, main)
    c, _ = cs.timed_run(3, target=cs.PAXOS3_KERNEL_TARGET, model=paxos_model)
    out["paxos-3"] = (cs.next_batch(c, c._final_carry), False, True, main)
    c, _ = cs.timed_run(4, target=cs.SC4_KERNEL_TARGET,
                        model=single_copy_model)
    out["single-copy-4"] = (cs.next_batch(c, c._final_carry), False, True,
                            main)
    c = cs.per_channel_paxos2().checker().target_states(
        cs.P2_PER_CHANNEL_KERNEL_TARGET).spawn_gpu(**cs.P2_PER_CHANNEL_KW)
    c = c.join()
    out["per-channel paxos-2"] = (cs.next_batch(c, c._final_carry), False,
                                  True, main)
    c = TwoPhaseSys(15).checker().symmetry().target_states(
        cs.SYM_2PC15_KERNEL_TARGET).spawn_gpu().join()
    out["2pc-15 symmetry"] = (cs.next_batch(c, c._final_carry, sym=True),
                              True, True, main)
    if "commit" in kinds:
        out["paxos-3 spill inject shape"] = (
            inject_cell(out["paxos-3"][0]), False, True, {"commit"})
        out["mesh 2pc-7 window"] = (mesh_cell(), False, False, {"window"})
    return out


def fresh(x: dict):
    """Copies of ``x``'s table and queue buffers for the commit to write,
    and a function that restores them to the batch's state."""
    q = x["queue"]
    window = "qlo" in x
    t0 = () if window else (x["tfp"], x["tpl"])
    q0 = tuple(q[:4])
    tables = tuple(t.clone() for t in t0)
    bufs = tuple(t.clone() for t in q0)

    def reset():
        for a, b in zip(tables + bufs, t0 + q0):
            a.copy_(b)

    return tables, q._replace(rows=bufs[0], fps=bufs[1], ebits=bufs[2],
                              depths=bufs[3]), reset


def commit_calls(x: dict, stream) -> dict:
    """The cell's commit: ``kernel`` (the current library's launch),
    ``plain`` and ``torch`` (the composition), each ``(call, reset,
    buffers)`` on its own copy of the table and the queue."""
    plan, q = x["plan"], x["queue"]
    tgt, cfp, cpl, sel, n_new = plan[:5]
    nn, tail, dev = x["n_new"], int(q.tail), tgt.device
    window = "qlo" in x  # the mesh's window append: no table half
    qlo, lo, hi = 0, 0, nn
    if window:
        qlo = x["qlo"]
        lo = max(qlo - tail, 0)
        hi = min(qlo + x["qpiece"][0].shape[0] - tail, nn)

    def kernel(kt, kq):
        if window:
            insert_commit_window(kq, cfp, n_new, qlo, check=False,
                                 stream=stream)
        else:
            insert_commit(*kt, tgt, cfp, cpl, n_new, kq, check=False,
                          stream=stream)

    def plain(kt, kq):
        if window:
            insert_commit_window_plain(kq, cfp, n_new, qlo)
        else:
            insert_commit_plain(*kt, tgt, cfp, cpl, n_new, kq)

    def composition(kt, kq):
        if not window:
            kt[0].index_put_((tgt[:nn],), cfp[:nn])
            kt[1].index_put_((tgt[:nn],), cpl[:nn])
        s = sel[lo:hi]
        p = torch.div(s, kq.arity, rounding_mode="floor")
        dst = torch.arange(tail + lo - qlo, tail + hi - qlo, device=dev)
        kq.rows.index_copy_(0, dst, kq.src_rows.index_select(0, s))
        kq.fps.index_copy_(0, dst, cfp[lo:hi])
        kq.ebits.index_copy_(0, dst, kq.parent_ebits.index_select(0, p))
        kq.depths.index_copy_(0, dst,
                              kq.parent_depths.index_select(0, p) + 1)

    out = {}
    for name, fn in (("kernel", kernel), ("plain", plain),
                     ("torch", composition)):
        kt, kq, reset = fresh(x)
        out[name] = (lambda fn=fn, kt=kt, kq=kq: fn(kt, kq), reset,
                     kt + tuple(kq[:4]))
    return out


def sample(fn, flush, cold: bool, err: int) -> dict:
    dev, by, ev = cs.device_ms(fn, flush if cold else None)
    ms = cs.time_cold_ms(fn, flush) if cold else cs.time_ms(fn)
    return dict(err=err, device_ms=dev, device_ms_by=by, events_device_ms=ev,
                ms=ms, host_ms=cs.host_ms(fn))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, action="append", default=[])
    ap.add_argument("--kernels", default=",".join(FAMILIES))
    args = ap.parse_args()
    kinds = set(args.kernels.split(","))
    if not kinds <= set(FAMILIES):
        ap.error(f"--kernels: {sorted(kinds - set(FAMILIES))}")
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device available", file=sys.stderr)
        return 2
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"this": build(Path(_cuda.CSRC), Path(tmp) / "this")}
        for i, d in enumerate(args.against):
            libs[str(d)] = build(d, Path(tmp) / f"against{i}")
        print(json.dumps({"card": torch.cuda.get_device_name(0),
                          "builds_sec": time.monotonic() - t0}), flush=True)
        order = list(libs) + list(libs)[::-1]
        res = {}
        stream = torch.cuda.current_stream().cuda_stream
        flush = torch.empty(cs.FLUSH_BYTES, dtype=torch.uint8, device="cuda")
        for cell, (x, sym, cold, fams) in cells(kinds).items():
            got = res.setdefault(cell, {})
            if fams & {"prep", "plan"}:
                tfp, fused, want = x["tfp"], x["fused"], x["plan"]
                fp, pl, skey, od, cidx, cov = fused
                m = skey.shape[0]
                bits = buckets.bucket_bits(tfp.shape[0] // cs.SLOTS)
                gathered = (fp[od], pl[od], buckets.key_buckets(skey, bits),
                            od, cidx, cov)
                pbuf = roomy(buckets.PlanBuffers(m, skey.device, sym), m)
                rows, valid, pfp = x["krows"], x["cvalid"], x["pfp"]
                qbuf = roomy(cp.PrepBuffers(rows.shape[0], x["cb"],
                                            rows.device), rows.shape[0])
            commit = None
            if fams & {"commit", "window"}:
                commit = commit_calls(x, stream)
                key = "insert_commit_window" if "window" in fams \
                    else "insert_commit"
                pfn, _, pbufs = commit["plain"]
                pfn()
                torch.cuda.synchronize()

                def commit_err(name):
                    fn, reset, bufs = commit[name]
                    reset()
                    fn()
                    torch.cuda.synchronize()
                    return sum(int((a != b).sum())
                               for a, b in zip(bufs, pbufs))

                tfn = commit["torch"][0]
                got.setdefault(key, {}).setdefault(
                    "torch composition", []).append(
                        sample(tfn, flush, cold, commit_err("torch")))
            for name in order:
                _cuda._LIB = libs[name]
                calls = {}
                if "prep" in fams:
                    calls["cand_prep"] = lambda: cp.cand_prep(
                        rows, valid, pfp, x["arity"], x["cb"], qbuf,
                        check=False, stream=stream)
                if "plan" in fams:
                    calls["bucket_plan"] = lambda: buckets.bucket_plan(
                        tfp, *gathered, out=pbuf, generation_order=sym,
                        check=False, stream=stream)
                    calls["composition"] = lambda: buckets.bucket_plan(
                        tfp, fp[od], pl[od], buckets.key_buckets(skey, bits),
                        od, cidx, cov, out=pbuf, generation_order=sym,
                        check=False, stream=stream)
                    if hasattr(libs[name], "srt_bucket_plan_fused"):
                        calls["bucket_plan_fused"] = (
                            lambda: buckets.bucket_plan_fused(
                                tfp, *fused, tfp.shape[0] // cs.SLOTS,
                                out=pbuf, generation_order=sym, check=False,
                                stream=stream))
                for k, fn in calls.items():
                    out = fn()
                    torch.cuda.synchronize()
                    if k == "cand_prep":
                        err = sum(int((g != w).sum())
                                  for g, w in zip(out, x["prep"]))
                    else:
                        err, _ = cs.plan_errors(out, want, tfp.shape[0])
                    got.setdefault(k, {}).setdefault(name, []).append(
                        sample(fn, flush, cold, err))
                if commit is not None:
                    got[key].setdefault(name, []).append(
                        sample(commit["kernel"][0], flush, cold,
                               commit_err("kernel")))
            _cuda._LIB = None
            if commit is not None:
                got[key]["torch composition"].append(
                    sample(tfn, flush, cold, commit_err("torch")))
            print(json.dumps({cell: {k: {n: [(s["device_ms"], s["host_ms"])
                                             for s in ss]
                                         for n, ss in d.items()}
                                     for k, d in got.items()}}), flush=True)
            del commit
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(res, indent=1))
    bad = [(c, k, n) for c, d in res.items() for k, dd in d.items()
           for n, ss in dd.items() for s in ss if s["err"]]
    print(json.dumps({"mismatches": bad,
                      "seconds": time.monotonic() - t0}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
