"""A/B times of the insert's two planning kernels on the card.

    python3 kernel_ab.py --against _archive/parent/stateright_tpu_torch/csrc

Builds ``csrc/bucket_plan.cu`` and ``csrc/cand_prep.cu`` of this tree and
of each ``--against`` directory (another tree's ``csrc``: a parent commit
unpacked with ``git archive``), each into a library of its own.  Then it
takes the next batch of each of ``chip_smoke.py``'s six main kernel cells
(2pc-7 L2-warm; 2pc-10, paxos-3, single-copy-4, per-channel paxos-2 and
2pc-15 under symmetry L2-cold) and times, from every library in turns (A,
B, ..., B, A), each held against its plain version:

 - ``cand_prep``;
 - ``bucket_plan``: the pre-gathered entry on sorted lanes gathered
   beforehand;
 - ``composition``: what a step ran before the fused entry, the sort's
   tail (``fp[order]``, ``payload[order]``, the buckets of the sorted
   keys) and the pre-gathered launch;
 - ``bucket_plan_fused``: the fused entry (where the library has it).

Each with ``chip_smoke.py``'s clocks (``device_ms``: the profiler, else
CUDA events behind a busy stream; ``ms``: CUDA events around each call;
``host_ms``: 200 unchecked enqueues).  Prints one line per cell and writes
every sample to ``chiprun_out/kernel_ab.json``.  Needs a CUDA device and
``nvcc``.
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

SOURCES = ("bucket_plan.cu", "cand_prep.cu")
OUT = Path("chiprun_out/kernel_ab.json")
# scratch for any library's tiles: 256 lanes or more, 8 leading words
MIN_TILE, LEAD_WORDS = 256, 8


def build(src: Path, into: Path) -> ctypes.CDLL:
    """The two kernels of ``src`` built into one library under ``into``."""
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


def cells() -> dict:
    """``{cell: (batch, sym, cold)}``: chip_smoke.py's six main cells."""
    out = {}
    c, _ = cs.timed_run(7, target=100_000)
    out["2pc-7"] = (cs.next_batch(c, c._final_carry), False, False)
    c, _ = cs.timed_run(10, target=cs.TPC10_TARGET)
    out["2pc-10"] = (cs.next_batch(c, c._final_carry), False, True)
    c, _ = cs.timed_run(3, target=cs.PAXOS3_KERNEL_TARGET, model=paxos_model)
    out["paxos-3"] = (cs.next_batch(c, c._final_carry), False, True)
    c, _ = cs.timed_run(4, target=cs.SC4_KERNEL_TARGET,
                        model=single_copy_model)
    out["single-copy-4"] = (cs.next_batch(c, c._final_carry), False, True)
    c = cs.per_channel_paxos2().checker().target_states(
        cs.P2_PER_CHANNEL_KERNEL_TARGET).spawn_gpu(**cs.P2_PER_CHANNEL_KW)
    c = c.join()
    out["per-channel paxos-2"] = (cs.next_batch(c, c._final_carry), False,
                                  True)
    c = TwoPhaseSys(15).checker().symmetry().target_states(
        cs.SYM_2PC15_KERNEL_TARGET).spawn_gpu().join()
    out["2pc-15 symmetry"] = (cs.next_batch(c, c._final_carry, sym=True),
                              True, True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, action="append", default=[])
    args = ap.parse_args()
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
        for cell, (x, sym, cold) in cells().items():
            tfp, fused, want = x["tfp"], x["fused"], x["plan"]
            fp, pl, skey, od, cidx, cov = fused
            m = skey.shape[0]
            bits = buckets.bucket_bits(tfp.shape[0] // cs.SLOTS)
            gathered = (fp[od], pl[od], buckets.key_buckets(skey, bits),
                        od, cidx, cov)
            pbuf = roomy(buckets.PlanBuffers(m, skey.device, sym), m)
            rows, valid, pfp = x["krows"], x["cvalid"], x["pfp"]
            qbuf = roomy(cp.PrepBuffers(rows.shape[0], x["cb"], rows.device),
                         rows.shape[0])
            for name in order:
                _cuda._LIB = libs[name]
                calls = {
                    "cand_prep": lambda: cp.cand_prep(
                        rows, valid, pfp, x["arity"], x["cb"], qbuf,
                        check=False, stream=stream),
                    "bucket_plan": lambda: buckets.bucket_plan(
                        tfp, *gathered, out=pbuf, generation_order=sym,
                        check=False, stream=stream),
                    "composition": lambda: buckets.bucket_plan(
                        tfp, fp[od], pl[od], buckets.key_buckets(skey, bits),
                        od, cidx, cov, out=pbuf, generation_order=sym,
                        check=False, stream=stream),
                }
                if hasattr(libs[name], "srt_bucket_plan_fused"):
                    calls["bucket_plan_fused"] = lambda: buckets.bucket_plan_fused(
                        tfp, *fused, tfp.shape[0] // cs.SLOTS, out=pbuf,
                        generation_order=sym, check=False, stream=stream)
                for k, fn in calls.items():
                    got = fn()
                    torch.cuda.synchronize()
                    if k == "cand_prep":
                        err = sum(int((g != w).sum())
                                  for g, w in zip(got, x["prep"]))
                    else:
                        err, _ = cs.plan_errors(got, want, tfp.shape[0])
                    dev, by, ev = cs.device_ms(fn, flush if cold else None)
                    ms = cs.time_cold_ms(fn, flush) if cold else cs.time_ms(fn)
                    res.setdefault(cell, {}).setdefault(k, {}).setdefault(
                        name, []).append(dict(err=err, device_ms=dev,
                                              device_ms_by=by,
                                              events_device_ms=ev, ms=ms,
                                              host_ms=cs.host_ms(fn)))
            _cuda._LIB = None
            print(json.dumps({cell: {k: {n: [(s["device_ms"], s["host_ms"])
                                             for s in ss]
                                         for n, ss in d.items()}
                                     for k, d in res[cell].items()}}),
                  flush=True)
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(res, indent=1))
    bad = [(c, k, n) for c, d in res.items() for k, dd in d.items()
           for n, ss in dd.items() for s in ss if s["err"]]
    print(json.dumps({"mismatches": bad,
                      "seconds": time.monotonic() - t0}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
