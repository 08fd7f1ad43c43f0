"""Roofline view: the static cost ledger against the card's ceilings.

The port's copy of ``stateright_tpu/telemetry/roofline.py``.
``analysis/costmodel.py`` produces the per-stage FLOPs/bytes ledger; this
module combines it with

 - a small **device-spec table** (:data:`DEVICE_SPECS`, matched on
   ``torch.cuda.get_device_name()``; ``STATERIGHT_TPU_DEVICE_SPEC=
   PEAK:HBM_BYTES_PER_SEC[:NAME[:VPU_PEAK]]`` overrides it) to classify
   each stage memory-bound or compute-bound against the ridge point
   ``peak / bandwidth`` of the peak its op mix can reach;
 - the recorder's stage seconds (``FlightRecorder.stages()``) for the
   achieved bytes/s and FLOPs/s against those ceilings.

The JSON keys stay JAX's, so ``telemetry/diff.py`` reads either package's
blocks.  On this card they mean:

 - ``mxu_peak`` -- the tensor cores' dense peak (bf16, FLOP/s): what a
   stage dominated by matrix products can reach (the JAX key names the
   TPU's matrix unit);
 - ``vpu_peak`` -- the CUDA cores' float32 peak (FLOP/s): what gathers,
   scatters, sorts and elementwise work top out at (the JAX key names the
   TPU's vector unit).  The port's work is int64, so this is a ceiling
   of the right order, not the exact integer rate;
 - ``hbm_bytes_per_sec`` -- device memory bandwidth;
 - ``mxu_ridge``/``vpu_ridge`` -- each peak over the bandwidth (FLOPs per
   byte), and ``peak_flops``/``ridge`` the pre-split aliases of the
   tensor-core pair.

With no CUDA device (the CPU), or a card not in the table, everything
degrades to arithmetic intensities without verdicts, never a crash.

Contract: the ledger is host-side analysis of the captured kernels and
the kernels' counts; with the roofline on or off a step dispatches the
same operations (``tests/test_torch_costmodel.py`` and ``chip_smoke.py``
pin it).  Enabled by ``.telemetry(roofline=True)`` or ``.roofline()``;
surfaces as ``checker.roofline()``, the recorder's ``roofline`` record
and snapshot, the run report's deterministic ``roofline`` block (static
counts only; the ceilings render in the markdown), the metrics bus's
roofline block, and the ``costmodel`` verb.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

# roofline record / block schema version
ROOFLINE_V = 1

ENV_DEVICE_SPEC = "STATERIGHT_TPU_DEVICE_SPEC"

# (needle in the lowercased device name, name, tensor-core peak FLOP/s
# (bf16 dense), CUDA-core peak FLOP/s (float32), memory bytes/s), from
# NVIDIA's data sheets; the first needle found wins, so the PCIe card's
# comes before the SXM's
DEVICE_SPECS = (
    ("h100 pcie", "nvidia-h100-pcie", 756e12, 51e12, 2.0e12),
    ("h100", "nvidia-h100-sxm", 989e12, 67e12, 3.35e12),
)

# a stage "is" dot-class when products carry at least half its FLOPs: then
# the tensor-core ridge is the honest ceiling, else the CUDA cores'
DOT_DOMINANCE = 0.5


def _spec_dict(name: str, mxu_peak: float, vpu_peak: float, bw: float,
               src: str) -> dict:
    """Normalized spec: both peaks, both ridges (JAX ``_spec_dict``)."""
    return {
        "name": name,
        "peak_flops": mxu_peak,  # alias of mxu_peak
        "mxu_peak": mxu_peak,
        "vpu_peak": vpu_peak,
        "hbm_bytes_per_sec": bw,
        "ridge": mxu_peak / bw,  # alias of mxu_ridge
        "mxu_ridge": mxu_peak / bw,
        "vpu_ridge": vpu_peak / bw,
        "src": src,
    }


def spec_for_name(device_name: str) -> Optional[dict]:
    """The table's spec for a device name (``torch.cuda.
    get_device_name()``), or None."""
    kind = str(device_name).lower()
    for needle, name, peak, vpu, bw in DEVICE_SPECS:
        if needle in kind:
            return _spec_dict(name, peak, vpu, bw, "device")
    return None


def device_spec(device=None) -> Optional[dict]:
    """The spec of the CUDA device ``device`` (default: the current one),
    the env override winning; None when nothing is known (the CPU)."""
    env = os.environ.get(ENV_DEVICE_SPEC, "").strip()
    if env:
        parts = env.split(":")
        try:
            peak, bw = float(parts[0]), float(parts[1])
            vpu = float(parts[3]) if len(parts) > 3 else peak / 64.0
            if peak > 0 and bw > 0 and vpu > 0:
                return _spec_dict(
                    parts[2] if len(parts) > 2 and parts[2]
                    else "env-override", peak, vpu, bw, "env")
        except (IndexError, ValueError):
            pass
        print(
            "stateright-tpu: roofline: ignoring malformed "
            f"{ENV_DEVICE_SPEC}={env!r} (want PEAK_FLOPS:HBM_BYTES_PER_SEC"
            "[:NAME[:VPU_PEAK_FLOPS]], e.g. 9.89e14:3.35e12:nvidia-h100-sxm:"
            "6.7e13; the VPU peak defaults to PEAK/64)",
            file=sys.stderr,
        )
    try:
        import torch

        if device is not None and getattr(
                torch.device(device), "type", "cuda") != "cuda":
            return None
        if not torch.cuda.is_available():
            return None
        name = torch.cuda.get_device_name(device)
    except Exception:  # noqa: BLE001 - no backend: no spec
        return None
    return spec_for_name(name)


def stage_dot_dominated(stage: dict) -> bool:
    """Does the stage's op mix earn the tensor-core ridge?  True when
    dot-class operations carry at least :data:`DOT_DOMINANCE` of its
    FLOPs."""
    classes = stage.get("classes") or {}
    dot = (classes.get("dot") or {}).get("flops") or 0
    total = stage.get("flops") or 0
    return total > 0 and dot / total >= DOT_DOMINANCE


def classify_stages(static: dict, spec: Optional[dict]) -> dict:
    """Per-stage verdict from the static block's intensities (JAX
    ``classify_stages``): ``memory-bound`` below the stage's ridge,
    ``compute-bound`` above, ``unknown`` without a spec or bytes."""
    out = {}
    for name, s in (static.get("stages") or {}).items():
        ai = s.get("intensity")
        dot = stage_dot_dominated(s)
        ridge = None
        if spec:
            ridge = (spec.get("mxu_ridge", spec.get("ridge")) if dot
                     else spec.get("vpu_ridge", spec.get("ridge")))
        if ai is None or ridge is None:
            verdict = "unknown"
        else:
            verdict = "memory-bound" if ai < ridge else "compute-bound"
        entry = {"intensity": ai, "verdict": verdict}
        if ridge is not None:
            entry["ridge"] = round(ridge, 3)
            entry["ridge_kind"] = "mxu" if dot else "vpu"
        out[name] = entry
    return out


def achieved_block(static: dict, spec: Optional[dict],
                   stages_secs: Optional[dict], unique: int,
                   batch: int) -> Optional[dict]:
    """Achieved-vs-ceiling estimate (JAX ``achieved_block``): the static
    per-step bytes/FLOPs times the estimated step count over the device
    seconds the recorder attributes.  An estimate by construction, so it
    lives in the live and markdown surfaces, never the report body."""
    if not stages_secs:
        return None
    dev_secs = stages_secs.get("device_secs")
    if not dev_secs or dev_secs <= 0 or batch <= 0 or unique <= 0:
        return None
    rows_per_step = int(batch) * max(int(static.get("devices", 1) or 1), 1)
    steps = max((int(unique) + rows_per_step - 1) // rows_per_step, 1)
    totals = static.get("totals") or {}
    bts, fls = totals.get("bytes"), totals.get("flops")
    if not bts:
        return None
    out = {
        "device_secs": dev_secs,
        "est_device_steps": steps,
        "bytes_per_sec": round(bts * steps / dev_secs, 1),
        "flops_per_sec": round((fls or 0) * steps / dev_secs, 1),
    }
    if spec:
        out["frac_of_hbm_ceiling"] = round(
            out["bytes_per_sec"] / spec["hbm_bytes_per_sec"], 6)
        out["frac_of_flops_ceiling"] = round(
            out["flops_per_sec"] / spec["peak_flops"], 6)
    return out


class RooflineLedger:
    """Host-side roofline accounting for one engine run (JAX
    ``RooflineLedger``).  ``cost_fn() -> CostReport | None`` is the
    engine's cost model at the run's capacities (cached on the twin).
    Built once at spawn and pushed into the recorder as the versioned
    ``roofline`` record and snapshot.  No device operation."""

    def __init__(self, engine: str, cost_fn, recorder=None,
                 device=None) -> None:
        self.engine = engine
        self.recorder = recorder
        self._report = None
        self._static: Optional[dict] = None
        self._recon: Optional[dict] = None
        self._spec = device_spec(device)
        try:
            self._report = cost_fn()
        except Exception:  # noqa: BLE001 - accounting never breaks a run
            self._report = None
        if self._report is not None:
            self._static = self._report.static_block()
            self._recon = self._report.recon_block()
            if recorder is not None:
                recorder.set_roofline(self.snapshot())
                recorder.record(
                    "roofline", v=ROOFLINE_V, at="init",
                    engine=self._static["engine"],
                    stages={
                        k: {"flops": v["flops"],
                            "bytes": v["bytes_read"] + v["bytes_written"]}
                        for k, v in self._static["stages"].items()
                    },
                    totals=dict(self._static["totals"]),
                    reconciled=bool(self._recon["ok"]),
                )

    @property
    def ok(self) -> bool:
        return self._static is not None

    def findings(self) -> list:
        """The JX4xx tensor-core candidate findings."""
        return list(self._report.findings) if self._report else []

    def static_block(self) -> Optional[dict]:
        """The DETERMINISTIC block for the run report."""
        return dict(self._static) if self._static else None

    def snapshot(self) -> Optional[dict]:
        """The live block: static + the reconciliation verdict + the
        resolved spec + per-stage verdicts."""
        if self._static is None:
            return None
        out = dict(self._static)
        out["reconciliation"] = dict(self._recon) if self._recon else None
        if self._spec:
            out["device_spec"] = dict(self._spec)
        out["verdicts"] = classify_stages(self._static, self._spec)
        return out

    def live_block(self, stages_secs: Optional[dict], unique: int,
                   batch: Optional[int] = None) -> Optional[dict]:
        """:meth:`snapshot` with the achieved-vs-ceiling estimate once the
        recorder attributes device seconds (``checker.roofline()``)."""
        snap = self.snapshot()
        if snap is None:
            return None
        if not batch:
            batch = int(self._static.get("batch", 0) or 0)
        ach = achieved_block(self._static, self._spec, stages_secs, unique,
                             batch)
        if ach is not None:
            snap["achieved"] = ach
        return snap
