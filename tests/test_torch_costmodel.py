"""The port's cost model and roofline view (``stateright_tpu_torch/analysis/
costmodel.py`` + ``telemetry/roofline.py``) against the JAX package's and
against the kernels' own counts, tolerance 0.

 - ``kernel_cost`` reproduces every bound of PERF.md §6's kernel table
   (the four hand-written kernels, from the shapes printed there, to the
   digits printed; the two kernels PR 2 superseded, whose sources are
   gone, are left out);
 - the pinned reconciliation contract: each kernel's count beside the walk
   of its plain version, the ratio inside ``[BYTES_LO, BYTES_HI]`` over
   every twin-bearing configuration of the models' ``_audit_models``, and
   the engine stages charged exactly the kernels' counts;
 - ``classify_stages`` and ``achieved_block`` give JAX's output on JAX's
   own static dicts; the spec table matches the card's name and the env
   override wins; the CPU degrades to intensities only;
 - the JX4xx candidates: JAX's ``JX400``/``JX402`` on 2pc-3, plus the
   port's ``JX401`` for its key sort, which JAX's insert at these shapes
   does not do (README's port section);
 - with the roofline on, a step dispatches exactly the operations it
   dispatches with it off; the ring record, the metrics bus, the report's
   deterministic ``roofline``/``audit``/``sanitizer`` blocks, a JAX and a
   port report of 2pc-5 still diffing ``IDENTICAL`` (``PERF-ONLY`` only
   for device or checkout drift, the perf aspects), and the verbs."""

import importlib
import json
import sys

import pytest

from stateright_tpu.telemetry import roofline as jax_roofline
from stateright_tpu_torch.analysis.costmodel import (
    BYTES_HI,
    BYTES_LO,
    classify_op,
    engine_stages,
    kernel_cost,
    kernel_rw,
    plain_walks,
    step_shapes,
    wavefront_costs,
)
from stateright_tpu_torch.models import _cli
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.parallel.tensor_model import twin_or_none
from stateright_tpu_torch.telemetry import roofline
from stateright_tpu_torch.telemetry.roofline import (
    ENV_DEVICE_SPEC,
    ROOFLINE_V,
    achieved_block,
    classify_stages,
    device_spec,
    spec_for_name,
)

sys.path.insert(0, "tests")

HBM = 3.35e12  # the bound's memory rate: H100 SXM (PERF.md §6)

# PERF.md §6's kernel table: (row, kernel, shapes, the bound printed).
# The spill inject's plan has no candidate map (``cidx`` None).
PERF_TABLE = [
    ("2pc-7", "insert_commit",
     {"novel": 3535, "width": 1, "parents": 1423}, "0.0000878"),
    ("2pc-10", "insert_commit",
     {"novel": 4286, "width": 1, "parents": 1694}, "0.0001064"),
    ("paxos-3", "insert_commit",
     {"novel": 2012, "width": 33, "parents": 1249}, "0.0003585"),
    ("single-copy-4", "insert_commit",
     {"novel": 2690, "width": 21, "parents": 1611}, "0.0003250"),
    ("per-channel paxos-2", "insert_commit",
     {"novel": 653, "width": 83, "parents": 396}, "0.0002723"),
    ("2pc-15 symmetry", "insert_commit",
     {"novel": 2772, "width": 1, "parents": 1682}, "0.0000702"),
    ("ORL", "insert_commit",
     {"novel": 36, "width": 17, "parents": 17}, "0.0000037"),
    ("spill 2pc-7 inject", "insert_commit",
     {"novel": 10385, "width": 1, "parents": 10385}, "0.0002728"),
    ("spill paxos-3 inject", "insert_commit",
     {"novel": 359, "width": 33, "parents": 359}, "0.0000643"),
    ("POR proviso", "insert_commit",
     {"novel": 16, "width": 83, "parents": 16}, "0.0000067"),
    ("2pc-7", "bucket_plan",
     {"lanes": 32768, "valid": 21858, "lines": 9749, "novel": 3535},
     "0.0005620"),
    ("2pc-10", "bucket_plan",
     {"lanes": 65536, "valid": 32979, "lines": 20191, "novel": 4286},
     "0.0010784"),
    ("paxos-3", "bucket_plan",
     {"lanes": 8192, "valid": 4522, "lines": 3443, "novel": 2012},
     "0.0001956"),
    ("single-copy-4", "bucket_plan",
     {"lanes": 8192, "valid": 4883, "lines": 4165, "novel": 2690},
     "0.0002353"),
    ("per-channel paxos-2", "bucket_plan",
     {"lanes": 4096, "valid": 1056, "lines": 708, "novel": 653},
     "0.0000503"),
    ("2pc-15 symmetry", "bucket_plan",
     {"lanes": 65536, "valid": 36880, "lines": 7424, "novel": 2772},
     "0.0005746"),
    ("ORL", "bucket_plan",
     {"lanes": 8192, "valid": 222, "lines": 93, "novel": 36}, "0.0000243"),
    ("paxos-3 prededup", "bucket_plan",
     {"lanes": 8192, "valid": 3463, "lines": 3443, "novel": 2012},
     "0.0001930"),
    ("spill 2pc-7 inject", "bucket_plan",
     {"lanes": 151552, "valid": 10385, "lines": 9609, "novel": 10385,
      "cidx": False},
     "0.0009027"),
    ("spill paxos-3 inject", "bucket_plan",
     {"lanes": 245760, "valid": 359, "lines": 358, "novel": 359,
      "cidx": False},
     "0.0006066"),
    ("POR proviso", "bucket_plan",
     {"lanes": 4096, "valid": 16, "lines": 16, "novel": 16}, "0.0000107"),
    ("2pc-7", "row_hash", {"rows": 75776, "width": 1, "valid": 21858},
     "0.0002558"),
    ("2pc-10", "row_hash", {"rows": 106496, "width": 1, "valid": 32979},
     "0.0003649"),
    ("paxos-3", "row_hash", {"rows": 61440, "width": 33, "valid": 4522},
     "0.0005214"),
    ("single-copy-4", "row_hash", {"rows": 40960, "width": 21, "valid": 4883},
     "0.0003549"),
    ("per-channel paxos-2", "row_hash",
     {"rows": 41984, "width": 83, "valid": 1056}, "0.0003221"),
    ("2pc-15 symmetry", "row_hash",
     {"rows": 157696, "width": 1, "valid": 36880}, "0.0005117"),
    ("2pc-15 symmetry init", "row_hash", {"rows": 1, "width": 1},
     "0.0000000048"),
    ("ORL init", "row_hash", {"rows": 1, "width": 17}, "0.00000004"),
    ("ORL", "row_hash", {"rows": 69632, "width": 17, "valid": 222},
     "0.0001961"),
    ("2pc-7", "cand_prep", {"lanes": 75776, "width": 1, "valid": 21858,
                            "budget": 32768, "parents": 2048}, "0.0003927"),
    ("2pc-10", "cand_prep", {"lanes": 106496, "width": 1, "valid": 32979,
                             "budget": 65536, "parents": 2048}, "0.0007415"),
    ("paxos-3", "cand_prep", {"lanes": 61440, "width": 33, "valid": 4522,
                              "budget": 8192, "parents": 1986}, "0.0004577"),
    ("single-copy-4", "cand_prep", {"lanes": 40960, "width": 21,
                                    "valid": 4883, "budget": 8192,
                                    "parents": 2048}, "0.0003403"),
    ("per-channel paxos-2", "cand_prep", {"lanes": 41984, "width": 83,
                                          "valid": 1056, "budget": 4096,
                                          "parents": 499}, "0.0002622"),
    ("2pc-15 symmetry", "cand_prep", {"lanes": 157696, "width": 1,
                                      "valid": 36880, "budget": 65536,
                                      "parents": 2048}, "0.0007661"),
    ("ORL", "cand_prep", {"lanes": 69632, "width": 17, "valid": 222,
                          "budget": 8192, "parents": 35}, "0.0001081"),
    ("paxos-3 prededup", "cand_prep", {"lanes": 61440, "width": 33,
                                       "valid": 3463, "budget": 8192,
                                       "parents": 1721}, "0.0003736"),
    ("POR proviso", "cand_prep", {"lanes": 20992, "width": 83, "valid": 16,
                                  "budget": 4096, "parents": 17},
     "0.0000486"),
    # the fused plan's rows: the same batches as the pre-gathered
    # plan's rows above
    ("2pc-7", "bucket_plan_fused",
     {"lanes": 32768, "valid": 21858, "lines": 9749, "novel": 3535},
     "0.0006058"),
    ("2pc-10", "bucket_plan_fused",
     {"lanes": 65536, "valid": 32979, "lines": 20191, "novel": 4286},
     "0.0011469"),
    ("paxos-3", "bucket_plan_fused",
     {"lanes": 8192, "valid": 4522, "lines": 3443, "novel": 2012},
     "0.0002015"),
    ("single-copy-4", "bucket_plan_fused",
     {"lanes": 8192, "valid": 4883, "lines": 4165, "novel": 2690},
     "0.0002406"),
    ("per-channel paxos-2", "bucket_plan_fused",
     {"lanes": 4096, "valid": 1056, "lines": 708, "novel": 653},
     "0.0000512"),
    ("2pc-15 symmetry", "bucket_plan_fused",
     {"lanes": 65536, "valid": 36880, "lines": 7424, "novel": 2772},
     "0.0006560"),
    ("ORL", "bucket_plan_fused",
     {"lanes": 8192, "valid": 222, "lines": 93, "novel": 36}, "0.0000247"),
    ("paxos-3 prededup", "bucket_plan_fused",
     {"lanes": 8192, "valid": 3463, "lines": 3443, "novel": 2012},
     "0.0001965"),
    ("spill 2pc-7 inject", "bucket_plan_fused",
     {"lanes": 151552, "valid": 10385, "lines": 9609, "novel": 10385,
      "cidx": False},
     "0.0009027"),
    ("spill paxos-3 inject", "bucket_plan_fused",
     {"lanes": 245760, "valid": 359, "lines": 358, "novel": 359,
      "cidx": False},
     "0.0006066"),
    ("POR proviso", "bucket_plan_fused",
     {"lanes": 4096, "valid": 16, "lines": 16, "novel": 16}, "0.0000107"),
    ("mesh 2pc-7 piece 0", "bucket_plan_fused",
     {"lanes": 32768, "keys": 6502, "valid": 6502, "lines": 2708,
      "novel": 884, "cidx": True, "win": True}, "0.0001627"),
]


@pytest.mark.parametrize("row", range(len(PERF_TABLE)),
                         ids=[f"{r[1]}-{r[0]}" for r in PERF_TABLE])
def test_kernel_cost_reproduces_the_perf_table_bound(row):
    _, kernel, shapes, printed = PERF_TABLE[row]
    nbytes, ops = kernel_cost(kernel, shapes)
    ms = nbytes / HBM * 1e3
    # every bound in the table is by bytes: the operations at 67e12/s are
    # smaller
    assert ops / 67e12 * 1e3 <= ms
    digits = len(printed.split(".")[1])
    assert f"{ms:.{digits}f}" == printed


def test_kernel_rw_splits_into_the_cost():
    for _, kernel, shapes, _ in PERF_TABLE:
        r, w, ops = kernel_rw(kernel, shapes)
        assert (r + w, ops) == kernel_cost(kernel, shapes)


def twin_configs():
    from stateright_tpu_torch.models import __all__ as names

    out = []
    for name in names:
        mod = importlib.import_module(f"stateright_tpu_torch.models.{name}")
        for label, model in mod._audit_models([]):
            out.append(label)
    return out


def test_plain_walks_stay_inside_the_band_over_the_fleet():
    """The pinned contract: the walk of each plain version is never below
    its kernel's bytes and at most BYTES_HI times them, over every
    twin-bearing configuration (the ratios are what BYTES_HI was stated
    from)."""
    from stateright_tpu_torch.models import __all__ as names

    seen = 0
    for name in names:
        mod = importlib.import_module(f"stateright_tpu_torch.models.{name}")
        for label, model in mod._audit_models([]):
            twin = twin_or_none(model)
            if twin is None:
                continue
            seen += 1
            for kernel, w in plain_walks(twin).items():
                ratio = w["plain_bytes"] / w["kernel_bytes"]
                assert BYTES_LO <= ratio <= BYTES_HI, (label, kernel, ratio)
    assert seen == 8


@pytest.mark.parametrize("name", ["2pc-3", "paxos-1"])
def test_engine_stages_are_the_kernels_counts(name):
    from stateright_tpu_torch.models.paxos import paxos_model

    model = TwoPhaseSys(3) if name == "2pc-3" else paxos_model(1)
    twin = model.tensor_model()
    rep = wavefront_costs(twin, 1 << 12, 1 << 11, 64)
    assert rep.recon_block()["ok"], rep.recon_block()
    a, w = twin.max_actions, twin.width
    sh = step_shapes(64, a, w, 1 << 12, max(4 * 64, 4096))
    assert rep.stages["hash"].bytes_total == kernel_cost(
        "cand_prep", sh["cand_prep"])[0]
    assert rep.stages["hash"].flops == kernel_cost(
        "cand_prep", sh["cand_prep"])[1]
    ref = engine_stages(64, a, w, 1 << 12, max(4 * 64, 4096))
    for stage in ("hash", "dedup-insert", "queue"):
        assert rep.stages[stage].to_json() == ref[stage].to_json()
    # the step's plan is the fused entry: no sort's tail is charged
    kernels = (kernel_cost("bucket_plan_fused", sh["bucket_plan"])[0]
               + kernel_cost("insert_commit", sh["insert_commit"])[0]
               + kernel_cost("sort", sh["sort"])[0])
    pop = 64 * (8 * w + 16) * 2 + 4 * 64 * 8
    assert (rep.stages["dedup-insert"].bytes_total
            + rep.stages["queue"].bytes_total) == kernels + pop


def test_walk_scales_from_the_shared_capture():
    """``property``/``expand`` are walks of the preflight's batch-4
    capture (no recapture), scaled per row to the step's batch."""
    twin = TwoPhaseSys(3).tensor_model()
    a = wavefront_costs(twin, 1 << 12, 1 << 11, 64)
    b = wavefront_costs(twin, 1 << 12, 1 << 11, 128)
    assert list(twin._graph_cache) == [("property_masks", 4, "cpu"),
                                       ("step_rows", 4, "cpu")]
    for st in ("property", "expand"):
        assert b.stages[st].bytes_total == 2 * a.stages[st].bytes_total
        assert b.stages[st].flops == 2 * a.stages[st].flops


def test_classify_op_covers_the_catalogue():
    assert classify_op("index") == "gather"
    assert classify_op("index_put") == "scatter"
    assert classify_op("select_scatter") == "scatter"
    assert classify_op("sort") == "sort"
    assert classify_op("bmm") == "dot"
    assert classify_op("any") == "reduce"
    assert classify_op("bitwise_and") == "elementwise"


def test_jx4xx_on_2pc3_are_jaxs_and_the_key_sort():
    from stateright_tpu.analysis.costmodel import (
        wavefront_costs as jax_costs,
    )
    from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxSys

    rules = lambda rep: {(f.rule_id, f.severity) for f in rep.findings}
    port = wavefront_costs(TwoPhaseSys(3).tensor_model(), 1 << 12, 1 << 11,
                           64)
    ref = jax_costs(JaxSys(3)._tensor_cached(), 1 << 12, 1 << 11, 64)
    assert rules(port) == rules(ref) | {("JX401", "info")}
    sort = [c for c in port.candidates if c["op_class"] == "sort"]
    assert [c["op"] for c in sort] == ["sort"]
    byte_list = [c["bytes"] for c in port.candidates]
    assert byte_list == sorted(byte_list, reverse=True)
    assert port.candidates[0]["stage"] == "dedup-insert"
    assert all("hatch" not in f.message for f in port.findings)


# -- the roofline view, against the JAX package's ------------------------------

STATIC = {"stages": {
    "a": {"intensity": 0.05},
    "b": {"intensity": 500.0},
    "c": {},
    "d": {"intensity": 3.0, "flops": 100,
          "classes": {"dot": {"flops": 80}}},
}}


def test_classify_stages_equals_jax():
    for spec in (
        {"peak_flops": 1e14, "hbm_bytes_per_sec": 1e12, "ridge": 100.0},
        spec_for_name("NVIDIA H100 80GB HBM3"),
        None,
    ):
        assert classify_stages(STATIC, spec) == jax_roofline.classify_stages(
            STATIC, spec)
    v = classify_stages(STATIC, spec_for_name("NVIDIA H100 80GB HBM3"))
    assert v["a"]["verdict"] == "memory-bound" and v["a"]["ridge_kind"] == "vpu"
    assert v["b"]["verdict"] == "compute-bound"
    assert v["c"]["verdict"] == "unknown" and v["d"]["ridge_kind"] == "mxu"


def test_achieved_block_equals_jax():
    static = {"totals": {"bytes": 1000, "flops": 100}, "batch": 10}
    spec = {"peak_flops": 1e6, "hbm_bytes_per_sec": 1e6, "ridge": 1.0}
    for st, unique, batch in (
        (static, 25, 10), ({**static, "devices": 4}, 100, 10),
        ({"totals": {}}, 25, 10),
    ):
        for secs in ({"device_secs": 2.0}, None):
            for sp in (spec, None):
                assert achieved_block(st, sp, secs, unique, batch) == \
                    jax_roofline.achieved_block(st, sp, secs, unique, batch)
    ach = achieved_block(static, spec, {"device_secs": 2.0}, 25, 10)
    assert ach["est_device_steps"] == 3 and ach["bytes_per_sec"] == 1500.0


def test_spec_table_and_override(monkeypatch, capsys):
    monkeypatch.delenv(ENV_DEVICE_SPEC, raising=False)
    sxm = spec_for_name("NVIDIA H100 80GB HBM3")
    assert (sxm["mxu_peak"], sxm["vpu_peak"], sxm["hbm_bytes_per_sec"]) == (
        989e12, 67e12, 3.35e12)
    assert sxm["vpu_ridge"] == 67e12 / 3.35e12 and sxm["src"] == "device"
    assert spec_for_name("NVIDIA H100 PCIe")["name"] == "nvidia-h100-pcie"
    assert spec_for_name("Intel Xeon") is None
    import torch

    if not torch.cuda.is_available():
        assert device_spec() is None  # intensities only
    monkeypatch.setenv(ENV_DEVICE_SPEC, "9.89e14:3.35e12:h100:6.7e13")
    spec = device_spec()
    assert spec["src"] == "env" and spec["name"] == "h100"
    assert spec == jax_roofline.device_spec()
    monkeypatch.setenv(ENV_DEVICE_SPEC, "garbage")
    assert device_spec() is None or device_spec()["src"] != "env"
    assert "malformed" in capsys.readouterr().err


# -- the ledger on a run ----------------------------------------------------------


def test_roofline_on_dispatches_the_same_operations(monkeypatch):
    """With the roofline on, every step dispatches exactly the operations
    of the step with it off (the flags-off pin of 2pc-3)."""
    from test_torch_engine import FLAGS_OFF_OPS_PER_STEP, OpCount

    from stateright_tpu_torch.parallel import wavefront

    steps = []
    step = wavefront._Engine.step

    def counted(self, c):
        probe = OpCount()
        with probe:
            out = step(self, c)
        steps.append(probe.ops)
        return out

    monkeypatch.setattr(wavefront._Engine, "step", counted)
    runs = []
    for on in (False, True):
        steps.clear()
        b = TwoPhaseSys(3).checker().telemetry(roofline=on)
        c = b.spawn_gpu(device="cpu", batch=64, steps_per_call=4).join()
        runs.append((c, list(steps)))
    (off, off_steps), (on, on_steps) = runs
    assert off.roofline() is None and on.roofline() is not None
    assert on_steps == off_steps
    assert {sum(s.values()) for s in on_steps} <= FLAGS_OFF_OPS_PER_STEP["2pc"]
    assert on.unique_state_count() == off.unique_state_count() == 288


def test_roofline_record_snapshot_and_metrics_bus():
    from stateright_tpu_torch.telemetry.metrics import MetricsBus

    c = TwoPhaseSys(3).checker().roofline().spawn_gpu(
        device="cpu", batch=64).join()
    recs = c.flight_recorder.records("roofline")
    assert len(recs) == 1 and recs[0]["at"] == "init"
    assert recs[0]["v"] == ROOFLINE_V and recs[0]["reconciled"] is True
    assert set(recs[0]["stages"]) == {"property", "expand", "hash",
                                      "dedup-insert", "queue"}
    assert c.flight_recorder.summary()["roofline"]["totals"]["bytes"] > 0
    live = c.roofline()
    assert live["reconciliation"]["ok"] and "achieved" in live
    assert {v["verdict"] for v in live["verdicts"].values()} == {"unknown"}
    static = c.roofline(live=False)
    assert "reconciliation" not in static and "verdicts" not in static
    assert {f.rule_id for f in c._roofline_ledger.findings()} >= {"JX400",
                                                                 "JX402"}
    # the metrics block: the ring record published as per-stage gauges
    from stateright_tpu_torch.telemetry.recorder import FlightRecorder

    bus = MetricsBus()
    rec = FlightRecorder(metrics=bus)
    rec.record("roofline", **{k: v for k, v in recs[0].items()
                              if k not in ("seq", "t", "kind")})
    text = bus.expose()
    assert 'stateright_roofline_stage_bytes{engine="gpu-wavefront"' in text
    assert 'stage="dedup-insert"' in text


def test_report_blocks_deterministic_and_the_jax_diff(tmp_path):
    """The run report carries the deterministic ``roofline``, ``audit``
    and ``sanitizer`` blocks (the preflight leaves ``_audit_report``), two
    runs write the same body, and a JAX report of 2pc-5 with its preflight
    diffs the port's ``IDENTICAL`` (``PERF-ONLY`` for device or checkout
    drift alone)."""
    from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxSys
    from stateright_tpu_torch.telemetry.diff import (
        IDENTICAL, PERF_ONLY, diff_reports,
    )
    from stateright_tpu_torch.telemetry.report import VOLATILE_KEYS

    bodies = []
    for i in range(2):
        p = str(tmp_path / f"t{i}.json")
        TwoPhaseSys(5).checker().roofline().report(p).spawn_gpu(
            device="cpu", capacity=1 << 10, batch=64,
            steps_per_call=4).join()
        with open(p) as f:
            bodies.append({k: v for k, v in json.load(f).items()
                           if k not in VOLATILE_KEYS})
    assert bodies[0] == bodies[1]
    b = bodies[0]
    assert b["audit"]["ok"] and "JX106" in b["audit"]["rules"]
    assert b["sanitizer"]["undecided"] == 0
    assert b["sanitizer"]["checked_run"] is False
    assert "device_spec" not in b["roofline"]
    assert "reconciliation" not in b["roofline"]
    md = (tmp_path / "t0.md").read_text()
    assert "## Roofline (static cost model)" in md
    assert "## Audit / sanitizer" in md
    j = str(tmp_path / "j.json")
    JaxSys(5).checker().report(j).spawn_tpu(
        sync=True, capacity=1 << 10, frontier_capacity=64, steps_per_call=4)
    with open(j) as f:
        a = json.load(f)
    assert "audit" in a and "sanitizer" in a
    t = str(tmp_path / "plain.json")
    TwoPhaseSys(5).checker().report(t).spawn_gpu(
        device="cpu", capacity=1 << 10, batch=64, steps_per_call=4).join()
    with open(t) as f:
        port = json.load(f)
    d = diff_reports(a, port)
    assert d["violations"] == [] and d["verdict"] in (IDENTICAL, PERF_ONLY)
    assert set(d["config_delta"]) <= {"engine", "device", "git_rev"}
    if d["verdict"] == PERF_ONLY:
        assert set(d["config_delta"]) & {"device", "git_rev"}


def test_costmodel_verbs(capsys, tmp_path):
    from stateright_tpu_torch.models import two_phase_commit

    out = str(tmp_path / "c.json")
    assert two_phase_commit.main(["costmodel", f"--out={out}"]) == 0
    text = capsys.readouterr().out
    assert "kernel reconciliation: ok" in text and "JX402" in text
    with open(out) as f:
        doc = json.load(f)
    assert doc["configs"][0]["stages"]["hash"]["flops"] > 0
    assert _cli.main(["costmodel", "two_phase_commit", "increment"]) == 0
    assert capsys.readouterr().out.strip().endswith("costmodel fleet: OK")


def test_fold_into_report():
    from stateright_tpu_torch.analysis import AuditReport
    from stateright_tpu_torch.analysis.costmodel import fold_into_report

    rep = wavefront_costs(TwoPhaseSys(3).tensor_model(), 1 << 12, 1 << 11, 64)
    report = AuditReport()
    fold_into_report(rep, report)
    assert {"JX400", "JX402"} <= report.rule_ids()
    assert report.metrics["costmodel"]["reconciled"] is True


def test_the_port_does_not_import_the_reference():
    """The new modules import neither ``jax`` nor ``stateright_tpu`` (the
    subprocess isolation test covers whole runs)."""
    import subprocess

    code = ("import sys\n"
            "import stateright_tpu_torch.analysis.costmodel\n"
            "import stateright_tpu_torch.analysis.kernel_audit\n"
            "import stateright_tpu_torch.analysis.interval\n"
            "import stateright_tpu_torch.telemetry.roofline\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'stateright_tpu.'))"
            " or m == 'stateright_tpu']\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
    assert roofline.DEVICE_SPECS
