"""Run reports, the run registry and the contract-aware diff in the port
(``stateright_tpu_torch/telemetry/{report,registry,diff,_atomic}.py``):

 - the report body is byte-stable across two runs, outside
   ``VOLATILE_KEYS``;
 - the port's ``diff`` of the JAX engine's report and the port's report of
   2pc-5 classifies ``IDENTICAL`` with no violations, and its config
   differs only in the engine (its ``instance.sig`` is the JAX one);
 - ``runs(DIR)`` and ``STATERIGHT_TPU_RUN_DIR`` archive each run once,
   with a ``config_key``-indexed headline; a resumed run links to its
   parent, and the lineage pair diffs ``IDENTICAL``;
 - the registry's durable append heals a torn tail line;
 - the registry and the report add no operation to a step;
 - a report's ``git_rev`` is read from the package's own checkout only:
   a copy without ``.git`` gets None, a worktree's ``.git`` file is
   followed.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxSys
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.telemetry import RunRegistry
from stateright_tpu_torch.telemetry._atomic import durable_append_line
from stateright_tpu_torch.telemetry.diff import (
    IDENTICAL, PERF_ONLY, diff_reports,
)
from stateright_tpu_torch.telemetry.report import VOLATILE_KEYS, _git_rev

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

KW = dict(device="cpu", batch=64, capacity=1 << 10, steps_per_call=4)


def body_bytes(path):
    with open(path) as f:
        doc = json.load(f)
    return json.dumps({k: v for k, v in doc.items()
                       if k not in VOLATILE_KEYS}).encode()


def test_report_body_is_byte_stable(tmp_path):
    paths = [str(tmp_path / f"r{i}.json") for i in range(2)]
    for p in paths:
        TwoPhaseSys(5).checker().report(p).spawn_gpu(**KW).join()
    assert body_bytes(paths[0]) == body_bytes(paths[1])
    with open(paths[0]) as f:
        doc = json.load(f)
    assert doc["engine"] == "gpu-wavefront" and doc["totals"]["done"]
    assert doc["growth_events"] and doc["health_timeline"]
    assert doc["final_phase"] == "done"
    assert sum(doc["cartography"]["depth_hist"]) == 8_832
    assert doc["config"]["device"] == "cpu"
    with pytest.raises(ValueError):
        TwoPhaseSys(3).checker().report(str(tmp_path / "x.md"))


def test_jax_and_port_reports_diff_identical(tmp_path):
    j, t = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    JaxSys(5).checker().report(j).spawn_tpu(
        sync=True, capacity=1 << 10, frontier_capacity=64, steps_per_call=4)
    TwoPhaseSys(5).checker().report(t).spawn_gpu(**KW).join()
    with open(j) as f:
        a = json.load(f)
    with open(t) as f:
        b = json.load(f)
    d = diff_reports(a, b)
    assert d["verdict"] in (IDENTICAL, PERF_ONLY), d
    assert d["violations"] == []
    assert set(d["config_delta"]) <= {"engine", "device", "git_rev"}
    assert a["config"]["instance"] == b["config"]["instance"]
    assert a["cartography"] == b["cartography"]
    assert a["growth_events"] == b["growth_events"]
    assert a["health_timeline"] == b["health_timeline"]


def test_registry_archives_each_run_once(tmp_path, monkeypatch):
    root = str(tmp_path / "runs")
    c = TwoPhaseSys(3).checker().runs(root).spawn_gpu(**KW).join()
    c.join()  # a second join archives nothing more
    reg = RunRegistry(root)
    (rec,) = reg.index()
    assert rec["run_id"] == c.run_id
    assert rec["headline"]["unique"] == 288
    assert reg.load(c.run_id)["totals"]["unique"] == 288
    monkeypatch.setenv("STATERIGHT_TPU_RUN_DIR", root)
    TwoPhaseSys(3).checker().spawn_bfs().join()
    recs = reg.index()
    assert len(recs) == 2 and recs[1]["engine"] == "BfsChecker"
    assert len(reg.trends()) == 2  # two configurations, one run each


def test_resume_links_lineage_and_diffs_identical(tmp_path):
    root = str(tmp_path / "runs")
    parent = (TwoPhaseSys(5).checker().runs(root).target_states(2000)
              .spawn_gpu(**KW).join())
    snap = parent.checkpoint()
    assert str(snap["run_id"]) == parent.run_id
    child = (TwoPhaseSys(5).checker().runs(root)
             .spawn_gpu(device="cpu", resume=snap).join())
    assert child.parent_run_id == parent.run_id
    reg = RunRegistry(root)
    assert [r["run_id"] for r in reg.chain(child.run_id)] == [
        parent.run_id, child.run_id]
    d = diff_reports(reg.load(parent.run_id), reg.load(child.run_id))
    assert d["verdict"] == IDENTICAL and "lineage" in d, d


def test_durable_append_heals_a_torn_tail(tmp_path):
    path = str(tmp_path / "index.jsonl")
    with open(path, "w") as f:
        f.write('{"run_id": "a"}\n{"run_id": "b", "torn')
    durable_append_line(path, json.dumps({"run_id": "c"}))
    reg = RunRegistry(str(tmp_path))
    assert [r["run_id"] for r in reg.index()] == ["a", "c"]
    assert os.listdir(str(tmp_path)) == ["index.jsonl"]


def test_report_and_registry_add_no_operation(tmp_path, monkeypatch):
    from torch.utils._python_dispatch import TorchDispatchMode

    from stateright_tpu_torch.parallel import wavefront

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    counts = []
    step = wavefront._Engine.step

    def counted(self, c):
        Count.n = 0
        with Count():
            out = step(self, c)
        counts.append(Count.n)
        return out

    monkeypatch.setattr(wavefront._Engine, "step", counted)
    TwoPhaseSys(3).checker().cartography().spawn_gpu(**KW).join()
    plain = set(counts)
    counts.clear()
    TwoPhaseSys(3).checker().report(str(tmp_path / "r.json")).runs(
        str(tmp_path / "runs")).spawn_gpu(**KW).join()
    assert set(counts) == plain


def _fake_repo(root, rev="0123456789abcdef0123"):
    """A minimal git dir at ``root/.git``: HEAD on ``main``, one loose ref."""
    gd = root / ".git"
    (gd / "refs" / "heads").mkdir(parents=True)
    (gd / "HEAD").write_text("ref: refs/heads/main\n")
    (gd / "refs" / "heads" / "main").write_text(rev + "\n")
    return gd


def test_git_rev_never_leaves_the_checkout(tmp_path):
    # a git-archive copy nested in another repository: the copy has no
    # .git of its own, so its reports carry no revision, never the
    # enclosing repository's
    _fake_repo(tmp_path)
    copy = tmp_path / "archive"
    shutil.copytree(os.path.join(REPO, "stateright_tpu_torch"),
                    copy / "stateright_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    code = ("from stateright_tpu_torch.telemetry.report import _git_rev;"
            "print(repr(_git_rev()))")
    env = dict(os.environ, PYTHONPATH=str(copy))
    out = subprocess.run([sys.executable, "-c", code], cwd=copy, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "None"
    assert _git_rev(tmp_path) == "0123456789ab"


def test_git_rev_follows_a_worktree_gitdir_file(tmp_path):
    # a `git worktree`: `.git` is a file naming the worktree's git dir,
    # whose branch ref lives in the main repository's git dir
    main = _fake_repo(tmp_path / "main", rev="fedcba9876543210fedc")
    wt_dir = main / "worktrees" / "wt"
    wt_dir.mkdir(parents=True)
    (wt_dir / "HEAD").write_text("ref: refs/heads/main\n")
    (wt_dir / "commondir").write_text("../..\n")
    wt = tmp_path / "wt"
    wt.mkdir()
    (wt / ".git").write_text(f"gitdir: {wt_dir}\n")
    assert _git_rev(wt) == "fedcba987654"
    (wt / ".git").write_text("gitdir: missing\n")
    assert _git_rev(wt) is None
