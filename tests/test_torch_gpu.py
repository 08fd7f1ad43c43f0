"""Card-only tests of the port: each hand-written CUDA kernel against its
plain PyTorch version on a CUDA device (integer outputs: equal), at the
2pc widths, ``bucket_plan`` in generation order (the symmetry runs' mode)
on the seeded cases of the CPU tests and at the 2pc-15 symmetry cell, at the paxos widths (W = 18 words and A = 16 actions for
paxos-1, W = 33 and A = 30 for paxos-3) and at the compiled twins' (W = 21
and A = 20 for single-copy-4 and lin-reg-3-ordered, W = 25 and A = 24 for
dining-3, W = 83 and A = 82 for per-channel paxos-2), ``row_hash`` from W = 1
to its widest row, and the engine's table and queue on
``cuda`` against ``cpu`` (2pc-4, 2pc-5, a bounded 2pc-7, paxos-2,
lin-reg-3-ordered, raft-3, per-channel paxos-1, single-copy(2,1) with two
puts in both packings, and wo(2,1); 2pc-7 and raft-3 under symmetry; the
ORL sender/receiver; 2pc-7 and paxos-2 under ``.prededup()``), a
prededup step's ``row_hash`` launch and ``window_unique`` against their
plain versions, a live checkpoint and an autosave generation resumed
on ``cuda`` against an uninterrupted ``cuda`` run, and checked mode and the
spill tier: 2pc-5 under ``.spill()`` and a budget that evicts (tables,
queue rows, store and tallies) and under ``.checked()`` on ``cuda`` against
``cpu``, and the out-of-range twin's error on the card with the CUDA
context still usable after it; a real device OOM, which the supervisor
classifies as ``oom``, and a supervised 2pc-5 killed at a host sync that
ends on ``cuda`` with the ``cpu`` run's tables; and partial-order
reduction: ``.por()`` runs on ``cuda`` against ``cpu`` (per-channel
paxos-1 plain, with queue growth and with the rollback, ``WorkersSys(7)``,
``ToggleSys``, 2pc-5 under symmetry and prededup) and the proviso round's
three insert kernels against their plain versions; and the service layer:
the Explorer over a 2pc-5 GPU run on ``cuda`` (both discoveries through
``/.states``) and a packed two-tenant fleet on ``cuda`` against ``cpu``;
and the sharded engine (``spawn_gpu(devices=N)``): 2pc-5, 2pc-4 with
growth, 2pc-5 under symmetry, prededup and cartography, and ``ToggleSys``
under POR, each snapshot on ``cuda`` against ``cpu``, shard for shard;
and the mesh engine (``.mesh()``, 4 pieces on the card): 2pc-5, 2pc-5
under symmetry, 2pc-4 with growth and per-channel paxos-1 under POR on
``cuda`` against 4 pieces on ``cpu``, and ``insert_commit``'s window mode
against its plain version; and the block graph (``ops/block_loop.py``):
``block_cond`` against its plain version, the graph block against the
eager loop bit for bit block after block (2pc-5, paxos-2, 2pc-4 under
symmetry, every flag of the single-device engine, the target and
discovery stops, each complete and stopped by growth), exact launch
counts, and a run's capture records.

Marked ``gpu``; each test decides inside itself whether a card is present
and skips without one.  This file imports no JAX (the machine with the
card has none), so on that machine it runs without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import io
import json
import time

import numpy as np
import pytest
import torch

from stateright_tpu_torch import checkpoint as ckpt
from stateright_tpu_torch import convert
from stateright_tpu_torch.actor import Network
from stateright_tpu_torch.models.linearizable_register import abd_model
from stateright_tpu_torch.models.orl import orl_model
from stateright_tpu_torch.models.paxos import paxos_model
from stateright_tpu_torch.models.raft import raft_model
from stateright_tpu_torch.models.single_copy_register import single_copy_model
from stateright_tpu_torch.models.write_once_register import wo_register_model
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.ops.buckets import (
    SLOTS,
    PlanBuffers,
    bucket_bits,
    bucket_insert,
    bucket_plan,
    bucket_plan_fused,
    bucket_plan_fused_plain,
    bucket_plan_plain,
    compact_candidates,
    sort_candidates,
    sort_keys,
    window_unique,
)
from stateright_tpu_torch.ops.cand_prep import (
    PREP_TILE,
    PrepBuffers,
    cand_prep,
    cand_prep_plain,
    sort_prepared,
)
from stateright_tpu_torch.ops.hashing import (
    GAMMA as GAMMA_I64,
    ROW_HASH_MAX_WIDTH,
    row_hash,
    row_hash_plain,
)
from stateright_tpu_torch.ops.insert_commit import (
    QueueAppend,
    commit_tile,
    insert_commit,
    insert_commit_plain,
)
from stateright_tpu_torch.testing.block_legs import (
    BLOCK_LEGS,
    BLOCK_TARGET,
    per_channel_paxos,
)
from test_torch_plan_cases import (
    GEN_CASES,
    PLAN_CASES,
    gen_case,
    plan_case,
)

pytestmark = pytest.mark.gpu
EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def rand_i64(rng, *shape):
    return torch.from_numpy(
        rng.integers(0, 1 << 64, size=shape, dtype=np.uint64).view(np.int64)
    )


def i64(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.uint64).view(np.int64).copy())


# 1 and 3 (2pc's and narrow rows), 21, 33 and 83 (the compiled twins' and
# paxos widths), and 191, 192 and 200, whose tiles hold 32, 31 and 30 rows:
# less than a warp, not a multiple of 32
@pytest.mark.parametrize("width", [1, 3, 21, 33, 83, 191, 192, 200])
def test_row_hash_kernel_matches_plain(cuda, width):
    rng = np.random.default_rng(width)
    rows = rand_i64(rng, 5000, width)
    rows[::7] = 0
    rows[::11] = -1
    valid = torch.from_numpy(rng.random(5000) < 0.5)
    for v in (None, valid):
        want = row_hash_plain(rows, v)
        got = row_hash(rows.to(cuda), None if v is None else v.to(cuda))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)


def test_row_hash_kernel_widest_row(cuda):
    """At the widest row the tile holds one row; one word more raises."""
    rng = np.random.default_rng(0)
    rows = rand_i64(rng, 70, ROW_HASH_MAX_WIDTH)
    valid = torch.from_numpy(rng.random(70) < 0.5)
    got = row_hash(rows.to(cuda), valid.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), row_hash_plain(rows, valid))
    wide = torch.zeros((2, ROW_HASH_MAX_WIDTH + 1), dtype=torch.int64)
    with pytest.raises(ValueError, match="row_hash"):
        row_hash(wide.to(cuda))


@pytest.mark.parametrize("case", PLAN_CASES)
def test_bucket_plan_kernel_matches_plain(cuda, case):
    rng = np.random.default_rng(PLAN_CASES.index(case))
    tfp, _tpl, fps, payloads, compact = plan_case(case, rng)
    inputs = sort_candidates(fps, payloads, tfp.shape[0] // SLOTS, compact)
    want = bucket_plan_plain(tfp, *inputs)
    args = [None if x is None else x.to(cuda) for x in (tfp, *inputs)]
    out = PlanBuffers(inputs[0].shape[0], cuda)
    for _ in range(2):  # the second launch finds the scratch reset
        got = [x.cpu() for x in bucket_plan(*args, out=out)]
        torch.cuda.synchronize()
        assert int(got[4]) == int(want[4])  # n_new
        assert bool(got[5]) == bool(want[5])  # overflow
        novel = int((want[0] != tfp.shape[0]).sum())  # planned, even if blocked
        for g, w in zip(got[:4], want[:4]):
            assert torch.equal(g[:novel], w[:novel])
    expect = {"overflow_in_last_tile_only": (True, 0), "cand_overflow": (False, 0),
              "n_new_zero": (False, 0), "m_1": (False, 1)}.get(case)
    if expect is not None:
        assert (bool(want[5]), int(want[4])) == expect
    else:
        assert int(want[4]) > 0


def check_generation_order(cuda, tfp, inputs):
    """The generation-order kernel against its plain version on one input,
    twice into the same buffers (the second launch finds the scratch and
    the staged slots reset); each call is two launches."""
    want = bucket_plan_plain(tfp, *inputs, generation_order=True)
    args = [None if x is None else x.to(cuda) for x in (tfp, *inputs)]
    out = PlanBuffers(inputs[0].shape[0], cuda, generation_order=True)
    before = bucket_plan.launches
    planned = int((want[0] != tfp.shape[0]).sum())
    for _ in range(2):
        got = [x.cpu() for x in bucket_plan(*args, out=out,
                                            generation_order=True)]
        torch.cuda.synchronize()
        assert int(got[4]) == int(want[4])  # n_new
        assert bool(got[5]) == bool(want[5])  # overflow
        for g, w in zip(got[:4], want[:4]):
            assert torch.equal(g[:planned], w[:planned])
    assert bucket_plan.launches - before == 4
    assert bool((out.stage[:out.m] == -1).all())  # no slot left staged
    return want, planned


@pytest.mark.parametrize("case", PLAN_CASES + GEN_CASES)
def test_bucket_plan_generation_order_kernel_matches_plain(cuda, case):
    if case in PLAN_CASES:
        rng = np.random.default_rng(PLAN_CASES.index(case))
        tfp, _tpl, fps, payloads, compact = plan_case(case, rng)
    else:
        rng = np.random.default_rng(GEN_CASES.index(case))
        nb, pre, fps, compact = gen_case(case, rng)
        payloads = rand_i64(rng, fps.size)
        tfp = torch.full((nb * SLOTS,), -1, dtype=torch.int64)
        bucket_insert(tfp, torch.zeros_like(tfp), i64(pre), i64(pre))
        fps = i64(fps)
    inputs = sort_candidates(fps, payloads, tfp.shape[0] // SLOTS, compact)
    want, planned = check_generation_order(cuda, tfp, inputs)
    # the same slots as table order (an overflowing lane of the last bucket
    # plans slot nslots, so the whole lists are compared), listed in
    # candidate order
    tab = bucket_plan_plain(tfp, *inputs)
    assert torch.equal(torch.sort(want[0]).values, torch.sort(tab[0]).values)
    assert torch.equal(torch.sort(want[3][:planned]).values, want[3][:planned])


def fused_case(case):
    """(table fp, the fused entry's inputs, the pre-gathered entry's) of a
    ``PLAN_CASES`` or ``GEN_CASES`` case."""
    if case in PLAN_CASES:
        rng = np.random.default_rng(PLAN_CASES.index(case))
        tfp, _tpl, fps, payloads, compact = plan_case(case, rng)
    else:
        rng = np.random.default_rng(GEN_CASES.index(case))
        nb, pre, fps, compact = gen_case(case, rng)
        payloads = rand_i64(rng, fps.size)
        tfp = torch.full((nb * SLOTS,), -1, dtype=torch.int64)
        bucket_insert(tfp, torch.zeros_like(tfp), i64(pre), i64(pre))
        fps = i64(fps)
    f, pl, cidx, cov = compact_candidates(fps, payloads, compact)
    fused = (f, pl, *sort_keys(f), cidx, cov)
    nb = tfp.shape[0] // SLOTS
    return tfp, fused, sort_candidates(fps, payloads, nb, compact)


@pytest.mark.parametrize("gen", [False, True], ids=["table", "generation"])
@pytest.mark.parametrize("case", PLAN_CASES + GEN_CASES)
def test_bucket_plan_fused_kernel_matches_plain(cuda, case, gen):
    """The fused entry against its plain version, twice into the same
    buffers (the scratch and the staged slots reset), and the
    pre-gathered entry on the same case: the planned lanes (blocked or
    not) and both scalars, equal to plain and to each other."""
    tfp, fused, sort = fused_case(case)
    nb = tfp.shape[0] // SLOTS
    want = bucket_plan_fused_plain(tfp, *fused, nb, generation_order=gen)
    planned = int((want[0] != tfp.shape[0]).sum())
    dev = [None if x is None else x.to(cuda) for x in fused]
    out = PlanBuffers(fused[0].shape[0], cuda, generation_order=gen)
    before = bucket_plan_fused.launches
    for _ in range(2):
        got = [x.cpu() for x in bucket_plan_fused(
            tfp.to(cuda), *dev, nb, out=out, generation_order=gen)]
        torch.cuda.synchronize()
        assert int(got[4]) == int(want[4])  # n_new
        assert bool(got[5]) == bool(want[5])  # overflow
        for g, w in zip(got[:4], want[:4]):
            assert torch.equal(g[:planned], w[:planned])
    assert bucket_plan_fused.launches - before == (4 if gen else 2)
    assert int(out.scratch.abs().sum()) == 0  # left as the launch found it
    if gen:
        assert bool((out.stage[:out.m] == -1).all())
    gathered = [None if x is None else x.to(cuda) for x in sort]
    pre = [x.cpu() for x in bucket_plan(
        tfp.to(cuda), *gathered, generation_order=gen)]
    torch.cuda.synchronize()
    assert int(pre[4]) == int(want[4]) and bool(pre[5]) == bool(want[5])
    for g, w in zip(pre[:4], want[:4]):
        assert torch.equal(g[:planned], w[:planned])


@pytest.mark.parametrize("pieces", [2, 4])
def test_bucket_plan_fused_window_matches_plain(cuda, pieces):
    """The mesh engine's form: each table piece's window of the sorted
    lanes, buckets rebased, against the plain window."""
    tfp, fused, _ = fused_case("many_tiles")
    nb = tfp.shape[0] // SLOTS
    nbp = nb // pieces
    bits = bucket_bits(nb)
    firsts = [((k * nbp) << (64 - bits)) ^ (1 << 63) for k in range(pieces)]
    starts = torch.tensor([x - (1 << 64) if x >> 63 else x for x in firsts]
                          + [(1 << 63) - 1], dtype=torch.int64)
    bounds = torch.searchsorted(fused[2], starts)
    dev = [x.to(cuda) for x in fused]
    out = PlanBuffers(fused[0].shape[0], cuda)
    for k in range(pieces):
        part = tfp[k * nbp * SLOTS:(k + 1) * nbp * SLOTS]
        win = bounds[k:k + 2].clone()
        want = bucket_plan_fused_plain(part, *fused, nb, win=win,
                                       boff=k * nbp)
        planned = int((want[0] != part.shape[0]).sum())
        assert planned > 0
        got = [x.cpu() for x in bucket_plan_fused(
            part.to(cuda), *dev, nb, out=out, win=win.to(cuda),
            boff=k * nbp)]
        torch.cuda.synchronize()
        assert int(got[4]) == int(want[4]) and bool(got[5]) == bool(want[5])
        for g, w in zip(got[:4], want[:4]):
            assert torch.equal(g[:planned], w[:planned])


def staged_prep_case(width, mask, rng):
    """(rows, valid, pfps, arity) at ``width`` with a dense, sparse (3 %)
    or empty mask; M = 1,110 lanes is no multiple of the kernel's tile."""
    parents, arity = 37, 30
    m = parents * arity
    rows = rand_i64(rng, m, width)
    rows[::9, -1:] = -1
    rate = {"dense": 1.0, "sparse": 0.03, "empty": 0.0}[mask]
    valid = torch.from_numpy(rng.random(m) < rate)
    return rows, valid, rand_i64(rng, parents), arity


@pytest.mark.parametrize("budget", ["n_valid", "n_valid_minus_1"])
@pytest.mark.parametrize("mask", ["dense", "sparse", "empty"])
@pytest.mark.parametrize("width", [21, 33, 83, 700])
def test_cand_prep_staged_rows_match_plain(cuda, width, mask, budget):
    """The staged fold (rows copied to shared memory, in batches where a
    tile's valid rows do not fit; W = 700 is past a 48 KB tile of 256
    rows), every output lane and both scalars bit for bit, twice."""
    assert 1110 % PREP_TILE
    rng = np.random.default_rng(width * 7 + len(mask))
    rows, valid, pfps, arity = staged_prep_case(width, mask, rng)
    nv = int(valid.sum())
    cb = max(1, nv if budget == "n_valid" else nv - 1)
    want = cand_prep_plain(rows, valid, pfps, arity, cb)
    args = [x.to(cuda) for x in (rows, valid, pfps)]
    out = PrepBuffers(rows.shape[0], cb, cuda)
    for _ in range(2):
        got = [x.cpu() for x in cand_prep(*args, arity, cb, out=out)]
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    assert bool(want[5]) == (budget == "n_valid_minus_1" and nv > 1)


@pytest.mark.parametrize("budget", ["n_valid", "n_valid_minus_1"])
@pytest.mark.parametrize("mask", ["dense", "sparse", "empty"])
def test_cand_prep_staged_namespace_mode_matches_plain(cuda, mask, budget):
    """The namespace mode on staged rows (W = 33), bit for bit."""
    from stateright_tpu_torch.ops.cand_prep import Namespace

    rng = np.random.default_rng(33 + len(mask))
    rows, valid, pfps, arity = staged_prep_case(33, mask, rng)
    nv = int(valid.sum())
    cb = max(1, nv if budget == "n_valid" else nv - 1)
    ns = ns_case("k_8", rng, rows, arity)
    want = cand_prep_plain(rows, valid, pfps, arity, cb, ns)
    cns = Namespace(*(x.to(cuda) for x in ns[:3]), ns.bits)
    args = [x.to(cuda) for x in (rows, valid, pfps)]
    out = PrepBuffers(rows.shape[0], cb, cuda)
    for _ in range(2):
        got = [x.cpu() for x in cand_prep(*args, arity, cb, out=out, ns=cns)]
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_bucket_plan_generation_order_at_the_2pc15_symmetry_cell(cuda):
    """The next batch of a 2pc-15 symmetry run bounded at 200,000 classes:
    the engine's inputs to ``bucket_plan`` (canonical rows through
    ``cand_prep``, the stable sort), generation order on the card equal to
    the plain version."""
    c = TwoPhaseSys(15).checker().symmetry().target_states(200_000).spawn_gpu(
        device=cuda).join()
    carry, tm = c._final_carry, c.tensor
    head = int(carry[convert.HEAD])
    rows = carry[convert.QROWS][head:head + c._batch]
    succ, valid = tm.step_rows(rows)
    m = succ.shape[0] * tm.max_actions
    krows = tm.representative_rows(succ).reshape(m, -1)
    prep = cand_prep_plain(krows, valid.reshape(m),
                           carry[convert.QFP][head:head + c._batch],
                           tm.max_actions, min(c._cand, m))
    tfp = carry[convert.TFP]
    sort = (*sort_prepared(prep[0], prep[1], prep[3], tfp.shape[0] // SLOTS),
            prep[2], prep[5])
    want, planned = check_generation_order(cuda, tfp.cpu(),
                                           [x.cpu() for x in sort])
    assert int(want[4]) > 1000 and planned == int(want[4])


@pytest.mark.parametrize("name,unique", [("2pc7", 2326), ("raft3", 2926)])
def test_symmetry_table_and_queue_identical_on_cuda_and_cpu(cuda, name, unique):
    """Symmetry runs (canonical keys, generation-order inserts): the same
    table bytes, cursors and queue rows ``[0, tail)`` on both devices."""
    def run(device):
        m = TwoPhaseSys(7) if name == "2pc7" else raft_model(3)
        c = m.checker().symmetry().spawn_gpu(device=device, batch=256)
        return c.join().final_snapshot()

    g, c = run(cuda), run("cpu")
    assert int(g["unique"]) == int(c["unique"]) == unique
    assert int(g["head"]) == int(c["head"]) and int(g["tail"]) == int(c["tail"])
    tail = int(g["tail"])
    for k in ("table_fp", "table_parent"):
        np.testing.assert_array_equal(g[k], c[k], err_msg=k)
    for k in ("q_rows", "q_fp", "q_ebits", "q_depth"):
        np.testing.assert_array_equal(g[k][:tail], c[k][:tail], err_msg=k)


# the queue row widths of the commit's card tests: 2pc's 1, 2, the
# compiled twins' 21, paxos-3's 33, per-channel paxos-2's 83, and 700,
# whose tiles hold 2 lanes
COMMIT_WIDTHS = [1, 2, 21, 33, 83, 700]
# novel counts around a tile of T = commit_tile(width) lanes, in m = 37 T + 3
# lanes (not a multiple of T); "3000/4096" and "1/1" give m too
COMMIT_COUNTS = ["0", "1", "T-1", "T", "T+1", "m", "3000/4096", "1/1"]


def commit_counts(count: str, width: int) -> tuple:
    """``(n_new, m)`` of one of :data:`COMMIT_COUNTS` at ``width``."""
    if "/" in count:
        n, m = count.split("/")
        return int(n), int(m)
    t = commit_tile(width)
    m = 37 * t + 3
    return {"0": 0, "1": 1, "T-1": t - 1, "T": t, "T+1": t + 1,
            "m": m}[count], m


def commit_case(rng, m, n_new, width, tail, q, tags=False, arity=4,
                nslots=1 << 14):
    """Random commit inputs on the CPU: a table of ``nslots``, ``m`` plan
    lanes whose first ``n_new`` take distinct slots (the rest point past
    the table, as dead lanes may), and a queue of ``q`` rows of ``width``
    words appended at ``tail`` (with a sweep's tag column when ``tags``)."""
    nslots = max(nslots, 2 * n_new)
    tfp, tpl = rand_i64(rng, nslots), rand_i64(rng, nslots)
    tgt = torch.full((m,), nslots, dtype=torch.int64)
    tgt[:n_new] = torch.from_numpy(rng.choice(nslots, n_new, replace=False))
    cfp, cpl = rand_i64(rng, m), rand_i64(rng, m)
    b = -(-m // arity)

    def i32(lo, hi, size):
        return torch.from_numpy(rng.integers(lo, hi, size).astype(np.int32))

    extra = dict(tags=i32(-5, 5, q), parent_tags=i32(0, 1000, b)) if tags \
        else {}
    queue = QueueAppend(
        rand_i64(rng, q, width), rand_i64(rng, q), i32(0, 99, q),
        i32(0, 99, q), torch.tensor(tail), torch.from_numpy(rng.permutation(m)),
        rand_i64(rng, b * arity, width), i32(-99, 99, b), i32(0, 99, b),
        arity, **extra)
    return (tfp, tpl, tgt, cfp, cpl, torch.tensor(n_new)), queue


def commit_matches_plain(cuda, table, queue) -> None:
    """``insert_commit`` on the card against ``insert_commit_plain`` on the
    CPU, each on its own copy: the tables, the queue's four buffers and the
    tag column, every word (``queue`` None: the table-only launch)."""
    tfp, tpl, tgt, cfp, cpl, n = table
    cq = pq = None
    if queue is not None:
        cq = QueueAppend(*(x.to(cuda) if torch.is_tensor(x) else x
                           for x in queue))
        pq = QueueAppend(*(x.clone() if torch.is_tensor(x) else x
                           for x in queue))
    pf, pp = insert_commit_plain(tfp.clone(), tpl.clone(), tgt, cfp, cpl, n,
                                 pq)
    before = insert_commit.launches
    kf, kp = insert_commit(*(t.to(cuda) for t in (tfp, tpl, tgt, cfp, cpl, n)),
                           cq)
    torch.cuda.synchronize()
    assert insert_commit.launches == before + (tgt.shape[0] > 0)
    assert torch.equal(kf.cpu(), pf) and torch.equal(kp.cpu(), pp)
    if queue is not None:
        for g, w in zip(cq[:4] + (cq.tags,), pq[:4] + (pq.tags,)):
            assert (g is None and w is None) or torch.equal(g.cpu(), w)


@pytest.mark.parametrize("count", COMMIT_COUNTS)
@pytest.mark.parametrize("width", COMMIT_WIDTHS)
@pytest.mark.parametrize("with_queue", [False, True])
def test_insert_commit_kernel_matches_plain(cuda, count, width, with_queue):
    """Counts around the tile (none, one, a tile less one, a tile, a tile
    and one, every lane) at every row width, appended at an unaligned
    tail, with and without the queue half."""
    n_new, m = commit_counts(count, width)
    rng = np.random.default_rng(2 + width)
    tail = 123
    table, queue = commit_case(rng, m, n_new, width, tail, tail + m + 50)
    commit_matches_plain(cuda, table, queue if with_queue else None)


@pytest.mark.parametrize("width", COMMIT_WIDTHS)
def test_insert_commit_kernel_rows_end_at_the_queue_end(cuda, width):
    """The appended rows end at the queue's last row, inside a tile: the
    last tile's nominal rows reach past the buffer, and its live ones must
    not."""
    t = commit_tile(width)
    m = 5 * t + 3
    n_new = 3 * t + 1
    rng = np.random.default_rng(5 + width)
    q = 1000 + n_new
    table, queue = commit_case(rng, m, n_new, width, q - n_new, q)
    commit_matches_plain(cuda, table, queue)


@pytest.mark.parametrize("width", [1, 2])
def test_insert_commit_kernel_more_tiles_than_the_grid(cuda, width):
    """m = 2^20 lanes with 2^19 novel: far more tiles than the capped
    grid, so every CTA strides over many."""
    m, n_new = 1 << 20, 1 << 19
    rng = np.random.default_rng(17)
    table, queue = commit_case(rng, m, n_new, width, 77, m + 100,
                               nslots=1 << 21)
    commit_matches_plain(cuda, table, queue)


def prep_case(case, rng):
    """(rows, valid, pfps, arity, cb) for one case."""
    parents, arity, width, rate, cb = 40, 37, 1, 0.3, None
    if case == "m_1":
        parents, arity, rate, cb = 1, 1, 1.0, 1
    elif case == "m_257":
        parents, arity, width, rate, cb = 257, 1, 2, 0.5, 200
    elif case == "many_tiles":  # far more tiles than resident CTAs
        parents, rate, cb = 6500, 0.29, 1 << 17
    elif case == "cb_is_m":
        width = 3
    m = parents * arity
    rows = rand_i64(rng, m, width)
    valid = torch.from_numpy(rng.random(m) < rate)
    if case == "valid_run_across_3_tiles":
        valid[:] = False
        valid[PREP_TILE - 7:3 * PREP_TILE + 9] = True
    elif case == "n_valid_0":
        valid[:] = False
    nv = int(valid.sum())
    cb = cb or {"n_valid_cb": nv, "n_valid_cb_plus_1": nv - 1,
                "cb_is_m": m}.get(case, 1000)
    return rows, valid, rand_i64(rng, parents), arity, cb


PREP_CASES = ["m_1", "m_257", "valid_run_across_3_tiles", "many_tiles",
              "n_valid_0", "n_valid_cb", "n_valid_cb_plus_1", "cb_is_m"]


@pytest.mark.parametrize("case", PREP_CASES)
def test_cand_prep_kernel_matches_plain(cuda, case):
    """Every output lane (live and dead) and both scalars, bit for bit."""
    rng = np.random.default_rng(PREP_CASES.index(case))
    rows, valid, pfps, arity, cb = prep_case(case, rng)
    want = cand_prep_plain(rows, valid, pfps, arity, cb)
    args = [x.to(cuda) for x in (rows, valid, pfps)]
    out = PrepBuffers(rows.shape[0], cb, cuda)
    for _ in range(2):  # the second launch finds the scratch reset
        got = [x.cpu() for x in cand_prep(*args, arity, cb, out=out)]
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    overflow = {"n_valid_cb_plus_1": True, "many_tiles": False,
                "n_valid_0": False, "n_valid_cb": False}.get(case)
    if overflow is not None:
        assert bool(want[5]) == overflow


@pytest.mark.parametrize("n", [4, 5])
def test_engine_tables_identical_on_cuda_and_cpu(cuda, n):
    g = TwoPhaseSys(n).checker().spawn_gpu(device=cuda, batch=256).join()
    c = TwoPhaseSys(n).checker().spawn_gpu(device="cpu", batch=256).join()
    assert g.unique_state_count() == c.unique_state_count()
    for a, b in zip(g._table_np(), c._table_np()):
        np.testing.assert_array_equal(a, b)


def test_2pc7_table_and_queue_identical_on_cuda_and_cpu(cuda):
    """2pc-7 at a small batch, bounded so the CPU side stays short: table
    bytes, cursors and queue rows ``[0, tail)`` equal on both devices."""
    def run(device):
        b = TwoPhaseSys(7).checker().target_states(40_000)
        return b.spawn_gpu(device=device, batch=256).join().final_snapshot()

    g, c = run(cuda), run("cpu")
    assert int(g["head"]) == int(c["head"]) and int(g["tail"]) == int(c["tail"])
    assert int(g["unique"]) == int(c["unique"]) >= 40_000
    tail = int(g["tail"])
    for k in ("table_fp", "table_parent"):
        np.testing.assert_array_equal(g[k], c[k], err_msg=k)
    for k in ("q_rows", "q_fp", "q_ebits", "q_depth"):
        np.testing.assert_array_equal(g[k][:tail], c[k][:tail], err_msg=k)


# (width, arity) of the actor twins: paxos-1 and paxos-3 (hand-written),
# single-copy-4 / lin-reg-3-ordered, dining-3 and per-channel paxos-2
# (compiled)
ROW_SHAPES = [(18, 16), (33, 30), (21, 20), (25, 24), (83, 82)]


@pytest.mark.parametrize("width,arity", ROW_SHAPES)
def test_wide_row_kernels_match_plain(cuda, width, arity):
    """``cand_prep``, ``row_hash`` and ``insert_commit`` (with its queue
    half) on rows as wide as the actor twins', every lane bit for bit."""
    rng = np.random.default_rng(width)
    parents = 700
    m = parents * arity
    rows = rand_i64(rng, m, width)
    rows[::5, -3:] = -1  # free slot words, as in a paxos row
    valid = torch.from_numpy(rng.random(m) < 0.2)
    pfps = rand_i64(rng, parents)
    cb = 4096
    want = cand_prep_plain(rows, valid, pfps, arity, cb)
    got = cand_prep(*(x.to(cuda) for x in (rows, valid, pfps)), arity, cb,
                    out=PrepBuffers(m, cb, cuda))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)

    assert torch.equal(row_hash(rows.to(cuda), valid.to(cuda)).cpu(),
                       row_hash_plain(rows, valid))

    nslots, q, n_new = 1 << 15, 20000, 3000
    tgt = torch.full((cb,), nslots, dtype=torch.int64)
    tgt[:n_new] = torch.from_numpy(rng.choice(nslots, n_new, replace=False))
    cfp, cpl = rand_i64(rng, cb), rand_i64(rng, cb)
    queue = QueueAppend(
        rand_i64(rng, q, width), rand_i64(rng, q),
        torch.from_numpy(rng.integers(0, 99, q).astype(np.int32)),
        torch.from_numpy(rng.integers(0, 99, q).astype(np.int32)),
        torch.tensor(77), torch.from_numpy(rng.choice(m, cb, replace=False)),
        rows, torch.from_numpy(rng.integers(-99, 99, parents).astype(np.int32)),
        torch.from_numpy(rng.integers(0, 99, parents).astype(np.int32)), arity,
    )
    cq = QueueAppend(*(x.to(cuda) if torch.is_tensor(x) else x for x in queue))
    tfp, tpl = rand_i64(rng, nslots), rand_i64(rng, nslots)
    pf, pp = insert_commit_plain(tfp.clone(), tpl.clone(), tgt, cfp, cpl,
                                 torch.tensor(n_new), queue)
    kf, kp = insert_commit(*(t.to(cuda) for t in (tfp, tpl, tgt, cfp, cpl,
                                                  torch.tensor(n_new))), cq)
    torch.cuda.synchronize()
    assert torch.equal(kf.cpu(), pf) and torch.equal(kp.cpu(), pp)
    for g, w in zip(cq[:4], queue[:4]):
        assert torch.equal(g.cpu(), w)


def test_paxos2_table_and_queue_identical_on_cuda_and_cpu(cuda):
    """Paxos-2 (W = 22 words, A = 20): 16,668 unique on both devices, the
    same table bytes, cursors and queue rows ``[0, tail)``."""
    def run(device):
        c = paxos_model(2).checker().spawn_gpu(device=device, batch=256)
        return c.join().final_snapshot()

    g, c = run(cuda), run("cpu")
    assert int(g["unique"]) == int(c["unique"]) == 16668
    assert int(g["head"]) == int(c["head"]) and int(g["tail"]) == int(c["tail"])
    tail = int(g["tail"])
    for k in ("table_fp", "table_parent"):
        np.testing.assert_array_equal(g[k], c[k], err_msg=k)
    for k in ("q_rows", "q_fp", "q_ebits", "q_depth"):
        np.testing.assert_array_equal(g[k][:tail], c[k][:tail], err_msg=k)


@pytest.mark.parametrize("name", ["linreg3_ordered", "raft3"])
def test_compiled_twin_table_and_queue_identical_on_cuda_and_cpu(cuda, name):
    """The actor compiler's twins: lin-reg-3-ordered (36,213 unique) and
    raft-3 (5,725, timers): the same table bytes, cursors and queue rows
    ``[0, tail)`` on both devices."""
    def run(device):
        m = (abd_model(3, 2, Network.new_ordered()) if name != "raft3"
             else raft_model(3))
        return m.checker().spawn_gpu(device=device).join().final_snapshot()

    g, c = run(cuda), run("cpu")
    unique = {"linreg3_ordered": 36213, "raft3": 5725}[name]
    assert int(g["unique"]) == int(c["unique"]) == unique
    assert int(g["head"]) == int(c["head"]) and int(g["tail"]) == int(c["tail"])
    tail = int(g["tail"])
    for k in ("table_fp", "table_parent"):
        np.testing.assert_array_equal(g[k], c[k], err_msg=k)
    for k in ("q_rows", "q_fp", "q_ebits", "q_depth"):
        np.testing.assert_array_equal(g[k][:tail], c[k][:tail], err_msg=k)


def per_channel(m):
    m.per_channel_()
    return m


CHANNEL_AND_HISTORY_MODELS = {
    "paxos1_per_channel": (lambda: per_channel(paxos_model(1)), 265),
    "singlecopy_put2": (lambda: single_copy_model(2, 1, put_count=2), 369),
    "singlecopy_put2_per_channel": (
        lambda: per_channel(single_copy_model(2, 1, put_count=2)), 369),
    "wo21": (lambda: wo_register_model(2, 1), 71),
}


@pytest.mark.parametrize("name", sorted(CHANNEL_AND_HISTORY_MODELS))
def test_channel_and_history_twins_table_and_queue_identical_on_cuda_and_cpu(cuda, name):
    """The per-channel packing and the write-once and multi-op histories:
    the JAX engine's unique counts, and the same table bytes, cursors and
    queue rows ``[0, tail)`` on both devices."""
    build, unique = CHANNEL_AND_HISTORY_MODELS[name]

    def run(device):
        c = build().checker().spawn_gpu(device=device, batch=64)
        return c.join().final_snapshot()

    g, c = run(cuda), run("cpu")
    assert int(g["unique"]) == int(c["unique"]) == unique
    assert int(g["head"]) == int(c["head"]) and int(g["tail"]) == int(c["tail"])
    tail = int(g["tail"])
    for k in ("table_fp", "table_parent"):
        np.testing.assert_array_equal(g[k], c[k], err_msg=k)
    for k in ("q_rows", "q_fp", "q_ebits", "q_depth"):
        np.testing.assert_array_equal(g[k][:tail], c[k][:tail], err_msg=k)


def assert_same_snapshot(a, b):
    """Equal table bytes, cursors and queue rows ``[0, tail)``."""
    assert int(a["head"]) == int(b["head"]) and int(a["tail"]) == int(b["tail"])
    tail = int(a["tail"])
    for k in ("table_fp", "table_parent"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in ("q_rows", "q_fp", "q_ebits", "q_depth"):
        np.testing.assert_array_equal(a[k][:tail], b[k][:tail], err_msg=k)


def test_orl_table_and_queue_identical_on_cuda_and_cpu(cuda):
    """The ORL system compiled for the card: 148 unique and "delivered" on
    both devices, neither always property violated, the same tables."""
    def run(device):
        return orl_model().checker().spawn_gpu(device=device).join()

    g, c = run(cuda), run("cpu")
    assert g.unique_state_count() == c.unique_state_count() == 148
    assert set(g.discoveries()) == {"delivered"}
    g.assert_properties()
    assert_same_snapshot(g.final_snapshot(), c.final_snapshot())


def test_live_checkpoint_and_autosave_resume_on_cuda(cuda, tmp_path):
    """A live ``checkpoint()`` (after an ``np.savez`` round trip) and the
    newest autosave generation of a stopped 2pc-5 run each resume on
    ``cuda`` to the uninterrupted ``cuda`` run's tables and queue."""
    full = TwoPhaseSys(5).checker().spawn_gpu(
        device=cuda, batch=64, steps_per_call=2).join()
    running = TwoPhaseSys(5).checker().autosave(
        str(tmp_path), every_secs=0.0, keep=2,
    ).spawn_gpu(device=cuda, batch=64, steps_per_call=2)
    live = running.checkpoint(timeout=120.0)
    deadline = time.monotonic() + 120
    while ckpt.latest_gen_number(str(tmp_path)) is None:
        assert time.monotonic() < deadline and not running.is_done()
        time.sleep(0.01)
    running.stop().join()
    assert 0 < int(live["unique"]) < 8832
    assert int(live["head"]) < int(live["tail"])
    assert 1 <= len(ckpt.list_generations(str(tmp_path))) <= 2
    buf = io.BytesIO()
    np.savez(buf, **live)
    buf.seek(0)
    for snap in (dict(np.load(buf)), ckpt.latest_generation(str(tmp_path))[0]):
        r = TwoPhaseSys(5).checker().spawn_gpu(device=cuda, resume=snap).join()
        assert (r.unique_state_count(), r.state_count()) == (8832, 58146)
        assert r.discovery_fps() == full.discovery_fps()
        assert_same_snapshot(r.final_snapshot(), full.final_snapshot())


# -- the step-transform flags ------------------------------------------------


@pytest.mark.parametrize("name", ["2pc7", "paxos2"])
def test_flagged_table_and_queue_identical_on_cuda_and_cpu(cuda, name):
    """``.prededup()`` (the dedup's ``row_hash`` launch and
    ``window_unique`` on the card): the same counts, removed lanes, table
    bytes, cursors and queue rows ``[0, tail)`` on both devices, and the
    unflagged run's counts and queue rows."""
    def run(device, flags=True):
        if name == "2pc7":
            b = TwoPhaseSys(7).checker().target_states(40_000)
        else:
            b = paxos_model(2).checker()
        if flags:
            b = b.prededup()
        return b.spawn_gpu(device=device, batch=256).join()

    g, c, plain = run(cuda), run("cpu"), run(cuda, flags=False)
    assert g.prededup_removed() == c.prededup_removed() > 0
    assert g.state_count() == c.state_count() == plain.state_count()
    gs, ps = g.final_snapshot(), plain.final_snapshot()
    assert_same_snapshot(gs, c.final_snapshot())
    tail = int(gs["tail"])
    assert tail == int(ps["tail"])
    for k in ("q_rows", "q_fp", "q_ebits", "q_depth"):
        np.testing.assert_array_equal(gs[k][:tail], ps[k][:tail], err_msg=k)


def test_prededup_step_row_hash_matches_plain(cuda):
    """The next batch of a prededup paxos-2 run as its step meets it: the
    expand (the coalesced writer) on the card equals it on the CPU, the
    ``row_hash`` launch on the
    successor rows equals ``row_hash_plain``, ``window_unique`` on the
    card equals it on the CPU, and ``cand_prep`` on the first occurrences
    equals its plain version."""
    run = paxos_model(2).checker().target_states(5_000).prededup()
    run = run.spawn_gpu(device=cuda, batch=256).join()
    carry = run._final_carry
    head, tail = int(carry[convert.HEAD]), int(carry[convert.TAIL])
    assert tail > head
    pos = (head + torch.arange(256, device=cuda)).clamp_(
        max=carry[convert.QROWS].shape[0] - 1)
    tm = run.tensor
    succ, valid = tm.step_rows(carry[convert.QROWS][pos])
    csucc, cvalid = tm.step_rows(carry[convert.QROWS][pos].cpu())
    assert torch.equal(succ.cpu(), csucc) and torch.equal(valid.cpu(), cvalid)
    valid = valid & (torch.arange(256, device=cuda) < tail - head)[:, None]
    m = succ.shape[0] * succ.shape[1]
    rows, cvalid = succ.reshape(m, -1), valid.reshape(m)
    before = row_hash.launches
    fps = row_hash(rows, cvalid)
    assert row_hash.launches == before + 1
    assert torch.equal(fps.cpu(), row_hash_plain(rows.cpu(), cvalid.cpu()))
    kept = window_unique(fps)
    assert torch.equal(kept.cpu(), window_unique(fps.cpu()))
    mask = kept != -1
    assert 0 < int(mask.sum()) < int(cvalid.sum())
    pfps = carry[convert.QFP][pos]
    cb = run._cand
    got = cand_prep(rows, mask, pfps, tm.max_actions, cb,
                    out=PrepBuffers(m, cb, cuda))
    want = cand_prep_plain(rows.cpu(), mask.cpu(), pfps.cpu(),
                           tm.max_actions, cb)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def test_cartography_and_growth_records_identical_on_cuda_and_cpu(cuda):
    """2pc-7 under ``.telemetry(cartography=True)`` from a small table:
    the cartography block, the growth records' ``(status, unique, cap)``
    sequence and the health timeline are the same on both devices."""
    from stateright_tpu_torch.telemetry.health import phase_timeline

    def run(device):
        return (TwoPhaseSys(7).checker().telemetry(cartography=True)
                .spawn_gpu(device=device, capacity=1 << 12, batch=512,
                           steps_per_call=16).join())

    g, c = run(cuda), run("cpu")
    assert g.unique_state_count() == c.unique_state_count() == 296_448
    assert g.cartography() == c.cartography()
    assert sum(g.cartography()["depth_hist"]) == 296_448

    def ladder(x):
        return [(r["status"], r["unique"], r["cap"])
                for r in x.flight_recorder.records("growth")]

    assert ladder(g) == ladder(c) and ladder(g)
    assert (phase_timeline(g.flight_recorder.records("step"))
            == phase_timeline(c.flight_recorder.records("step")))


def test_memory_ledger_analytic_bytes_equal_live_bytes_on_cuda(cuda):
    """On the card the ledger counts the kernels' resident buffers too:
    its analytic bytes equal the live tensors' at the final rung, each
    growth's forecast transient is at least the run's measured peak across
    it (tensor bytes against the requested bytes, the allocator's bound
    against the allocated ones) wherever the growth raised the process's
    peak, at least one does, and the device readings are there."""
    from stateright_tpu_torch.telemetry.memory import device_memory_stats

    # the engine never resets the process's peak counters: the test owns
    # them, and starts them here, so the earlier tests' peaks are not in
    # the way of this run's growths
    torch.cuda.reset_peak_memory_stats(cuda)
    c = (TwoPhaseSys(6).checker().telemetry(cartography=True, memory=True)
         .spawn_gpu(device=cuda, capacity=1 << 12, batch=256).join())
    live = {n: t.nbytes for n, t in c.live_buffers().items()}
    spec = {s.name: s.nbytes for s in c._memory_spec_fn()(c._memory_caps())}
    assert live == spec
    assert any(n.startswith("prep_") for n in live)
    assert c.growth_memory
    assert any(g["peak_requested_bytes"] is not None
               for g in c.growth_memory), c.growth_memory
    for g in c.growth_memory:
        if g["peak_requested_bytes"] is not None:
            assert g["transient_bytes"] >= g["peak_requested_bytes"] > 0, g
        if g["peak_bytes"] is not None:
            assert g["transient_alloc_bytes"] >= g["peak_bytes"], g
    stats = device_memory_stats(cuda)
    assert stats is not None and stats["bytes_limit"] > 0
    assert c.memory()["device"]["bytes_in_use"] > 0


# -- checked mode and the spill tier on the card ------------------------------

SPILL_KW = dict(capacity=1 << 12, batch=128, queue_capacity=4096,
                spill_bloom_bits=1 << 14, steps_per_call=8)


def spill_budget(n: int, cuda: bool, cap_fit: int = 1 << 13) -> int:
    """A device budget under which a 2pc-n run on ``cuda`` (or the CPU)
    evicts at the ``cap_fit`` rung: each device's own analytic buffers
    (the card's include the kernels' scratch), so both evict at the same
    growth."""
    from stateright_tpu_torch.parallel.wavefront import memory_spec_fn
    from stateright_tpu_torch.telemetry.memory import total_bytes

    model = TwoPhaseSys(n)
    tm = model.tensor_model()
    batch = SPILL_KW["batch"]
    m = batch * tm.max_actions
    spec = memory_spec_fn(tm, len(model.properties()), cuda=cuda,
                          spill=(SPILL_KW["spill_bloom_bits"], 4 * m))

    def tot(cap):
        return total_bytes(spec(dict(cap=cap, qcap=SPILL_KW["queue_capacity"],
                                     batch=batch, cand=min(4096, m))))

    return tot(cap_fit) + tot(2 * cap_fit) - 1


def test_spill_2pc5_identical_on_cuda_and_cpu(cuda, monkeypatch):
    """2pc-5 under a budget that evicts at the 2^13 rung on each device:
    8,832 unique, and the same tables, queue rows, store arrays and spill
    tallies on ``cuda`` and ``cpu``; on the card the ledger's analytic
    bytes (the inject's plan buffers included) equal the live tensors'."""
    monkeypatch.setenv("STATERIGHT_TPU_CAPACITY_GUARD", "off")
    runs = []
    for device in (cuda, "cpu"):
        monkeypatch.setenv("STATERIGHT_TPU_DEVICE_BYTES", str(
            spill_budget(5, device != "cpu")))
        runs.append(TwoPhaseSys(5).checker().spill().spawn_gpu(
            device=device, **SPILL_KW).join())
    g, c = runs
    assert g.unique_state_count() == c.unique_state_count() == 8832
    assert g.state_count() == c.state_count()
    assert g.spill_status()["evictions"] >= 1
    assert g.spill_status() == c.spill_status()
    assert g.inject_calls == c.inject_calls > 0
    live = {n: t.nbytes for n, t in g.live_buffers().items()}
    assert live == {s.name: s.nbytes
                    for s in g._memory_spec_fn()(g._memory_caps())}
    assert any(n.startswith("inject_") for n in live)
    gs, cs = g.final_snapshot(), c.final_snapshot()
    assert_same_snapshot(gs, cs)
    for k in ("spill_fp", "spill_parent"):
        np.testing.assert_array_equal(gs[k], cs[k], err_msg=k)


def test_checked_2pc5_identical_on_cuda_and_cpu(cuda):
    """Under ``.checked()`` the guard raises no flag on 2pc-5 on either
    device, and the tables and queue rows are the same."""
    g, c = (TwoPhaseSys(5).checker().checked().spawn_gpu(
        device=d, batch=256).join() for d in (cuda, "cpu"))
    assert g.unique_state_count() == c.unique_state_count() == 8832
    assert_same_snapshot(g.final_snapshot(), c.final_snapshot())


def test_checked_oob_twin_raises_and_the_context_survives(cuda):
    """The out-of-range twin under ``.checked()`` on the card raises
    ``CheckedExecutionError`` naming state 4: the guard clamped the gather,
    so no device-side assert fired, and a 2pc-3 run on the card afterwards
    still gives 288.  ``skip_audit()``: the preflight would refuse the
    twin (JX201) before the run."""
    from test_torch_oob_twin import OOBModel

    from stateright_tpu_torch.analysis import CheckedExecutionError

    with pytest.raises(CheckedExecutionError) as exc:
        OOBModel().checker().skip_audit().checked().spawn_gpu(
            device=cuda, batch=8, capacity=1 << 10).join()
    assert exc.value.state == 4 and "out-of-bounds" in str(exc.value)
    torch.cuda.synchronize(cuda)
    c = TwoPhaseSys(3).checker().spawn_gpu(device=cuda, batch=64).join()
    assert c.unique_state_count() == 288


def test_a_real_device_oom_classifies_as_oom(cuda):
    """An allocation past the card's memory raises the caching allocator's
    ``torch.OutOfMemoryError``, which the supervisor puts in ``oom``; the
    card stays usable after it."""
    from stateright_tpu_torch.supervisor import OOM, classify_failure

    free, total = torch.cuda.mem_get_info(cuda)
    with pytest.raises(torch.OutOfMemoryError) as exc:
        torch.empty(2 * total, dtype=torch.uint8, device=cuda)
    assert classify_failure(exc.value) == OOM
    torch.cuda.empty_cache()
    c = TwoPhaseSys(3).checker().spawn_gpu(device=cuda, batch=64).join()
    assert c.unique_state_count() == 288


def test_supervised_2pc5_killed_at_a_host_sync_ends_on_the_cpu_tables(
        cuda, tmp_path):
    """2pc-5 supervised on the card, killed by a plan at its seventh host
    sync, resumes on the card (never on the CPU) and ends with the table
    bytes and queue rows of the same supervised run on ``cpu``."""
    from stateright_tpu_torch.supervisor import supervise
    from stateright_tpu_torch.testing.faults import Fault, FaultPlan

    runs = {}
    for dev in (cuda, "cpu"):
        plan = FaultPlan([Fault(site="host_sync", action="kill", at=6)])
        with plan:
            runs[str(dev)] = res = supervise(
                TwoPhaseSys(5).checker().telemetry(),
                autosave_dir=str(tmp_path / str(dev).replace(":", "")),
                every_secs=0.0, max_restarts=2, sleep=lambda s: None,
                device=dev, batch=64, steps_per_call=2)
        assert plan.fired and res.restarts == 1
        assert res.checker.device.type == torch.device(dev).type
    g, c = runs[str(cuda)], runs["cpu"]
    assert g.unique_state_count() == c.unique_state_count() == 8832
    assert g.state_count() == c.state_count() == 58146
    assert_same_snapshot(g.checker.final_snapshot(),
                         c.checker.final_snapshot())


# -- partial-order reduction ---------------------------------------------------


@pytest.mark.parametrize("name,kw,counts", [
    ("pc-paxos1", dict(batch=64), (250, 437)),
    # queue growth (a boost at each boundary) and a candidate budget at
    # which a proviso round overflows after its ample round committed
    ("pc-paxos1-grow", dict(capacity=1 << 8, batch=16), (256, 452)),
    ("pc-paxos1-budget", dict(capacity=1 << 12, batch=64, cand=24),
     (250, 438)),
    ("workers7", dict(batch=64), (15, 15)),
    ("toggle", dict(batch=64), (4, 6)),
    ("2pc5-sym-prededup", dict(batch=64), None),
])
def test_por_table_and_queue_identical_on_cuda_and_cpu(cuda, name, kw,
                                                       counts):
    """``.por()`` on ``cuda`` against ``cpu``: the ample mask, its conjunct
    kernel captured on the card, the proviso round's second set of kernel
    buffers and the rollback give the same counts, tables, queue rows and
    tallies; the ledger's analytic bytes (both rounds' buffers) equal the
    live tensors' on the card."""
    from stateright_tpu_torch.testing.por_fixtures import ToggleSys, WorkersSys

    build = {"pc-paxos1": lambda: per_channel_paxos(1),
             "pc-paxos1-grow": lambda: per_channel_paxos(1),
             "pc-paxos1-budget": lambda: per_channel_paxos(1),
             "workers7": lambda: WorkersSys(7), "toggle": ToggleSys,
             "2pc5-sym-prededup": lambda: TwoPhaseSys(5)}[name]

    def run(device):
        b = build().checker().por()
        if name.endswith("sym-prededup"):
            b = b.symmetry().prededup()
        return b.spawn_gpu(device=device, **kw).join()

    g, c = run(cuda), run("cpu")
    assert g._por and c._por
    assert (g.unique_state_count(), g.state_count()) == (
        c.unique_state_count(), c.state_count())
    if counts is not None:
        assert (g.unique_state_count(), g.state_count()) == counts
    assert g.growth_events == c.growth_events
    assert g.por_status() == c.por_status()
    assert_same_snapshot(g.final_snapshot(), c.final_snapshot())
    live = {n: t.nbytes for n, t in g.live_buffers().items()}
    assert live == {s.name: s.nbytes
                    for s in g._memory_spec_fn()(g._memory_caps())}
    assert any(n.startswith("plan2_") for n in live)


def test_por_proviso_round_kernels_match_plain(cuda):
    """The proviso round of a per-channel paxos-1 step on the card: its
    inputs kept at the first round that inserts, then ``cand_prep``,
    ``bucket_plan`` and ``insert_commit`` against their plain versions on
    them (a copy of the table after the ample round, the append at
    ``tail + n_new1``)."""
    from stateright_tpu_torch.parallel import wavefront

    kept = {}
    run = wavefront._Engine._insert_round

    def keep(self, c, krows, kept_mask, fps, tail, cand_rows, ebits, depths,
             prep_out, plan_out):
        second = tail is not c[convert.TAIL]  # the append after round 1
        if second and not kept:
            snap = dict(tfp=c[convert.TFP].clone(), tpl=c[convert.TPL].clone(),
                        krows=krows.clone(), kept=kept_mask.clone(),
                        fps=fps.clone(), tail=tail.clone(),
                        rows=cand_rows.clone(), ebits=ebits.clone(),
                        depths=depths.clone(), arity=self.arity,
                        cb=self.eff_cand, nb=self.cap // SLOTS,
                        queue=[c[i].clone() for i in (
                            convert.QROWS, convert.QFP, convert.QEBITS,
                            convert.QDEPTH)])
        out = run(self, c, krows, kept_mask, fps, tail, cand_rows, ebits,
                  depths, prep_out, plan_out)
        if second and not kept and int(out[2]) > 0:
            kept.update(snap)
        return out

    # the blocks run the eager loop, so the step's Python runs every step
    # (the block graph runs it once, at its capture) and may read the count
    block = wavefront._Engine.run
    wavefront._Engine._insert_round = keep
    wavefront._Engine.run = wavefront._Engine._run_steps
    try:
        per_channel_paxos(1).checker().por().spawn_gpu(device=cuda,
                                                       batch=64).join()
    finally:
        wavefront._Engine._insert_round = run
        wavefront._Engine.run = block
    assert kept, "no proviso round inserted anything"
    k = kept
    got = cand_prep(k["krows"], k["kept"], k["fps"], k["arity"], k["cb"])
    want = cand_prep_plain(k["krows"], k["kept"], k["fps"], k["arity"],
                           k["cb"])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    sort = (*sort_prepared(want[0], want[1], want[3], k["nb"]), want[2],
            want[5])
    gplan = bucket_plan(k["tfp"], *sort)
    wplan = bucket_plan_plain(k["tfp"], *sort)
    n_new = int(wplan[4])
    assert n_new > 0 and int(gplan[4]) == n_new
    for a, b in zip(gplan[:4], wplan[:4]):
        assert torch.equal(a[:n_new], b[:n_new])
    tables = [(k["tfp"].clone(), k["tpl"].clone()) for _ in range(2)]
    queues = [QueueAppend(*[q.clone() for q in k["queue"]], k["tail"],
                          wplan[3], k["rows"], k["ebits"], k["depths"],
                          k["arity"]) for _ in range(2)]
    plan = (*wplan[:3], wplan[4])  # the slots, fingerprints, payloads, count
    insert_commit(*tables[0], *plan, queues[0])
    insert_commit_plain(*tables[1], *plan, queues[1])
    for a, b in zip(tables[0] + tuple(queues[0][:4]),
                    tables[1] + tuple(queues[1][:4])):
        assert torch.equal(a, b)


# -- the sweep's kernel modes: cand_prep's namespace, insert_commit's tags ---


def ns_case(case, rng, rows, arity):
    """A sweep namespace for ``rows`` (``[B * arity, W]``): per-parent tags
    over ``k`` instances, their low-bit tags and seed scrambles; "remap"
    makes lane 0 namespace onto 0 (and so GAMMA)."""
    from stateright_tpu_torch.fingerprint import mix64, sweep_ns_xor
    from stateright_tpu_torch.ops.cand_prep import Namespace

    b = rows.shape[0] // arity
    k = {"k_1": 1, "k_1000": 1000}.get(case, 8)
    bits = max(1, (k - 1).bit_length())
    tags = rng.integers(0, k, b).astype(np.int32)
    low = np.arange(k, dtype=np.uint64)
    xor = np.asarray([sweep_ns_xor(int(s)) for s in rng.integers(0, 9, k)],
                     np.uint64)
    if case == "remap":
        h0 = int(row_hash_plain(rows[:1])[0]) & ((1 << 64) - 1)
        tags[0] = 0
        low[0] = np.uint64(0)
        xor[0] = np.uint64(mix64(h0) & ~((1 << bits) - 1))
    return Namespace(torch.from_numpy(tags), i64(low), i64(xor), bits)


NS_CASES = ["m_1", "m_257", "many_tiles", "n_valid_cb_plus_1", "k_1",
            "k_1000", "remap"]


@pytest.mark.parametrize("case", NS_CASES)
def test_cand_prep_namespace_mode_matches_plain(cuda, case):
    """The namespace mode, every output lane and both scalars bit for bit,
    on random shapes and on a lane whose namespaced key remaps."""
    from stateright_tpu_torch.ops.cand_prep import Namespace

    rng = np.random.default_rng(100 + NS_CASES.index(case))
    base = case if case in PREP_CASES else "cb_is_m"
    rows, valid, pfps, arity, cb = prep_case(base, rng)
    if case == "remap":
        valid[0] = True
    ns = ns_case(case, rng, rows, arity)
    want = cand_prep_plain(rows, valid, pfps, arity, cb, ns)
    if case == "remap":
        assert int(want[0][0]) == int(GAMMA_I64)
    cns = Namespace(*(x.to(cuda) for x in ns[:3]), ns.bits)
    args = [x.to(cuda) for x in (rows, valid, pfps)]
    out = PrepBuffers(rows.shape[0], cb, cuda)
    for _ in range(2):
        got = [x.cpu() for x in cand_prep(*args, arity, cb, out=out, ns=cns)]
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    # the mode off on the same buffers is the plain launch again
    plain = cand_prep_plain(rows, valid, pfps, arity, cb)
    got = [x.cpu() for x in cand_prep(*args, arity, cb, out=out)]
    for g, w in zip(got, plain):
        assert torch.equal(g, w)


@pytest.mark.parametrize("count", ["0", "1", "T+1", "m", "3000/4096",
                                   "1/1"])
@pytest.mark.parametrize("width", [1, 2, 33])
def test_insert_commit_tag_column_matches_plain(cuda, count, width):
    n_new, m = commit_counts(count, width)
    rng = np.random.default_rng(7 + width)
    tail = 123
    table, queue = commit_case(rng, m, n_new, width, tail, tail + m + 50,
                               tags=True)
    commit_matches_plain(cuda, table, queue)


@pytest.mark.parametrize("family", ["2pc-seeds", "lifted"])
def test_sweep_tables_identical_on_cuda_and_cpu(cuda, family):
    """A seed-only sweep and the lifted cohort: the final tables, queue
    rows, tags and per-instance counters equal on both devices."""
    from stateright_tpu_torch.models.two_phase_commit import sweep_family
    from stateright_tpu_torch.testing.sweep_fixtures import (
        bounded_counter_spec,
    )

    spec_of = {"2pc-seeds": lambda: sweep_family(4),
               "lifted": lambda: bounded_counter_spec([1, 2, 3, 4])}[family]
    snaps = []
    for dev in (cuda, "cpu"):
        spec = spec_of()
        c = spec.instances[0].model.checker().sweep(spec).spawn_gpu(
            device=dev, capacity=1 << 12, batch=64).join()
        snaps.append(c.final_snapshot())
    g, c = snaps
    tail = int(c["tail"])
    for k in ("table_fp", "table_parent", "unique_k", "scount_k", "disc",
              "maxdepth_k", "tail"):
        assert np.array_equal(np.asarray(g[k]), np.asarray(c[k])), k
    for k in ("q_rows", "q_fp", "q_tag", "q_ebits", "q_depth"):
        assert np.array_equal(np.asarray(g[k])[:tail],
                              np.asarray(c[k])[:tail]), k


def test_explorer_serves_a_gpu_run_on_cuda(cuda):
    """2pc-5 served with ``strategy="gpu"`` on the card: 8,832 unique, and
    both discoveries resolve through ``/.states``."""
    import json
    import urllib.request

    from stateright_tpu_torch.explorer import serve

    server = serve(TwoPhaseSys(5).checker().telemetry(metrics=True),
                   "localhost:0", block=False, strategy="gpu", device=cuda,
                   batch=32, steps_per_call=1)
    try:
        while not server.checker.is_done():
            with urllib.request.urlopen(f"http://{server.addr}/.status") as r:
                json.loads(r.read())
            time.sleep(0.02)
        server.checker.join()
        with urllib.request.urlopen(f"http://{server.addr}/.status") as r:
            st = json.loads(r.read())
        assert st["unique_state_count"] == 8832 and st["done"] is True
        disc = {n: d for _, n, d in st["properties"] if d is not None}
        assert set(disc) == {"abort agreement", "commit agreement"}
        for encoded in disc.values():
            with urllib.request.urlopen(
                    f"http://{server.addr}/.states/{encoded}") as r:
                assert r.status == 200
    finally:
        server.shutdown()


def test_packed_fleet_on_cuda_equals_cpu(cuda, tmp_path):
    """Two packable 2pc-3 tenants in one cohort on the card: the same
    results as the same fleet on the CPU."""
    from stateright_tpu_torch.fleet import FleetSpec, Job, run_fleet

    out = []
    for dev in (cuda, "cpu"):
        jobs = [Job(key=k, packable=True, capacity=1 << 12, batch=64,
                    build=lambda: TwoPhaseSys(3).checker())
                for k in ("a", "b")]
        res = run_fleet(FleetSpec(jobs=jobs, slots=2),
                        root=str(tmp_path / str(dev)), stream=None,
                        device=str(dev))
        assert res.completed == 2 and len(res.packed) == 1
        out.append({k: (r.unique, r.states, r.max_depth,
                        tuple(r.discoveries))
                    for k, r in res.results.items()})
    assert out[0] == out[1]
    assert out[0]["a"][:2] == (288, 1146)


def sharded_snapshots_equal(a: dict, b: dict) -> None:
    live = np.asarray(a["fps"]) != EMPTY
    assert sorted(a) == sorted(b)
    for k in a:
        if k == "run_id":
            continue
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if k in ("rows", "ebits"):
            x, y = x[live], y[live]
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("name,kw", [
    ("2pc5", dict(devices=4)),
    ("2pc4-growth", dict(devices=8, capacity=1 << 8,
                         frontier_capacity=1 << 5)),
    ("2pc5-sym-prededup-cart", dict(devices=4)),
    ("toggle-por", dict(devices=2)),
])
def test_sharded_snapshot_identical_on_cuda_and_cpu(cuda, name, kw):
    """The sharded engine (``spawn_gpu(devices=N)``) on ``cuda`` against
    ``cpu``: the whole snapshot, shard for shard, and the launches of the
    kernels on its path (``cand_prep`` is not on it)."""
    from stateright_tpu_torch.ops.cand_prep import cand_prep
    from stateright_tpu_torch.ops.hashing import row_hash
    from stateright_tpu_torch.ops.insert_commit import insert_commit
    from stateright_tpu_torch.testing.por_fixtures import ToggleSys

    def build():
        if name == "toggle-por":
            return ToggleSys().checker().por()
        b = TwoPhaseSys(4 if "2pc4" in name else 5).checker()
        if "sym" in name:
            b = b.symmetry().prededup().cartography()
        return b

    kernels = (cand_prep, row_hash, bucket_plan, insert_commit)
    before = [k.launches for k in kernels]
    g = build().spawn_gpu(device=cuda, sync=True, **kw)
    launched = [k.launches - b for k, b in zip(kernels, before)]
    c = build().spawn_gpu(device="cpu", sync=True, **kw)
    assert g.growth_events == c.growth_events
    assert g.cartography() == c.cartography()
    sharded_snapshots_equal(g.final_snapshot(), c.final_snapshot())
    assert launched[0] == 0 and all(n > 0 for n in launched[1:]), launched


@pytest.mark.parametrize("name", ["2pc5", "2pc5-sym", "2pc4-growth",
                                  "pc-paxos1-por"])
def test_mesh_snapshot_identical_on_cuda_and_cpu(cuda, name):
    """The mesh engine (``.mesh()``) with 4 pieces on the card against 4
    pieces on the CPU: the whole snapshot (tables, cursors, queue rows
    ``[0, tail)``), the growth events, and the launches of every kernel on
    its path with ``insert_commit``'s window mode."""
    from stateright_tpu_torch.ops.cand_prep import cand_prep
    from stateright_tpu_torch.ops.insert_commit import insert_commit_window

    def build(dev):
        if name == "pc-paxos1-por":
            m = paxos_model(1)
            m.per_channel_()
            b = m.checker().por()
        else:
            b = TwoPhaseSys(4 if "2pc4" in name else 5).checker()
        b = b.mesh(devices=[dev] * 4)
        return b.symmetry() if "sym" in name else b

    kw = dict(capacity=1 << 9, batch=128) if "growth" in name else dict(
        capacity=1 << 12, batch=64)
    kernels = (cand_prep, bucket_plan_fused, insert_commit,
               insert_commit_window)
    before = [k.launches for k in kernels]
    g = build(cuda).spawn_gpu(sync=True, **kw)
    launched = [k.launches - b for k, b in zip(kernels, before)]
    c = build("cpu").spawn_gpu(sync=True, **kw)
    assert g.growth_events == c.growth_events
    assert (g.unique_state_count(), g.state_count()) == (
        c.unique_state_count(), c.state_count())
    gs, cs = g.final_snapshot(), c.final_snapshot()
    tail = int(gs["tail"])
    for k in ("table_fp", "table_parent", "head", "tail", "unique", "scount",
              "disc"):
        np.testing.assert_array_equal(np.asarray(gs[k]), np.asarray(cs[k]),
                                      err_msg=k)
    for k in ("q_rows", "q_fp", "q_ebits", "q_depth"):
        np.testing.assert_array_equal(gs[k][:tail], cs[k][:tail], err_msg=k)
    assert all(p == [str(cuda)] * 4 for p in g.pieces().values())
    assert all(n > 0 for n in launched), launched


WINDOW_CASES = ["3000/123/0", "3000/123/2048", "0/0/0", "1/4095/2048",
                "4096/0/4096", "piece_starts_in_a_tile",
                "piece_ends_in_a_tile", "tail_near_the_piece_end"]


def window_case(case: str, t: int, rows: int) -> tuple:
    """``(n_new, tail, qlo)`` of one of :data:`WINDOW_CASES` for tiles of
    ``t`` lanes and a piece of ``rows`` rows."""
    if "/" in case:
        return tuple(int(v) for v in case.split("/"))
    if case == "piece_starts_in_a_tile":  # lane 2t + 7 is the piece's first
        return 3000, 100, 100 + 2 * t + 7
    if case == "piece_ends_in_a_tile":  # lane 2t + 7 the first past it
        return 3000, 2500, 2500 + 2 * t + 7 - rows
    return 3000, 4096 + rows - 5, 4096  # five rows in the piece


@pytest.mark.parametrize("case", WINDOW_CASES)
@pytest.mark.parametrize("width", [1, 3, 33, 83])
def test_insert_commit_window_mode_matches_plain(cuda, case, width):
    """``insert_commit``'s window mode (a queue piece of 2,048 rows from
    ``qlo``) against its plain version: the rows of ``[tail, tail + n_new)``
    that fall in the piece, and nothing else; a piece boundary inside a
    tile of lanes counted from 0 (lane 2T + 7), and a tail five rows before
    the piece's end."""
    from stateright_tpu_torch.ops.insert_commit import (
        insert_commit_window, insert_commit_window_plain,
    )

    rng = np.random.default_rng(11 + width)
    m, arity, rows = 4096, 4, 2048
    n_new, tail, qlo = window_case(case, commit_tile(width), rows)
    b = m // arity
    cfp = rand_i64(rng, m)
    n = torch.tensor(n_new)

    def i32(lo, hi, size):
        return torch.from_numpy(rng.integers(lo, hi, size).astype(np.int32))

    queue = QueueAppend(
        rand_i64(rng, rows, width), rand_i64(rng, rows), i32(0, 99, rows),
        i32(0, 99, rows), torch.tensor(tail),
        torch.from_numpy(rng.permutation(m)), rand_i64(rng, b * arity, width),
        i32(-99, 99, b), i32(0, 99, b), arity)
    cq = QueueAppend(*(x.to(cuda) if torch.is_tensor(x) else x
                       for x in queue))
    pq = QueueAppend(*(x.clone() if torch.is_tensor(x) else x
                       for x in queue))
    before = insert_commit_window.launches
    insert_commit_window(cq, cfp.to(cuda), n.to(cuda), qlo)
    insert_commit_window_plain(pq, cfp, n, qlo)
    torch.cuda.synchronize()
    assert insert_commit_window.launches == before + 1
    for g, w in zip(cq[:4], pq[:4]):
        assert torch.equal(g.cpu(), w)


# -- engine prewarm and the compile cache ---------------------------------------

PREWARM_CAPS = dict(capacity=1 << 10, batch=64, steps_per_call=1,
                    queue_capacity=1 << 12)


def test_prewarmed_engine_launches_on_the_run_threads_stream(cuda,
                                                             monkeypatch):
    """An engine the prewarm thread builds holds the stream the run thread
    launches on (here a side stream the run runs under), never the
    worker's own; the run equals a plain one on that stream."""
    import threading

    from stateright_tpu_torch.parallel import prewarm, wavefront

    built = []
    engine = wavefront.GpuChecker._engine

    def spy(self, cap, qcap, batch, cand):
        eng = engine(self, cap, qcap, batch, cand)
        built.append((threading.current_thread().name, eng))
        return eng

    monkeypatch.setattr(wavefront.GpuChecker, "_engine", spy)
    side = torch.cuda.Stream(cuda)
    with torch.cuda.stream(side):
        warm = TwoPhaseSys(5).checker().prewarm().telemetry().spawn_gpu(
            sync=True, **PREWARM_CAPS)
        plain = TwoPhaseSys(5).checker().spawn_gpu(sync=True, **PREWARM_CAPS)
    torch.cuda.synchronize()
    on_worker = [e for name, e in built
                 if name == prewarm.PREWARM_THREAD_NAME]
    assert on_worker and warm.growth_events
    assert all(e.stream == side.cuda_stream for e in on_worker)
    assert all(e.stream == side.cuda_stream for _, e in built)
    rungs = warm.flight_recorder.records("compile")[1:]
    assert rungs and all(r["source"] == "prewarm" for r in rungs), rungs
    assert warm.unique_state_count() == plain.unique_state_count() == 8832
    for a, b in zip(warm._table_np(), plain._table_np()):
        np.testing.assert_array_equal(a, b)


def test_prewarmed_2pc5_equals_plain(cuda):
    warm = TwoPhaseSys(5).checker().prewarm().spawn_gpu(sync=True,
                                                        **PREWARM_CAPS)
    plain = TwoPhaseSys(5).checker().spawn_gpu(sync=True, **PREWARM_CAPS)
    assert warm.growth_events == plain.growth_events != []
    assert (warm.state_count(), warm.steps_run) == (plain.state_count(),
                                                    plain.steps_run)
    for a, b in zip(warm._table_np(), plain._table_np()):
        np.testing.assert_array_equal(a, b)
    ws, ps = warm.final_snapshot(), plain.final_snapshot()
    tail = int(ws["tail"])
    assert tail == int(ps["tail"])
    for k in ("q_rows", "q_fp", "q_ebits", "q_depth"):
        np.testing.assert_array_equal(np.asarray(ws[k])[:tail],
                                      np.asarray(ps[k])[:tail], err_msg=k)
    assert warm.discovery_fps() == plain.discovery_fps()


CACHE_CHILD = """
import json, sys
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.ops import _cuda
from stateright_tpu_torch.parallel.prewarm import compile_counters
c = TwoPhaseSys(3).checker().compile_cache(sys.argv[1]).telemetry().spawn_gpu(
    sync=True)
print(json.dumps({"unique": c.unique_state_count(),
                  "init": c.flight_recorder.records("compile")[0],
                  "counters": compile_counters(),
                  "library": str(_cuda.library_path())}))
"""


def test_compile_cache_round_trip_builds_then_loads(cuda, tmp_path):
    """Two processes over one fresh directory: the first builds the kernel
    library with ``nvcc`` (a miss, its seconds on the init rung), the
    second loads it (``source="persistent"``)."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    d = str(tmp_path / "cache")
    runs = []
    for _ in range(2):
        out = subprocess.run([sys.executable, "-c", CACHE_CHILD, d],
                             cwd=repo, capture_output=True, text=True,
                             timeout=600, env=dict(os.environ))
        assert out.returncode == 0, out.stderr
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    miss, hit = runs
    assert miss["unique"] == hit["unique"] == 288
    assert Path(miss["library"]).parent == Path(d)
    assert miss["init"]["source"] == "fresh" and not miss["init"]["cache_hit"]
    assert miss["init"]["build_secs"] > 0
    assert miss["counters"]["persistent_cache_misses"] == 1
    assert hit["init"]["source"] == "persistent" and hit["init"]["cache_hit"]
    assert hit["counters"]["persistent_cache_hits"] == 1


# -- the block graph (ops/block_loop.py) ----------------------------------------


def test_block_cond_kernel_matches_plain(cuda):
    """``srt_block_cond`` against ``block_cond_plain`` on seeded carries:
    every term of JAX's ``cond`` (status, queue, discoveries, target,
    checked word, ``k < steps``), with and without the reset of ``k``."""
    from stateright_tpu_torch.ops.block_loop import (
        CondInputs,
        block_cond,
        block_cond_plain,
    )

    rng = np.random.default_rng(22)
    before = block_cond.launches

    def s(v):
        return torch.tensor(int(v), dtype=torch.int64, device=cuda)

    for case in range(256):
        n_disc = int(rng.integers(0, 4))
        disc = (torch.from_numpy(rng.integers(0, 2, n_disc).astype(np.int64))
                .to(cuda) if n_disc else None)
        err = (torch.tensor(bool(rng.integers(0, 2)), device=cuda)
               if rng.integers(0, 2) else None)
        target = int(rng.integers(0, 8)) if rng.integers(0, 2) else None
        x = CondInputs(s(rng.integers(0, 4)), s(rng.integers(0, 4)),
                       s(rng.integers(0, 8)), s(rng.integers(0, 3) // 2),
                       disc, err, target)
        steps = int(rng.integers(1, 5))
        k = torch.tensor([int(rng.integers(0, 6))], dtype=torch.int64,
                         device=cuda)
        reset = bool(rng.integers(0, 2))
        go, k1 = block_cond(x, k, steps, reset=reset)
        want_go, want_k = block_cond_plain(
            x, torch.zeros_like(k) if reset else k, steps)
        assert torch.equal(go, want_go), case
        assert torch.equal(k1, want_k), case
    assert block_cond.launches == before + 256


def block_engine(cuda, name: str, steps: int = 8, grow: bool = False):
    """A fresh CUDA engine of the leg ``name`` and its init carry: at a
    finished run's capacities (no growth), or at small ones (``grow``:
    the blocks stop on a growth status).  Under ``.spill()`` the Bloom
    words are all ones, so every candidate defers and the pending buffer
    fills."""
    from stateright_tpu_torch.parallel import wavefront

    build, kw = BLOCK_LEGS[name]
    c = build().spawn_gpu(device=cuda, batch=64, steps_per_call=steps,
                          **kw).join()
    if grow:
        eng = c._engine(1 << 10, 1 << 9, 64, 256)
    else:
        eng = c._engine(c._cap, c._qcap, c._batch, c._cand)
    carry, _ = eng.init()
    if eng.spill:
        sp = eng.layout.spill_start + wavefront._SP_BLOOM
        carry[sp] = torch.full_like(carry[sp], -1)
    return c, eng, carry


def eager_go_steps(eng, carry) -> int:
    """The eager loop's steps whose ``go`` was true, on a copy."""
    c, n = [t.clone() for t in carry], 0
    for _ in range(eng.steps):
        n += int(eng.go_of(c))
        c = eng.step(c)
    return n


@pytest.mark.parametrize("grow", [False, True], ids=["complete", "growth"])
@pytest.mark.parametrize("name", sorted(BLOCK_LEGS))
def test_graph_block_equals_the_eager_loop(cuda, name, grow):
    """Block after block from the init carry, the graph block and the eager
    loop (``_Engine._run_steps``) on the same carry give the same carry
    entries, stats and executed steps, bit for bit, and the graph block's
    ``k`` is the eager loop's count of steps with ``go`` true; the run
    ends where the host would take over (a growth or spill status, an
    empty queue, every property discovered, the target)."""
    from stateright_tpu_torch.parallel import wavefront

    c, eng, carry = block_engine(cuda, name, grow=grow)
    blocks = stopped = 0
    while blocks < 200:
        ref = [t.clone() for t in carry]
        want_k = eager_go_steps(eng, ref)
        want, wstats = eng._run_steps(ref)
        got, gstats = eng.run(carry)
        assert len(got) == len(want)
        for i, (a, b) in enumerate(zip(got, want)):
            assert torch.equal(a, b), (name, blocks, i)
        assert torch.equal(gstats, wstats), (name, blocks)
        k = int(gstats[-1])
        assert k == want_k
        eng.account(k)
        blocks += 1
        stopped += k < eng.steps
        carry = got
        st = gstats[:-1].cpu().numpy()
        head, tail, unique, status = (int(st[0]), int(st[1]), int(st[2]),
                                      int(st[wavefront._ST_STATUS]))
        if not k or status != 0 or tail <= head:
            break
    assert eng.block is not None and blocks > int(grow) - 1
    assert stopped >= 1
    if name == "2pc5_target" and not grow:
        assert unique >= BLOCK_TARGET
    if name == "2pc5_discovery" and not grow:
        assert (carry[wavefront.DISC] != 0).all()


def test_graph_block_launch_counts_are_exact(cuda):
    """The wrappers' launch counters after a graph block equal the eager
    block's per-step launches times the executed steps, and the cond's
    launches are ``1 + k`` (the block's first evaluation, then one a
    step); under ``.prededup()`` every step kernel is counted, row_hash
    included.  The first block (the capture and its warm step) is run
    before the counters are read."""
    from stateright_tpu_torch.ops.block_loop import block_cond
    from stateright_tpu_torch.parallel import wavefront

    wrappers = (cand_prep, row_hash, bucket_plan_fused, insert_commit,
                block_cond)
    c, eng, carry = block_engine(cuda, "2pc5_prededup", grow=True)
    carry, stats = eng.run(carry)
    eng.account(int(stats[-1]))
    seen_short = False
    while True:
        ref = [t.clone() for t in carry]
        base = {w: w.launches for w in wrappers}
        _, wstats = eng._run_steps(ref)
        eager = {w: w.launches - base[w] for w in wrappers}
        base = {w: w.launches for w in wrappers}
        carry, gstats = eng.run(carry)
        k = int(gstats[-1])
        eng.account(k)
        graph = {w: w.launches - base[w] for w in wrappers}
        assert eager[block_cond] == 0
        for w in wrappers[:-1]:
            assert eager[w] % eng.steps == 0
            assert graph[w] == eager[w] // eng.steps * k, w.__name__
        assert graph[row_hash] == k and graph[insert_commit] == k
        assert graph[block_cond] == 1 + k
        seen_short |= k < eng.steps
        if int(gstats[wavefront._ST_STATUS]) != 0 or k == 0:
            break
    assert seen_short


def test_scoped_profiler_traces_a_block_graph_run_on_the_cpu_only(
        cuda, tmp_path):
    """``.telemetry(profile_steps=N)`` over every block of paxos-3 (the
    run whose kernels fault the device under CUPTI in the block graph's
    WHILE body): the session traces the CPU only, its ``start`` event
    gives the reason, the trace is written and the run completes."""
    from stateright_tpu_torch.ops.block_loop import CUPTI_FAULT

    c = (paxos_model(3).checker()
         .telemetry(profile_steps=1 << 20, profile_dir=str(tmp_path))
         .spawn_gpu(device=cuda).join())
    assert c.unique_state_count() == 1_194_428
    start, stop = c.flight_recorder.records("profile")
    assert start["cuda"] is False and start["cuda_off"] == CUPTI_FAULT
    assert stop["event"] == "stop" and stop["profiled_steps"] > 10
    with open(stop["trace"]) as f:
        events = json.load(f)["traceEvents"]
    assert events and not any(e.get("cat") == "kernel" for e in events)


def test_block_graph_records_its_capture(cuda):
    """A run on the card captures one block graph per engine key and
    records its costs; the eager loop never runs there, and the executed
    steps are at most the issued ones."""
    from stateright_tpu_torch.parallel import wavefront

    calls = []
    eager = wavefront._Engine._run_steps

    def spy(self, carry):
        calls.append(self.key)
        return eager(self, carry)

    wavefront._Engine._run_steps = spy
    try:
        g = TwoPhaseSys(5).checker().spawn_gpu(
            device=cuda, capacity=1 << 10, batch=64).join()
    finally:
        wavefront._Engine._run_steps = eager
    assert g.unique_state_count() == 8832
    assert not calls
    assert 2 <= len(g.block_graphs) <= len(g.growth_events) + 1
    for rec in g.block_graphs:
        assert rec["nodes"] > 0 and rec["capture_secs"] > 0
        assert rec["pool_bytes"] > 0
        assert rec["launches_per_step"]["insert_commit"] == 1
    assert 0 < g.steps_executed < g.steps_run
