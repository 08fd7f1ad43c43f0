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
plain versions, and a live checkpoint and an autosave generation resumed
on ``cuda`` against an uninterrupted ``cuda`` run.

Marked ``gpu``; each test decides inside itself whether a card is present
and skips without one.  This file imports no JAX (the machine with the
card has none), so on that machine it runs without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import io
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
    PLAN_TILE,
    SLOTS,
    PlanBuffers,
    bucket_insert,
    bucket_plan,
    bucket_plan_plain,
    sort_candidates,
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
    ROW_HASH_MAX_WIDTH,
    row_hash,
    row_hash_plain,
)
from stateright_tpu_torch.ops.insert_commit import (
    QueueAppend,
    insert_commit,
    insert_commit_plain,
)
from test_torch_plan_cases import GEN_CASES, gen_case, in_buckets

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


def plan_case(case, rng):
    """(table fp, table payload, candidates, payloads, compact)."""
    nb, compact = 256, None
    pre = in_buckets(rng, nb, lambda b: b >= 0, 4 * nb)
    if case == "segment_spans_3_tiles":
        # one bucket, one fingerprint 600 times and eleven others: the
        # bucket's run and the fingerprint's run both cross tile edges
        nb, pre = 1, in_buckets(rng, 1, lambda b: b >= 0, 4)
        few = in_buckets(rng, 1, lambda b: b >= 0, 12)
        fps = np.concatenate([np.repeat(few[:1], 600),
                              rng.choice(few, 3 * PLAN_TILE - 600)])
    elif case == "overflow_in_last_tile_only":
        # 17 novel fingerprints in the last bucket sort to the last tile
        nb = 64
        pre = in_buckets(rng, nb, lambda b: b < nb - 1, 2 * nb)
        others = in_buckets(rng, nb, lambda b: b < nb - 1, 150)
        fps = np.concatenate([
            rng.choice(others, 2 * PLAN_TILE + 83),
            in_buckets(rng, nb, lambda b: b == nb - 1, SLOTS + 1),
        ])
    elif case == "cand_overflow":
        fps = in_buckets(rng, nb, lambda b: b >= 0, 700)
        compact = 512
    elif case == "n_new_zero":  # every candidate is in the table
        fps = rng.choice(pre, 900)
    elif case == "m_1":
        fps = in_buckets(rng, nb, lambda b: b >= 0, 1)
    elif case == "m_tile_plus_1":
        fps = rng.choice(in_buckets(rng, nb, lambda b: b >= 0, 200),
                         PLAN_TILE + 1)
        fps[::5] = EMPTY
    elif case == "many_tiles":  # far more tiles than resident CTAs
        nb, pre = 1 << 15, np.empty(0, np.uint64)
        fps = rng.choice(in_buckets(rng, nb, lambda b: b >= 0, 60_000),
                         300_000)
        fps[rng.random(fps.size) < 0.3] = EMPTY
        compact = 250_000
    else:
        raise ValueError(case)
    tfp = torch.full((nb * SLOTS,), -1, dtype=torch.int64)
    tpl = torch.zeros_like(tfp)
    if pre.size:
        bucket_insert(tfp, tpl, i64(pre), i64(pre))
    return tfp, tpl, i64(fps), rand_i64(rng, fps.size), compact


PLAN_CASES = ["segment_spans_3_tiles", "overflow_in_last_tile_only",
              "cand_overflow", "n_new_zero", "m_1", "m_tile_plus_1",
              "many_tiles"]


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


@pytest.mark.parametrize("n_new,m", [(3000, 4096), (0, 4096), (1, 1)])
@pytest.mark.parametrize("with_queue", [False, True])
def test_insert_commit_kernel_matches_plain(cuda, n_new, m, with_queue):
    rng = np.random.default_rng(2)
    nslots, arity, width, q, tail = 1 << 14, 4, 2, 9000, 123
    tfp, tpl = rand_i64(rng, nslots), rand_i64(rng, nslots)
    tgt = torch.full((m,), nslots, dtype=torch.int64)
    tgt[:n_new] = torch.from_numpy(rng.choice(nslots, n_new, replace=False))
    cfp, cpl = rand_i64(rng, m), rand_i64(rng, m)
    n = torch.tensor(n_new)
    queue = None
    if with_queue:
        b = -(-m // arity)
        queue = QueueAppend(
            rand_i64(rng, q, width), rand_i64(rng, q),
            torch.from_numpy(rng.integers(0, 99, q).astype(np.int32)),
            torch.from_numpy(rng.integers(0, 99, q).astype(np.int32)),
            torch.tensor(tail), torch.from_numpy(rng.permutation(m)),
            rand_i64(rng, b * arity, width),
            torch.from_numpy(rng.integers(-99, 99, b).astype(np.int32)),
            torch.from_numpy(rng.integers(0, 99, b).astype(np.int32)), arity,
        )
        cq = QueueAppend(*(x.to(cuda) if torch.is_tensor(x) else x
                           for x in queue))
        queue = QueueAppend(*(x.clone() if torch.is_tensor(x) else x
                              for x in queue))
    pf, pp = insert_commit_plain(tfp.clone(), tpl.clone(), tgt, cfp, cpl, n,
                                 queue)
    kf, kp = insert_commit(*(t.to(cuda) for t in (tfp, tpl, tgt, cfp, cpl, n)),
                           cq if with_queue else None)
    torch.cuda.synchronize()
    assert torch.equal(kf.cpu(), pf) and torch.equal(kp.cpu(), pp)
    if with_queue:
        for g, w in zip(cq[:4], queue[:4]):
            assert torch.equal(g.cpu(), w)


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
