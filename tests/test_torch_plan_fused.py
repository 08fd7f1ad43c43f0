"""The fused plan entry (``stateright_tpu_torch.ops.buckets.bucket_plan_fused``)
on the CPU, where it runs its plain form, tolerance 0:

 - against the composition it replaces on the engines' step, the key sort
   with the sorted lanes gathered (``sort_candidates``, and
   ``cand_prep.sort_prepared`` for ``cand_prep``'s lanes) followed by
   ``bucket_plan_plain``: every output lane, live and dead, and both
   scalars;
 - against the JAX package's ``bucket_insert``
   (``stateright_tpu/ops/buckets.py:137``): ``n_new``, both flags,
   ``sel[:n_new]`` and the planned slots and values, and the tables after
   the port's ``bucket_insert``, which now plans through the fused entry;

in table order and in generation order, on the shared case sets
(``tests/test_torch_plan_cases.py``: ``PLAN_CASES`` and ``GEN_CASES``)
and on three more: a one-bucket table (``bits == 0``), an all-EMPTY batch,
and a duplicate pair whose two lanes sort to the two sides of a tile
boundary.  A window (the mesh engine's table pieces) plans each piece's
run of the sorted lanes as the whole plan does."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from stateright_tpu.ops import buckets as jb
from stateright_tpu_torch.ops import buckets as tb
from stateright_tpu_torch.ops import cand_prep as cp
from test_torch_plan_cases import (
    GEN_CASES,
    PLAN_CASES,
    gen_case,
    i64,
    in_buckets,
    plan_case,
    rand_i64,
)

EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)
MORE_CASES = ["bits_0", "all_empty", "dup_pair_across_tile"]


def more_case(case, rng):
    """(table fp, table payload, candidates, payloads, compact)."""
    nb = 64
    if case == "bits_0":  # one bucket: no key bits name it
        nb = 1
        few = in_buckets(rng, 1, lambda b: b >= 0, 12)
        pre, fps = few[:3], rng.choice(few, 40)
    elif case == "all_empty":
        pre = in_buckets(rng, nb, lambda b: b >= 0, 100)
        fps = np.full(700, EMPTY, np.uint64)
    elif case == "dup_pair_across_tile":
        # sorted lanes PLAN_TILE - 1 and PLAN_TILE hold one fingerprint
        nb = 1 << 10
        pre = np.empty(0, np.uint64)
        fps = in_buckets(rng, nb, lambda b: b >= 0, 2 * tb.PLAN_TILE - 1)
        key = tb.bucket_key(i64(fps)) ^ tb.SIGN
        dup = fps[int(torch.sort(key, stable=True).indices[tb.PLAN_TILE - 1])]
        fps = rng.permutation(np.concatenate([fps, [dup]]))
    else:
        raise ValueError(case)
    tfp = torch.full((nb * tb.SLOTS,), -1, dtype=torch.int64)
    tpl = torch.zeros_like(tfp)
    if pre.size:
        tb.bucket_insert(tfp, tpl, i64(pre), i64(pre))
    return tfp, tpl, i64(fps), rand_i64(rng, fps.size), None


def case_inputs(case):
    """(table fp, table payload, candidates, payloads, compact) of any
    case of the three sets."""
    if case in PLAN_CASES:
        return plan_case(case, np.random.default_rng(PLAN_CASES.index(case)))
    if case in GEN_CASES:
        rng = np.random.default_rng(GEN_CASES.index(case))
        nb, pre, fps, compact = gen_case(case, rng)
        tfp = torch.full((nb * tb.SLOTS,), -1, dtype=torch.int64)
        tpl = torch.zeros_like(tfp)
        tb.bucket_insert(tfp, tpl, i64(pre), i64(pre))
        return tfp, tpl, i64(fps), rand_i64(rng, fps.size), compact
    return more_case(case, np.random.default_rng(10 + MORE_CASES.index(case)))


def fused_inputs(fps, payloads, compact):
    """The fused entry's inputs as the engines build them: the compacted
    lanes unsorted, the sorted keys and the permutation, the map and the
    budget flag."""
    f, p, cidx, cov = tb.compact_candidates(fps, payloads, compact)
    skey, order = tb.sort_keys(f)
    return f, p, skey, order, cidx, cov


@pytest.mark.parametrize("gen", [False, True], ids=["table", "generation"])
@pytest.mark.parametrize("case", PLAN_CASES + GEN_CASES + MORE_CASES)
def test_fused_plan_matches_composition_and_jax(case, gen):
    tfp, tpl, fps, payloads, compact = case_inputs(case)
    nb = tfp.shape[0] // tb.SLOTS
    inputs = fused_inputs(fps, payloads, compact)
    got = tb.bucket_plan_fused(tfp, *inputs, nb, generation_order=gen)
    old = tb.bucket_plan_plain(
        tfp, *tb.sort_candidates(fps, payloads, nb, compact),
        generation_order=gen)
    for g, o in zip(got, old):
        assert g.dtype == o.dtype and torch.equal(g, o)
    # cand_prep's lanes: the plain composition of the engines' step
    f, p, skey, order, cidx, cov = inputs
    prepared = cp.sort_prepared(f, p, tb.bucket_key(f) ^ tb.SIGN, nb)
    again = tb.bucket_plan_plain(tfp, *prepared, cidx, cov,
                                 generation_order=gen)
    for g, o in zip(got, again):
        assert torch.equal(g, o)

    # the JAX insert on the same table and batch
    u64 = lambda t: t.numpy().view(np.uint64)  # noqa: E731
    jt = (jnp.asarray(u64(tfp)), jnp.asarray(u64(tpl)))
    rj = jb.bucket_insert(*jt, jnp.asarray(u64(fps)),
                          jnp.asarray(u64(payloads)), window=64,
                          compact=compact, generation_order=gen)
    tgt, cfp, cpl, sel, n_new, overflow = got
    n = int(rj[3])
    assert int(n_new) == n
    assert bool(overflow) == bool(rj[4])
    assert bool(cov) == bool(rj[5])
    np.testing.assert_array_equal(sel.numpy()[:n], np.asarray(rj[2])[:n])
    jfp, jpl = np.asarray(rj[0]), np.asarray(rj[1])
    t = tgt.numpy()[:n]
    np.testing.assert_array_equal(np.sort(t), np.flatnonzero(jfp != u64(tfp)))
    np.testing.assert_array_equal(jfp[t], u64(cfp)[:n])
    np.testing.assert_array_equal(jpl[t], u64(cpl)[:n])
    # and the port's insert, which plans through the fused entry
    rt = tb.bucket_insert(tfp.clone(), tpl.clone(), fps, payloads,
                          compact=compact, generation_order=gen)
    assert int(rt[3]) == n
    np.testing.assert_array_equal(rt[2].numpy()[:n], np.asarray(rj[2])[:n])
    np.testing.assert_array_equal(u64(rt[0]), jfp)
    np.testing.assert_array_equal(u64(rt[1]), jpl)
    expect = {"all_empty": 0, "n_new_zero": 0}
    if case in expect:
        assert n == expect[case]
    if case == "dup_pair_across_tile":
        assert n == 2 * tb.PLAN_TILE - 1


@pytest.mark.parametrize("pieces", [2, 4])
def test_fused_plan_windows_are_the_pieces_of_the_whole_plan(pieces):
    """Each table piece's window of the sorted lanes (bounds from a
    ``searchsorted`` of the keys, buckets rebased by the piece's first)
    plans that piece's part of the whole table's plan: the same novel
    lanes in the same order, slots offset by the piece."""
    tfp, _tpl, fps, payloads, compact = plan_case(
        "cand_overflow", np.random.default_rng(3))
    compact = 1024  # room for every valid lane
    nb = tfp.shape[0] // tb.SLOTS
    nbp = nb // pieces
    f, p, skey, order, cidx, cov = fused_inputs(fps, payloads, compact)
    whole = tb.bucket_plan_fused(tfp, f, p, skey, order, cidx, cov, nb)
    n = int(whole[4])
    assert n > 0 and not bool(whole[5])
    bits = tb.bucket_bits(nb)
    firsts = [((k * nbp) << (64 - bits)) ^ (1 << 63) for k in range(pieces)]
    starts = torch.tensor([x - (1 << 64) if x >> 63 else x for x in firsts]
                          + [(1 << 63) - 1], dtype=torch.int64)
    bounds = torch.searchsorted(skey, starts)
    got = [[] for _ in range(4)]
    for k in range(pieces):
        part = tfp[k * nbp * tb.SLOTS:(k + 1) * nbp * tb.SLOTS]
        plan = tb.bucket_plan_fused(part, f, p, skey, order, cidx, cov, nb,
                                    win=bounds[k:k + 2], boff=k * nbp)
        nk = int(plan[4])
        got[0].append(plan[0][:nk] + k * nbp * tb.SLOTS)
        for i in (1, 2, 3):
            got[i].append(plan[i][:nk])
    for g, w in zip(got, whole[:4]):
        assert torch.equal(torch.cat(g), w[:n])
