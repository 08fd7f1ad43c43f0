"""The port's slot-multiset network ops (``parallel/actor_tensor.py``),
``closure_verdict`` and the ``put_count=1`` history codec
(``parallel/history_tensor.py``) against the JAX package's on seeded random
inputs, bit for bit (tolerance 0): sorted slot rows with free tails, codes
whose top bit (word bit 63) is set, saturated counts, full rows, both send
semantics, ordered appends on deep flows, and both history strategies."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from stateright_tpu.parallel import actor_tensor as jat
from stateright_tpu.parallel.history_tensor import (
    LinHistoryCodec as JaxLinHistoryCodec,
    closure_verdict as jax_closure_verdict,
)
from stateright_tpu_torch.parallel import actor_tensor as tat
from stateright_tpu_torch.parallel.history_tensor import (
    LinHistoryCodec,
    closure_verdict,
)

EMPTY = np.uint64(jat.SLOT_EMPTY)
CODE_BITS = 64 - jat.COUNT_BITS


def t64(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint64).view(np.int64))


def u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def random_codes(rng, n):
    """Codes over the whole 58-bit range; a third have bit 57 set, so their
    slot words have bit 63 set (negative as int64)."""
    codes = rng.integers(0, 1 << CODE_BITS, size=n, dtype=np.uint64)
    top = rng.random(n) < 1 / 3
    codes[top] |= np.uint64(1 << (CODE_BITS - 1))
    return codes


def random_slots(rng, rows, n):
    """Canonical slot rows: distinct codes, counts in 1..63 (a quarter
    saturated), sorted ascending as unsigned words, EMPTY tail; some rows
    are full and some empty."""
    out = np.full((rows, n), EMPTY, np.uint64)
    occ = rng.integers(0, n + 1, size=rows)
    occ[::7] = n  # full rows
    occ[1::11] = 0
    for r in range(rows):
        codes = np.unique(random_codes(rng, occ[r]))
        counts = rng.integers(1, jat.COUNT_MASK + 1, size=codes.size)
        counts[rng.random(codes.size) < 0.25] = jat.COUNT_MASK
        words = (codes << np.uint64(jat.COUNT_BITS)) | counts.astype(np.uint64)
        out[r, : words.size] = np.sort(words)
    return out


@pytest.mark.parametrize("set_semantics", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slot_send_matches_jax(seed, set_semantics):
    rng = np.random.default_rng(seed)
    rows, n = 600, 8
    slots = random_slots(rng, rows, n)
    # half the sends hit a code already in the row
    code = random_codes(rng, rows)
    hit = rng.random(rows) < 0.5
    for r in np.nonzero(hit)[0]:
        k = int((slots[r] != EMPTY).sum())
        if k:
            code[r] = slots[r, rng.integers(k)] >> np.uint64(jat.COUNT_BITS)
    enable = rng.random(rows) < 0.8
    want, wof = jat.slot_send(jnp.asarray(slots), jnp.asarray(code),
                              jnp.asarray(enable), set_semantics=set_semantics)
    got, gof = tat.slot_send(t64(slots), t64(code), torch.from_numpy(enable),
                             set_semantics=set_semantics)
    np.testing.assert_array_equal(u64(got), np.asarray(want))
    np.testing.assert_array_equal(gof.numpy(), np.asarray(wof))
    # the cases the inputs were built to reach
    full = (slots != EMPTY).all(axis=1)
    assert gof.numpy()[full & enable & ~hit].all()  # no free slot
    if not set_semantics:
        assert gof.numpy()[enable & ~full].any()  # a saturated count


def test_slot_sends_compose_then_canonicalize_matches_jax():
    """Three sends in a row, then one sort, as the paxos step does."""
    rng = np.random.default_rng(7)
    slots = random_slots(rng, 400, 10)
    js, ts = jnp.asarray(slots), t64(slots)
    for _ in range(3):
        code = random_codes(rng, 400)
        en = rng.random(400) < 0.7
        js, _ = jat.slot_send(js, jnp.asarray(code), jnp.asarray(en))
        ts, _ = tat.slot_send(ts, t64(code), torch.from_numpy(en))
    np.testing.assert_array_equal(u64(ts), np.asarray(js))
    np.testing.assert_array_equal(u64(tat.slot_canonicalize(ts)),
                                  np.asarray(jat.slot_canonicalize(js)))


@pytest.mark.parametrize("seed", [0, 1])
def test_slot_canonicalize_sorts_free_slots_last(seed):
    rng = np.random.default_rng(seed)
    slots = random_slots(rng, 500, 12)
    for r in slots:  # scramble each row, free slots included
        rng.shuffle(r)
    got = u64(tat.slot_canonicalize(t64(slots)))
    np.testing.assert_array_equal(got, np.asarray(jat.slot_canonicalize(
        jnp.asarray(slots))))
    np.testing.assert_array_equal(got, np.sort(slots, axis=1))
    occ = (got != EMPTY).sum(axis=1)
    for r, k in zip(got, occ):
        assert (r[k:] == EMPTY).all() and (r[:k] != EMPTY).all()


@pytest.mark.parametrize("index", [0, 3, 7])
def test_slot_deliver_and_field_views_match_jax(index):
    rng = np.random.default_rng(index)
    slots = random_slots(rng, 300, 8)
    js, ts = jnp.asarray(slots), t64(slots)
    np.testing.assert_array_equal(u64(tat.slot_deliver(ts, index)),
                                  np.asarray(jat.slot_deliver(js, index)))
    np.testing.assert_array_equal(u64(tat.slot_codes(ts)),
                                  np.asarray(jat.slot_codes(js)))
    np.testing.assert_array_equal(u64(tat.slot_counts(ts)),
                                  np.asarray(jat.slot_counts(js)))
    np.testing.assert_array_equal(tat.slot_occupied(ts).numpy(),
                                  np.asarray(jat.slot_occupied(js)))


def test_slot_codec_round_trip_reads_int64_rows():
    envs = [(("e", i), 1 + i % jat.COUNT_MASK) for i in range(5)]
    codes = {("e", i): int(c) for i, c in
             enumerate(random_codes(np.random.default_rng(3), 5))}
    back = {v: k for k, v in codes.items()}
    port = tat.SlotCodec(8, codes.__getitem__, back.__getitem__)
    ref = jat.SlotCodec(8, codes.__getitem__, back.__getitem__)
    words = port.pack(envs)
    assert words == ref.pack(envs)
    as_i64 = t64(np.asarray(words, np.uint64)).tolist()
    assert any(w < 0 for w in as_i64)  # free slots and top-bit codes
    assert sorted(port.unpack(as_i64)) == sorted(envs)
    with pytest.raises(ValueError):
        port.pack([(("e", 0), jat.COUNT_MASK + 1)])


@pytest.mark.parametrize("C", range(1, 8))
def test_closure_verdict_matches_jax(C):
    rng = np.random.default_rng(C)
    B = 2000
    done = rng.random((B, C)) < 0.6
    s = rng.integers(0, 3, size=(B, C, C)).astype(np.int32)
    rvals = rng.integers(0, C + 1, size=(B, C)).astype(np.int32)
    rvals[rng.random((B, C)) < 0.1] = 0  # null reads
    want = np.asarray(jax_closure_verdict(jnp.asarray(done), jnp.asarray(s),
                                          jnp.asarray(rvals)))
    got = closure_verdict(torch.from_numpy(done),
                          torch.from_numpy(s.astype(np.int64)),
                          torch.from_numpy(rvals.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < B  # both verdicts occur


def ordered_slots(rng, rows, n, n_codes, n_flows, pair):
    """Canonical ordered-network slot rows: in-universe codes, each flow's
    envelopes at ranks 1..depth, free tails; some rows full, some empty,
    and a quarter of the rows put every envelope on flow 0, one slot short
    of full (a flow as deep as the rank field allows at n = 64)."""
    out = np.full((rows, n), EMPTY, np.uint64)
    occ = rng.integers(0, n + 1, size=rows)
    occ[::7] = n
    occ[1::11] = 0
    occ[3::4] = n - 1
    flow0 = np.nonzero(pair == 0)[0]
    for r in range(rows):
        deep = r % 4 == 3
        codes = rng.choice(flow0 if deep else n_codes, occ[r])
        depth = {}
        words = []
        for c in codes:
            f = pair[c]
            depth[f] = depth.get(f, 0) + 1
            words.append((int(c) << jat.COUNT_BITS)
                         | min(depth[f], jat.COUNT_MASK))
        out[r, : len(words)] = np.sort(np.asarray(words, np.uint64))
    return out


@pytest.mark.parametrize("n", [8, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_slot_send_ordered_matches_jax(seed, n):
    """Ordered appends on random rows: full rows, flows as deep as the
    rank field (n = 64 slots on one flow), and ``-1`` ("no send") codes on
    the disabled lanes, as the compiled step passes them."""
    rng = np.random.default_rng(seed)
    rows, n_codes, n_flows = 500, 40, 6
    pair = rng.integers(0, n_flows, size=n_codes).astype(np.int32)
    pair[:8] = 0  # flow 0 has codes enough for deep rows
    slots = ordered_slots(rng, rows, n, n_codes, n_flows, pair)
    code = rng.integers(0, n_codes, size=rows).astype(np.int64)
    code[rng.random(rows) < 0.3] = -1
    code[3::4] = 0  # appends to the deep flow
    enable = (code >= 0) & (rng.random(rows) < 0.9)
    want, wof = jat.slot_send_ordered(
        jnp.asarray(slots), jnp.asarray(code.astype(np.uint64)),
        jnp.asarray(pair), jnp.asarray(enable))
    got, gof = tat.slot_send_ordered(
        t64(slots), torch.from_numpy(code), torch.from_numpy(pair).long(),
        torch.from_numpy(enable))
    np.testing.assert_array_equal(u64(got), np.asarray(want))
    np.testing.assert_array_equal(gof.numpy(), np.asarray(wof))
    full = (slots != EMPTY).all(axis=1)
    assert gof.numpy()[full & enable].all()
    assert (~gof.numpy() & enable).any()
    if n == 64:
        # a 63-deep flow cannot take another envelope
        depth = ((slots != EMPTY) & (pair[np.where(
            slots != EMPTY, slots >> np.uint64(jat.COUNT_BITS), 0
        ).astype(np.int64)] == pair[np.maximum(code, 0)][:, None])).sum(1)
        assert gof.numpy()[enable & ~full & (depth >= jat.COUNT_MASK)].all()
        assert (enable & ~full & (depth >= jat.COUNT_MASK)).any()


@pytest.mark.parametrize("C", [1, 3, 7])
def test_lin_history_codec_device_verdict_matches_jax(C):
    """The closure strategy's device verdict on random packed fields (any
    phase, snapshot and read value), against the JAX codec's."""
    rng = np.random.default_rng(C)
    threads, values = list(range(C)), [chr(65 + i) for i in range(C)]
    hc = LinHistoryCodec(threads, values, "\0")
    jc = JaxLinHistoryCodec(threads, values, "\0")
    B = 3000
    phase = rng.integers(0, 3, size=(B, C))
    snap = rng.integers(0, 1 << max(1, 2 * (C - 1)), size=(B, C))
    rval = rng.integers(0, C + 1, size=(B, C))
    got = hc.device_verdict(*(torch.from_numpy(x)
                              for x in (phase, snap, rval))).numpy()
    want = np.asarray(jc.device_verdict(*(jnp.asarray(x.astype(np.int32))
                                          for x in (phase, snap, rval))))
    np.testing.assert_array_equal(got, want)
    assert want.any() and (C == 1 or not want.all())


def test_lin_history_codec_table_keys_and_lookup_match_jax():
    """The table strategy (writes may fail): ``device_key`` packs random
    fields like the JAX codec's, and ``device_lookup`` (sorted int64 keys
    and ``torch.searchsorted``) returns its verdicts, absent keys False."""
    rets = (("write_ok",), ("write_fail",))
    hc = LinHistoryCodec([5, 6], list("AB"), "\0", write_rets=rets)
    jc = JaxLinHistoryCodec([5, 6], list("AB"), "\0", write_rets=rets)
    np.testing.assert_array_equal(hc.table_keys, jc.table_keys)
    rng = np.random.default_rng(11)
    B = 4000
    fields = [rng.integers(0, 4, size=(B, 2)), rng.integers(0, 4, size=(B, 2)),
              rng.integers(0, 4, size=(B, 2)), rng.integers(0, 2, size=(B, 2))]
    keys = hc.device_key(*(torch.from_numpy(f) for f in fields))
    jkeys = jc.device_key(*(jnp.asarray(f.astype(np.int32)) for f in fields))
    np.testing.assert_array_equal(keys.numpy(), np.asarray(jkeys))
    # half the probes are real table keys
    keys[::2] = torch.from_numpy(rng.choice(hc.table_keys, B // 2))
    got = hc.device_lookup(keys).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jc.device_lookup(jnp.asarray(keys.numpy()))))
    assert got.any() and not got.all()
