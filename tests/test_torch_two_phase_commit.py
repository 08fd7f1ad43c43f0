"""The port's 2pc twin (``stateright_tpu_torch.models.two_phase_commit``)
against the JAX twin and the object model on every reachable state of
2pc-3: encodings, fingerprints, ``step_rows`` successors and validity, and
``property_masks`` must be equal (tolerance 0)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxSys
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys


def reachable_states(model):
    seen = {}
    frontier = list(model.init_states())
    for s in frontier:
        seen[model.fingerprint_state(s)] = s
    while frontier:
        nxt = []
        for s in frontier:
            for t in model.next_states(s):
                fp = model.fingerprint_state(t)
                if fp not in seen:
                    seen[fp] = t
                    nxt.append(t)
        frontier = nxt
    return list(seen.values())


@pytest.fixture(scope="module")
def space():
    sys_ = TwoPhaseSys(3)
    states = reachable_states(sys_)
    tensor = sys_.tensor_model()
    rows = np.asarray([tensor.encode_state(s) for s in states], np.uint64)
    return sys_, JaxSys(3), states, rows


def test_reachable_space_and_fingerprints_match_reference(space):
    sys_, jsys, states, rows = space
    assert len(states) == 288
    assert len(reachable_states(jsys)) == 288
    jt = jsys.tensor_model()
    for s, row in zip(states, rows):
        assert tuple(int(w) for w in row) == jt.encode_state(s)
        assert sys_.tensor_model().decode_state(row) == s
        assert sys_.fingerprint_state(s) == jsys.fingerprint_state(s)


def test_step_rows_match_jax_twin_and_object_model(space):
    sys_, jsys, states, rows = space
    tt, jt = sys_.tensor_model(), jsys.tensor_model()
    succ, valid = tt.step_rows(torch.from_numpy(rows.view(np.int64)))
    jsucc, jvalid = jt.step_rows(jnp.asarray(rows))
    succ = succ.numpy().view(np.uint64)
    valid = valid.numpy()
    jsucc, jvalid = np.asarray(jsucc), np.asarray(jvalid)
    assert succ.shape == jsucc.shape == (288, tt.max_actions, tt.width)
    np.testing.assert_array_equal(valid, jvalid)
    np.testing.assert_array_equal(succ[valid], jsucc[jvalid])
    for i, s in enumerate(states):
        obj = sorted(tuple(tt.encode_state(t)) for t in sys_.next_states(s))
        dev = sorted(tuple(int(w) for w in succ[i, a])
                     for a in range(tt.max_actions) if valid[i, a])
        assert dev == obj


def test_property_masks_match_jax_twin_and_object_model(space):
    sys_, jsys, states, rows = space
    masks = sys_.tensor_model().property_masks(
        torch.from_numpy(rows.view(np.int64))
    ).numpy()
    jmasks = np.asarray(jsys.tensor_model().property_masks(jnp.asarray(rows)))
    np.testing.assert_array_equal(masks, jmasks)
    for i, s in enumerate(states):
        for p, prop in enumerate(sys_.properties()):
            assert bool(masks[i, p]) == bool(prop.condition(sys_, s))


def test_init_rows_match_reference():
    for n in (1, 3, 7):
        np.testing.assert_array_equal(
            TwoPhaseSys(n).tensor_model().init_rows(),
            JaxSys(n).tensor_model().init_rows(),
        )


def test_packer_layout_matches_reference():
    for n in (2, 10, 29):
        assert (TwoPhaseSys(n).tensor_model().packer.layout
                == JaxSys(n).tensor_model().packer.layout)
