"""The port's native module (``stateright_tpu_torch/native/``): its C++
consistency search against the port's Python search and the JAX
package's native search on seeded random register histories, the known
cases of ``tests/test_native.py``, the verdict cache, the compiled-CPU
BFS baseline's counts against JAX's baseline and the engines on 2pc-3
and paxos-1, where the build lands, and the warning and the Python
fallback when it fails."""

import random
import warnings
from pathlib import Path

import pytest
import torch

from stateright_tpu import native as jnative
from stateright_tpu import semantics as jsem
from stateright_tpu.native.baseline import compiled_cpu_bfs as jax_bfs
from stateright_tpu.semantics.register import READ as JREAD
from stateright_tpu.semantics.register import write as jwrite
from stateright_tpu_torch import native
from stateright_tpu_torch.native import build as nbuild
from stateright_tpu_torch.native.baseline import compiled_cpu_bfs
from stateright_tpu_torch.semantics import (
    LinearizabilityTester, Register, SequentialConsistencyTester,
)
from stateright_tpu_torch.semantics.register import READ, write

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def python_verdict(tester) -> bool:
    return tester.valid and tester.serialized_history() is not None


def native_verdict(tester) -> bool:
    v = tester._native_verdict()
    assert v is not None, "the native path is unexpectedly unavailable"
    return v


def random_histories(seed: int, n: int):
    """``(port tester, JAX tester)`` pairs fed the same simulated register
    traffic (biased toward valid histories by a real register)."""
    rng = random.Random(seed)
    for _ in range(n):
        for cls, jcls in ((LinearizabilityTester, jsem.LinearizabilityTester),
                          (SequentialConsistencyTester,
                           jsem.SequentialConsistencyTester)):
            t, j = cls(Register("\0")), jcls(jsem.Register("\0"))
            threads = list(range(rng.randint(1, 3)))
            pending = {}
            register = "\0"
            for _ in range(rng.randint(0, 8)):
                th = rng.choice(threads)
                if th in pending:
                    op = pending.pop(th)
                    if op[0] == "write":
                        register = op[1] if rng.random() < 0.8 else register
                        ret = ("write_ok",)
                    else:
                        value = (register if rng.random() < 0.6
                                 else rng.choice("ABC\0"))
                        ret = ("read_ok", value)
                    t, j = t.on_return(th, ret), j.on_return(th, ret)
                else:
                    if rng.random() < 0.5:
                        v = rng.choice("ABC")
                        op, jop = write(v), jwrite(v)
                    else:
                        op, jop = READ, JREAD
                    pending[th] = op
                    t, j = t.on_invoke(th, op), j.on_invoke(th, jop)
            yield t, j


@pytest.mark.parametrize("seed", [42, 7])
def test_native_matches_python_and_jax_on_random_histories(seed):
    if jnative.load() is None:
        pytest.skip("the JAX package's native module is unavailable")
    bad = []
    for i, (t, j) in enumerate(random_histories(seed, 400)):
        py, nat, jnat = python_verdict(t), native_verdict(t), \
            j._native_verdict()
        if not (py == nat == jnat):
            bad.append((i, t, py, nat, jnat))
    assert not bad, bad[:3]


def test_native_known_cases():
    t = LinearizabilityTester(Register("\0"))
    t = t.on_invoke(0, write("A")).on_return(0, ("write_ok",))
    t = t.on_invoke(1, READ).on_return(1, ("read_ok", "A"))
    assert native_verdict(t) and python_verdict(t)
    # a read of a value never written
    t2 = LinearizabilityTester(Register("\0"))
    t2 = t2.on_invoke(1, READ).on_return(1, ("read_ok", "Z"))
    assert not native_verdict(t2) and not python_verdict(t2)

    # a stale read: linearizability rejects, sequential consistency accepts
    def run(cls):
        t = cls(Register("\0"))
        t = t.on_invoke(0, write("A")).on_return(0, ("write_ok",))
        return t.on_invoke(1, READ).on_return(1, ("read_ok", "\0"))

    assert not native_verdict(run(LinearizabilityTester))
    assert native_verdict(run(SequentialConsistencyTester))
    # an in-flight write may explain a read
    t3 = LinearizabilityTester(Register("\0"))
    t3 = t3.on_invoke(0, write("A"))
    t3 = t3.on_invoke(1, READ).on_return(1, ("read_ok", "A"))
    assert native_verdict(t3) and python_verdict(t3)
    # protocol misuse invalidates permanently
    t4 = LinearizabilityTester(Register("\0")).on_return(0, ("write_ok",))
    assert not t4.valid and t4._native_verdict() is False


def test_is_consistent_uses_native_and_caches(monkeypatch):
    calls = []
    real = LinearizabilityTester._native_verdict

    def spy(self):
        calls.append(1)
        return real(self)

    monkeypatch.setattr(LinearizabilityTester, "_native_verdict", spy)
    t = LinearizabilityTester(Register("\0"))
    t = t.on_invoke(0, write("Q")).on_return(0, ("write_ok",))
    t = t.on_invoke(5, READ).on_return(5, ("read_ok", "Q"))
    assert t.is_consistent() is True
    assert t.is_consistent() is True  # served from the cache
    assert calls == [1]


@pytest.mark.parametrize("name", ["2pc3", "paxos1"])
def test_compiled_cpu_bfs_matches_jax_and_the_engine(name):
    from stateright_tpu.models.paxos import paxos_model as jpaxos
    from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxSys
    from stateright_tpu_torch.models.paxos import paxos_model
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    model, jmodel = ((TwoPhaseSys(3), JaxSys(3)) if name == "2pc3"
                     else (paxos_model(1), jpaxos(1)))
    got = compiled_cpu_bfs(model, batch=64)
    want = jax_bfs(jmodel, batch=64)
    assert want is not None and got is not None
    for k in ("states", "unique", "wavefronts"):
        assert got[k] == want[k], k
    eng = model.checker().spawn_gpu(device="cpu", batch=64, sync=True)
    assert (got["unique"], got["states"]) == (eng.unique_state_count(),
                                              eng.state_count())
    # a target stops at a clean batch boundary at or past it
    part = compiled_cpu_bfs(model, target=100, batch=64)
    assert 100 <= part["unique"] < got["unique"]


def test_the_build_lands_under_build_and_is_the_ports_own():
    mod = native.load()
    assert mod is not None
    path = Path(mod.__file__).resolve()
    build_dir = (REPO / "stateright_tpu_torch" / "_build").resolve()
    assert build_dir in path.parents
    assert path == nbuild.module_path().resolve()
    assert mod.__name__ == "_stateright_torch_native"
    # built from the port's sources, not the JAX package's
    assert all((REPO / "stateright_tpu_torch" / "native" / s).exists()
               for s in nbuild.SOURCES)
    assert nbuild.build() == nbuild.module_path()  # cached: no rebuild


def test_a_failed_build_warns_once_and_python_decides(monkeypatch):
    monkeypatch.setattr(native, "_module", None)
    monkeypatch.setattr(native, "_attempted", False)

    def broken():
        raise RuntimeError("g++ failed (1): simulated")

    monkeypatch.setattr(nbuild, "build", broken)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert native.load() is None
        assert native.load() is None
    assert len([x for x in w if "native extension build failed"
                in str(x.message)]) == 1
    t = LinearizabilityTester(Register("\0"))
    t = t.on_invoke(0, write("B")).on_return(0, ("write_ok",))
    t = t.on_invoke(1, READ).on_return(1, ("read_ok", "W"))
    assert t._native_verdict() is None
    assert t.is_consistent() is False
