"""Actor-handler lint: AST + one bounded closure step over actor systems.

The port's own copy of ``stateright_tpu/analysis/handler_lint.py``, over
the port's actor layer (``actor/``).  It reads Python source and runs
handlers on the host: no device work, no graph.

The model checker's soundness rests on handlers being *pure functions of
(state, message)*: the CPU checkers memoize on state hashes, and the actor
compiler (``parallel/actor_compiler.py``) runs each handler exactly once
per (state, envelope) pair and replays the tabulated effect on device.  A
handler that consults a clock, mutates its input, or iterates a set in
hash order silently forks the transition relation between those replays.

Rules (the JAX package's ``docs/analysis.md`` catalogue):

 - ``AH201`` error — nondeterminism source in a handler (unseeded
   ``random``, wall-clock ``time``/``datetime``, ``uuid``, ``os.urandom``);
 - ``AH202`` warning — ordering/address nondeterminism: builtin ``id()``
   or iteration over a set literal / ``set()`` call (hash order leaks into
   send order);
 - ``AH203`` error — in-place mutation of the incoming state (assignment
   to, or a mutating method call on, the state parameter): states must be
   immutable values shared structurally across the visited set;
 - ``AH204`` error — unhashable actor start state: the checkers and the
   compiler's interning tables key on ``hash(state)``;
 - ``AH205`` warning — a numeric field (or collection size) grows
   monotonically under a bounded step of the tabulation closure: the
   Paxos-ballot trap — the compile closure diverges without a
   ``state_bound`` (downgraded to info when the model's compiled twin
   already declares one);
 - ``AH206`` info — handler source unavailable; AST rules skipped for
   that actor class.
"""

from __future__ import annotations

import ast
import dataclasses
import inspect
import textwrap
from collections import deque
from typing import Optional

from .report import Severity

_MUTATORS = frozenset(
    {
        "append", "extend", "insert", "remove", "pop", "clear", "add",
        "discard", "update", "setdefault", "popitem", "sort", "reverse",
    }
)

_TIME_FNS = frozenset(
    {"time", "monotonic", "perf_counter", "time_ns", "monotonic_ns"}
)

# (class, method name) -> list[(rule_id, severity, line, message)]
_AST_CACHE: dict = {}


def _root_name(node) -> Optional[str]:
    """Follow ``a.b[c].d`` down to its base ``Name``; None if the chain
    passes through a call or other expression (a copy breaks the chain)."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


class _HandlerVisitor(ast.NodeVisitor):
    def __init__(self, state_param: Optional[str], param_names: set):
        self.state_param = state_param
        self.param_names = param_names
        self.hits: list = []  # (rule_id, severity, lineno, message)

    # -- nondeterminism ------------------------------------------------------

    def visit_Call(self, node: ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute):
            base = f.value
            if isinstance(base, ast.Name) and base.id not in self.param_names:
                mod, attr = base.id, f.attr
                if mod == "random":
                    self._hit(
                        node, "AH201", Severity.ERROR,
                        f"unseeded random.{attr}() in a handler: every "
                        "closure replay rolls different dice",
                    )
                elif mod == "time" and attr in _TIME_FNS:
                    self._hit(
                        node, "AH201", Severity.ERROR,
                        f"wall-clock time.{attr}() in a handler: transitions "
                        "become time-dependent and unreproducible",
                    )
                elif mod == "uuid" and attr.startswith("uuid"):
                    self._hit(
                        node, "AH201", Severity.ERROR,
                        f"uuid.{attr}() in a handler is a nondeterminism "
                        "source",
                    )
                elif mod == "os" and attr == "urandom":
                    self._hit(
                        node, "AH201", Severity.ERROR,
                        "os.urandom() in a handler is a nondeterminism source",
                    )
            if f.attr in ("now", "utcnow"):
                root = _root_name(f.value)
                if root in ("datetime", "date") and root not in self.param_names:
                    self._hit(
                        node, "AH201", Severity.ERROR,
                        f"{root}.{f.attr}() in a handler: wall-clock "
                        "nondeterminism",
                    )
            # in-place mutation via method call on the state param
            if (
                self.state_param
                and f.attr in _MUTATORS
                and _root_name(f.value) == self.state_param
            ):
                self._hit(
                    node, "AH203", Severity.ERROR,
                    f"in-place mutation of the incoming state "
                    f"({ast.unparse(f)}(...)): handlers must return a new "
                    "state — the old one is shared across the visited set",
                )
        elif isinstance(f, ast.Name):
            if f.id == "id" and "id" not in self.param_names:
                self._hit(
                    node, "AH202", Severity.WARNING,
                    "builtin id() is a memory address: varies across runs "
                    "and processes",
                )
        self.generic_visit(node)

    # -- in-place mutation via assignment ------------------------------------

    def _check_target(self, target):
        if isinstance(target, (ast.Attribute, ast.Subscript)):
            if self.state_param and _root_name(target) == self.state_param:
                self.hits.append(
                    (
                        "AH203",
                        Severity.ERROR,
                        target.lineno,
                        f"assignment into the incoming state "
                        f"({ast.unparse(target)} = ...): handlers must "
                        "build a new state, not mutate the shared one",
                    )
                )
        elif isinstance(target, (ast.Tuple, ast.List)):
            for t in target.elts:
                self._check_target(t)

    def visit_Assign(self, node: ast.Assign):
        for t in node.targets:
            self._check_target(t)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign):
        self._check_target(node.target)
        self.generic_visit(node)

    # -- set-iteration ordering ----------------------------------------------

    def visit_For(self, node: ast.For):
        it = node.iter
        is_set = isinstance(it, ast.Set) or (
            isinstance(it, ast.Call)
            and isinstance(it.func, ast.Name)
            and it.func.id in ("set", "frozenset")
        )
        if is_set:
            self._hit(
                node, "AH202", Severity.WARNING,
                "iteration over a set in a handler: hash order leaks into "
                "effect order; iterate sorted(...) instead",
            )
        self.generic_visit(node)

    def _hit(self, node, rule, sev, msg):
        self.hits.append((rule, sev, node.lineno, msg))


def _rebinds(fndef, name: str) -> bool:
    """True when the function binds ``name`` itself (plain assignment,
    walrus, for/with target, aug-assign to the bare name)."""
    for node in ast.walk(fndef):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        elif isinstance(node, ast.NamedExpr):
            targets = [node.target]
        elif isinstance(node, ast.For):
            targets = [node.target]
        elif isinstance(node, ast.withitem) and node.optional_vars:
            targets = [node.optional_vars]
        for t in targets:
            stack = [t]
            while stack:
                x = stack.pop()
                if isinstance(x, ast.Name) and x.id == name:
                    return True
                if isinstance(x, (ast.Tuple, ast.List)):
                    stack.extend(x.elts)
    return False


_AST_CACHE_MAX = 2048


def _lint_method(cls, method_name: str) -> Optional[list]:
    """AST-lint one handler; cached per (class, method).  None means the
    source is unavailable (AH206)."""
    key = (cls, method_name)
    if key in _AST_CACHE:
        return _AST_CACHE[key]
    if len(_AST_CACHE) >= _AST_CACHE_MAX:
        _AST_CACHE.clear()  # strong class keys would pin redefined classes
    fn = getattr(cls, method_name, None)
    if fn is None:
        _AST_CACHE[key] = []
        return []
    try:
        src = textwrap.dedent(inspect.getsource(fn))
        tree = ast.parse(src)
    except (OSError, TypeError, IndentationError, SyntaxError):
        _AST_CACHE[key] = None
        return None
    fndef = next(
        (
            n
            for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ),
        None,
    )
    if fndef is None:
        _AST_CACHE[key] = []
        return []
    params = [a.arg for a in fndef.args.args]
    # on_msg(self, id, state, src, msg, out) / on_timeout(self, id, state, out)
    state_param = (
        params[2] if method_name in ("on_msg", "on_timeout") and len(params) > 2
        else None
    )
    # A handler that REBINDS the state name (`state = dict(state)`) then
    # mutates its own local copy is sound: drop the mutation rule for it
    # rather than abort a correct model (conservative under-reporting).
    if state_param is not None and _rebinds(fndef, state_param):
        state_param = None
    v = _HandlerVisitor(state_param, set(params))
    v.visit(fndef)
    _AST_CACHE[key] = v.hits
    return v.hits


# -- bounded closure probe (AH205) -------------------------------------------


def _leaves(obj, path: str = "", depth: int = 0):
    """Numeric leaves of a state value, plus collection sizes, keyed by a
    stable field path (dataclass fields, tuple indices; set/dict contents
    collapse onto one aggregated path)."""
    if depth > 6:
        return
    if isinstance(obj, bool) or obj is None:
        return
    if isinstance(obj, int):
        yield path or ".", int(obj)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name), f"{path}.{f.name}", depth + 1)
    elif isinstance(obj, tuple) and hasattr(obj, "_fields"):  # namedtuple
        for name in obj._fields:
            yield from _leaves(getattr(obj, name), f"{path}.{name}", depth + 1)
    elif isinstance(obj, (tuple, list)):
        yield f"{path}.len", len(obj)
        for k, v in enumerate(obj):
            yield from _leaves(v, f"{path}[{k}]", depth + 1)
    elif isinstance(obj, (set, frozenset)):
        yield f"{path}.len", len(obj)
        for v in obj:
            yield from _leaves(v, f"{path}{{}}", depth + 1)
    elif isinstance(obj, dict):
        yield f"{path}.len", len(obj)
        for v in obj.values():
            yield from _leaves(v, f"{path}{{}}", depth + 1)


def _probe_domains(model, max_calls: int = 4000, max_rounds: int = 10):
    """One bounded step of the tabulation closure: pair every discovered
    state with every discovered envelope (exactly what the compiler's
    closure does, over-approximating reachability), bounded by a handler
    call budget.  Returns ``(growing, converged)`` where ``growing`` maps
    ``(actor_index, field_path)`` to its per-round max series."""
    from ..actor import Id, Out, Send
    from ..actor.network import Envelope

    n = len(model.actors)
    state_round: list = [dict() for _ in range(n)]  # state -> round seen
    env_round: dict = {}
    work: deque = deque()  # ("s", i, state, round) | ("e", env, round)
    maxes: dict = {}  # (i, path) -> {round: max}
    calls = 0

    def note(i, s, rnd):
        for path, val in _leaves(s):
            cur = maxes.setdefault((i, path), {})
            cur[rnd] = max(cur.get(rnd, val), val)

    def add_state(i, s, rnd):
        try:
            if s in state_round[i]:
                return
        except TypeError:
            return  # unhashable: AH204 already covers it
        state_round[i][s] = rnd
        note(i, s, rnd)
        work.append(("s", i, s, rnd))

    def add_env(env, rnd):
        if env in env_round:
            return
        env_round[env] = rnd
        work.append(("e", env, rnd))

    try:
        inits = list(model.init_states())
    except Exception:  # noqa: BLE001 - init failure surfaces elsewhere
        return {}, True
    for init in inits:  # seed from EVERY initial system state
        for i, s in enumerate(init.actor_states):
            add_state(i, s, 0)
        for env in init.network.iter_deliverable():
            add_env(env, 0)

    done_pairs: set = set()

    def run_handler(i, s, env, rnd):
        nonlocal calls
        calls += 1
        out = Out()
        try:
            if env is None:
                ret = model.actors[i].on_timeout(Id(i), s, out)
            else:
                ret = model.actors[i].on_msg(Id(i), s, env.src, env.msg, out)
        except Exception:  # noqa: BLE001 - impossible pair: compiler poisons
            return
        if ret is not None:
            add_state(i, ret, rnd + 1)
        for c in out.commands:
            if isinstance(c, Send):
                add_env(Envelope(src=Id(i), dst=c.dst, msg=c.msg), rnd + 1)

    truncated = False
    while work:
        if calls >= max_calls or work[0][-1] >= max_rounds:
            # budget or round cap hit with expansion still pending: the
            # closure did NOT converge (items stay queued so the flag and
            # the queue agree)
            truncated = True
            break
        kind, *rest = work.popleft()
        if kind == "s":
            i, s, rnd = rest
            run_handler(i, s, None, rnd)
            for env in list(env_round):
                if int(env.dst) == i and (i, s, env) not in done_pairs:
                    done_pairs.add((i, s, env))
                    run_handler(i, s, env, rnd)
        else:
            env, rnd = rest
            i = int(env.dst)
            if i < n:
                for s in list(state_round[i]):
                    if (i, s, env) not in done_pairs:
                        done_pairs.add((i, s, env))
                        run_handler(i, s, env, max(rnd, state_round[i][s]))

    converged = not truncated and not work
    growing: dict = {}
    if not converged:
        for (i, path), per_round in maxes.items():
            rounds = sorted(per_round)
            if len(rounds) < 4:
                continue
            series = []
            running = None
            for r in rounds:
                running = per_round[r] if running is None else max(
                    running, per_round[r]
                )
                series.append(running)
            # strictly increasing over the last 3 observed rounds: the
            # field is still growing when the budget ran out
            tail = series[-4:]
            if all(a < b for a, b in zip(tail, tail[1:])):
                growing[(i, path)] = series
    return growing, converged


def run_handler_lint(
    model,
    report,
    *,
    deep: bool = False,
    bounded_twin: bool = False,
) -> None:
    """Lint ``model``'s actors into ``report``.  ``bounded_twin`` downgrades
    AH205 to info (the compiled twin already declares a ``state_bound``,
    so the growth is cut before it reaches the device)."""
    from ..actor import Actor, Id, Out

    actors = getattr(model, "actors", None)
    if not actors:
        return

    seen_classes: set = set()
    for i, actor in enumerate(actors):
        cls = type(actor)
        if cls in seen_classes:
            continue
        seen_classes.add(cls)
        loc_base = f"actor[{i}] {cls.__name__}"
        for method in ("on_start", "on_msg", "on_timeout"):
            fn = getattr(cls, method, None)
            if fn is None or fn is getattr(Actor, method, None):
                continue  # inherited no-op default
            hits = _lint_method(cls, method)
            if hits is None:
                report.add(
                    "AH206",
                    Severity.INFO,
                    f"{loc_base}.{method}",
                    "handler source unavailable; AST lint skipped",
                )
                continue
            for rule, sev, line, msg in hits:
                report.add(rule, sev, f"{loc_base}.{method}:{line}", msg)

    # AH204: start states must be hashable (checker memoization and the
    # compiler's interning tables both key on hash(state)).
    for i, actor in enumerate(actors):
        try:
            s = actor.on_start(Id(i), Out())
        except Exception as e:  # noqa: BLE001 - surfaced as a finding
            report.add(
                "AH206",
                Severity.INFO,
                f"actor[{i}] {type(actor).__name__}.on_start",
                f"on_start failed during preflight: {type(e).__name__}: {e}",
            )
            continue
        try:
            hash(s)
        except TypeError as e:
            report.add(
                "AH204",
                Severity.ERROR,
                f"actor[{i}] {type(actor).__name__}",
                f"start state is unhashable ({e}); states must be immutable "
                "hashable values (frozen dataclasses, tuples, frozensets)",
            )

    if deep:
        growing, _converged = _probe_domains(model)
        sev = Severity.INFO if bounded_twin else Severity.WARNING
        for (i, path), series in sorted(growing.items()):
            suffix = (
                " (the compiled twin's state_bound cuts this tail: ok)"
                if bounded_twin
                else "; compiling to the device needs a state_bound "
                "(the Paxos-ballot trap — see parallel/actor_compiler.py)"
            )
            report.add(
                "AH205",
                sev,
                f"actor[{i}] field {path!r}",
                "monotonically growing domain under the tabulation closure "
                f"(max per round: {series[-4:]}); the compile closure "
                "diverges without a bound" + suffix,
            )
