"""Sweep specification: the enumerated model family.

The port's own copy of ``stateright_tpu/sweep/spec.py`` (all 139 lines:
the module imports no JAX, but the port imports nothing of that package).
A :class:`SweepSpec` is an ordered list of :class:`SweepInstance`
entries — each a fully configured object-form model plus the sweep
bookkeeping (a unique ``key``, a JSON-safe ``params`` dict for the
registry, an optional per-instance ``target``, and a fingerprint
``seed`` scrambling the instance's table layout).  The instance's
position in the spec is its global **tag**: it lands in the low bits of
the table sort key (``fingerprint.ns_fingerprint``, on the card ``cand_prep``'s
namespace mode) and keeps instances
apart in the shared visited table, so re-ordering a spec is a different
sweep by construction.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

SWEEP_V = 1
ENV_SWEEP = "STATERIGHT_TPU_SWEEP"


class SweepInstance:
    """One member of a sweep: a configured model + sweep bookkeeping."""

    def __init__(
        self,
        key: str,
        model: Any,
        params: Optional[dict] = None,
        seed: int = 0,
        target: Optional[int] = None,
    ):
        if not key or not isinstance(key, str):
            raise ValueError("SweepInstance needs a non-empty string key")
        self.key = key
        self.model = model
        self.params = dict(params or {})
        self.seed = int(seed)
        self.target = None if target is None else int(target)

    def __repr__(self) -> str:
        return f"SweepInstance({self.key!r})"


class SweepSpec:
    """An ordered family of instances; positions are the instance tags."""

    def __init__(self, instances: Sequence[SweepInstance]):
        self.instances = list(instances)
        if not self.instances:
            raise ValueError("a sweep needs at least one instance")
        keys = [i.key for i in self.instances]
        if len(set(keys)) != len(keys):
            dup = sorted(k for k in set(keys) if keys.count(k) > 1)
            raise ValueError(f"duplicate instance keys: {dup}")

    def __len__(self) -> int:
        return len(self.instances)

    def __iter__(self):
        return iter(self.instances)

    @classmethod
    def family(
        cls,
        factory: Callable[..., Any],
        params_list: Sequence[dict],
        key_fn: Optional[Callable[[dict], str]] = None,
        seeds: Optional[Sequence[int]] = None,
    ) -> "SweepSpec":
        """Build a spec by calling ``factory(**params)`` per entry.

        ``key_fn`` derives the instance key from the params (default:
        ``k=v`` pairs joined by ``,``); ``seeds`` optionally assigns
        per-instance table seeds (default 0 — the instance TAG already
        separates namespaces, and seed 0 keeps discovery-trace parity
        with the sequential oracle; nonzero seeds re-seed the table
        layout for hash-fuzzing sweeps)."""
        insts = []
        for i, params in enumerate(params_list):
            key = (
                key_fn(params)
                if key_fn is not None
                else ",".join(f"{k}={v}" for k, v in sorted(params.items()))
                or f"instance-{i}"
            )
            insts.append(
                SweepInstance(
                    key,
                    factory(**params),
                    params=params,
                    seed=seeds[i] if seeds is not None else 0,
                )
            )
        return cls(insts)


def resolve_sweep_spec(builder_spec, model) -> Optional[SweepSpec]:
    """The effective sweep spec for a spawn: the builder's
    ``sweep(SPEC)`` wins; else the ``STATERIGHT_TPU_SWEEP=N`` env knob
    asks the model for its default family (``model.sweep_family(N)``,
    defined by sweep-capable examples).  Models without the hook print a
    loud ignored-knob one-liner once instead of silently doing nothing
    (the ``--per-channel``-on-a-non-actor-model rule)."""
    import os
    import sys

    if builder_spec is not None:
        return builder_spec
    env = os.environ.get(ENV_SWEEP, "").strip()
    if not env or env == "0":
        return None
    if env.isdigit():
        n = int(env)
    else:
        # a corrupted knob must not silently change the engine: warn
        # and run the plain wavefront (the spill-env malformed rule)
        print(
            f"stateright-tpu-torch: ignoring malformed {ENV_SWEEP}={env!r} "
            "(want the instance count, e.g. 8); running without a "
            "sweep",
            file=sys.stderr,
        )
        return None
    fam = getattr(model, "sweep_family", None)
    if fam is None:
        if not getattr(model, "_sweep_warn_printed", False):
            try:
                object.__setattr__(model, "_sweep_warn_printed", True)
            except Exception:  # noqa: BLE001 - __slots__ models
                pass
            print(
                f"stateright-tpu-torch: {ENV_SWEEP} set but "
                f"{type(model).__name__} defines no sweep_family(); knob "
                "ignored (see sweep/)",
                file=sys.stderr,
            )
        return None
    return fam(n)
