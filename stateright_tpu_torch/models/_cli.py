"""The ``check`` verbs of the example models.

The port's counterpart of the ``check``, ``check-tpu`` and ``check-auto``
verbs of ``stateright_tpu/models/_cli.py``'s users: the same positional
arguments, the ``--per-channel`` flag (``pop_perf``/``apply_encoding``
there) and, on the GPU verbs, ``--prededup`` and ``--mxu``
(``pop_perf``/``apply_perf`` there; :func:`pop_step_flags`,
:func:`with_step_flags`; ``--mxu`` has no effect in the port).
:func:`check_main` is the one dispatcher: each model gives it a table
from the verbs it offers to their banners and to one of the spawns here:
:func:`host_bfs` and :func:`host_dfs` (on ``default_threads()``
threads), :func:`host_sym_dfs` (the host DFS with symmetry),
:func:`auto` (``spawn_auto()``: a bounded host probe, then the GPU
engine), :func:`gpu` (``spawn_gpu()``) and :func:`sym_gpu`
(``.symmetry().spawn_gpu()``).  A model with no tensor form leaves the GPU
verbs out.  The other verbs and flags (``explore``, ``spawn``,
``--perf``, ``--checked``, ``--watch``, ``--por``, ``--spill``,
``--prewarm``) come with the modules they drive.
"""

from __future__ import annotations

import os
import sys
from typing import Callable

PER_CHANNEL_FLAG = "--per-channel"
# the GPU engine's step-transform flags: builder method per flag (``mxu``
# is accepted for parity with the JAX CLI and has no effect in the port)
STEP_FLAGS = {"--prededup": "prededup", "--mxu": "mxu"}


def pop_per_channel(args: list) -> tuple:
    """``(per_channel, args without the flag)``: the flag may stand
    anywhere after the verb."""
    kept = [a for a in args if a != PER_CHANNEL_FLAG]
    return len(kept) != len(args), kept


def pop_step_flags(args: list) -> tuple:
    """``(flags, args without them)``: the :data:`STEP_FLAGS` given, which
    may stand anywhere after the verb."""
    flags = [a for a in args if a in STEP_FLAGS]
    return flags, [a for a in args if a not in STEP_FLAGS]


def apply_encoding(model, per_channel: bool):
    """Apply ``--per-channel`` to the model (``ActorModel.per_channel_()``)
    before its twin resolves: the encoding is the fingerprint scheme.  A
    model without the builder method (2pc's hand-written twin) gets a loud
    one-line notice instead of a silent no-op, so an ignored flag never
    passes for "per-channel buys nothing"."""
    if per_channel:
        if hasattr(model, "per_channel_"):
            model.per_channel_()
        else:
            print(
                "stateright-tpu-torch: --per-channel ignored: "
                f"{type(model).__name__} is not an actor model (the "
                "encoding applies to compiled actor twins)",
                file=sys.stderr,
            )
    return model


def default_threads() -> int:
    return os.cpu_count() or 1


def host_bfs(model):
    return model.checker().threads(default_threads()).spawn_bfs()


def host_dfs(model):
    return model.checker().threads(default_threads()).spawn_dfs()


def host_sym_dfs(model):
    return model.checker().threads(default_threads()).symmetry().spawn_dfs()


def auto(model):
    return model.checker().threads(default_threads()).spawn_auto()


def gpu(model, flags=()):
    """``spawn_gpu()`` with the step ``flags`` (:data:`STEP_FLAGS`) on, or
    None when the model has no device twin."""
    if model._tensor_cached() is None:
        return None
    return with_step_flags(model.checker(), flags).spawn_gpu()


def sym_gpu(model, flags=()):
    if model._tensor_cached() is None:
        return None
    return with_step_flags(model.checker().symmetry(), flags).spawn_gpu()


def with_step_flags(builder, flags):
    """``builder`` with each of the :data:`STEP_FLAGS` in ``flags`` on."""
    for f in flags:
        builder = getattr(builder, STEP_FLAGS[f])()
    return builder


def check_main(prog: str, arg_usage: str, argv, build: Callable,
               verbs: dict[str, tuple[Callable, Callable]],
               max_args: int) -> int:
    """``python -m stateright_tpu_torch.models.<prog> VERB ARGS
    [--per-channel] [--prededup] [--mxu]``: build the model from the
    positional arguments, print the verb's banner and check it.  ``verbs``
    maps each verb the model offers to ``(banner, spawn)``:
    ``banner(args)`` is the line printed first, ``spawn(model)`` one of
    this module's spawns.  The step flags are for the GPU verbs
    (:func:`gpu`, :func:`sym_gpu`).  Exit 1 when a GPU verb finds no
    device twin, 2 on a usage error."""
    usage = (f"usage: python -m stateright_tpu_torch.models.{prog} "
             f"{'|'.join(verbs)} {arg_usage} [{PER_CHANNEL_FLAG}] "
             f"[{'] ['.join(STEP_FLAGS)}]")
    per_channel, args = pop_per_channel(
        list(sys.argv[1:] if argv is None else argv))
    flags, args = pop_step_flags(args)
    if not args or args[0] not in verbs or len(args) > 1 + max_args:
        print(usage, file=sys.stderr)
        return 2
    (banner, spawn), rest = verbs[args[0]], args[1:]
    if flags and spawn not in (gpu, sym_gpu):
        print(f"{' '.join(flags)}: only the GPU verbs take the step flags",
              file=sys.stderr)
        return 2
    print(banner(rest))
    model = apply_encoding(build(rest), per_channel)
    checker = spawn(model, flags) if flags else spawn(model)
    if checker is None:
        print("this configuration has no device twin in the port",
              file=sys.stderr)
        return 1
    checker.report()
    return 0
