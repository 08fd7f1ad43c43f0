"""The ``check-gpu`` verbs of the example models.

The port's counterpart of the ``check-tpu`` verbs of
``stateright_tpu/models/_cli.py``'s users: the same positional arguments
and the ``--per-channel`` flag (``pop_perf``/``apply_encoding`` there), on
``spawn_gpu()``; and, for the models with symmetry (2pc, raft),
``check-sym-gpu`` (``.symmetry().spawn_gpu()``) and ``check-sym`` (the
host DFS with symmetry, on ``default_threads()`` threads).  The other
verbs and flags (``explore``, ``spawn``, ``--perf``, ``--checked``,
``--watch``, ``--por``) come with the modules they drive.
"""

from __future__ import annotations

import os
import sys
from typing import Callable, Optional

PER_CHANNEL_FLAG = "--per-channel"


def pop_per_channel(args: list) -> tuple:
    """``(per_channel, args without the flag)``: the flag may stand
    anywhere after the verb."""
    kept = [a for a in args if a != PER_CHANNEL_FLAG]
    return len(kept) != len(args), kept


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


def check_gpu_main(prog: str, arg_usage: str, argv, build: Callable,
                   banner: Callable, max_args: int,
                   sym_banners: Optional[dict] = None) -> int:
    """``python -m stateright_tpu_torch.models.<prog> VERB ARGS
    [--per-channel]``: build the model from the positional arguments and
    check it.  ``check-gpu`` runs ``spawn_gpu()`` when the model has a
    device twin (exit 1 when it has none); ``sym_banners`` maps the
    symmetry verbs the model offers (``check-sym``: the host DFS,
    ``check-sym-gpu``: the GPU engine) to their banners.  Exit 2 on a
    usage error."""
    sym_banners = sym_banners or {}
    verbs = ["check-gpu", *sym_banners]
    usage = (f"usage: python -m stateright_tpu_torch.models.{prog} "
             f"{'|'.join(verbs)} {arg_usage} [{PER_CHANNEL_FLAG}]")
    per_channel, args = pop_per_channel(
        list(sys.argv[1:] if argv is None else argv))
    if not args or args[0] not in verbs or len(args) > 1 + max_args:
        print(usage, file=sys.stderr)
        return 2
    verb, rest = args[0], args[1:]
    print((sym_banners.get(verb) or banner)(rest))
    model = apply_encoding(build(rest), per_channel)
    builder = model.checker()
    if verb != "check-gpu":
        builder = builder.symmetry()
    if verb == "check-sym":
        builder.threads(default_threads()).spawn_dfs().report()
        return 0
    if model._tensor_cached() is None:
        print("this configuration has no device twin in the port",
              file=sys.stderr)
        return 1
    builder.spawn_gpu().report()
    return 0
