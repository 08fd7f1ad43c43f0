"""The ``check-gpu`` verb of the example models.

The port's counterpart of the ``check-tpu`` verbs of
``stateright_tpu/models/_cli.py``'s users: the same positional arguments
and the ``--per-channel`` flag (``pop_perf``/``apply_encoding`` there), on
``spawn_gpu()``.  The other verbs and flags (``explore``, ``spawn``,
``--perf``, ``--checked``, ``--watch``, ``--por``) come with the modules
they drive.
"""

from __future__ import annotations

import sys
from typing import Callable

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


def check_gpu_main(prog: str, arg_usage: str, argv, build: Callable,
                   banner: Callable, max_args: int) -> int:
    """``python -m stateright_tpu_torch.models.<prog> check-gpu ARGS
    [--per-channel]``: build the model from the positional arguments, and
    check it with ``spawn_gpu()`` when it has a device twin (exit 1 when it
    has none, 2 on a usage error)."""
    usage = (f"usage: python -m stateright_tpu_torch.models.{prog} "
             f"check-gpu {arg_usage} [{PER_CHANNEL_FLAG}]")
    per_channel, args = pop_per_channel(
        list(sys.argv[1:] if argv is None else argv))
    if not args or args[0] != "check-gpu" or len(args) > 1 + max_args:
        print(usage, file=sys.stderr)
        return 2
    rest = args[1:]
    print(banner(rest))
    model = apply_encoding(build(rest), per_channel)
    if model._tensor_cached() is None:
        print("this configuration has no device twin in the port",
              file=sys.stderr)
        return 1
    model.checker().spawn_gpu().report()
    return 0
