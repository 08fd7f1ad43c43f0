"""The ``check-gpu`` verb of the compiled example models.

The port's counterpart of the ``check-tpu`` verbs of
``stateright_tpu/models/_cli.py``'s users: the same positional arguments,
on ``spawn_gpu()``.  The other verbs and flags (``explore``, ``spawn``,
``--perf``, ``--checked``, ``--watch``) come with the modules they drive.
"""

from __future__ import annotations

import sys
from typing import Callable


def check_gpu_main(prog: str, arg_usage: str, argv, build: Callable,
                   banner: Callable, max_args: int) -> int:
    """``python -m stateright_tpu_torch.models.<prog> check-gpu ARGS``:
    build the model from the positional arguments, and check it with
    ``spawn_gpu()`` when it has a device twin (exit 1 when it has none,
    2 on a usage error)."""
    usage = (f"usage: python -m stateright_tpu_torch.models.{prog} "
             f"check-gpu {arg_usage}")
    args = list(sys.argv[1:] if argv is None else argv)
    if not args or args[0] != "check-gpu" or len(args) > 1 + max_args:
        print(usage, file=sys.stderr)
        return 2
    rest = args[1:]
    print(banner(rest))
    model = build(rest)
    if model._tensor_cached() is None:
        print("this configuration has no device twin in the port",
              file=sys.stderr)
        return 1
    model.checker().spawn_gpu().report()
    return 0
