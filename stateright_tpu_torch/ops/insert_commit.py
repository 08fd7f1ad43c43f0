"""The visited-set insert's commit: the table write and the queue append.

The port's counterpart of ``stateright_tpu/ops/pallas_insert.py``
(``pallas_scatter_insert`` and its Pallas kernel ``_insert_kernel``)
together with the engine's queue append
(``stateright_tpu/parallel/wavefront.py::append_novel``).  Contract: write
the first ``n_new`` pairs ``(cfp[j], cpl[j])`` to the distinct table slots
``tgt[j]``, in place, and, given a :class:`QueueAppend`, append the same
``n_new`` candidates at the queue tail; ``n_new`` and the tail are 0-d
device tensors, so neither version asks the host for the count.

On a CUDA tensor :func:`insert_commit` launches ``csrc/insert_commit.cu``
(one thread per lane, both halves in one launch; see the note in the
source).  On a CPU tensor it runs :func:`insert_commit_plain`, which is
:func:`insert_write_plain` followed by the append.  In the engine this is
the insert's only write path: there is no switch and no alternative.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import _cuda


class QueueAppend(NamedTuple):
    """The queue half of a commit: candidate ``sel[j]`` (an index into
    ``src_rows``) goes to queue row ``tail + j``, with its parent's lanes
    read at ``sel[j] // arity``."""

    rows: torch.Tensor  # int64[Q, W] queue rows, updated in place
    fps: torch.Tensor  # int64[Q]
    ebits: torch.Tensor  # int32[Q]
    depths: torch.Tensor  # int32[Q]
    tail: torch.Tensor  # 0-d int64: the first row to write
    sel: torch.Tensor  # int64[M]: original candidate index per novel lane
    src_rows: torch.Tensor  # int64[B * arity, W] candidate rows
    parent_ebits: torch.Tensor  # int32[B]
    parent_depths: torch.Tensor  # int32[B]
    arity: int


def insert_write_plain(tfp, tpl, tgt, cfp, cpl, n_new):
    """``tfp[tgt[:n]] = cfp[:n]`` and ``tpl[tgt[:n]] = cpl[:n]`` with
    ``n = n_new``, by a lane mask (no ``.item()``).  Returns the tables."""
    live = torch.arange(tgt.shape[0], device=tgt.device) < n_new
    t = tgt[live]
    tfp[t] = cfp[live]
    tpl[t] = cpl[live]
    return tfp, tpl


def insert_commit_plain(tfp, tpl, tgt, cfp, cpl, n_new,
                        queue: Optional[QueueAppend] = None):
    """:func:`insert_write_plain`, then the queue append of the same
    ``n_new`` lanes.  Returns the tables."""
    insert_write_plain(tfp, tpl, tgt, cfp, cpl, n_new)
    if queue is not None:
        lanes = torch.arange(tgt.shape[0], device=tgt.device)
        live = lanes < n_new
        s = queue.sel[live]
        p = s // queue.arity
        dst = queue.tail + lanes[live]
        queue.rows[dst] = queue.src_rows[s]
        queue.fps[dst] = cfp[live]
        queue.ebits[dst] = queue.parent_ebits[p]
        queue.depths[dst] = queue.parent_depths[p] + 1
    return tfp, tpl


def _check(tfp, tpl, tgt, cfp, cpl, n_new, queue) -> None:
    dev = tfp.device
    nslots, m = tfp.shape[0], tgt.shape[0]
    i64, i32 = torch.int64, torch.int32
    _cuda.require(tfp, "tfp", i64, 1, dev)
    _cuda.require(tpl, "tpl", i64, 1, dev, nslots)
    for t, name in ((tgt, "tgt"), (cfp, "cfp"), (cpl, "cpl")):
        _cuda.require(t, name, i64, 1, dev, m)
    _cuda.require(n_new, "n_new", i64, 0, dev)
    if queue is None:
        return
    _cuda.require(queue.fps, "fps", i64, 1, dev)
    q = queue.fps.shape[0]
    _cuda.require(queue.rows, "rows", i64, 2, dev, q)
    width = queue.rows.shape[1]
    _cuda.require(queue.ebits, "ebits", i32, 1, dev, q)
    _cuda.require(queue.depths, "depths", i32, 1, dev, q)
    _cuda.require(queue.tail, "tail", i64, 0, dev)
    _cuda.require(queue.sel, "sel", i64, 1, dev, m)
    _cuda.require(queue.src_rows, "src_rows", i64, 2, dev)
    b = queue.parent_ebits.shape[0]
    _cuda.require(queue.parent_ebits, "parent_ebits", i32, 1, dev)
    _cuda.require(queue.parent_depths, "parent_depths", i32, 1, dev, b)
    if queue.src_rows.shape != (b * queue.arity, width):
        raise ValueError(f"src_rows: shape {tuple(queue.src_rows.shape)}, "
                         f"expected ({b * queue.arity}, {width})")


def insert_commit(tfp, tpl, tgt, cfp, cpl, n_new,
                  queue: Optional[QueueAppend] = None, *, check: bool = True,
                  stream: Optional[int] = None):
    """Write the ``n_new`` novel candidates into the tables, in place, and
    append them to the queue when ``queue`` is given; returns
    ``(tfp, tpl)``.  ``tfp``/``tpl``: int64[nslots]; ``tgt``, ``cfp``,
    ``cpl``: int64[M]; ``n_new``: 0-d int64 on the same device.

    ``check=False`` skips the argument checks: only for a caller whose
    buffers are its own and were validated when it allocated them (the
    engine).  ``stream``: the raw CUDA stream (default: the current one)."""
    if tfp.device.type != "cuda":
        return insert_commit_plain(tfp, tpl, tgt, cfp, cpl, n_new, queue)
    if check:
        _check(tfp, tpl, tgt, cfp, cpl, n_new, queue)
    m = tgt.shape[0]
    if m:
        if stream is None:
            stream = _cuda.stream_of(tfp)
        if queue is None:
            qargs = (None,) * 9 + (0, 1)
        else:
            qargs = (
                queue.rows.data_ptr(), queue.fps.data_ptr(),
                queue.ebits.data_ptr(), queue.depths.data_ptr(),
                queue.tail.data_ptr(), queue.sel.data_ptr(),
                queue.src_rows.data_ptr(), queue.parent_ebits.data_ptr(),
                queue.parent_depths.data_ptr(), queue.rows.shape[1],
                queue.arity,
            )
        _cuda.check("insert_commit", _cuda.library().srt_insert_commit(
            tfp.data_ptr(), tpl.data_ptr(), tgt.data_ptr(), cfp.data_ptr(),
            cpl.data_ptr(), n_new.data_ptr(), m, *qargs, stream,
        ))
        insert_commit.launches += 1
    return tfp, tpl


insert_commit.launches = 0
