"""The visited-set insert's write half: kernel A and its plain version.

The port's counterpart of ``stateright_tpu/ops/pallas_insert.py``
(``pallas_scatter_insert`` and its Pallas kernel ``_insert_kernel``).
Contract, unchanged: write the first ``n_new`` pairs ``(cfp[i], cpl[i])``
to the distinct table slots ``tgt[i]``, in place; ``n_new`` is a 0-d
device tensor, so neither version asks the host for the count.

On a CUDA tensor :func:`insert_write` launches ``csrc/insert_write.cu``
(one thread per lane; the TPU kernel's sort-by-slot and DMA ring have no
job on the GPU, see the note in the source).  On a CPU tensor it runs
:func:`insert_write_plain`.  In the engine this is the insert's only write
path: there is no switch and no alternative.
"""

from __future__ import annotations

import torch

from . import _cuda


def insert_write_plain(tfp, tpl, tgt, cfp, cpl, n_new):
    """``tfp[tgt[:n]] = cfp[:n]`` and ``tpl[tgt[:n]] = cpl[:n]`` with
    ``n = n_new``, by a lane mask (no ``.item()``).  Returns the tables."""
    live = torch.arange(tgt.shape[0], device=tgt.device) < n_new
    t = tgt[live]
    tfp[t] = cfp[live]
    tpl[t] = cpl[live]
    return tfp, tpl


def insert_write(tfp, tpl, tgt, cfp, cpl, n_new):
    """Write the ``n_new`` novel candidates into the tables, in place;
    returns ``(tfp, tpl)``.  ``tfp``/``tpl``: int64[nslots]; ``tgt``,
    ``cfp``, ``cpl``: int64[M]; ``n_new``: 0-d int64 on the same device."""
    if tfp.device.type != "cuda":
        return insert_write_plain(tfp, tpl, tgt, cfp, cpl, n_new)
    dev = tfp.device
    nslots, m = tfp.shape[0], tgt.shape[0]
    for t, name, n in ((tfp, "tfp", nslots), (tpl, "tpl", nslots),
                       (tgt, "tgt", m), (cfp, "cfp", m), (cpl, "cpl", m)):
        _cuda.require(t, name, torch.int64, 1, dev)
        if t.shape[0] != n:
            raise ValueError(f"{name}: length {t.shape[0]}, expected {n}")
    _cuda.require(n_new, "n_new", torch.int64, 0, dev)
    if m:
        _cuda.check("insert_write", _cuda.library().srt_insert_write(
            tfp.data_ptr(), tpl.data_ptr(), tgt.data_ptr(), cfp.data_ptr(),
            cpl.data_ptr(), n_new.data_ptr(), m, _cuda.stream_of(tfp),
        ))
        insert_write.launches += 1
    return tfp, tpl


insert_write.launches = 0
