"""Vectorized state fingerprinting on the device.

The port's counterpart of ``stateright_tpu/ops/hashing.py``: exactly
:func:`stateright_tpu_torch.fingerprint.hash_words` over fixed-width rows,
so device fingerprints match host fingerprints bit for bit.

**64-bit words as int64 bit patterns.**  PyTorch has no ``>>``, ``+`` or
``searchsorted`` on ``uint64``, so rows, fingerprints and table words are
carried as ``int64`` holding the same 64 bits: add and multiply wrap the
same mod 2^64, a logical right shift is ``(x >> k) & ((1 << (64-k)) - 1)``
(:func:`lshr`), unsigned order is the signed order of ``x ^ (1 << 63)``,
and ``EMPTY`` (2^64 - 1) is ``-1``.  :func:`mix64_np` is the numpy host
mirror over real ``uint64``.

On a CUDA tensor :func:`row_hash` launches kernel B (``csrc/row_hash.cu``);
on a CPU tensor it runs :func:`row_hash_plain`, the same arithmetic in
PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fingerprint import (
    _SM_GAMMA, _SM_M1, _SM_M1_INV, _SM_M2, _SM_M2_INV, FINGERPRINT_SEED,
)
from . import _cuda


def to_i64(x: int) -> int:
    """The int64 whose bits are the unsigned 64-bit ``x``."""
    x &= (1 << 64) - 1
    return x - (1 << 64) if x >= 1 << 63 else x


GAMMA = to_i64(_SM_GAMMA)
M1 = to_i64(_SM_M1)
M2 = to_i64(_SM_M2)
SEED = to_i64(FINGERPRINT_SEED)
# unmix64's multipliers: the inverses of M1 and M2 mod 2^64, wrapped
M1_INV = to_i64(_SM_M1_INV)
M2_INV = to_i64(_SM_M2_INV)
SIGN = -(1 << 63)  # the top bit: ``x ^ SIGN`` sorts int64 in unsigned order

# Empty-slot sentinel of the device hash tables: 2^64 - 1 as int64.
EMPTY = -1
EMPTY_U64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def lshr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns by ``0 <= k <= 64``."""
    if k == 0:
        return x
    if k >= 64:
        return torch.zeros_like(x)
    return (x >> k) & ((1 << (64 - k)) - 1)


def mix64(h: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer, elementwise over int64 bit patterns."""
    h = h ^ lshr(h, 30)
    h = h * M1
    h = h ^ lshr(h, 27)
    h = h * M2
    h = h ^ lshr(h, 31)
    return h


def unmix64(h: torch.Tensor) -> torch.Tensor:
    """Elementwise inverse of :func:`mix64` over int64 bit patterns (JAX
    ``ops/hashing.py:75``; host mirror ``fingerprint.unmix64``)."""
    h = h ^ lshr(h, 31) ^ lshr(h, 62)
    h = h * M2_INV
    h = h ^ lshr(h, 27) ^ lshr(h, 54)
    h = h * M1_INV
    h = h ^ lshr(h, 30) ^ lshr(h, 60)
    return h


def ns_hash_plain(fps: torch.Tensor, ns_low: torch.Tensor,
                  ns_xor: torch.Tensor, bits: int) -> torch.Tensor:
    """Namespace fingerprints for a sweep (JAX ``ops/hashing.py:86``,
    ``ns_hash``): the LOW ``bits`` bits of the sort key ``mix64(fp)``
    become the lane's instance tag ``ns_low``, the high bits are XORed with
    its table-seed scramble ``ns_xor`` (0 for an unseeded instance), and
    the mixer is inverted; 0 and EMPTY remap to GAMMA, as in
    :func:`row_hash_plain`.  Per lane; the tensors broadcast.  Host mirror:
    ``fingerprint.ns_fingerprint``.  ``cand_prep``'s namespace mode is this
    function fused into the kernel."""
    low = (1 << bits) - 1
    key = ((mix64(fps) ^ ns_xor) & ~low) | (ns_low & low)
    h = unmix64(key)
    return torch.where((h == 0) | (h == EMPTY), GAMMA, h)


def mix64_np(h) -> np.ndarray:
    """Host-side :func:`mix64` over numpy ``uint64``: must match the device
    remix bit for bit — ``host_bucket_rehash`` derives the same bucket for
    the same fingerprint that the device insert did."""
    h = np.asarray(h, np.uint64)
    with np.errstate(over="ignore"):  # u64 wrap is the point of the mix
        h = h ^ (h >> np.uint64(30))
        h = h * np.uint64(_SM_M1)
        h = h ^ (h >> np.uint64(27))
        h = h * np.uint64(_SM_M2)
        h = h ^ (h >> np.uint64(31))
    return h


def fold64(h: torch.Tensor, w) -> torch.Tensor:
    """Fold one word into the running digest (= host ``fingerprint.fold64``)."""
    return mix64((h ^ w) + GAMMA)


# the widest row kernel B stages: one row at an odd stride of W | 1 words
# in its 48 KiB tile (less its 64 valid bytes)
ROW_HASH_MAX_WIDTH = (48 * 1024 - 64) // 8 - 1


def row_hash_plain(rows: torch.Tensor, valid=None) -> torch.Tensor:
    """Plain PyTorch fingerprint of each row: ``int64[..., W] -> int64[...]``
    (EMPTY where ``valid`` is False)."""
    width = rows.shape[-1]
    h = torch.full(rows.shape[:-1], SEED, dtype=torch.int64, device=rows.device)
    for i in range(width):
        h = fold64(h, rows[..., i])
    h = fold64(h, width)
    h = torch.where((h == 0) | (h == EMPTY), GAMMA, h)
    if valid is not None:
        h = torch.where(valid, h, EMPTY)
    return h


def row_hash(rows: torch.Tensor, valid=None) -> torch.Tensor:
    """Fingerprint each row: ``int64[..., W] -> int64[...]``, identical to
    ``hash_words(row)`` on the host; lanes where ``valid`` (bool, the rows'
    leading shape) is False get EMPTY.  CUDA tensors launch kernel B."""
    if rows.device.type != "cuda":
        return row_hash_plain(rows, valid)
    lead = rows.shape[:-1]
    width = rows.shape[-1]
    if width > ROW_HASH_MAX_WIDTH:
        raise ValueError(f"row_hash: rows of {width} words; the kernel "
                         f"stages at most {ROW_HASH_MAX_WIDTH} in shared memory")
    flat = rows.reshape(-1, width)
    n = flat.shape[0]
    _cuda.require(flat, "rows", torch.int64, 2, rows.device)
    vflat = None
    if valid is not None:
        if valid.shape != lead:
            raise ValueError(f"valid: shape {tuple(valid.shape)}, "
                             f"expected {tuple(lead)}")
        vflat = valid.reshape(n)
        _cuda.require(vflat, "valid", torch.bool, 1, rows.device)
    out = torch.empty(n, dtype=torch.int64, device=rows.device)
    if n:
        _cuda.check("row_hash", _cuda.library().srt_row_hash(
            flat.data_ptr(), None if vflat is None else vflat.data_ptr(),
            out.data_ptr(), n, width, _cuda.stream_of(rows),
        ))
        _cuda.count_launch(row_hash)
    return out.reshape(lead)


row_hash.launches = 0
