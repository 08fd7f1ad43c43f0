"""Host/disk tiers of the spilled visited set.

The port's own copy of ``stateright_tpu/spill/store.py:36-389``, numpy
only.  Its disk flush fires the fault layer's ``spill_flush`` seam
(``testing/faults.py``; JAX ``store.py:286``) before it writes, so a
chaos plan can fail it (an ENOSPC there degrades the store to host RAM
instead of crashing the run).  :class:`SpillStore` is an append-only ``(fingerprint, parent)`` store:
entries arrive in eviction batches (already unique — they come out of
the hot table), live first in host-RAM numpy segments, and flush to an
mmap'd disk segment file when the RAM tier passes its byte budget
(``STATERIGHT_TPU_HOST_BYTES``; no budget = never flush).  A
:class:`HostIndex` — open-addressing, linear-probing, ``mix64``-keyed,
fully vectorized numpy — maps every spilled fingerprint to its global
append offset, so membership (the per-sync pending resolution) is a few
gathers per probe round, never a Python loop over candidates.

The store is exact where the device Bloom filter is probabilistic: the
engine defers Bloom-positive candidates here, and ``contains`` is the
final word.  Parent payloads stay with the data segments (RAM or mmap)
— trace reconstruction merges them with the hot table's
(``GpuChecker._parents``).
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

import numpy as np

from ..ops.hashing import EMPTY_U64 as EMPTY, mix64_np
from ..testing import faults

ENV_HOST_BYTES = "STATERIGHT_TPU_HOST_BYTES"

# one spilled entry: fingerprint + parent fingerprint, u64 each
BYTES_PER_ENTRY = 16


def default_host_budget() -> Optional[int]:
    """Host-tier byte budget: the ``STATERIGHT_TPU_HOST_BYTES``
    override, else half the machine's physical RAM (sysconf), else
    None.  Shared by the ``capacity --spill`` planner AND the runtime
    store's flush threshold, so the run flushes to disk where the plan
    said it would.  A malformed override warns loudly — a silently
    ignored budget would flush (or fill host RAM) orders of magnitude
    away from what the operator configured."""
    env = os.environ.get(ENV_HOST_BYTES, "").strip()
    if env:
        try:
            return int(env)
        except ValueError:
            import sys

            print(
                f"stateright-tpu-torch: spill: ignoring malformed "
                f"{ENV_HOST_BYTES}={env!r} (want plain bytes, e.g. "
                "17179869184); using half of physical RAM",
                file=sys.stderr,
            )
    try:
        pages = os.sysconf("SC_PHYS_PAGES")
        page = os.sysconf("SC_PAGE_SIZE")
        if pages > 0 and page > 0:
            return int(pages * page) // 2
    except (ValueError, OSError, AttributeError):
        pass
    return None


class HostIndex:
    """Open-addressing hash index: ``uint64 fp -> uint64 value``.

    Linear probing over power-of-two numpy arrays, home slot from
    ``mix64(fp)`` (the avalanched remix the device bucket derivation
    uses), grown at 50% load.  Insert and lookup are batch-vectorized:
    each probe round is one gather + compares over the still-unresolved
    lanes, and at <=50% load the expected round count is ~2.  ``EMPTY``
    is the free-slot sentinel and therefore not an insertable key (the
    engines already exclude it — it is the invalid-lane sentinel)."""

    def __init__(self, capacity: int = 1 << 12):
        cap = 1
        while cap < max(capacity, 16):
            cap <<= 1
        self._keys = np.full(cap, EMPTY, np.uint64)
        self._vals = np.zeros(cap, np.uint64)
        self._count = 0

    def __len__(self) -> int:
        return self._count

    @property
    def capacity(self) -> int:
        return int(self._keys.size)

    @property
    def nbytes(self) -> int:
        return int(self._keys.nbytes + self._vals.nbytes)

    def _home(self, fps: np.ndarray) -> np.ndarray:
        mask = np.uint64(self._keys.size - 1)
        return (mix64_np(fps) & mask).astype(np.int64)

    def _grow_to(self, capacity: int) -> None:
        occ = self._keys != EMPTY
        old_k, old_v = self._keys[occ], self._vals[occ]
        cap = self._keys.size
        while cap < capacity:
            cap <<= 1
        self._keys = np.full(cap, EMPTY, np.uint64)
        self._vals = np.zeros(cap, np.uint64)
        self._count = 0
        if old_k.size:
            self.insert(old_k, old_v)

    def insert(self, fps, vals) -> None:
        """Insert ``fps -> vals`` (first writer wins on duplicates, both
        intra-batch and vs existing entries)."""
        fps = np.asarray(fps, np.uint64).reshape(-1)
        vals = np.asarray(vals, np.uint64).reshape(-1)
        if fps.size == 0:
            return
        # intra-batch dedup (keep first occurrence): the probe loop's
        # claim protocol assumes distinct keys race for distinct slots
        ufps, first = np.unique(fps, return_index=True)
        if ufps.size != fps.size:
            first.sort()
            fps, vals = fps[first], vals[first]
        if (self._count + fps.size) * 2 > self._keys.size:
            self._grow_to((self._count + fps.size) * 4)
        h = self._home(fps)
        r = np.zeros(fps.size, np.int64)
        mask = np.int64(self._keys.size - 1)
        unresolved = np.ones(fps.size, bool)
        while unresolved.any():
            idx = (h + r) & mask
            cur = self._keys[idx]
            live = unresolved
            is_empty = live & (cur == EMPTY)
            is_match = live & (cur == fps)
            unresolved = unresolved & ~is_match  # already present: done
            if is_empty.any():
                ci = np.nonzero(is_empty)[0]
                cidx = idx[ci]
                order = np.argsort(cidx, kind="stable")
                ci, cidx = ci[order], cidx[order]
                keep = np.concatenate([[True], cidx[1:] != cidx[:-1]])
                win = ci[keep]
                self._keys[idx[win]] = fps[win]
                self._vals[idx[win]] = vals[win]
                self._count += win.size
                unresolved[win] = False
                # claim losers re-probe the same slot next round (it now
                # holds a different key, so they advance then)
            adv = unresolved & ~is_empty & ~is_match
            r[adv] += 1

    def contains(self, fps) -> np.ndarray:
        """``bool[n]`` membership per fingerprint."""
        return self.lookup(fps)[1]

    def lookup(self, fps) -> tuple:
        """``(vals, found)``: the stored value per fingerprint (0 where
        absent) and the membership mask."""
        fps = np.asarray(fps, np.uint64).reshape(-1)
        vals = np.zeros(fps.size, np.uint64)
        found = np.zeros(fps.size, bool)
        if fps.size == 0 or self._count == 0:
            return vals, found
        h = self._home(fps)
        r = np.zeros(fps.size, np.int64)
        mask = np.int64(self._keys.size - 1)
        unresolved = np.ones(fps.size, bool)
        # at <=50% load every probe chain ends at an EMPTY slot; the cap
        # is a belt against a corrupted index turning into a spin
        for _ in range(self._keys.size):
            if not unresolved.any():
                break
            idx = (h + r) & mask
            cur = self._keys[idx]
            hit = unresolved & (cur == fps)
            vals[hit] = self._vals[idx[hit]]
            found |= hit
            miss = unresolved & (cur == EMPTY)
            unresolved = unresolved & ~hit & ~miss
            r[unresolved] += 1
        return vals, found


class SpillStore:
    """Append-only tiered ``(fp, parent)`` store + RAM hash index.

    ``host_budget`` bounds the RAM tier's DATA bytes: exceeding it
    flushes every RAM segment into one new mmap'd disk segment under
    ``directory`` (created lazily; a temp dir by default).  The default
    budget is :func:`default_host_budget` — the same
    ``STATERIGHT_TPU_HOST_BYTES``-or-half-physical-RAM figure
    ``capacity --spill`` plans with, so the runtime actually flushes
    where the plan said the disk tier takes over.  The index
    (fp -> global offset) always stays in RAM — it is the membership
    oracle the per-sync pending resolution hits."""

    def __init__(
        self,
        directory: Optional[str] = None,
        host_budget: Optional[int] = None,
    ):
        if host_budget is None:
            host_budget = default_host_budget()
        self.host_budget = host_budget
        self._dir = directory
        self._own_dir = directory is None  # we created it: clean it up
        self._ram: list = []  # [(fps, parents)] newest last
        self._disk: list = []  # np.memmap[(n, 2) u64] segments
        self._disk_paths: list = []
        self._index = HostIndex()
        self._total = 0
        self._ram_bytes = 0
        self._disk_bytes = 0
        self._closed = False
        # disk-tier degradation (docs/robustness.md): a failed segment
        # flush (ENOSPC, dead disk) warns once and pins the tier in host
        # RAM — the run keeps its exactness guarantees, it just stops
        # paging to disk.  Surfaces as ``degraded`` in the spill block
        # and a ``spill_degraded`` health transition.
        self.degraded = False
        self.degraded_reason: Optional[str] = None

    # -- writing -------------------------------------------------------------

    def append(self, fps, parents) -> int:
        """Append one eviction batch; returns how many entries were NEW
        to the store (re-evictions of already-spilled fps are dropped —
        cannot happen from the engine, but the store defends itself)."""
        fps = np.asarray(fps, np.uint64).reshape(-1)
        parents = np.asarray(parents, np.uint64).reshape(-1)
        if fps.size == 0:
            return 0
        fresh = ~self._index.contains(fps)
        fps, parents = fps[fresh], parents[fresh]
        if fps.size == 0:
            return 0
        offs = np.arange(self._total, self._total + fps.size, dtype=np.uint64)
        self._index.insert(fps, offs)
        self._ram.append((fps.copy(), parents.copy()))
        self._total += int(fps.size)
        self._ram_bytes += int(fps.size) * BYTES_PER_ENTRY
        if self.host_budget is not None and self._ram_bytes > self.host_budget:
            self._flush_to_disk()
        return int(fps.size)

    def close(self, delete: Optional[bool] = None) -> None:
        """Release the disk tier's mmap handles and (``delete=True``, the
        default for self-created temp dirs) remove the segment files —
        a checking campaign must not accumulate ~16GB temp dirs and open
        fds per spilled run.  The store is unusable afterwards; callers
        snapshot via :meth:`to_arrays` first if the contents matter."""
        if self._closed:
            return
        self._closed = True
        if delete is None:
            delete = self._own_dir
        for mm in self._disk:
            try:
                mm._mmap.close()  # numpy keeps the handle otherwise
            except (AttributeError, OSError, ValueError):
                pass
        self._disk = []
        if delete:
            for path in self._disk_paths:
                try:
                    os.unlink(path)
                except OSError:
                    pass
            if self._own_dir and self._dir is not None:
                try:
                    os.rmdir(self._dir)
                except OSError:
                    pass
        self._disk_paths = []

    def _flush_to_disk(self) -> None:
        n = sum(f.size for f, _ in self._ram)
        if n == 0 or self.degraded:
            return
        try:
            faults.fire("spill_flush", entries=n)
            if self._dir is None:
                self._dir = tempfile.mkdtemp(prefix="stateright-tpu-torch-spill-")
                # self-created temp dirs are reclaimed at process exit even
                # when no caller ever invokes close() — the segments are
                # process-local scratch (snapshots carry portable arrays)
                import atexit

                atexit.register(self.close)
            os.makedirs(self._dir, exist_ok=True)
            path = os.path.join(
                self._dir, f"spill-{len(self._disk):04d}.bin"
            )
            # atomic segment write (telemetry/_atomic.py — the package's
            # ONE crash-write discipline, streamed so the payload is
            # never doubled in RAM): a crash mid-flush leaves no
            # half-segment at the final path, and an ENOSPC lands HERE
            # (where it degrades) instead of as a SIGBUS on a later mmap
            # page-in of a sparse file
            from ..telemetry._atomic import atomic_write_stream

            atomic_write_stream(
                path,
                (
                    np.ascontiguousarray(
                        np.stack([f, p], axis=1)
                    ).tobytes()
                    for f, p in self._ram
                ),
            )
            mm = np.memmap(path, dtype=np.uint64, mode="r", shape=(n, 2))
        except OSError as e:
            # disk full / dead disk: warn ONCE, pin the tier in host RAM
            # and keep running — losing the disk tier costs capacity
            # headroom, never correctness (the index + RAM segments are
            # intact), and crashing the run here would lose everything
            self.degraded = True
            self.degraded_reason = f"{type(e).__name__}: {e}"
            import sys

            print(
                "stateright-tpu-torch: spill: disk-segment flush failed "
                f"({self.degraded_reason}); the spill tier stays in "
                "host RAM (degraded — no further disk flushes this run)",
                file=sys.stderr,
            )
            return
        self._disk.append(mm)
        self._disk_paths.append(path)
        self._disk_bytes += n * BYTES_PER_ENTRY
        self._ram = []
        self._ram_bytes = 0

    # -- reading -------------------------------------------------------------

    def __len__(self) -> int:
        return self._total

    @property
    def host_bytes(self) -> int:
        """RAM-tier data bytes (the index is accounted separately)."""
        return self._ram_bytes

    @property
    def disk_bytes(self) -> int:
        return self._disk_bytes

    @property
    def index_bytes(self) -> int:
        return self._index.nbytes

    def contains(self, fps) -> np.ndarray:
        return self._index.contains(fps)

    def iter_segments(self):
        """Yield ``(fps, parents)`` per segment, disk tiers first (append
        order): snapshot export, bloom rebuild, and parent-map merge all
        walk this."""
        for mm in self._disk:
            yield np.asarray(mm[:, 0]), np.asarray(mm[:, 1])
        for f, p in self._ram:
            yield f, p

    def to_arrays(self) -> tuple:
        """``(fps, parents)`` concatenated over every tier — the snapshot
        manifest's portable form (disk segments are machine-local paths;
        snapshots must survive a move)."""
        fs, ps = [], []
        for f, p in self.iter_segments():
            fs.append(f)
            ps.append(p)
        if not fs:
            e = np.zeros(0, np.uint64)
            return e, e.copy()
        return np.concatenate(fs), np.concatenate(ps)

    @classmethod
    def from_arrays(
        cls, fps, parents, directory: Optional[str] = None,
        host_budget: Optional[int] = None,
    ) -> "SpillStore":
        store = cls(directory=directory, host_budget=host_budget)
        store.append(fps, parents)
        return store
