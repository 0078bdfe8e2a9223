"""Cloud object storage abstraction (the paper's GCS stand-in).

The paper (§III.A) characterizes object storage as: RESTful GET/PUT on
immutable whole objects addressed by globally unique name, range reads,
no rename, higher latency than local disk, no POSIX semantics.  This module
implements that contract with two real backends (in-memory, local-dir) plus
wrappers for failure injection and virtual-time performance accounting used
by the Table III/IV benchmark reproductions.

Everything above this layer (festivus, chunkstore, checkpointing, the data
pipeline) speaks only this API, so swapping in a real GCS/S3 client is a
one-class change.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import random
import tempfile
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

from repro_torch.core import perfmodel


class ObjectNotFound(KeyError):
    pass


class TransientStoreError(IOError):
    """Retryable failure (503-equivalent)."""


@dataclasses.dataclass(frozen=True)
class ObjectMeta:
    key: str
    size: int
    etag: str
    generation: int


def _etag(data: bytes) -> str:
    return hashlib.md5(data).hexdigest()


class ObjectStore:
    """Abstract object store: immutable objects, range GETs, atomic PUT."""

    def put(self, key: str, data: bytes) -> ObjectMeta:
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        meta = self.head(key)
        return self.get_range(key, 0, meta.size)

    def get_range(self, key: str, offset: int, length: int) -> bytes:
        raise NotImplementedError

    def get_range_view(self, key: str, offset: int, length: int) -> memoryview:
        """Range GET as a read-only buffer view.

        Backends that hold objects in memory can serve this zero-copy
        (:class:`InMemoryObjectStore`); the default wraps :meth:`get_range`.
        The hot read path (festivus block fetches under the cluster DES)
        uses this so that simulating a 512-node campaign does not memcpy
        every byte the fleet "reads" — the returned view is still the real
        stored data, so correctness is never simulated."""
        return memoryview(self.get_range(key, offset, length))

    def head(self, key: str) -> ObjectMeta:
        raise NotImplementedError

    def list(self, prefix: str = "") -> List[str]:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        try:
            self.head(key)
            return True
        except ObjectNotFound:
            return False


@dataclasses.dataclass
class StoreStats:
    """Request accounting — the raw material for bandwidth benchmarks."""

    gets: int = 0
    puts: int = 0
    heads: int = 0
    lists: int = 0
    deletes: int = 0
    bytes_read: int = 0
    bytes_written: int = 0

    def snapshot(self) -> "StoreStats":
        return dataclasses.replace(self)

    def delta(self, earlier: "StoreStats") -> "StoreStats":
        return StoreStats(
            gets=self.gets - earlier.gets,
            puts=self.puts - earlier.puts,
            heads=self.heads - earlier.heads,
            lists=self.lists - earlier.lists,
            deletes=self.deletes - earlier.deletes,
            bytes_read=self.bytes_read - earlier.bytes_read,
            bytes_written=self.bytes_written - earlier.bytes_written,
        )

    @staticmethod
    def merge(items: Iterator["StoreStats"]) -> "StoreStats":
        """Reduce per-mount stats into a fleet aggregate (cluster gather)."""
        return merge_counters(StoreStats, items)


def merge_counters(cls, items):
    """Sum every field of a counters dataclass across instances."""
    out = cls()
    for s in items:
        for f in dataclasses.fields(out):
            setattr(out, f.name, getattr(out, f.name) + getattr(s, f.name))
    return out


class InMemoryObjectStore(ObjectStore):
    """Dict-backed store; the default for tests and the virtual-time bench."""

    def __init__(self):
        self._objects: Dict[str, bytes] = {}
        self._meta: Dict[str, ObjectMeta] = {}
        self._lock = threading.RLock()
        self._generation = 0
        self.stats = StoreStats()

    def put(self, key: str, data: bytes) -> ObjectMeta:
        if not isinstance(data, (bytes, bytearray, memoryview)):
            raise TypeError(f"object data must be bytes, got {type(data)}")
        data = bytes(data)
        with self._lock:
            self._generation += 1
            meta = ObjectMeta(key=key, size=len(data), etag=_etag(data),
                              generation=self._generation)
            self._objects[key] = data
            self._meta[key] = meta
            self.stats.puts += 1
            self.stats.bytes_written += len(data)
            return meta

    def get_range(self, key: str, offset: int, length: int) -> bytes:
        with self._lock:
            if key not in self._objects:
                raise ObjectNotFound(key)
            data = self._objects[key]
            self.stats.gets += 1
            out = data[offset:offset + length]
            self.stats.bytes_read += len(out)
            return out

    def get_range_view(self, key: str, offset: int, length: int) -> memoryview:
        """Zero-copy range GET: a read-only view into the stored object
        (objects are immutable — a PUT replaces the buffer, it never
        mutates it, so outstanding views stay valid)."""
        with self._lock:
            if key not in self._objects:
                raise ObjectNotFound(key)
            out = memoryview(self._objects[key])[offset:offset + length]
            self.stats.gets += 1
            self.stats.bytes_read += len(out)
            return out

    def head(self, key: str) -> ObjectMeta:
        with self._lock:
            self.stats.heads += 1
            if key not in self._meta:
                raise ObjectNotFound(key)
            return self._meta[key]

    def list(self, prefix: str = "") -> List[str]:
        with self._lock:
            self.stats.lists += 1
            return sorted(k for k in self._objects if k.startswith(prefix))

    def delete(self, key: str) -> None:
        with self._lock:
            self.stats.deletes += 1
            self._objects.pop(key, None)
            self._meta.pop(key, None)


class LocalDirObjectStore(ObjectStore):
    """Filesystem-backed store with atomic PUT (temp file + rename).

    Object keys map to files under `root`; '/' in keys becomes directory
    structure.  PUT is atomic (crash mid-write never exposes a torn object),
    which the checkpoint layer's manifest-last commit protocol relies on.
    """

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.RLock()
        self._generation = 0
        self.stats = StoreStats()

    def _path(self, key: str) -> str:
        if ".." in key.split("/"):
            raise ValueError(f"invalid key: {key}")
        return os.path.join(self.root, key)

    def put(self, key: str, data: bytes) -> ObjectMeta:
        data = bytes(data)
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        with self._lock:
            self._generation += 1
            gen = self._generation
            self.stats.puts += 1
            self.stats.bytes_written += len(data)
        return ObjectMeta(key=key, size=len(data), etag=_etag(data),
                          generation=gen)

    def get_range(self, key: str, offset: int, length: int) -> bytes:
        path = self._path(key)
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                out = f.read(length)
        except FileNotFoundError:
            raise ObjectNotFound(key) from None
        with self._lock:
            self.stats.gets += 1
            self.stats.bytes_read += len(out)
        return out

    def head(self, key: str) -> ObjectMeta:
        path = self._path(key)
        with self._lock:
            self.stats.heads += 1
        try:
            size = os.path.getsize(path)
        except FileNotFoundError:
            raise ObjectNotFound(key) from None
        return ObjectMeta(key=key, size=size, etag="", generation=0)

    def list(self, prefix: str = "") -> List[str]:
        with self._lock:
            self.stats.lists += 1
        out = []
        for dirpath, _, files in os.walk(self.root):
            for name in files:
                rel = os.path.relpath(os.path.join(dirpath, name), self.root)
                key = rel.replace(os.sep, "/")
                if key.startswith(prefix):
                    out.append(key)
        return sorted(out)

    def delete(self, key: str) -> None:
        with self._lock:
            self.stats.deletes += 1
        try:
            os.unlink(self._path(key))
        except FileNotFoundError:
            pass


class FlakyObjectStore(ObjectStore):
    """Failure-injection wrapper: pre-emptible cloud realism for tests.

    Raises TransientStoreError on a deterministic pseudo-random fraction of
    operations; festivus and the task queue must retry through it.
    """

    def __init__(self, inner: ObjectStore, failure_rate: float = 0.1,
                 seed: int = 0):
        self.inner = inner
        self.failure_rate = failure_rate
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.injected_failures = 0
        #: op name ("put"/"get_range"/"head"/"delete") -> failures injected
        #: into it; the per-op breakdown ClusterReport worker stats surface
        self.injected_by_op: Dict[str, int] = {}

    def _maybe_fail(self, op: str):
        with self._lock:
            if self._rng.random() < self.failure_rate:
                self.injected_failures += 1
                self.injected_by_op[op] = self.injected_by_op.get(op, 0) + 1
                raise TransientStoreError(f"injected failure in {op}")

    def put(self, key, data):
        self._maybe_fail("put")
        return self.inner.put(key, data)

    def get_range(self, key, offset, length):
        self._maybe_fail("get_range")
        return self.inner.get_range(key, offset, length)

    def get_range_view(self, key, offset, length):
        self._maybe_fail("get_range")
        return self.inner.get_range_view(key, offset, length)

    def head(self, key):
        self._maybe_fail("head")
        return self.inner.head(key)

    def list(self, prefix=""):
        return self.inner.list(prefix)

    def delete(self, key):
        self._maybe_fail("delete")
        return self.inner.delete(key)


def retrying(fn, *args, attempts: int = 5, base_delay_s: float = 0.001,
             sleep=time.sleep, on_retry=None, budget_s: Optional[float] = None,
             **kwargs):
    """Exponential-backoff retry for TransientStoreError.

    The paper runs on pre-emptible nodes where transient 5xx responses are
    routine; every store access in the framework funnels through this.
    `on_retry(attempt_index)` is called before each backoff so callers can
    surface retry counts in their stats.

    `sleep` is the backoff clock: wall-clock ``time.sleep`` by default, but
    under the virtual-time DES callers MUST pass a virtual charge hook
    (``Festivus`` routes it into the worker's task tail) — otherwise a
    retry storm burns real seconds while showing zero simulated latency.

    `budget_s` is the per-request retry budget: the total backoff this
    call may spend.  A retry whose backoff would exceed the remaining
    budget re-raises immediately instead of sleeping — the deadline-aware
    contract a latency SLO needs (waiting longer than the deadline to
    return an error helps nobody).  None (the default) keeps the
    attempts-only behaviour.
    """
    slept = 0.0
    for i in range(attempts):
        try:
            return fn(*args, **kwargs)
        except TransientStoreError:
            if i == attempts - 1:
                raise
            delay = base_delay_s * (2**i)
            if budget_s is not None and slept + delay > budget_s:
                raise
            if on_retry is not None:
                on_retry(i)
            sleep(delay)
            slept += delay
    raise AssertionError("unreachable")


class VirtualTimeStore(ObjectStore):
    """Virtual-clock wrapper: deterministic bandwidth accounting.

    Each range-GET is assigned a *service time* from the calibrated
    ObjectStoreModel, and per-(node, connection) virtual clocks advance
    accordingly; node NIC and zone-fabric caps are applied analytically by
    the benchmark layer (perfmodel.cluster_bandwidth).  Real data still
    flows (correctness is never simulated), only time is virtual.
    """

    def __init__(self, inner: ObjectStore,
                 model: perfmodel.ObjectStoreModel = perfmodel.FESTIVUS_STORE_MODEL):
        self.inner = inner
        self.model = model
        self._lock = threading.Lock()
        self._conn_clock: Dict[int, float] = {}
        self.total_service_s = 0.0
        self.completed_requests = 0
        self.bytes_served = 0

    def put(self, key, data):
        return self.inner.put(key, data)

    def head(self, key):
        return self.inner.head(key)

    def list(self, prefix=""):
        return self.inner.list(prefix)

    def delete(self, key):
        return self.inner.delete(key)

    def get_range(self, key: str, offset: int, length: int,
                  conn_id: int = 0) -> bytes:
        data = self.inner.get_range(key, offset, length)
        dt = self.model.service_time_s(len(data))
        with self._lock:
            self._conn_clock[conn_id] = self._conn_clock.get(conn_id, 0.0) + dt
            self.total_service_s += dt
            self.completed_requests += 1
            self.bytes_served += len(data)
        return data

    def elapsed_virtual_s(self, concurrency: Optional[int] = None) -> float:
        """Makespan under `concurrency` parallel connections (water-filled)."""
        with self._lock:
            if concurrency:
                return self.total_service_s / concurrency
            if not self._conn_clock:
                return 0.0
            return max(self._conn_clock.values())

    def bandwidth_bytes_per_s(self, concurrency: Optional[int] = None) -> float:
        t = self.elapsed_virtual_s(concurrency)
        return self.bytes_served / t if t > 0 else 0.0


# ---------------------------------------------------------------------------
# Replica placement (multi-region object layout)
# ---------------------------------------------------------------------------

class ReplicaMap:
    """Which regions hold a copy of each object, and where a reader pulls.

    Key-generic: works over chunkstore chunk keys, manifest keys, or whole
    objects — the map never touches the data, it only answers
    :meth:`locate`.  Three placement policies (the classic trio):

    * ``pin_primary`` — every object lives only in the primary region;
      every remote read crosses a WAN link (the single-region layout,
      made explicit).
    * ``full_mirror`` — every object is replicated to every region;
      every read is local, at maximal replication cost.
    * ``demand_k`` — objects start at the primary; a region that reads an
      object `promote_after` times earns a local replica, up to `k`
      copies per object (demand-driven placement off observed per-region
      read heat).

    ``locate(key, reader_region)`` returns the replica region a reader in
    `reader_region` should pull from — the nearest-by-RTT holder, via the
    ``nearest`` callable (defaults to :func:`repro.configs.regions.nearest_region`)
    — and records read heat.  Promotion is returned (not silently
    applied) as the second element so the caller can bill the replication
    copy: ``locate_and_promote`` folds both.
    """

    POLICIES = ("pin_primary", "full_mirror", "demand_k")

    def __init__(self, regions, primary: str, *, policy: str = "pin_primary",
                 k: int = 2, promote_after: int = 3, nearest=None):
        self.regions = tuple(regions)
        if primary not in self.regions:
            raise ValueError(f"primary {primary!r} not in regions "
                             f"{self.regions}")
        if policy not in self.POLICIES:
            raise ValueError(f"unknown policy {policy!r} "
                             f"(known: {self.POLICIES})")
        if not 1 <= k <= len(self.regions):
            raise ValueError(f"k={k} outside [1, {len(self.regions)}]")
        self.primary = primary
        self.policy = policy
        self.k = k
        self.promote_after = promote_after
        if nearest is None:
            from repro_torch.configs.regions import nearest_region
            nearest = nearest_region
        self._nearest = nearest
        #: key -> set of regions holding a replica (lazily populated;
        #: absent key == primary only / all, per policy)
        self._replicas: Dict[str, set] = {}
        #: (key, region) -> reads observed (demand_k heat)
        self._heat: Dict[Tuple[str, str], int] = {}
        self.promotions = 0

    def holders(self, key: str):
        """Regions currently holding a replica of `key` (sorted)."""
        if self.policy == "full_mirror":
            return sorted(self.regions)
        extra = self._replicas.get(key)
        if not extra:
            return [self.primary]
        return sorted(extra | {self.primary})

    def read_heat(self, key: str, region: str) -> int:
        return self._heat.get((key, region), 0)

    def locate(self, key: str, reader_region: str):
        """(source region, promote?) for a read of `key` from
        `reader_region`.  Records heat; ``promote`` is True when this
        read crosses demand_k's threshold and earns `reader_region` a
        local replica — the *caller* applies it via :meth:`promote` so it
        can bill the copy bytes."""
        if reader_region not in self.regions:
            raise ValueError(f"reader region {reader_region!r} not in "
                             f"{self.regions}")
        holders = self.holders(key)
        src = (reader_region if reader_region in holders
               else self._nearest(reader_region, holders))
        if self.policy != "demand_k" or src == reader_region:
            return src, False
        hk = (key, reader_region)
        heat = self._heat.get(hk, 0) + 1
        self._heat[hk] = heat
        promote = heat >= self.promote_after and len(holders) < self.k
        return src, promote

    def promote(self, key: str, region: str) -> None:
        """Grant `region` a replica of `key` (the demand_k copy)."""
        self._replicas.setdefault(key, set()).add(region)
        self.promotions += 1

    def locate_and_promote(self, key: str, reader_region: str):
        """(source region, promoted?) — locate, applying any earned
        promotion immediately.  The returned source is still the
        *pre-promotion* holder: this read's bytes cross the WAN; the
        replica serves the next one."""
        src, promote = self.locate(key, reader_region)
        if promote:
            self.promote(key, reader_region)
        return src, promote

    def replica_count(self, key: str) -> int:
        return len(self.holders(key))


class ZoneSpread:
    """Fabric-aware placement of freshly-ingested hot data across zones.

    The intra-region sibling of :class:`ReplicaMap`: where ReplicaMap
    answers *which region* a reader pulls a replica from, ZoneSpread
    answers *which fabric zone* hosts a freshly-written object's flows.
    An ingest pool pinned into one zone (``ClusterConfig.pool_zones``)
    writes every scene batch — and re-reads them all on the next wheel
    revolution — against that single zone's water-filled capacity, while
    the other zones idle.  Spreading placement assigns each written key
    a home zone round-robin in first-write order (sticky thereafter, the
    way a bucket's chunks don't migrate), so both the write wave and the
    wheel's scan fan across every zone.

    Deterministic by construction: assignment depends only on the order
    of first :meth:`place` calls, never on hashing or clocks — the DES
    twin tests rely on that.
    """

    def __init__(self, zones: int):
        if zones < 1:
            raise ValueError(f"zones={zones} must be >= 1")
        self.zones = zones
        self._zone_of: Dict[str, int] = {}
        self._next = 0

    def place(self, key: str) -> int:
        """Home zone for `key`: assigned round-robin on first placement,
        sticky on every later call."""
        z = self._zone_of.get(key)
        if z is None:
            z = self._zone_of[key] = self._next
            self._next = (self._next + 1) % self.zones
        return z

    def zone_of(self, key: str) -> Optional[int]:
        """Assigned zone, or None if `key` was never placed."""
        return self._zone_of.get(key)

    def zones_used(self) -> int:
        """Distinct zones holding at least one placed key."""
        return len(set(self._zone_of.values()))

    def __len__(self):
        return len(self._zone_of)
