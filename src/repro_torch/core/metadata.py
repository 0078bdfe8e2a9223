"""Shared metadata key/value store (the paper's Redis).

Festivus §III.B: "Rather than query the object store itself for object
metadata, we maintain our own separate scalable in-memory key/value store to
perform metadata-related operations (this metadata server is shared by all
instances of the file system)."

Object-store HEAD/LIST operations are slow (tens of ms) and billable; file
open/stat/readdir must never touch them on the hot path.  This module is a
Redis-shaped in-process KV server: string ops, hashes, sorted counters, and
TTL — enough for (a) the festivus stat/dirent cache, (b) task-queue state,
(c) chunkstore manifests.  All methods are thread-safe; a latency model can
be attached for the virtual-time benchmarks.
"""

from __future__ import annotations

import fnmatch
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple


class MetadataStore:
    """Redis-like shared KV store with hashes and TTLs."""

    def __init__(self, latency_s: float = 0.0, clock=time.monotonic):
        self._kv: Dict[str, Any] = {}
        self._hashes: Dict[str, Dict[str, Any]] = {}
        self._expiry: Dict[str, float] = {}
        self._lock = threading.RLock()
        self._clock = clock
        self.latency_s = latency_s  # accounted by virtual-time benches
        self.ops = 0

    # -- housekeeping -------------------------------------------------------
    def _tick(self, key: str):
        self.ops += 1
        deadline = self._expiry.get(key)
        if deadline is not None and self._clock() >= deadline:
            self._kv.pop(key, None)
            self._hashes.pop(key, None)
            self._expiry.pop(key, None)

    # -- strings ------------------------------------------------------------
    def set(self, key: str, value: Any, ttl_s: Optional[float] = None):
        with self._lock:
            self._tick(key)
            self._kv[key] = value
            if ttl_s is not None:
                self._expiry[key] = self._clock() + ttl_s
            else:
                self._expiry.pop(key, None)

    def get(self, key: str, default: Any = None) -> Any:
        with self._lock:
            self._tick(key)
            return self._kv.get(key, default)

    def setnx(self, key: str, value: Any) -> bool:
        """Set-if-not-exists; the task-queue lease primitive."""
        with self._lock:
            self._tick(key)
            if key in self._kv:
                return False
            self._kv[key] = value
            return True

    def peek(self, key: str, default: Any = None) -> Any:
        """Watch-channel read: the value as a client-side coherence watch
        sees it.  Unlike :meth:`get` this is *not* a modeled KV round-trip
        (no op count, no latency accrual through the cluster's MountMeta):
        it stands for a subscription the server pushes updates into — e.g.
        an array's write generation, which every reader consults on every
        access and which only ever changes when a writer (who pays the
        counted ``incr``) bumps it.  Steady-state readers therefore cost
        what they did before the watch existed; only actual changes make
        them pay a counted revalidation."""
        with self._lock:
            return self._kv.get(key, default)

    def incr(self, key: str, amount: int = 1) -> int:
        with self._lock:
            self._tick(key)
            cur = int(self._kv.get(key, 0)) + amount
            self._kv[key] = cur
            return cur

    def delete(self, key: str) -> None:
        with self._lock:
            self._tick(key)
            self._kv.pop(key, None)
            self._hashes.pop(key, None)
            self._expiry.pop(key, None)

    def exists(self, key: str) -> bool:
        with self._lock:
            self._tick(key)
            return key in self._kv or key in self._hashes

    def keys(self, pattern: str = "*") -> List[str]:
        with self._lock:
            self.ops += 1
            allk = set(self._kv) | set(self._hashes)
            return sorted(k for k in allk if fnmatch.fnmatch(k, pattern))

    # -- hashes -------------------------------------------------------------
    def hset(self, key: str, field: str, value: Any) -> None:
        with self._lock:
            self._tick(key)
            self._hashes.setdefault(key, {})[field] = value

    def hmset(self, key: str, mapping: Dict[str, Any]) -> None:
        with self._lock:
            self._tick(key)
            self._hashes.setdefault(key, {}).update(mapping)

    def hget(self, key: str, field: str, default: Any = None) -> Any:
        with self._lock:
            self._tick(key)
            return self._hashes.get(key, {}).get(field, default)

    def hgetall(self, key: str) -> Dict[str, Any]:
        with self._lock:
            self._tick(key)
            return dict(self._hashes.get(key, {}))

    def hdel(self, key: str, field: str) -> None:
        with self._lock:
            self._tick(key)
            self._hashes.get(key, {}).pop(field, None)

    def hlen(self, key: str) -> int:
        with self._lock:
            self._tick(key)
            return len(self._hashes.get(key, {}))

    # -- compare-and-swap (lease renewal) ------------------------------------
    def cas(self, key: str, expected: Any, new: Any) -> bool:
        with self._lock:
            self._tick(key)
            if self._kv.get(key) != expected:
                return False
            self._kv[key] = new
            return True


class StatCache:
    """Festivus's file-metadata view on top of the shared MetadataStore.

    Keyed ``stat:<path>`` -> {size, etag, generation, chunks?}.  Populated on
    write (chunkstore PUT) or by an explicit `sync_from_store` crawl — never
    lazily from per-read HEADs, which is the gcsfuse failure mode the paper
    measured as an ~80 ms per-random-read penalty (Table IV).
    """

    PREFIX = "stat:"

    def __init__(self, meta: MetadataStore):
        self.meta = meta

    def put(self, path: str, size: int, etag: str = "",
            extra: Optional[dict] = None, generation: Optional[int] = None):
        """Record one object's metadata.  `generation` is the store's
        monotonic write generation — the SSD tier's revalidation token
        (:class:`repro.core.festivus.SsdTier`): it rides the same hmset
        (no extra KV op), and every reader gets it with the hgetall it
        already pays for the size."""
        entry = {"size": int(size), "etag": etag}
        if generation is not None:
            entry["generation"] = int(generation)
        if extra:
            entry.update(extra)
        self.meta.hmset(self.PREFIX + path, entry)
        # maintain parent-directory listings for readdir
        if "/" in path:
            parent, name = path.rsplit("/", 1)
        else:
            parent, name = "", path
        self.meta.hset("dir:" + parent, name, 1)

    def get(self, path: str) -> Optional[dict]:
        entry = self.meta.hgetall(self.PREFIX + path)
        return entry or None

    def size(self, path: str) -> Optional[int]:
        entry = self.get(path)
        return None if entry is None else int(entry["size"])

    def listdir(self, path: str) -> List[str]:
        return sorted(self.meta.hgetall("dir:" + path).keys())

    def remove(self, path: str):
        self.meta.delete(self.PREFIX + path)
        if "/" in path:
            parent, name = path.rsplit("/", 1)
        else:
            parent, name = "", path
        self.meta.hdel("dir:" + parent, name)

    def sync_from_store(self, store) -> int:
        """Crawl the object store once and (re)build the metadata index."""
        n = 0
        for key in store.list(""):
            meta = store.head(key)
            self.put(key, meta.size, meta.etag, generation=meta.generation)
            n += 1
        return n
