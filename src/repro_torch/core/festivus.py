"""festivus — "a file system for the rest of us" (paper §III.B), in library form.

A userspace virtual file system over cloud object storage.  The kernel-module
half of FUSE has no analogue inside a JAX data pipeline, so this module keeps
the *userspace architecture* that made festivus fast and exposes it as a
file API:

* **Large block reads** — all object I/O happens in aligned blocks of
  ``block_bytes`` (default 4 MiB: the paper's FUSE_MAX_PAGES_PER_REQ=1024
  tuning, which it measured as an 18x win over the 128 KiB default at random
  4 MB reads, Table IV).
* **Shared metadata KV** — stat/readdir served from
  :class:`repro.core.metadata.StatCache`, never from per-read HEADs.
* **Asynchronous block engine** — a thread pool keeps many range-GETs in
  flight; duplicate in-flight fetches are coalesced through a futures map.
* **Readahead** — sequential access schedules the next ``readahead_blocks``
  blocks speculatively (VM_MAX_READAHEAD's analogue).
* **Block cache** — byte-bounded LRU shared across files (the page cache's
  analogue; preserves cross-process sharing the paper notes is lost when
  applications read straight into private userspace buffers).

A deliberately naive :class:`GcsFuseLikeFS` implements the baseline the paper
benchmarks against: 128 KiB request ceiling, HEAD-per-open, no readahead, no
cross-file cache.
"""

from __future__ import annotations

import bisect
import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

from repro_torch.core import perfmodel
from repro_torch.core.metadata import MetadataStore, StatCache
from repro_torch.core.object_store import (
    ObjectNotFound,
    ObjectStore,
    TransientStoreError,
    merge_counters,
    retrying,
)


@dataclasses.dataclass
class FestivusConfig:
    #: aligned read-block size; the paper's key knob (128 KiB default FUSE vs
    #: the 4 MiB festivus setting)
    block_bytes: int = 4 * perfmodel.MiB
    #: speculative blocks fetched ahead on sequential access
    readahead_blocks: int = 4
    #: max concurrent range-GETs per mount
    max_inflight: int = 32
    #: LRU block-cache capacity in bytes
    cache_bytes: int = 256 * perfmodel.MiB
    #: retry attempts for transient store errors
    max_retries: int = 5
    #: fetch blocks synchronously on the caller's thread instead of through
    #: the async engine.  The cluster DES sets this: it runs one handler at
    #: a time, so a thread-pool round-trip per block is pure overhead there
    #: (I/O *time* is modeled analytically from the service-time accounting,
    #: which is identical either way) — and without pool threads the
    #: simulation is single-threaded end to end.
    inline_fetch: bool = False
    #: local-SSD tier capacity in bytes (the second level of the two-level
    #: design; see :class:`_SsdTier`).  0 — the default — disables the tier
    #: entirely: no lookups, no admission, no device-time accrual, so a
    #: mount with ``ssd_bytes=0`` behaves bit-identically to one built
    #: before the tier existed.
    ssd_bytes: int = 0
    #: device service-time model for the SSD tier
    ssd_model: perfmodel.LocalSsdModel = perfmodel.LOCAL_SSD_MODEL
    #: admit store fetches into the SSD tier.  False is the read-around
    #: admission policy: the mount still *serves* from a warm tier but
    #: never fills it — what an ingest-pool mount sharing a persistent
    #: tier would run so a one-pass scan cannot churn a serve tier's
    #: working set.  (An ingest pool with ``ssd_bytes=0`` bypasses the
    #: tier outright; writes never admit under any policy — write-around.)
    ssd_admit: bool = True
    #: per-request retry budget: total backoff seconds one read/write may
    #: spend before giving up (routed through :func:`retrying`'s
    #: ``budget_s``).  None keeps the attempts-only legacy behaviour.  An
    #: exhausted budget raises the TransientStoreError to the caller —
    #: under the cluster DES that dead-letters the task through the queue
    #: rather than stalling a latency-SLO request indefinitely.
    retry_budget_s: Optional[float] = None
    #: deadline-aware hedged reads: on a transient block-fetch failure,
    #: wait a p99-based hedge delay and issue a *second* request instead
    #: of walking the full exponential-backoff ladder (first response
    #: wins; counted in ``hedged_reads`` / ``hedge_wins``).  Off by
    #: default — the single-request path stays bit-identical.
    hedged_reads: bool = False
    #: hedge delay floor, used until enough fetch-latency samples accrue
    #: to compute an observed p99 (and as a lower bound thereafter)
    hedge_delay_floor_s: float = 1e-3


@dataclasses.dataclass
class FestivusStats:
    cache_hits: int = 0
    cache_misses: int = 0
    blocks_fetched: int = 0
    bytes_fetched: int = 0
    readahead_issued: int = 0
    coalesced_fetches: int = 0
    #: transient store errors absorbed by the retry loop (pre-emptible realism)
    retried_ops: int = 0
    #: SSD-tier counters (two-level storage).  A block lookup that misses
    #: RAM consults the SSD tier when one is mounted: `ssd_hits` were
    #: served from the device (generation-validated), `ssd_misses` fell
    #: through to the store — `ssd_stale_drops` of those found an entry
    #: stamped with an outdated KV generation and dropped it unserved.
    #: Conservation law (pinned by tests/test_properties.py): with the
    #: tier mounted, ``cache_hits + ssd_hits + ssd_misses`` equals total
    #: block lookups, and ``ssd_hits + ssd_misses == cache_misses``.
    ssd_hits: int = 0
    ssd_misses: int = 0
    ssd_stale_drops: int = 0
    ssd_evictions: int = 0
    ssd_fill_bytes: int = 0
    #: modeled device time: `ssd_read_s` bills into request tails on hits
    #: (an SSD hit replaces a remote GET and its fabric flow);
    #: `ssd_fill_write_s` is the write-behind admission cost — reported
    #: device busy-time, never added to the admitting request's latency.
    ssd_read_s: float = 0.0
    ssd_fill_write_s: float = 0.0
    #: retry-backoff seconds actually charged (virtual seconds under the
    #: DES — billed into task tails; wall seconds slept otherwise)
    retry_backoff_s: float = 0.0
    #: reads abandoned because their retry budget ran out (the request
    #: then fails fast to the caller instead of blowing its deadline)
    retry_budget_exhausted: int = 0
    #: hedged reads issued (a transient primary failure answered with a
    #: delayed second request instead of a full backoff ladder), and how
    #: many of those hedges won (their response was the one served)
    hedged_reads: int = 0
    hedge_wins: int = 0
    #: SSD devices dropped by fault injection (reads fall through to the
    #: store from the drop instant on)
    ssd_device_failures: int = 0

    def hit_rate(self) -> float:
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0

    def ssd_hit_rate(self) -> float:
        total = self.ssd_hits + self.ssd_misses
        return self.ssd_hits / total if total else 0.0

    @staticmethod
    def merge(items) -> "FestivusStats":
        """Reduce per-mount stats into a fleet aggregate (cluster gather)."""
        return merge_counters(FestivusStats, items)


class _BlockCache:
    """Byte-bounded LRU of (path, block_index) -> bytes."""

    def __init__(self, capacity_bytes: int):
        self.capacity = capacity_bytes
        self._data: Dict[Tuple[str, int], bytes] = {}
        self._order: List[Tuple[str, int]] = []
        self._bytes = 0
        self._lock = threading.Lock()

    def get(self, key: Tuple[str, int]) -> Optional[bytes]:
        with self._lock:
            if key not in self._data:
                return None
            self._order.remove(key)
            self._order.append(key)
            return self._data[key]

    def put(self, key: Tuple[str, int], value: bytes) -> None:
        with self._lock:
            if key in self._data:
                self._bytes -= len(self._data[key])
                self._order.remove(key)
            self._data[key] = value
            self._order.append(key)
            self._bytes += len(value)
            while self._bytes > self.capacity and self._order:
                old = self._order.pop(0)
                self._bytes -= len(self._data.pop(old))

    def invalidate_path(self, path: str) -> None:
        with self._lock:
            victims = [k for k in self._data if k[0] == path]
            for k in victims:
                self._bytes -= len(self._data[k])
                self._order.remove(k)
                del self._data[k]

    def __len__(self):
        return len(self._data)


class SsdTier:
    """Byte-bounded LRU of (path, block) -> (bytes, generation): the
    persistent local-SSD level under the RAM :class:`_BlockCache`.

    Two properties distinguish it from the RAM cache above it:

    * **Persistence** — the tier is a standalone handle a fleet keeps
      *across* mounts (`Festivus(..., ssd_tier=...)`), modeling a local
      SSD that survives worker leases and remounts.  A remounting worker
      starts RAM-cold but device-warm.
    * **Generation stamps** — every entry carries the object's KV write
      generation observed at fill time.  A lookup must present the
      current generation (read from the shared stat KV, which every read
      already consults for size); a mismatched stamp means some mount
      rewrote the object since the fill, so the entry is dropped
      unserved.  A rebuilt chunk is therefore never served stale no
      matter how long the device held it.
    """

    def __init__(self, capacity_bytes: int):
        self.capacity = capacity_bytes
        self._data: Dict[Tuple[str, int], Tuple[bytes, object]] = {}
        self._order: List[Tuple[str, int]] = []
        self._bytes = 0
        self._lock = threading.Lock()
        #: cumulative capacity evictions over the tier's whole life (the
        #: handle outlives mounts, so this is not per-campaign; mounts
        #: snapshot deltas into their own FestivusStats)
        self.evictions = 0

    def get(self, key: Tuple[str, int],
            generation) -> Tuple[Optional[bytes], bool]:
        """Return ``(bytes, False)`` when `key` is held and stamped with
        `generation`; ``(None, True)`` when a stale-stamped entry was
        found and dropped; ``(None, False)`` on a plain miss."""
        with self._lock:
            entry = self._data.get(key)
            if entry is None:
                return None, False
            data, stamp = entry
            if stamp != generation:
                self._bytes -= len(data)
                self._order.remove(key)
                del self._data[key]
                return None, True
            self._order.remove(key)
            self._order.append(key)
            return data, False

    def put(self, key: Tuple[str, int], value: bytes, generation) -> None:
        with self._lock:
            if key in self._data:
                self._bytes -= len(self._data[key][0])
                self._order.remove(key)
            self._data[key] = (value, generation)
            self._order.append(key)
            self._bytes += len(value)
            while self._bytes > self.capacity and self._order:
                old = self._order.pop(0)
                self._bytes -= len(self._data.pop(old)[0])
                self.evictions += 1

    def invalidate_path(self, path: str) -> None:
        with self._lock:
            victims = [k for k in self._data if k[0] == path]
            for k in victims:
                self._bytes -= len(self._data[k][0])
                self._order.remove(k)
                del self._data[k]

    @property
    def bytes_used(self) -> int:
        return self._bytes

    def __len__(self):
        return len(self._data)


class Festivus:
    """The virtual file system: open/read/stat/listdir over an ObjectStore."""

    def __init__(self, store: ObjectStore, meta: Optional[MetadataStore] = None,
                 config: Optional[FestivusConfig] = None,
                 pool: Optional[ThreadPoolExecutor] = None,
                 ssd_tier: Optional[SsdTier] = None):
        self.store = store
        self.meta = meta if meta is not None else MetadataStore()
        self.statcache = StatCache(self.meta)
        self.config = config or FestivusConfig()
        self.stats = FestivusStats()
        #: counters are bumped from caller threads and pool threads alike;
        #: += is not atomic, so all stats writes go through _bump
        self._stats_lock = threading.Lock()
        self._cache = _BlockCache(self.config.cache_bytes)
        #: the local-SSD level (two-level storage).  A passed-in handle is
        #: the *persistent* form — the device outliving this mount (a
        #: fleet re-attaches it on remount); otherwise `ssd_bytes > 0`
        #: creates a mount-lifetime tier.  None = single-level behavior,
        #: bit-identical to the pre-tier read path.
        if ssd_tier is not None:
            self._ssd = ssd_tier
        elif self.config.ssd_bytes > 0:
            self._ssd = SsdTier(self.config.ssd_bytes)
        else:
            self._ssd = None
        #: device read-time accrued by SSD hits since the last drain (the
        #: DES bills it into the task tail: local reads ride no fabric flow)
        self._pending_ssd_s = 0.0
        #: retry backoff accrued since the last drain (virtual mode only).
        #: Under ``inline_fetch`` (the DES) backoff is *charged* here and
        #: billed into the task tail — never slept; real-thread mounts keep
        #: wall-clock time.sleep.  This is the fix for the silent retry
        #: storm: before it, a storm burnt wall seconds invisible to the
        #: simulation.
        self._pending_retry_s = 0.0
        self._retry_sleep = (self._charge_retry_backoff
                             if self.config.inline_fetch else self._wall_sleep)
        #: observed per-fetch store service times (hedged reads only):
        #: a FIFO of recent samples plus the same samples sorted, so the
        #: p99 hedge delay is O(log n) per observation
        self._fetch_window: deque = deque()
        self._fetch_sorted: List[float] = []
        #: `pool` lets many mounts share one block engine (the cluster DES
        #: runs hundreds of mounts but one task at a time — per-mount pools
        #: would pin nodes x max_inflight idle OS threads); with
        #: `inline_fetch` there is no block engine at all
        self._owns_pool = pool is None and not self.config.inline_fetch
        if self.config.inline_fetch:
            self._pool = None
        else:
            self._pool = pool if pool is not None else ThreadPoolExecutor(
                max_workers=self.config.max_inflight,
                thread_name_prefix="festivus")
        self._inflight: Dict[Tuple[str, int], Future] = {}
        # RLock: if a fetch completes before add_done_callback registers, the
        # done-callback runs synchronously on this thread while it still
        # holds the lock inside _block_future.
        self._inflight_lock = threading.RLock()
        #: per-path last sequential block, for readahead detection
        self._last_block: Dict[str, int] = {}
        #: write/delete hooks: each is called with the object path after a
        #: successful PUT/DELETE and after the block cache drops the path.
        #: This is the coherence fan-out for *derived* caches — the block
        #: cache only holds raw object bytes, but a serving tier caches
        #: decoded tiles built FROM those bytes, and nothing short of a
        #: hook can tell it a chunk object was rewritten underneath it
        #: (the stale-tiles-forever bug the ingest path exposed).
        self.write_hooks: List = []

    # -- metadata path (never touches the object store) ---------------------
    def stat(self, path: str) -> dict:
        entry = self.statcache.get(path)
        if entry is None:
            raise FileNotFoundError(path)
        return entry

    def exists(self, path: str) -> bool:
        return self.statcache.get(path) is not None

    def listdir(self, path: str) -> List[str]:
        return self.statcache.listdir(path)

    def sync_metadata(self) -> int:
        return self.statcache.sync_from_store(self.store)

    def _bump(self, **fields) -> None:
        with self._stats_lock:
            for name, n in fields.items():
                setattr(self.stats, name, getattr(self.stats, name) + n)

    def _count_retry(self, _attempt: int) -> None:
        self._bump(retried_ops=1)

    def _wall_sleep(self, seconds: float) -> None:
        """Real-thread backoff: sleep wall clock, but still count it."""
        self._bump(retry_backoff_s=seconds)
        time.sleep(seconds)

    def _charge_retry_backoff(self, seconds: float) -> None:
        """Virtual backoff: accrue into the pending pool the DES drains
        into the task tail (``drain_retry_pending``) — no wall sleep."""
        with self._stats_lock:
            self.stats.retry_backoff_s += seconds
            self._pending_retry_s += seconds

    def drain_retry_pending(self) -> float:
        """Retry backoff charged since the last drain (virtual seconds).
        Exactly 0.0 when no retry ever backed off — the DES adds this into
        every task tail, so the fault-free path must cost nothing."""
        if self._pending_retry_s == 0.0:
            return 0.0
        with self._stats_lock:
            s, self._pending_retry_s = self._pending_retry_s, 0.0
            return s

    # -- write path ----------------------------------------------------------
    def write(self, path: str, data: bytes) -> None:
        """Whole-object PUT (objects are immutable; update == rewrite).

        The PUT's store generation is recorded in the shared stat KV, so
        every mount's next read of `path` — which consults that entry for
        the size anyway — sees the bumped generation and refuses any SSD
        entry stamped with the old one.  Writes never admit into the SSD
        tier (write-around): a one-pass ingest wave must not evict the
        read working set this tier exists to protect.
        """
        meta = retrying(self.store.put, path, data,
                        attempts=self.config.max_retries,
                        sleep=self._retry_sleep,
                        budget_s=self.config.retry_budget_s,
                        on_retry=self._count_retry)
        self._cache.invalidate_path(path)
        if self._ssd is not None:
            self._ssd.invalidate_path(path)
        self.statcache.put(path, meta.size, meta.etag,
                           generation=meta.generation)
        for hook in self.write_hooks:
            hook(path)

    def delete(self, path: str) -> None:
        retrying(self.store.delete, path, attempts=self.config.max_retries,
                 sleep=self._retry_sleep,
                 budget_s=self.config.retry_budget_s,
                 on_retry=self._count_retry)
        self._cache.invalidate_path(path)
        if self._ssd is not None:
            self._ssd.invalidate_path(path)
        self.statcache.remove(path)
        for hook in self.write_hooks:
            hook(path)

    def drain_ssd_pending(self) -> float:
        """Device read-time accrued by SSD hits since the last drain.
        Always 0.0 with no tier mounted — the DES adds this into every
        task tail, so the no-tier path must cost exactly nothing.  (The
        pending check, not the tier check, decides: a device dropped by
        fault injection mid-task still bills the reads it served.)"""
        if self._ssd is None and self._pending_ssd_s == 0.0:
            return 0.0
        with self._stats_lock:
            s, self._pending_ssd_s = self._pending_ssd_s, 0.0
            return s

    def drop_ssd_tier(self) -> bool:
        """Fault injection: the local SSD device fails.  Detaches the tier
        — every later read falls through to the store, admissions stop —
        and returns whether a device was actually mounted.  Counted in
        ``ssd_device_failures``; time already accrued by served hits still
        bills (see :meth:`drain_ssd_pending`)."""
        if self._ssd is None:
            return False
        self._ssd = None
        self._bump(ssd_device_failures=1)
        return True

    # -- store fetch (retry budget + hedged reads) ---------------------------
    _HEDGE_WINDOW = 512      #: service-time samples kept for the p99 estimate
    _HEDGE_MIN_SAMPLES = 16  #: below this, fall back to hedge_delay_floor_s

    def _observe_fetch(self, service_s: float) -> None:
        with self._stats_lock:
            self._fetch_window.append(service_s)
            bisect.insort(self._fetch_sorted, service_s)
            if len(self._fetch_window) > self._HEDGE_WINDOW:
                old = self._fetch_window.popleft()
                del self._fetch_sorted[bisect.bisect_left(
                    self._fetch_sorted, old)]

    def _hedge_delay_s(self) -> float:
        with self._stats_lock:
            if len(self._fetch_sorted) >= self._HEDGE_MIN_SAMPLES:
                return perfmodel.percentile_sorted(self._fetch_sorted, 99.0)
        return self.config.hedge_delay_floor_s

    def _fetch_store(self, path: str, offset: int, length: int):
        """One range-GET against the backing store, with recovery.

        Plain mode (``hedged_reads=False``): the classic budgeted retry
        loop — same single-request sequence as before, so the fault-free
        path is bit-identical.  Hedged mode: try the primary once; on a
        transient failure wait a p99-based hedge delay (charged to the
        virtual clock under the DES) and fire a second, hedge request —
        first success wins.  Only if both fail does the budgeted retry
        loop take over, with the hedge delay already deducted from the
        budget.  A budget that runs dry re-raises: under the engine the
        task fails, burns its queue retries, and dead-letters.
        """
        budget = self.config.retry_budget_s
        if not self.config.hedged_reads:
            try:
                return retrying(self.store.get_range_view, path, offset,
                                length, attempts=self.config.max_retries,
                                sleep=self._retry_sleep, budget_s=budget,
                                on_retry=self._count_retry)
            except TransientStoreError:
                if budget is not None:
                    self._bump(retry_budget_exhausted=1)
                raise
        try:
            data = self.store.get_range_view(path, offset, length)
        except TransientStoreError:
            delay = self._hedge_delay_s()
            self._bump(hedged_reads=1)
            self._retry_sleep(delay)
            try:
                data = self.store.get_range_view(path, offset, length)
                self._bump(hedge_wins=1)
            except TransientStoreError:
                remaining = (None if budget is None
                             else max(0.0, budget - delay))
                try:
                    data = retrying(self.store.get_range_view, path, offset,
                                    length, attempts=self.config.max_retries,
                                    sleep=self._retry_sleep,
                                    budget_s=remaining,
                                    on_retry=self._count_retry)
                except TransientStoreError:
                    if budget is not None:
                        self._bump(retry_budget_exhausted=1)
                    raise
        service_s = getattr(self.store, "last_op_service_s", None)
        if service_s is not None:
            self._observe_fetch(service_s)
        return data

    # -- block engine ---------------------------------------------------------
    def _fetch_block(self, path: str, block: int, size: int,
                     generation=None) -> memoryview:
        """Fetch one aligned block as a read-only buffer view (zero-copy
        from stores that can serve it that way); accounting (stats and,
        under the DES, modeled service time) is identical to a bytes GET.

        With an SSD tier mounted the device is consulted first: an entry
        stamped with the caller's `generation` (read from the stat KV the
        read already consulted) is served at device read time with *no*
        store request and no fabric flow; a stale or missing entry falls
        through to the store range-GET, whose bytes are then admitted
        back into the tier write-behind (unless the mount's admission
        policy is read-around).
        """
        offset = block * self.config.block_bytes
        length = min(self.config.block_bytes, size - offset)
        if self._ssd is not None:
            data, stale = self._ssd.get((path, block), generation)
            if data is not None:
                read_s = self.config.ssd_model.read_time_s(len(data))
                with self._stats_lock:
                    self.stats.ssd_hits += 1
                    self.stats.ssd_read_s += read_s
                    self._pending_ssd_s += read_s
                self._cache.put((path, block), data)
                return data
            if stale:
                self._bump(ssd_misses=1, ssd_stale_drops=1)
            else:
                self._bump(ssd_misses=1)
        data = self._fetch_store(path, offset, length)
        self._bump(blocks_fetched=1, bytes_fetched=len(data))
        if self._ssd is not None and self.config.ssd_admit:
            before = self._ssd.evictions
            self._ssd.put((path, block), data, generation)
            self._bump(ssd_fill_bytes=len(data),
                       ssd_evictions=self._ssd.evictions - before,
                       ssd_fill_write_s=self.config.ssd_model.write_time_s(
                           len(data)))
        self._cache.put((path, block), data)
        return data

    def _block_future(self, path: str, block: int, size: int,
                      generation=None) -> Future:
        """Submit (or join) an async fetch of one block."""
        key = (path, block)
        with self._inflight_lock:
            fut = self._inflight.get(key)
            if fut is not None:
                self._bump(coalesced_fetches=1)
                return fut
            fut = self._pool.submit(self._fetch_block, path, block, size,
                                    generation)
            self._inflight[key] = fut

            def _done(f, key=key):
                with self._inflight_lock:
                    self._inflight.pop(key, None)

            fut.add_done_callback(_done)
            return fut

    def _get_block(self, path: str, block: int, size: int,
                   generation=None) -> bytes:
        cached = self._cache.get((path, block))
        if cached is not None:
            self._bump(cache_hits=1)
            return cached
        self._bump(cache_misses=1)
        if self._pool is None:  # inline mode: fetch on this thread
            return self._fetch_block(path, block, size, generation)
        return self._block_future(path, block, size, generation).result()

    def _maybe_readahead(self, path: str, last_block: int, size: int,
                         generation=None) -> None:
        nblocks = -(-size // self.config.block_bytes)
        prev = self._last_block.get(path)
        self._last_block[path] = last_block
        if prev is None or last_block != prev + 1:
            return  # not sequential
        for b in range(last_block + 1,
                       min(last_block + 1 + self.config.readahead_blocks, nblocks)):
            if self._cache.get((path, b)) is None:
                self._bump(readahead_issued=1)
                if self._pool is None:  # inline: prefetch == warm the cache
                    self._fetch_block(path, b, size, generation)
                else:
                    self._block_future(path, b, size, generation)

    # -- read path -------------------------------------------------------------
    def _gather_parts(self, path: str, offset: int,
                      length: Optional[int]) -> List:
        """Fetch the covering blocks of [offset, offset+length) and return
        the in-order list of bytes-like parts (shared by :meth:`read` /
        :meth:`read_view`; all cache and stats accounting lives here)."""
        entry = self.stat(path)
        size = int(entry["size"])
        # the KV write generation rides the same stat entry every read
        # already pays for — SSD-tier revalidation is therefore free in
        # metadata ops (None with no tier, or for pre-generation entries,
        # which then never validate: conservative, never stale)
        gen = entry.get("generation") if self._ssd is not None else None
        if length is None:
            length = size - offset
        if offset < 0 or offset > size:
            raise ValueError(f"offset {offset} out of range for {path} ({size}B)")
        length = max(0, min(length, size - offset))
        if length == 0:
            return []
        bb = self.config.block_bytes
        first, last = offset // bb, (offset + length - 1) // bb

        # issue all misses concurrently, then assemble in order (inline
        # mode fetches at discovery: there is no concurrency to exploit)
        futures: Dict[int, Future] = {}
        blocks: Dict[int, bytes] = {}
        for b in range(first, last + 1):
            cached = self._cache.get((path, b))
            if cached is not None:
                self._bump(cache_hits=1)
                blocks[b] = cached
            else:
                self._bump(cache_misses=1)
                if self._pool is None:
                    blocks[b] = self._fetch_block(path, b, size, gen)
                else:
                    futures[b] = self._block_future(path, b, size, gen)
        for b, fut in futures.items():
            blocks[b] = fut.result()

        self._maybe_readahead(path, last, size, gen)

        parts = []
        for b in range(first, last + 1):
            data = blocks[b]
            lo = offset - b * bb if b == first else 0
            hi = offset + length - b * bb if b == last else len(data)
            parts.append(data[lo:hi])
        return parts

    def read(self, path: str, offset: int = 0, length: Optional[int] = None) -> bytes:
        """Random-access read; any range, assembled from aligned blocks.

        Blocks beyond the first are fetched concurrently (the async engine),
        which is what lets a single mount saturate a node NIC (Table III's
        1 GB/s single-node row).
        """
        return b"".join(self._gather_parts(path, offset, length))

    def read_view(self, path: str, offset: int = 0,
                  length: Optional[int] = None) -> memoryview:
        """Zero-copy read: same block fetches, cache traffic, and (under
        the DES) modeled service time as :meth:`read`, but the result is a
        read-only buffer view instead of assembled bytes.

        When every covering block is a view into one underlying stored
        object (the :class:`InMemoryObjectStore` fast path), the result is
        a single contiguous view of that object — no bytes are copied no
        matter how many blocks the range spans.  Otherwise the parts are
        joined once.  Scan-style handlers and the chunk decoder use this;
        anything that wants an owned ``bytes`` keeps calling :meth:`read`.
        """
        parts = self._gather_parts(path, offset, length)
        if not parts:
            return memoryview(b"")
        if len(parts) == 1:
            p = parts[0]
            return p if isinstance(p, memoryview) else memoryview(p)
        base = parts[0].obj if isinstance(parts[0], memoryview) else None
        if base is not None and all(
                isinstance(p, memoryview) and p.obj is base for p in parts):
            # all blocks slice one immutable object: the requested range is
            # itself a contiguous slice of it (blocks are offset-aligned)
            return memoryview(base)[offset:offset + sum(len(p) for p in parts)]
        return memoryview(b"".join(parts))

    def open(self, path: str) -> "FestivusFile":
        self.stat(path)  # raises if unknown
        return FestivusFile(self, path)

    def close(self):
        if self._owns_pool:
            self._pool.shutdown(wait=True)


class FestivusFile:
    """POSIX-flavored file handle (seek/read/tell) over Festivus.

    This is the interface that lets "a vast number of tools, utilities,
    libraries and application code" (§III.A) run unmodified: anything that
    wants a file-like object can be pointed at cloud storage.
    """

    def __init__(self, fs: Festivus, path: str):
        self.fs = fs
        self.path = path
        self._pos = 0
        self._size = int(fs.stat(path)["size"])

    def seek(self, offset: int, whence: int = 0) -> int:
        if whence == 0:
            self._pos = offset
        elif whence == 1:
            self._pos += offset
        elif whence == 2:
            self._pos = self._size + offset
        else:
            raise ValueError(f"bad whence {whence}")
        return self._pos

    def tell(self) -> int:
        return self._pos

    def read(self, length: Optional[int] = None) -> bytes:
        data = self.fs.read(self.path, self._pos, length)
        self._pos += len(data)
        return data

    @property
    def size(self) -> int:
        return self._size

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class GcsFuseLikeFS:
    """The paper's comparison baseline, faithfully naive.

    * 128 KiB request ceiling (FUSE default FUSE_MAX_PAGES_PER_REQ=32);
    * metadata HEAD against the object store on every open (no shared KV);
    * no readahead, no cross-file block cache, single-threaded fetches.

    Used by benchmarks/blocksize.py to reproduce Table IV's right column.
    """

    REQUEST_CEILING = 128 * perfmodel.KiB

    def __init__(self, store: ObjectStore):
        self.store = store
        self.stats = FestivusStats()

    def read(self, path: str, offset: int = 0, length: Optional[int] = None) -> bytes:
        try:
            meta = self.store.head(path)  # paid on every access
        except ObjectNotFound:
            raise FileNotFoundError(path) from None
        size = meta.size
        if length is None:
            length = size - offset
        length = max(0, min(length, size - offset))
        parts = []
        pos = offset
        while pos < offset + length:
            n = min(self.REQUEST_CEILING, offset + length - pos)
            parts.append(self.store.get_range(path, pos, n))
            self.stats.blocks_fetched += 1
            self.stats.bytes_fetched += n
            pos += n
        return b"".join(parts)
