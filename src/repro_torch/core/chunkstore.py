"""Chunked n-dimensional array storage over festivus (the JPX tile role).

The paper's imagery is stored as internally-tiled JPEG 2000 with a
multi-resolution codestream (§III.C).  The general mechanism is a *chunked
array format over object storage*: each array is a manifest plus a grid of
independently-coded chunk objects, so

* reads of any region touch only the covering chunks (the paper's "read
  smaller portions of a file" requirement that broke gcsfuse),
* chunk size is the block-size knob of Table IV, chosen ~4 MiB,
* writers write disjoint chunks concurrently with no coordination,
* a multi-resolution pyramid provides the JPX progressive-decode analogue.

Layout under a root prefix::

    <root>/<name>/.manifest           JSON: shape/dtype/chunks/codec/pyramid
    <root>/<name>/c/<i>.<j>...        encoded chunk objects (C-order index)
    <root>/<name>/p<level>/c/...      pyramid levels (imagery only)

The checkpoint layer stores every parameter shard as a chunk grid here, and
the data pipeline reads training shards through the same path — the paper's
"everything is a file" discipline, applied to tensors.
"""

from __future__ import annotations

import dataclasses
import json
import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import codec as codec_mod
from repro_torch.core.festivus import Festivus

MANIFEST = ".manifest"


@dataclasses.dataclass(frozen=True)
class ArraySpec:
    name: str
    shape: Tuple[int, ...]
    dtype: str
    chunks: Tuple[int, ...]
    codec: str = "raw"
    fill_value: float = 0.0
    pyramid_levels: int = 0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(text: str) -> "ArraySpec":
        d = json.loads(text)
        d["shape"] = tuple(d["shape"])
        d["chunks"] = tuple(d["chunks"])
        return ArraySpec(**d)

    @property
    def grid(self) -> Tuple[int, ...]:
        return tuple(-(-s // c) for s, c in zip(self.shape, self.chunks))

    @property
    def nchunks(self) -> int:
        return int(np.prod(self.grid)) if self.grid else 1


def _chunk_key(root: str, name: str, idx: Sequence[int], level: int = 0) -> str:
    prefix = f"{root}/{name}" if level == 0 else f"{root}/{name}/p{level}"
    return f"{prefix}/c/{'.'.join(str(i) for i in idx)}"


def parse_chunk_key(root: str, key: str
                    ) -> Optional[Tuple[str, int, Tuple[int, ...]]]:
    """Invert :func:`_chunk_key`: object key -> (array name, level, chunk
    idx), or None for non-chunk keys (manifests, foreign prefixes).

    The write-invalidation path uses this to turn a festivus write hook
    (which only knows the object path) back into (array, chunk)
    coordinates, so derived-tile caches can evict exactly the tiles a
    chunk rewrite makes stale.
    """
    prefix = root.rstrip("/") + "/"
    if not key.startswith(prefix):
        return None
    parts = key[len(prefix):].split("/")
    if len(parts) < 3 or parts[-2] != "c":
        return None
    try:
        idx = tuple(int(p) for p in parts[-1].split("."))
    except ValueError:
        return None
    level, name_parts = 0, parts[:-2]
    last = name_parts[-1]
    if (len(name_parts) >= 2 and len(last) >= 2 and last[0] == "p"
            and last[1:].isdigit()):
        level = int(last[1:])
        name_parts = name_parts[:-1]
    return "/".join(name_parts), level, idx


def spatial_dims(shape: Sequence[int]) -> Tuple[int, int]:
    """Imagery convention: channel-last for rank >= 3 ([..., H, W, C]),
    plain [..., H, W] otherwise.  The single source of truth — the serving
    layer (repro.serve) addresses tiles with the same convention."""
    nd = len(shape)
    return (nd - 3, nd - 2) if nd >= 3 else (nd - 2, nd - 1)


def pyramid_level_shape(shape: Sequence[int], level: int) -> Tuple[int, ...]:
    """Shape of a pyramid level: spatial axes halved `level` times with a
    floor of 1 (an axis at the floor stops halving; build_pyramid pools
    it with window 1)."""
    if level == 0:
        return tuple(shape)
    out = list(shape)
    for d in spatial_dims(shape):
        out[d] = max(1, out[d] >> level)
    return tuple(out)


class ChunkStore:
    """Create/open chunked arrays on a Festivus mount."""

    def __init__(self, fs: Festivus, root: str = "arrays",
                 io_threads: int = 16):
        self.fs = fs
        self.root = root.rstrip("/")
        self._io_threads = io_threads
        self._pool_obj: Optional[ThreadPoolExecutor] = None

    @property
    def _pool(self) -> ThreadPoolExecutor:
        """Chunk fan-out pool, created on first threaded use.  An inline
        mount never touches it: the cluster DES builds one ChunkStore per
        simulated node, and eager pools would pin nodes x io_threads idle
        OS threads under a simulation that runs one handler at a time."""
        if self._pool_obj is None:
            self._pool_obj = ThreadPoolExecutor(max_workers=self._io_threads,
                                                thread_name_prefix="chunkstore")
        return self._pool_obj

    def _map(self, fn, items):
        """Apply `fn` over chunk work items, yielding results in input
        order.  Threaded fan-out normally; a plain sequential map when the
        mount is inline (``FestivusConfig.inline_fetch`` — the virtual-time
        DES).  Festivus runs no pool threads of its own under the DES, but
        the chunkstore pool survived, leaking real concurrency (and a
        read-modify-write race) into a simulation that models I/O time
        analytically.  ``ThreadPoolExecutor.map`` also yields in input
        order, so the two paths are bit-identical."""
        if self.fs.config.inline_fetch:
            return [fn(item) for item in items]
        return self._pool.map(fn, items)

    # -- lifecycle -----------------------------------------------------------
    def create(self, name: str, shape: Sequence[int], dtype,
               chunks: Sequence[int], codec: str = "raw",
               pyramid_levels: int = 0) -> "ChunkedArray":
        shape = tuple(int(s) for s in shape)
        chunks = tuple(int(c) for c in chunks)
        if len(shape) != len(chunks):
            raise ValueError(f"rank mismatch: shape {shape} vs chunks {chunks}")
        if any(c <= 0 for c in chunks):
            raise ValueError(f"non-positive chunk dims: {chunks}")
        codec_mod.by_name(codec)  # validate
        spec = ArraySpec(name=name, shape=shape, dtype=np.dtype(dtype).str,
                         chunks=chunks, codec=codec,
                         pyramid_levels=pyramid_levels)
        self.fs.write(f"{self.root}/{name}/{MANIFEST}",
                      spec.to_json().encode())
        return ChunkedArray(self, spec)

    def open(self, name: str) -> "ChunkedArray":
        raw = self.fs.read(f"{self.root}/{name}/{MANIFEST}")
        return ChunkedArray(self, ArraySpec.from_json(raw.decode()))

    def exists(self, name: str) -> bool:
        return self.fs.exists(f"{self.root}/{name}/{MANIFEST}")

    def delete(self, name: str) -> None:
        prefix = f"{self.root}/{name}"
        for key in self.fs.store.list(prefix + "/"):
            self.fs.delete(key)

    def list_arrays(self) -> List[str]:
        names = set()
        for key in self.fs.store.list(self.root + "/"):
            rest = key[len(self.root) + 1:]
            if rest.endswith(MANIFEST):
                names.add(rest[: -len(MANIFEST) - 1])
        return sorted(names)


class ChunkedArray:
    """One chunked array; region reads/writes + pyramid access."""

    def __init__(self, store: ChunkStore, spec: ArraySpec):
        self.store = store
        self.spec = spec
        self._np_dtype = np.dtype(spec.dtype)
        self._codec = codec_mod.by_name(spec.codec)
        #: per-handle level-built cache, keyed by the array write
        #: generation it was validated at (level -> generation).  While the
        #: generation is unchanged this costs one metadata-KV check per
        #: handle (what read-only serving always paid); any write bumps the
        #: generation — observed through the KV's uncounted watch channel
        #: (:meth:`MetadataStore.peek`) — forcing a counted revalidation, so
        #: a stale handle can no longer serve a level that re-ingest
        #: invalidated underneath it.
        self._built_levels: dict = {}

    # -- chunk primitives -----------------------------------------------------
    def _key(self, idx: Sequence[int], level: int = 0) -> str:
        return _chunk_key(self.store.root, self.spec.name, idx, level)

    def write_chunk(self, idx: Sequence[int], data: np.ndarray) -> None:
        idx = tuple(int(i) for i in idx)
        self._put_chunk(idx, data)
        self._note_writes([idx])

    def _put_chunk(self, idx: Tuple[int, ...], data: np.ndarray) -> None:
        """Encode + PUT one level-0 chunk, with no dirty-set bookkeeping
        (region writes batch theirs into one KV round-trip)."""
        expected = self.chunk_shape(idx)
        if tuple(data.shape) != expected:
            raise ValueError(
                f"chunk {idx} of {self.spec.name}: shape {data.shape} != {expected}")
        data = np.ascontiguousarray(data, dtype=self._np_dtype)
        self.store.fs.write(self._key(idx), self._codec.encode(data.tobytes()))

    def read_chunk(self, idx: Sequence[int], level: int = 0) -> np.ndarray:
        idx = tuple(int(i) for i in idx)
        shape = self.chunk_shape(idx, level)
        key = self._key(idx, level)
        if not self.store.fs.exists(key):
            return np.full(shape, self.spec.fill_value, dtype=self._np_dtype)
        # read_view: the codec decodes straight out of the block cache /
        # store buffer (raw chunks: zero copies until the final owned
        # ndarray) — same block requests and modeled service time as read()
        raw = codec_mod.decode(self.store.fs.read_view(key))
        return np.frombuffer(raw, dtype=self._np_dtype).reshape(shape).copy()

    def chunk_exists(self, idx: Sequence[int]) -> bool:
        return self.store.fs.exists(self._key(tuple(int(i) for i in idx)))

    def chunk_shape(self, idx: Sequence[int], level: int = 0) -> Tuple[int, ...]:
        shape = self.level_shape(level)
        return tuple(min(c, s - i * c)
                     for i, s, c in zip(idx, shape, self.spec.chunks))

    def chunk_indices(self) -> Iterator[Tuple[int, ...]]:
        yield from np.ndindex(*self.spec.grid)

    # -- dirty-chunk tracking (the ingest wheel's incremental-rebuild state) --
    @property
    def _gen_key(self) -> str:
        return f"arraygen:{self.store.root}/{self.spec.name}"

    @property
    def _dirty_key(self) -> str:
        return f"dirty:{self.store.root}/{self.spec.name}"

    def generation(self) -> int:
        """The array's write generation: 0 until the first write, bumped
        once per write_region/write_chunk/pyramid build.  Read through the
        KV watch channel (uncounted — see :meth:`MetadataStore.peek`), so
        polling it is free; changing it costs the writer a counted incr."""
        return int(self.store.fs.meta.peek(self._gen_key, 0))

    def _note_writes(self, indices: Sequence[Tuple[int, ...]]) -> None:
        """Record level-0 chunk rewrites in the shared KV: the dirty set
        (what an incremental pyramid rebuild re-pools) and the write
        generation (what invalidates per-handle level caches) — one hmset
        plus one incr no matter how many chunks the region touched."""
        if not indices:
            return
        meta = self.store.fs.meta
        meta.hmset(self._dirty_key,
                   {".".join(str(i) for i in idx): 1 for idx in indices})
        meta.incr(self._gen_key)

    def dirty_chunks(self) -> List[Tuple[int, ...]]:
        """Level-0 chunks written since the last pyramid build (sorted)."""
        raw = self.store.fs.meta.hgetall(self._dirty_key)
        return sorted(tuple(int(p) for p in field.split("."))
                      for field in raw)

    # -- region I/O -------------------------------------------------------------
    def _covering(self, start: Sequence[int], stop: Sequence[int]):
        los = [s // c for s, c in zip(start, self.spec.chunks)]
        his = [-(-e // c) for e, c in zip(stop, self.spec.chunks)]
        yield from np.ndindex(*[h - l for l, h in zip(los, his)])
        # note: caller adds `los` back; see read_region

    def read_region(self, start: Sequence[int], stop: Sequence[int],
                    level: int = 0) -> np.ndarray:
        """Read [start, stop) assembling covering chunks (fetched in parallel).

        With ``level > 0`` the region is addressed in that pyramid level's
        coordinate space (:meth:`level_shape`) and assembled from the level's
        chunk grid — the JPX progressive-decode path a tile server uses to
        serve an overview without touching full-resolution data.
        """
        if not (0 <= level <= self.spec.pyramid_levels):
            raise ValueError(
                f"level {level} outside pyramid of {self.spec.name} "
                f"(levels 0..{self.spec.pyramid_levels})")
        if level > 0:
            # an unbuilt level must raise like read_level, not silently
            # assemble fill values (level 0's sparse semantics don't apply:
            # only build_pyramid can populate a level's chunks)
            self._check_level_built(level)
        shape = self.level_shape(level)
        start = tuple(int(s) for s in start)
        stop = tuple(int(s) for s in stop)
        for s, e, dim in zip(start, stop, shape):
            if not (0 <= s <= e <= dim):
                raise ValueError(
                    f"region {start}..{stop} outside {shape} (level {level})")
        out = np.full(tuple(e - s for s, e in zip(start, stop)),
                      self.spec.fill_value, dtype=self._np_dtype)
        los = [s // c for s, c in zip(start, self.spec.chunks)]
        his = [-(-e // c) for e, c in zip(stop, self.spec.chunks)]

        def fetch(rel_idx):
            idx = tuple(l + r for l, r in zip(los, rel_idx))
            chunk = self.read_chunk(idx, level)
            src, dst = [], []
            for d, (i, c) in enumerate(zip(idx, self.spec.chunks)):
                c0 = i * c
                lo = max(start[d], c0)
                hi = min(stop[d], c0 + chunk.shape[d])
                src.append(slice(lo - c0, hi - c0))
                dst.append(slice(lo - start[d], hi - start[d]))
            return tuple(dst), chunk[tuple(src)]

        rels = list(np.ndindex(*[h - l for l, h in zip(los, his)]))
        for dst, piece in self.store._map(fetch, rels):
            out[dst] = piece
        return out

    #: the serving-layer spelling: any region, any pyramid level
    read = read_region

    def write_region(self, start: Sequence[int], data: np.ndarray) -> None:
        """Write a region; only whole-chunk-aligned writes touch one object
        per chunk.  Unaligned edges do read-modify-write (documented cost)
        under a per-chunk KV lock: two concurrent writers sharing a
        boundary chunk serialize their RMW instead of one losing the
        other's update (the lock key lives in the shared metadata KV, so
        it serializes across mounts/nodes, not just threads of one pool).
        """
        start = tuple(int(s) for s in start)
        stop = tuple(s + d for s, d in zip(start, data.shape))
        los = [s // c for s, c in zip(start, self.spec.chunks)]
        his = [-(-e // c) for e, c in zip(stop, self.spec.chunks)]

        def put(rel_idx):
            idx = tuple(l + r for l, r in zip(los, rel_idx))
            cshape = self.chunk_shape(idx)
            src, dst = [], []
            aligned = True
            for d, (i, c) in enumerate(zip(idx, self.spec.chunks)):
                c0 = i * c
                lo = max(start[d], c0)
                hi = min(stop[d], c0 + cshape[d])
                aligned &= (lo == c0 and hi == c0 + cshape[d])
                dst.append(slice(lo - c0, hi - c0))
                src.append(slice(lo - start[d], hi - start[d]))
            if aligned:
                chunk = np.ascontiguousarray(data[tuple(src)], dtype=self._np_dtype)
                self._put_chunk(idx, chunk)
                return idx
            meta = self.store.fs.meta
            lock_key = f"lock:{self._key(idx)}"
            while not meta.setnx(lock_key, 1):
                # threaded mounts only: the DES runs one handler at a time,
                # so under virtual time the lock is always free on first try
                time.sleep(0.0002)
            try:
                chunk = self.read_chunk(idx)
                chunk[tuple(dst)] = data[tuple(src)]
                self._put_chunk(idx, chunk)
            finally:
                meta.delete(lock_key)
            return idx

        rels = list(np.ndindex(*[h - l for l, h in zip(los, his)]))
        self._note_writes(list(self.store._map(put, rels)))

    def read_all(self) -> np.ndarray:
        return self.read_region((0,) * len(self.spec.shape), self.spec.shape)

    # -- multi-resolution pyramid (JPX codestream analogue) ---------------------
    def _spatial_dims(self) -> Tuple[int, int]:
        return spatial_dims(self.spec.shape)

    def level_shape(self, level: int) -> Tuple[int, ...]:
        return pyramid_level_shape(self.spec.shape, level)

    @property
    def _pyramid_key(self) -> str:
        return f"pyramid:{self.store.root}/{self.spec.name}"

    def _check_level_built(self, level: int) -> None:
        gen = self.generation()
        if self._built_levels.get(level) == gen:
            return
        raw = self.store.fs.meta.hget(self._pyramid_key, str(level))
        if raw is None:
            self._built_levels.pop(level, None)
            raise KeyError(
                f"pyramid level {level} not built for {self.spec.name}")
        self._built_levels[level] = gen

    def _pool_windows(self) -> List[Tuple[int, int]]:
        """Per-level (ph, pw) mean-pool windows, from the *global* level
        dims: an axis already at its max(1, ...) floor stops halving (pool
        window 1 keeps it while the other axis keeps downsampling).  The
        single schedule both rebuild paths follow — which is what makes
        them bit-identical."""
        dh, dw = self._spatial_dims()
        h, w = self.spec.shape[dh], self.spec.shape[dw]
        windows = []
        for _ in range(self.spec.pyramid_levels):
            ph, pw = (2 if h >= 2 else 1), (2 if w >= 2 else 1)
            windows.append((ph, pw))
            h, w = h // ph, w // pw
        return windows

    def _finish_pyramid_build(self) -> None:
        """Shared build epilogue: the dirty set is consumed and the write
        generation bumps, so every handle revalidates its level cache."""
        meta = self.store.fs.meta
        gen = meta.incr(self._gen_key)
        meta.delete(self._dirty_key)
        self._built_levels = {level: gen
                              for level in range(1, self.spec.pyramid_levels + 1)}

    def pyramid_built(self) -> bool:
        """True when every configured level is recorded in the KV."""
        if self.spec.pyramid_levels <= 0:
            return True
        recorded = self.store.fs.meta.hgetall(self._pyramid_key)
        return all(str(level) in recorded
                   for level in range(1, self.spec.pyramid_levels + 1))

    def build_pyramid(self, full: bool = False) -> int:
        """Build/refresh the 2x-downsampled mean-pool pyramid; returns the
        number of level-chunk objects written.

        Incremental by default: when every level is already recorded in
        the metadata KV, only the *ancestors of currently-dirty level-0
        chunks* are re-pooled (each recomputed from its exact level-0
        footprint through the same float64 pooling chain), so a wheel pass
        over a small ingested batch rewrites a handful of chunk objects
        instead of re-encoding the whole pyramid.  ``full=True`` forces
        the from-scratch rebuild — the cross-check oracle the tests pin
        the incremental path against, and the only path when the pyramid
        has never been built.  Both paths consume the dirty set and bump
        the array generation.
        """
        if self.spec.pyramid_levels <= 0:
            return 0
        if not full and self.pyramid_built():
            return self._build_pyramid_incremental()
        return self._build_pyramid_full()

    def _build_pyramid_full(self) -> int:
        dh, dw = self._spatial_dims()  # always adjacent: dw == dh + 1
        current = self.read_all().astype(np.float64)
        writes = 0
        for level, (ph, pw) in enumerate(self._pool_windows(), start=1):
            h, w = current.shape[dh], current.shape[dw]
            h2, w2 = h // ph, w // pw
            sl = [slice(None)] * current.ndim
            sl[dh], sl[dw] = slice(0, h2 * ph), slice(0, w2 * pw)
            c = current[tuple(sl)]
            new_shape = c.shape[:dh] + (h2, ph, w2, pw) + c.shape[dh + 2:]
            current = c.reshape(new_shape).mean(axis=(dh + 1, dh + 3))
            data = np.ascontiguousarray(current).astype(self._np_dtype)
            grid = tuple(-(-s // ch) for s, ch in
                         zip(data.shape, self.spec.chunks))
            for idx in np.ndindex(*grid):
                sl = tuple(slice(i * ch, min((i + 1) * ch, s))
                           for i, ch, s in zip(idx, self.spec.chunks, data.shape))
                self.store.fs.write(self._key(idx, level),
                                    self._codec.encode(
                                        np.ascontiguousarray(data[sl]).tobytes()))
                writes += 1
            # stash level shape in the metadata KV for readers
            self.store.fs.meta.hset(self._pyramid_key, str(level),
                                    json.dumps(list(data.shape)))
        self._finish_pyramid_build()
        return writes

    def _build_pyramid_incremental(self) -> int:
        dirty = self.dirty_chunks()
        if not dirty:
            return 0
        dh, dw = self._spatial_dims()
        ch_h, ch_w = self.spec.chunks[dh], self.spec.chunks[dw]
        h0, w0 = self.spec.shape[dh], self.spec.shape[dw]
        windows = self._pool_windows()
        writes = 0
        sh = sw = 1  # accumulated downsample factor up to `level`
        for level, (ph, pw) in enumerate(windows, start=1):
            sh *= ph
            sw *= pw
            lshape = self.level_shape(level)
            h_l, w_l = lshape[dh], lshape[dw]
            affected = set()
            for idx in dirty:
                # the dirty chunk's level-0 footprint, projected down to
                # `level` (pixels past the level's h_l * sh clip influence
                # nothing — the pooling slice drops them)
                r0 = (idx[dh] * ch_h) // sh
                r1 = min(-(-min((idx[dh] + 1) * ch_h, h0) // sh), h_l)
                c0 = (idx[dw] * ch_w) // sw
                c1 = min(-(-min((idx[dw] + 1) * ch_w, w0) // sw), w_l)
                if r1 <= r0 or c1 <= c0:
                    continue
                for ry in range(r0 // ch_h, -(-r1 // ch_h)):
                    for rx in range(c0 // ch_w, -(-c1 // ch_w)):
                        lidx = list(idx)
                        lidx[dh], lidx[dw] = ry, rx
                        affected.add(tuple(lidx))
            for lidx in sorted(affected):
                self._rebuild_level_chunk(lidx, level, windows[:level],
                                          sh, sw)
                writes += 1
        self._finish_pyramid_build()
        return writes

    def _rebuild_level_chunk(self, lidx: Tuple[int, ...], level: int,
                             windows: List[Tuple[int, int]],
                             sh: int, sw: int) -> None:
        """Recompute one level-`level` chunk from its exact level-0
        footprint, through the same float64 pooling chain (same windows,
        same reduction order) as the full rebuild — bit-identical output,
        touching only the chunk's own source region."""
        dh, dw = self._spatial_dims()
        cshape = self.chunk_shape(lidx, level)
        start = [i * c for i, c in zip(lidx, self.spec.chunks)]
        stop = [min(s + c, dim)
                for s, c, dim in zip(start, self.spec.chunks, self.spec.shape)]
        # spatial extent at `level`, mapped back to level 0 (always inside
        # the array: level dims are floor-divided by the window product)
        start[dh] = lidx[dh] * self.spec.chunks[dh] * sh
        stop[dh] = start[dh] + cshape[dh] * sh
        start[dw] = lidx[dw] * self.spec.chunks[dw] * sw
        stop[dw] = start[dw] + cshape[dw] * sw
        cur = self.read_region(tuple(start), tuple(stop)).astype(np.float64)
        for ph, pw in windows:
            h2, w2 = cur.shape[dh] // ph, cur.shape[dw] // pw
            new_shape = cur.shape[:dh] + (h2, ph, w2, pw) + cur.shape[dh + 2:]
            cur = cur.reshape(new_shape).mean(axis=(dh + 1, dh + 3))
        data = np.ascontiguousarray(cur).astype(self._np_dtype)
        self.store.fs.write(self._key(lidx, level),
                            self._codec.encode(
                                np.ascontiguousarray(data).tobytes()))

    def invalidate_pyramid(self) -> None:
        """Drop every pyramid level from the metadata KV and bump the
        write generation: all handles' next level read raises KeyError
        instead of serving a stale level forever (the per-handle
        `_built_levels` cache revalidates on the generation change)."""
        meta = self.store.fs.meta
        for level in range(1, self.spec.pyramid_levels + 1):
            meta.hdel(self._pyramid_key, str(level))
        meta.incr(self._gen_key)
        self._built_levels.clear()

    def read_level(self, level: int) -> np.ndarray:
        if level == 0:
            return self.read_all()
        raw = self.store.fs.meta.hget(
            f"pyramid:{self.store.root}/{self.spec.name}", str(level))
        if raw is None:
            raise KeyError(f"pyramid level {level} not built for {self.spec.name}")
        shape = tuple(json.loads(raw))
        out = np.zeros(shape, dtype=self._np_dtype)
        grid = tuple(-(-s // c) for s, c in zip(shape, self.spec.chunks))
        for idx in np.ndindex(*grid):
            sl = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(idx, self.spec.chunks, shape))
            cshape = tuple(s.stop - s.start for s in sl)
            raw_chunk = codec_mod.decode(self.store.fs.read(self._key(idx, level)))
            out[sl] = np.frombuffer(raw_chunk, dtype=self._np_dtype).reshape(cshape)
        return out
