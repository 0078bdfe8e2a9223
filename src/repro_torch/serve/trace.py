"""Request-trace generation: Zipf popularity + load spikes.

Web-map traffic is famously skewed — a few hot tiles (cities, coastlines)
absorb most requests, and events produce sharp load spikes on top of a
steady base rate.  This module generates deterministic synthetic traces
with both properties:

* **Zipf popularity** — tile k (in a seeded random popularity order) is
  requested with probability proportional to ``1 / rank^alpha``.
* **Spikes** — piecewise-constant rate multipliers over time windows
  (:class:`Spike`), driving an inhomogeneous Poisson arrival process.
  :func:`diurnal_spikes` and :func:`flash_crowd_spikes` build the two
  canonical web-traffic shapes out of spike windows.

Generation is numpy-bulk end to end (the time-rescaling construction:
draw unit-exponential arrival levels in bulk, invert the piecewise-linear
cumulative hazard with one ``np.interp``), so a million-request trace
costs a few bulk draws, not a million scalar RNG round-trips.

Everything is seeded, so a trace is a pure function of its parameters —
the serving benchmark's runs are reproducible records.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.chunkstore import pyramid_level_shape
from repro_torch.serve.tileserver import TileRequest, tile_grid


@dataclasses.dataclass(frozen=True)
class Spike:
    """Rate multiplier over [t0, t1): offered load = base * multiplier."""

    t0: float
    t1: float
    multiplier: float

    def __post_init__(self):
        if self.t1 <= self.t0:
            raise ValueError(f"empty spike window [{self.t0}, {self.t1})")
        if self.multiplier <= 0:
            raise ValueError(f"non-positive spike multiplier {self.multiplier}")

    def contains(self, t: float) -> bool:
        """True iff `t` falls inside the spike window [t0, t1) — what the
        serving benchmark checks autoscaler join timestamps against."""
        return self.t0 <= t < self.t1


def rate_at(t: float, base_rps: float, spikes: Sequence[Spike]) -> float:
    """Offered request rate at instant t (overlapping spikes compound)."""
    rate = base_rps
    for s in spikes:
        if s.t0 <= t < s.t1:
            rate *= s.multiplier
    return rate


def diurnal_spikes(duration_s: float, period_s: float,
                   peak_multiplier: float, steps: int = 8) -> Tuple[Spike, ...]:
    """A diurnal load cycle as non-overlapping spike windows.

    Each period is cut into `steps` equal windows whose multipliers trace
    a raised cosine from trough (1.0, "night") to `peak_multiplier`
    ("evening peak") and back — the piecewise-constant stand-in for the
    day/night traffic swing a global map tier sees.
    """
    if period_s <= 0 or duration_s <= 0:
        raise ValueError(f"need positive duration/period, got "
                         f"{duration_s}/{period_s}")
    if peak_multiplier <= 1.0:
        raise ValueError(f"peak_multiplier must exceed 1, got "
                         f"{peak_multiplier}")
    if steps < 2:
        raise ValueError(f"need >= 2 steps per period, got {steps}")
    out: List[Spike] = []
    step = period_s / steps
    t = 0.0
    while t < duration_s:
        j = round(t / step) % steps
        mult = 1.0 + (peak_multiplier - 1.0) * 0.5 * (
            1.0 - math.cos(2.0 * math.pi * (j + 0.5) / steps))
        t1 = min(t + step, duration_s)
        if mult > 1.0 + 1e-9:
            out.append(Spike(t, t1, mult))
        t += step
    return tuple(out)


def flash_crowd_spikes(t0: float, peak_multiplier: float, *,
                       peak_s: float, decay_s: float,
                       decay_steps: int = 5,
                       decay: float = 0.5) -> Tuple[Spike, ...]:
    """A flash crowd: instant onset at `t0`, geometric cool-down after.

    The peak multiplier holds for `peak_s`, then each of `decay_steps`
    windows of `decay_s` multiplies the *excess* over base by `decay` —
    the "everyone loads the event map at once, then drifts away" shape
    that stresses predictive scale-out harder than a symmetric spike.
    """
    if t0 < 0 or peak_s <= 0 or decay_s <= 0:
        raise ValueError(f"need t0 >= 0 and positive peak_s/decay_s, got "
                         f"{t0}/{peak_s}/{decay_s}")
    if peak_multiplier <= 1.0:
        raise ValueError(f"peak_multiplier must exceed 1, got "
                         f"{peak_multiplier}")
    if not 0.0 < decay < 1.0:
        raise ValueError(f"decay must be in (0, 1), got {decay}")
    out = [Spike(t0, t0 + peak_s, peak_multiplier)]
    t = t0 + peak_s
    excess = peak_multiplier - 1.0
    for _ in range(decay_steps):
        excess *= decay
        if excess < 0.05:
            break
        out.append(Spike(t, t + decay_s, 1.0 + excess))
        t += decay_s
    return tuple(out)


def tile_universe(shape: Sequence[int], pyramid_levels: int, tile_px: int,
                  array: str = "composite") -> List[Tuple[str, int, int, int]]:
    """Every addressable (array, level, x, y) across the pyramid (level
    shapes from the chunkstore's own halving rule, so the universe matches
    what a TileServer can actually serve)."""
    out = []
    for level in range(pyramid_levels + 1):
        ny, nx = tile_grid(pyramid_level_shape(shape, level), tile_px)
        for y in range(ny):
            for x in range(nx):
                out.append((array, level, x, y))
    return out


def _hazard_knots(duration_s: float, base_rps: float,
                  spikes: Sequence[Spike]):
    """(time knots, cumulative-hazard knots) of the piecewise-constant
    rate function over [0, duration_s] — the inversion table for the
    time-rescaling construction."""
    edges = {0.0, duration_s}
    for s in spikes:
        if s.t0 < duration_s and s.t1 > 0.0:
            edges.add(max(0.0, s.t0))
            edges.add(min(duration_s, s.t1))
    t_knots = np.array(sorted(edges))
    rates = np.array([rate_at(t, base_rps, spikes) for t in t_knots[:-1]])
    lam_knots = np.concatenate(([0.0], np.cumsum(rates * np.diff(t_knots))))
    return t_knots, lam_knots


def zipf_spike_trace(universe: Sequence[Tuple[str, int, int, int]],
                     duration_s: float, base_rps: float,
                     alpha: float = 1.1, spikes: Sequence[Spike] = (),
                     seed: int = 0,
                     formats: Optional[Sequence[Tuple[str, float]]] = None,
                     region: str = "",
                     ) -> List[TileRequest]:
    """Deterministic Zipf-popularity trace with spike windows.

    Tiles are ranked by a seeded shuffle of `universe`; request k picks a
    tile with probability ∝ ``1 / rank^alpha``.  Arrivals follow the
    exact inhomogeneous Poisson process of the piecewise-constant rate
    (base × compounded spike multipliers), via time rescaling: bulk
    unit-exponential levels are inverted through the cumulative hazard
    in one vectorized pass — no per-request RNG round-trips, so a
    million-request trace generates in bulk-numpy time.

    `formats` optionally assigns each request an encode format, as
    ``(name, weight)`` pairs (e.g. ``(("png", 0.3), ("jpeg", 0.7))``);
    None leaves every request on the default raw format and draws no
    extra random numbers.  `region` stamps every request with a client
    source region (no extra draws; "" keeps the untagged legacy shape).
    """
    if not universe:
        raise ValueError("empty tile universe")
    if duration_s <= 0 or base_rps <= 0:
        raise ValueError(f"need positive duration/rate, got "
                         f"{duration_s}/{base_rps}")
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(universe))
    ranks = np.arange(1, len(universe) + 1, dtype=np.float64)
    probs = ranks ** -alpha
    probs /= probs.sum()
    t_knots, lam_knots = _hazard_knots(duration_s, base_rps, spikes)
    total = float(lam_knots[-1])
    # bulk unit-exponential levels until the hazard budget is exceeded
    # (one draw almost always suffices: 10 sigma of headroom)
    parts: List[np.ndarray] = []
    acc = 0.0
    block = int(total + 10.0 * math.sqrt(total) + 16.0)
    while acc < total:
        cum = np.cumsum(rng.exponential(1.0, size=block)) + acc
        parts.append(cum)
        acc = float(cum[-1])
    levels = np.concatenate(parts)
    levels = levels[levels < total]
    ts = np.interp(levels, lam_knots, t_knots)
    n = len(ts)
    if n == 0:
        raise ValueError("trace came out empty; raise duration_s * base_rps")
    picks = order[rng.choice(len(universe), size=n, p=probs)]
    fmt_names: Optional[List[str]] = None
    if formats is not None:
        if not formats:
            raise ValueError("empty formats sequence (pass None for raw)")
        weights = np.array([w for _, w in formats], dtype=np.float64)
        if (weights <= 0).any():
            raise ValueError(f"format weights must be positive: {formats}")
        fmt_idx = rng.choice(len(formats), size=n, p=weights / weights.sum())
        names = [name for name, _ in formats]
        fmt_names = [names[i] for i in fmt_idx]
    trace: List[TileRequest] = []
    uni = universe
    if fmt_names is None:
        for t, k in zip(ts.tolist(), picks.tolist()):
            array, level, x, y = uni[k]
            trace.append(TileRequest(t=t, level=level, x=x, y=y, array=array,
                                     region=region))
    else:
        for t, k, fmt in zip(ts.tolist(), picks.tolist(), fmt_names):
            array, level, x, y = uni[k]
            trace.append(TileRequest(t=t, level=level, x=x, y=y, array=array,
                                     fmt=fmt, region=region))
    return trace


def continental_universes(shape: Sequence[int], pyramid_levels: int,
                          tile_px: int, regions: Sequence[str],
                          array: str = "composite",
                          ) -> Dict[str, List[Tuple[str, int, int, int]]]:
    """Partition the tile universe into per-region (continental) views.

    Clients on each continent browse *their own* part of the world: every
    level below the coarsest is split into longitude bands — tile column
    x belongs to ``regions[x * len(regions) // nx]`` — while the coarsest
    level (the world overview every map session opens on) is shared by
    all regions.  The per-region universes are what give per-region edge
    caches genuinely distinct working sets: a Europe edge full of Europe
    tiles cannot answer Asia's traffic.
    """
    if not regions:
        raise ValueError("need at least one region")
    if len(set(regions)) != len(regions):
        raise ValueError(f"duplicate regions in {regions}")
    out: Dict[str, List[Tuple[str, int, int, int]]] = {r: [] for r in regions}
    nreg = len(regions)
    for level in range(pyramid_levels + 1):
        ny, nx = tile_grid(pyramid_level_shape(shape, level), tile_px)
        for y in range(ny):
            for x in range(nx):
                tile = (array, level, x, y)
                if level == pyramid_levels:
                    for r in regions:
                        out[r].append(tile)
                else:
                    out[regions[x * nreg // nx]].append(tile)
    return out


def geo_trace(universes: Dict[str, Sequence[Tuple[str, int, int, int]]],
              duration_s: float, base_rps,
              alpha: float = 1.1, spikes=None, seed: int = 0,
              formats: Optional[Sequence[Tuple[str, float]]] = None,
              ) -> List[TileRequest]:
    """A multi-continent trace: one Zipf/spike trace per region, merged.

    `universes` maps each client region to its tile universe (see
    :func:`continental_universes`); `base_rps` is one rate for all
    regions or a ``{region: rps}`` dict (continents differ in traffic);
    `spikes` likewise one spike sequence for all or a per-region dict.
    Each region draws an independent seeded trace over *its* universe
    (own popularity permutation, own arrival process) and the results
    merge by arrival time — so the blend is deterministic, and any
    region's sub-trace is recoverable by filtering on ``req.region``.
    """
    traces: List[List[TileRequest]] = []
    for i, region in enumerate(sorted(universes)):
        rps = base_rps[region] if isinstance(base_rps, dict) else base_rps
        if isinstance(spikes, dict):
            sp = spikes.get(region, ())
        else:
            sp = spikes if spikes is not None else ()
        traces.append(zipf_spike_trace(
            universes[region], duration_s, rps, alpha=alpha, spikes=sp,
            seed=seed + 7919 * (i + 1), formats=formats, region=region))
    merged = [r for tr in traces for r in tr]
    merged.sort(key=lambda r: r.t)
    return merged
