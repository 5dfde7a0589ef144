"""Synthetic datasets mirroring the paper's four (§7.1, Fig. 15).

All generators are seed-deterministic and scale-parameterized so that the
CI tests run a ~1/1000 scale and the benchmarks a ~1/100 scale of the
paper's tuple counts, preserving the *ratios* every experiment depends on:

  tweets   — 56 locations; CA (key 6) is the heavy hitter, TX (key 48)
             second; CA:AZ = 6.85, CA:IL = 4.05 (paper §7.2); WV (key 54)
             is the small co-resident key on CA's worker at 48 cores.
  dsb      — sales fact table keyed by date (moderate skew), item (high
             skew), customer (mild skew): Zipf-like with different s.
  tpch     — Orders totalprice values, log-normal-ish (Fig. 15b), range
             partitioned for the Sort workflow.
  synthetic— W4's two-phase distribution change: 80% key 0 for the first
             quarter, then 60% key 0 / 20% key 10 (§7.8).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

Chunk = Tuple[np.ndarray, np.ndarray]

# --------------------------------------------------------------------- #
# Tweets (W1)                                                             #
# --------------------------------------------------------------------- #
NUM_LOCATIONS = 56
CA, TX, IL, AZ, WV = 6, 48, 17, 4, 54


def tweet_counts(scale: float = 1.0) -> np.ndarray:
    """Per-location tweet counts; paper ratios at scale=1.0 -> CA=26_000."""
    rng = np.random.default_rng(7)
    counts = np.maximum((rng.zipf(1.7, NUM_LOCATIONS) * 40).astype(np.int64), 120)
    counts = np.minimum(counts, 2_400)
    counts[CA] = 26_000
    counts[TX] = 20_000
    counts[IL] = round(26_000 / 4.05)      # 6_420
    counts[AZ] = round(26_000 / 6.85)      # 3_796
    counts[WV] = 600                        # the small key sharing CA's worker
    return np.maximum((counts * scale).astype(np.int64), 1)


def tweets_stream(scale: float = 1.0, seed: int = 0) -> Chunk:
    """Shuffled (location, value) stream of the filtered covid tweets."""
    counts = tweet_counts(scale)
    keys = np.repeat(np.arange(NUM_LOCATIONS, dtype=np.int64), counts)
    rng = np.random.default_rng(seed)
    rng.shuffle(keys)
    vals = rng.random(keys.size)
    return keys, vals


def slang_table() -> Chunk:
    """Build side of W1: one top-slang row per location."""
    keys = np.arange(NUM_LOCATIONS, dtype=np.int64)
    return keys, np.ones(NUM_LOCATIONS, dtype=np.float64)


# --------------------------------------------------------------------- #
# DSB-like sales (W2)                                                     #
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class DsbSpec:
    num_dates: int = 64        # moderate skew  (Fig. 15d)
    num_items: int = 128       # high skew      (Fig. 15e)
    num_customers: int = 256   # mild skew      (Fig. 15f)
    date_zipf: float = 1.25
    item_zipf: float = 2.0
    customer_zipf: float = 1.05


def _zipf_keys(n: int, num_keys: int, s: float, rng) -> np.ndarray:
    ranks = np.arange(1, num_keys + 1, dtype=np.float64)
    p = ranks ** (-s)
    p /= p.sum()
    return rng.choice(num_keys, size=n, p=p).astype(np.int64)


def dsb_sales(n: int, spec: DsbSpec = DsbSpec(), seed: int = 1):
    """Returns (date_keys, item_keys, customer_keys, values)."""
    rng = np.random.default_rng(seed)
    dates = _zipf_keys(n, spec.num_dates, spec.date_zipf, rng)
    items = _zipf_keys(n, spec.num_items, spec.item_zipf, rng)
    custs = _zipf_keys(n, spec.num_customers, spec.customer_zipf, rng)
    vals = rng.random(n)
    return dates, items, custs, vals


# --------------------------------------------------------------------- #
# TPC-H Orders (W3)                                                       #
# --------------------------------------------------------------------- #
def tpch_orders(n: int, seed: int = 2) -> np.ndarray:
    """totalprice values, mixture log-normal (Fig. 15b shape)."""
    rng = np.random.default_rng(seed)
    base = rng.lognormal(mean=10.9, sigma=0.45, size=n)
    # A low-price mode — TPC-H orders cluster below ~200k with a long tail.
    low = rng.lognormal(mean=10.0, sigma=0.3, size=n)
    pick = rng.random(n) < 0.35
    return np.where(pick, low, base)


def price_ranges(num_ranges: int, lo: float = 0.0, hi: float = 400_000.0) -> np.ndarray:
    """Equal-width range boundaries (the naive partitioner that skews)."""
    return np.linspace(lo, hi, num_ranges + 1)[1:-1]


def range_ids(vals: np.ndarray, bounds: np.ndarray) -> np.ndarray:
    return np.searchsorted(bounds, vals).astype(np.int64)


# --------------------------------------------------------------------- #
# Synthetic changing distribution (W4, §7.8)                              #
# --------------------------------------------------------------------- #
def synthetic_changing(n: int, num_keys: int = 42, seed: int = 3,
                       change_at: float = 0.25) -> Chunk:
    """First ``change_at`` of the stream: 80% key 0, rest uniform;
    afterwards: 60% key 0, 20% key 10, rest uniform (paper §7.8)."""
    rng = np.random.default_rng(seed)
    n1 = int(n * change_at)
    n2 = n - n1

    def mix(count, hot):
        ks = []
        for key, frac in hot:
            ks.append(np.full(int(count * frac), key, dtype=np.int64))
        rest = count - sum(a.size for a in ks)
        others = np.setdiff1d(np.arange(num_keys), [k for k, _ in hot])
        ks.append(rng.choice(others, size=rest).astype(np.int64))
        out = np.concatenate(ks)
        rng.shuffle(out)
        return out

    keys = np.concatenate([mix(n1, [(0, 0.8)]), mix(n2, [(0, 0.6), (10, 0.2)])])
    return keys, rng.random(keys.size)


def synthetic_small_table(num_keys: int = 42) -> Chunk:
    keys = np.arange(num_keys, dtype=np.int64)
    return keys, np.ones(num_keys, dtype=np.float64)
