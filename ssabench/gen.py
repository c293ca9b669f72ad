"""Inputs from a seed: lengths, residues and homologs.

Every draw goes through a ``numpy.random.Generator`` made from the run's
seed (and, for the sizes that have to stay the same for every seed, from a
fixed seed in the configuration or the traffic file). The same seed gives
the same inputs.
"""
from __future__ import annotations

import functools

import numpy as np


def rng(*seeds: int) -> np.random.Generator:
    """A generator for a tuple of whole numbers (any size, any sign)."""
    return np.random.default_rng([int(s) % (1 << 64) for s in seeds])


def lognormal_lengths(g: np.random.Generator, n: int, mean: float, sigma: float,
                      lo: int, hi: int) -> np.ndarray:
    """``n`` lengths, lognormal with the given mean and sigma, clipped."""
    mu = np.log(mean) - sigma**2 / 2
    return np.clip(np.rint(g.lognormal(mu, sigma, n)), lo, hi).astype(np.int64)


def residues(g: np.random.Generator, n: int, freqs) -> np.ndarray:
    """``n`` residue codes drawn by ``freqs`` (one weight a code), through a
    table of 65,536 entries, so a draw is one 16-bit integer."""
    return _table(tuple(freqs))[g.integers(0, 65536, n, dtype=np.uint16)]


@functools.lru_cache(maxsize=8)
def _table(freqs: tuple) -> np.ndarray:
    w = np.asarray(freqs, dtype=np.float64)
    edges = np.rint(np.cumsum(w / w.sum()) * 65536).astype(np.int64)
    return np.searchsorted(edges, np.arange(65536), side="right").astype(np.uint8)


def _indels(g, n: int, rate: float, mean: float):
    """Positions and lengths of about ``rate * n`` gap events (lengths
    geometric with the given mean)."""
    k = int(g.poisson(rate * n))
    return np.sort(g.integers(0, max(n, 1), k)), g.geometric(1.0 / mean, k)


def evolve(g: np.random.Generator, src: np.ndarray, target: int, sub_rate: float,
           indel_rate: float, indel_mean: float, freqs,
           layout: np.random.Generator | None = None) -> np.ndarray:
    """A homolog of ``src`` of exactly ``target`` residues: of a window of
    ``src`` as long as ``target`` where ``src`` is longer, substitutions at
    ``sub_rate``, deletions at ``indel_rate`` a residue, and insertions of
    drawn residues that make up the length, spread over as many events.

    ``layout`` draws where the window, the substitutions, the deletions and
    the insertions fall and how long each gap is; ``g`` the residues. One
    ``layout`` for every seed gives every seed the same alignment's shape."""
    lay = g if layout is None else layout
    if target < len(src):
        start = int(lay.integers(0, len(src) - target + 1))
        src = src[start : start + target]
    out = src.copy()
    hit = lay.random(len(out)) < sub_rate
    out[hit] = residues(g, int(hit.sum()), freqs)
    keep = np.ones(len(out), dtype=bool)
    pos, lens = _indels(lay, len(out), indel_rate / 2, indel_mean)
    for p, n in zip(pos, lens):
        keep[p : p + n] = False
    while keep.sum() > target:  # more to delete than the events took
        keep[lay.integers(0, len(keep))] = False
    out = out[keep]
    extra = target - len(out)
    if extra:
        k = max(1, len(pos))
        at = np.sort(lay.integers(0, len(out) + 1, k))
        sizes = lay.multinomial(extra, np.full(k, 1.0 / k))
        parts, prev = [], 0
        for a, n in zip(at, sizes):
            parts += [out[prev:a], residues(g, int(n), freqs)]
            prev = a
        parts.append(out[prev:])
        out = np.concatenate(parts)
    return out.astype(np.uint8)
