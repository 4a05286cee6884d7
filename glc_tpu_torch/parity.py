"""The contract between two encodes of the same input (numpy only).

Two containers agree when their headers, gapless info, frame counts and
raw masks are equal and their quantized pairs are equal except for flips:
a pair kept by one encode only (the keep gate sits on a threshold), or a
value that differs by ±1 (a rounding tie moved by an ulp of the MDCT).
The JAX package measured such flips on 0.19% of pairs between its TPU and
CPU runs; the contract allows 1%.  Used by the tests (port vs JAX package)
and by ``chip_smoke.py`` (card vs CPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np

MAX_FLIP_RATE = 0.01


def _positions(fs, n: int):
    rows = np.repeat(np.arange(fs.nnz.size, dtype=np.int64), fs.nnz.reshape(-1))
    return rows * n + fs.pairs["k"].astype(np.int64), fs.pairs["q"].astype(np.int64)


def pair_flips(fs_a, fs_b, n: int = 1024) -> dict:
    """Compare the pairs of two FrameSets of equal shape.

    Returns a dict: ``kept`` (positions kept by either), ``gate`` (kept by
    one only), ``pm1`` (values that differ by exactly 1), ``max_dq`` (the
    largest difference of a position kept by both) and ``rate``
    ((gate + pm1) / kept)."""
    pa, qa = _positions(fs_a, n)
    pb, qb = _positions(fs_b, n)
    common, ia, ib = np.intersect1d(pa, pb, assume_unique=True,
                                    return_indices=True)
    dq = np.abs(qa[ia] - qb[ib])
    kept = len(pa) + len(pb) - len(common)
    gate = kept - len(common)
    pm1 = int(np.count_nonzero(dq == 1))
    return {
        "kept": int(kept),
        "gate": int(gate),
        "pm1": pm1,
        "max_dq": int(dq.max(initial=0)),
        "rate": (gate + pm1) / max(kept, 1),
    }


def dense_pair_flips(q_a: np.ndarray, q_b: np.ndarray) -> dict:
    """`pair_flips` of two dense quantized arrays of equal shape (the q of
    ``encode_chunk_device`` or ``encode_math``): a position is kept where
    its q is nonzero."""
    if q_a.shape != q_b.shape:
        raise AssertionError(f"q shapes differ: {q_a.shape} vs {q_b.shape}")
    ka, kb = q_a != 0, q_b != 0
    dq = np.abs(q_a.astype(np.int64) - q_b.astype(np.int64))[ka & kb]
    kept = int(np.count_nonzero(ka | kb))
    gate = int(np.count_nonzero(ka != kb))
    pm1 = int(np.count_nonzero(dq == 1))
    return {
        "kept": kept,
        "gate": gate,
        "pm1": pm1,
        "max_dq": int(dq.max(initial=0)),
        "rate": (gate + pm1) / max(kept, 1),
    }


def check_containers(ea, eb, n: int = 1024) -> dict:
    """Raise AssertionError unless two EncodedAudio agree within the
    contract; return the `pair_flips` dict."""
    # compared field by field: the two sides may be either package's classes
    if dataclasses.astuple(ea.header) != dataclasses.astuple(eb.header):
        raise AssertionError(f"headers differ: {ea.header} vs {eb.header}")
    if (dataclasses.astuple(ea.gapless_info)
            != dataclasses.astuple(eb.gapless_info)):
        raise AssertionError(
            f"gapless info differs: {ea.gapless_info} vs {eb.gapless_info}")
    fa, fb = ea.frame_set, eb.frame_set
    if fa.nnz.shape != fb.nnz.shape:
        raise AssertionError(f"frame counts differ: {fa.nnz.shape} vs {fb.nnz.shape}")
    if not np.array_equal(fa.raw_mask, fb.raw_mask):
        raise AssertionError(
            f"raw masks differ on {int((fa.raw_mask != fb.raw_mask).sum())} frames")
    flips = pair_flips(fa, fb, n)
    if flips["max_dq"] > 1 or flips["rate"] > MAX_FLIP_RATE:
        raise AssertionError(f"pairs outside the contract: {flips}")
    return flips
