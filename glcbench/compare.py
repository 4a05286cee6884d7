"""The numbers that decide `correct`: the program's container against the
plain reference's, one answer (one track) at a time (`encoded_numbers`):

* ``flip_share`` — of the coded values (the kept pairs' positions, kept by
  either side, and the raw frames' samples), the share whose values differ;
* ``max_q_gap`` — the largest difference of a value coded by both;
* ``scale_gap`` — the largest relative difference of a scale factor of a
  frame that both code with pairs.

An answer that is missing, malformed or of another shape reads `WORST`
on every number.
"""

from __future__ import annotations

import numpy as np
import torch

ENCODE_NUMBERS = ("flip_share", "max_q_gap", "scale_gap")
WORST = {"flip_share": 1.0, "max_q_gap": 65535.0, "scale_gap": 1.0}


def worst(names) -> dict:
    return {k: WORST[k] for k in names}


def _pairs(got, ref, n: int, device):
    """(common, differing, gap) of the kept pairs, counted on `device`: the
    positions that both code, how many of them hold different values, and
    the largest difference; None where `got` codes a position twice."""
    dev = torch.device(device)

    def side(e):
        nnz = torch.from_numpy(e.nnz.reshape(-1)).to(dev)
        rows = torch.repeat_interleave(
            torch.arange(len(nnz), device=dev), nnz)
        return (rows * n + torch.from_numpy(e.k).to(dev),
                torch.from_numpy(e.q).to(dev))

    pa, qa = side(got)
    pb, qb = side(ref)  # the reference's positions rise strictly
    if len(pa) > 1 and not bool((pa[1:] > pa[:-1]).all()):
        pa, order = torch.sort(pa)
        qa = qa[order]
        if bool((pa[1:] == pa[:-1]).any()):
            return None
    if not len(pa) or not len(pb):
        return 0, 0, 0
    idx = torch.searchsorted(pb, pa).clamp_max(len(pb) - 1)
    hit = pb[idx] == pa
    dq = (qa[hit] - qb[idx[hit]]).abs()
    return (int(hit.sum()), int(torch.count_nonzero(dq)),
            int(dq.max()) if len(dq) else 0)


def encoded_numbers(got, ref, n: int, frame_size: int, detail: dict = None,
                    device="cpu") -> dict:
    """`got` and `ref` are `reference.Encoded` of hop `n`; `got` None is a
    missing or malformed container.  `detail`, if given, receives the
    counts behind ``flip_share``; the pairs are matched on `device`."""
    if got is None:
        return worst(ENCODE_NUMBERS)
    same_shape = (
        (got.sample_rate, got.channels, got.total_samples, got.encoder_delay,
         got.padding, got.original_length, got.nnz.shape)
        == (ref.sample_rate, ref.channels, ref.total_samples,
            ref.encoder_delay, ref.padding, ref.original_length,
            ref.nnz.shape))
    if not same_shape or got.k.max(initial=0) >= n:
        return worst(ENCODE_NUMBERS)
    pairs = _pairs(got, ref, n, device)
    if pairs is None:
        return worst(ENCODE_NUMBERS)
    common, differing, gap = pairs
    kept = len(got.k) + len(ref.k) - common
    flips = kept - common + differing
    # raw frames: a frame raw on one side only counts all its samples
    both = got.raw_mask & ref.raw_mask
    width = ref.channels * frame_size
    one = int(np.count_nonzero(got.raw_mask ^ ref.raw_mask))
    values = kept + (int(np.count_nonzero(both)) + one) * width
    flips += one * width
    if both.any():
        ga = got.raw[both[got.raw_mask]].astype(np.int64)
        rb = ref.raw[both[ref.raw_mask]].astype(np.int64)
        if ga.shape != rb.shape:
            return worst(ENCODE_NUMBERS)
        d = np.abs(ga - rb)
        flips += int(np.count_nonzero(d))
        gap = max(gap, int(d.max(initial=0)))
    coded = ~(got.raw_mask | ref.raw_mask)
    sa, sb = got.scales[coded], ref.scales[coded]
    scale_gap = float(np.max(np.abs(sa - sb) / np.maximum(np.abs(sb), 1e-30),
                             initial=0.0))
    if detail is not None:
        detail.update(values=values, gate=kept - common,
                      value=differing, raw_one_side=one,
                      raw_both=int(np.count_nonzero(both)))
    return {"flip_share": flips / max(values, 1), "max_q_gap": float(gap),
            "scale_gap": scale_gap}


def worst_of(readings: list, names) -> dict:
    """Each number's largest reading over the answers compared."""
    if not readings:
        return worst(names)
    return {k: max(r[k] for r in readings) for k in names}


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number at or under its limit."""
    return all(numbers[k] <= limits[k] for k in numbers)
