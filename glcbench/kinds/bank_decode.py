"""Sound-bank decode traffic: `album_decode`'s calls on a pool of short
clips whose lengths are log-spaced, as a library of sound effects holds
many short clips and a few long ones.  A game or an app loads a bank of
effects from their containers and decodes the whole bank to int16 in one
``Decoder.decode_many`` call.

The traffic file's parameters are `album_decode`'s, but the pool holds one
clip of each of ``pool_items`` lengths spaced evenly in log over
``item_seconds`` [lo, hi] (``np.geomspace``), in the seed's order; so every
seed carries the same lengths, and a call (``"albums"``: a bank of
``items_per_call`` clips) runs short clips through the decode's stacked
single-chunk groups, one pass a chunk-size rung.
"""

from __future__ import annotations

import numpy as np

from .album_decode import AlbumDecode


class BankDecode(AlbumDecode):
    """One cell of sound-bank decode traffic on `device`."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        super().__init__(cfg, traffic, seed, device)
        lo, hi = traffic["item_seconds"]
        lengths = np.geomspace(lo, hi, traffic["pool_items"])
        order = np.random.default_rng([self.seed, 0]).permutation(len(lengths))
        self.seconds = [float(lengths[i]) for i in order]


def make(cfg: dict, traffic: dict, seed: int, device) -> BankDecode:
    return BankDecode(cfg, traffic, seed, device)
