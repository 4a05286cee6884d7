"""The numbers that decide `correct` in a decode cell: the program's int16
stream of a track against the plain reference's (`reference_decode`), one
answer at a time (`decoded_numbers`):

* ``lsb_mismatch_share`` — the share of the int16 samples that differ;
* ``max_lsb`` — the largest absolute difference of a sample.

An answer that is missing, or whose length differs from the reference's
by even one sample (the codec's gapless promise is the exact length), reads
`WORST` on every number.
"""

from __future__ import annotations

import numpy as np

DECODE_NUMBERS = ("lsb_mismatch_share", "max_lsb")
WORST = {"lsb_mismatch_share": 1.0, "max_lsb": 65535.0}


def decoded_numbers(got, ref: np.ndarray, detail: dict = None) -> dict:
    """`got` and `ref` are int16 streams; `got` None is an answer that never
    came.  `detail`, if given, receives the counts behind the share."""
    if got is None or np.shape(got) != ref.shape:
        return dict(WORST)
    d = np.abs(np.asarray(got, np.int32) - ref.astype(np.int32))
    differ = int(np.count_nonzero(d))
    if detail is not None:
        detail.update(samples=len(ref), differ=differ)
    return {"lsb_mismatch_share": differ / max(len(ref), 1),
            "max_lsb": float(d.max(initial=0))}


def worst_of(readings: list) -> dict:
    """Each number's largest reading over the answers compared."""
    if not readings:
        return dict(WORST)
    return {k: max(r[k] for r in readings) for k in DECODE_NUMBERS}
