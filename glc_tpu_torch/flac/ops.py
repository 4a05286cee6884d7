"""FLAC block math: fixed-predictor residuals + Rice parameter stats.

Port of ``glc_tpu/flac/ops.py``.  `flac_block_stats` is the counterpart of
the JAX package's jitted program, written as torch ops that run on the
input tensor's own device; `flac_block_stats_host` and
`rice_params_from_sums` are numpy copies.

The reference computes these per subframe in scalar Rust
(reference src/flac.rs:480-552); here they are batched over all (frame,
channel) blocks at once:

* Fixed-predictor residual of order k == k-th finite difference (the orders
  0-4 polynomial predictors of flac.rs:498-505 are exactly Δᵏ).
* Rice parameter = min(14, floor(log2(mean |residual|))) with the integer
  floor-divide mean of flac.rs:523-524 — computed exactly by splitting the
  partition |residual| sums into 16-bit halves (each half-sum fits int32)
  and recombining on the host.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_RICE_PARAM_4BIT = 14  # flac.rs:12


def flac_block_stats(x: torch.Tensor, *, order: int, po: int):
    """x: [B, bs] int32 samples (one row per frame-channel block), on any
    device; the math runs where `x` lies.

    Returns (residual_full [B, bs] int32 with warm-up slots zeroed,
             sums_lo [B, P] int32, sums_hi [B, P] int32)
    where P = 1 << po and partition p covers residual indices
    [p*dps - order, (p+1)*dps - order) for p ≥ 1 and [0, dps - order) for
    p = 0 (flac.rs:616-637).  Exact integer arithmetic: equal to
    `flac_block_stats_host` on every device.
    """
    if x.dtype != torch.int32 or x.dim() != 2:
        raise TypeError(f"x must be [B, bs] int32, got {x.dtype} "
                        f"{tuple(x.shape)}")
    B, bs = x.shape
    res = x
    for _ in range(order):
        res = res[:, 1:] - res[:, :-1]
    # [B, bs]: warm-up slots zero, mirroring apply_fixed_predictor
    # (flac.rs:489-495)
    res_full = torch.cat([x.new_zeros((B, order)), res], dim=1)

    P = 1 << po
    dps = bs >> po
    parts = res_full.abs().reshape(B, P, dps)
    # Exact sums in int32: split |res| (≤ 2^20) into 16-bit halves; each
    # half-sum ≤ dps·2^16 ≤ 2^28.  dtype=int32, because torch's default
    # sum of an int32 tensor promotes to int64.
    lo = torch.sum(parts & 0xFFFF, dim=-1, dtype=torch.int32)
    hi = torch.sum(parts >> 16, dim=-1, dtype=torch.int32)
    return res_full, lo, hi


def flac_block_stats_host(x: np.ndarray, *, order: int, po: int):
    """Host (numpy) twin of `flac_block_stats` — identical integer results.

    The FLAC math is exact integer arithmetic and bandwidth-bound, so when
    the samples live on the host the k-fold diff is done in place rather
    than shipped to the device and back (the residual VALUES are needed
    host-side for bit packing either way).
    """
    B, bs = x.shape
    res = x
    for _ in range(order):
        res = res[:, 1:] - res[:, :-1]
    res_full = np.zeros((B, bs), np.int32)
    res_full[:, order:] = res

    P = 1 << po
    dps = bs >> po
    parts = np.abs(res_full).reshape(B, P, dps)
    lo = (parts & 0xFFFF).sum(axis=-1, dtype=np.int32)
    hi = (parts >> 16).sum(axis=-1, dtype=np.int32)
    return res_full, lo, hi


def rice_params_from_sums(
    sums_lo: np.ndarray, sums_hi: np.ndarray, bs: int, order: int, po: int
) -> np.ndarray:
    """Exact Rust rice-parameter estimate (flac.rs:514-552), vectorized.

    param = 0 if mean == 0 else min(14, floor(log2(mean))), where
    mean = sum(|residual|) // partition_len (u64 floor division).
    The "adjust for better compression" branch at flac.rs:546-549 is
    unreachable (mean ≥ 2^param by construction) — see SURVEY.md Q6 family.
    """
    sums = sums_hi.astype(np.uint64) * np.uint64(65536) + sums_lo.astype(
        np.uint64
    )
    P = 1 << po
    dps = bs >> po
    counts = np.full(P, dps, np.uint64)
    counts[0] = dps - order
    counts = np.maximum(counts, 1)  # partition 0 can be empty; param unused
    mean = sums // counts  # [B, P]
    # floor(log2(mean)) capped at 14, 0 for mean==0
    thresholds = np.uint64(1) << np.arange(1, MAX_RICE_PARAM_4BIT + 1,
                                           dtype=np.uint64)
    params = (mean[..., None] >= thresholds).sum(axis=-1).astype(np.int8)
    return params
