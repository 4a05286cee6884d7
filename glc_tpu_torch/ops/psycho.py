"""Psychoacoustic model: perceptual weights, critical bands, masking thresholds.

Port of ``glc_tpu/ops/psycho.py``.  `get_perceptual_tables` is the same
numpy code (bit-identical tables); `masking_thresholds` is the torch twin
of the JAX function, with the same f32 multiply association.

Mirrors the reference's simplified model (reference src/codec.rs:91-240):
piecewise-linear frequency weighting, simplified-Bark critical band edges, and
per-band RMS-energy masking thresholds.  The per-band reductions are one
small matmul against a dense 0/1 band-membership matrix padded to
MAX_BANDS on the CPU, and the hand kernel `band_energy`
(``ops/kernels.py``) on CUDA; the per-coefficient broadcast is a gather.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from .kernels import band_energy
from .mdct import fixed_rows_matmul

# The reference caps the band list at 50 edges (codec.rs:154) and then appends
# the final edge n (codec.rs:181) → at most 50 bands.
MAX_BANDS = 50


def _perceptual_weight(freq_hz: np.ndarray) -> np.ndarray:
    """Piecewise-linear weight curve (codec.rs:110-132), f32 math."""
    f = freq_hz.astype(np.float32)
    w = np.empty_like(f)
    m0 = f < 100.0
    m1 = (f >= 100.0) & (f < 200.0)
    m2 = (f >= 200.0) & (f < 5000.0)
    m3 = (f >= 5000.0) & (f < 10000.0)
    m4 = f >= 10000.0
    w[m0] = np.float32(0.3) + (f[m0] / np.float32(100.0)) * np.float32(0.4)
    w[m1] = np.float32(0.7) + ((f[m1] - np.float32(100.0)) / np.float32(100.0)) * np.float32(0.3)
    w[m2] = np.float32(1.0)
    w[m3] = np.float32(1.0) - ((f[m3] - np.float32(5000.0)) / np.float32(5000.0)) * np.float32(0.3)
    w[m4] = np.float32(0.7) - np.minimum(
        (f[m4] - np.float32(10000.0)) / np.float32(12000.0), np.float32(1.0)
    ) * np.float32(0.5)
    return np.maximum(w, np.float32(0.2))


def _critical_band_edges(n: int, sample_rate: int) -> np.ndarray:
    """Simplified-Bark band edges (codec.rs:146-183), f32 accumulation."""
    bands = [0]
    nyquist = np.float32(sample_rate) / np.float32(2.0)
    freq = np.float32(0.0)
    while freq < nyquist and len(bands) < MAX_BANDS:
        # Rust `as usize` truncates toward zero.
        b = int((freq / nyquist) * np.float32(n))
        if b > bands[-1] and b < n:
            bands.append(b)
        if freq < 500.0:
            freq = freq + np.float32(50.0)
        elif freq < 2000.0:
            freq = freq + np.float32(100.0)
        elif freq < 8000.0:
            freq = freq + np.float32(250.0)
        else:
            freq = freq + np.float32(500.0)
    bands.append(n)
    return np.asarray(bands, np.int64)


@dataclass(frozen=True)
class PerceptualTables:
    """Static per-(n, sample_rate) tables, padded to MAX_BANDS rows.

    * band_mask      [MAX_BANDS, n] f32 — 0/1 membership matrix
    * band_inv_count [MAX_BANDS]    f32 — 1/(end-start), 0 for padding rows
    * band_pf        [MAX_BANDS]    f32 — perceptual factor 1/max(avg_w, 0.1)
    * band_of        [n]            i32 — band index of each bin
    * inv_w          [n]            f32 — 1/max(weight_i, 0.1)
    * weights        [n]            f32 — raw weight curve
    """

    weights: np.ndarray
    band_edges: np.ndarray
    band_mask: np.ndarray
    band_inv_count: np.ndarray
    band_pf: np.ndarray
    band_of: np.ndarray
    inv_w: np.ndarray
    sample_rate: int
    n: int

    def __hash__(self):
        return hash((self.n, self.sample_rate))


@lru_cache(maxsize=32)
def get_perceptual_tables(n: int, sample_rate: int) -> PerceptualTables:
    # Weight curve (codec.rs:104-133): norm_freq = k/(2n), freq = norm_freq*rate
    k = np.arange(n, dtype=np.float32)
    norm_freq = k / (np.float32(2.0) * np.float32(n))
    freq_hz = norm_freq * np.float32(sample_rate)
    weights = _perceptual_weight(freq_hz)

    edges = _critical_band_edges(n, sample_rate)
    num_bands = len(edges) - 1

    band_mask = np.zeros((MAX_BANDS, n), np.float32)
    band_inv_count = np.zeros(MAX_BANDS, np.float32)
    band_pf = np.zeros(MAX_BANDS, np.float32)
    band_of = np.zeros(n, np.int32)
    for b in range(num_bands):
        start, end = int(edges[b]), min(int(edges[b + 1]), n)
        if start >= end:
            continue
        band_mask[b, start:end] = 1.0
        cnt = np.float32(end - start)
        band_inv_count[b] = np.float32(1.0) / cnt
        # Average weight with f32 sequential-equivalent sum (codec.rs:218)
        avg_w = (weights[start:end].sum(dtype=np.float32) / cnt).astype(np.float32)
        band_pf[b] = np.float32(1.0) / max(avg_w, np.float32(0.1))
        band_of[start:end] = b

    inv_w = (np.float32(1.0) / np.maximum(weights, np.float32(0.1))).astype(np.float32)

    return PerceptualTables(
        weights=weights,
        band_edges=edges,
        band_mask=band_mask,
        band_inv_count=band_inv_count,
        band_pf=band_pf,
        band_of=band_of,
        inv_w=inv_w,
        sample_rate=sample_rate,
        n=n,
    )


def masking_thresholds(
    coeffs: torch.Tensor,      # [..., n] f32
    global_max: torch.Tensor,  # [..., 1] f32 (max |coeff|, clamped ≥ 1e-10)
    band_mask: torch.Tensor,
    band_inv_count: torch.Tensor,
    band_pf: torch.Tensor,
    band_of: torch.Tensor,     # [n] int64 (an index tensor)
    inv_w: torch.Tensor,
    quality: float,
) -> torch.Tensor:
    """Per-coefficient masking thresholds (reference src/codec.rs:186-240).

    Band RMS energies from the band sums of squares, row-invariant on both
    devices: one matmul in fixed row blocks on the CPU
    (`fixed_rows_matmul`), the kernel `band_energy` on CUDA (any other
    device raises there); thresholds broadcast back per bin;
    largest peaks (>30% of global max) get the threshold capped at 5% of the
    global max.  Matches the reference's f32 multiply association:
    ((energy * 0.01) * compression_factor) * perceptual_factor * individual.
    Python-float constants are rounded to f32 before the f32 multiply, as
    the JAX package's np.float32 constants are.
    """
    compression_factor = float(
        np.float32(max(1.0 - np.float32(quality), np.float32(0.01)))
    )
    if coeffs.device.type == "cpu":
        band_sq = fixed_rows_matmul(coeffs * coeffs, band_mask.T)
    else:
        rows = coeffs.reshape(-1, coeffs.shape[-1]).contiguous()
        band_sq = band_energy(rows, band_mask).view(
            *coeffs.shape[:-1], band_mask.shape[0])
    energy = torch.sqrt(band_sq * band_inv_count)
    base = ((energy * 0.01) * compression_factor) * band_pf
    thr = base[..., band_of] * inv_w
    absc = torch.abs(coeffs)
    cap = global_max * 0.05
    return torch.where(absc > global_max * 0.3, torch.minimum(thr, cap), thr)
