"""Seeded programme-like material, made in plain torch on the device.

A track is four voices that play notes back to back (a lead, a pad, a bass
and a fast arpeggio; each note a fundamental with decaying partials under
an attack-decay envelope), drum-like transients (noise bursts that decay
in tens of milliseconds), a noise bed, and a few short silences, mixed
into the channels of the layout.  Every draw comes from one
``torch.Generator`` seeded from (seed, item), so a seed gives the same
tracks on the same kind of device, and tracks of one seed differ.  The
material is stationary at the scale of seconds, so tracks of one length
carry about the same work whatever the seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# (lowest Hz, octaves, shortest s, longest s, decay s, partials, level)
VOICES = (
    (220.0, 2.5, 0.20, 0.90, 0.60, 6, 0.30),   # lead
    (110.0, 2.0, 1.00, 3.00, 2.50, 4, 0.22),   # pad
    (41.0, 1.5, 0.25, 1.20, 0.80, 3, 0.30),    # bass
    (440.0, 2.0, 0.08, 0.20, 0.15, 5, 0.12),   # arpeggio
)
BASS = 2
TRANSIENTS_PER_S = 2.0
NOISE_BED = 0.004
PEAK = 0.9


def item_seed(seed: int, item: int) -> int:
    """The generator seed of one track: any whole seed, folded to 63 bits."""
    return (int(seed) * 1_000_003 + int(item) * 7_919 + 17) % (1 << 63)


def _uniform(n, lo, hi, g, dev):
    return lo + (hi - lo) * torch.rand(n, generator=g, device=dev,
                                       dtype=torch.float64)


def _events(seconds, lo, hi, g, dev):
    """Back-to-back event starts covering [0, seconds]."""
    count = int(seconds / lo) + 2
    durs = _uniform(count, lo, hi, g, dev)
    return torch.cumsum(durs, 0) - durs


def _voice(t, sr, spec, g, dev):
    low, octaves, dmin, dmax, decay, partials, level = spec
    seconds = float(t[-1]) + 1.0 / sr
    starts = _events(seconds, dmin, dmax, g, dev)
    freqs = low * torch.pow(2.0, _uniform(len(starts), 0.0, octaves, g, dev))
    amps = level * _uniform(len(starts), 0.4, 1.0, g, dev)
    idx = torch.searchsorted(starts, t, right=True) - 1
    phase = torch.cumsum(freqs[idx] * (2 * math.pi / sr), 0)
    dt = t - starts[idx]
    env = torch.clamp(dt / 0.01, max=1.0) * torch.exp(-dt / decay)
    env = (env * amps[idx]).to(torch.float32)
    phase = torch.remainder(phase, 2 * math.pi).to(torch.float32)
    out = torch.zeros_like(env)
    for h in range(1, partials + 1):
        out += torch.sin(phase * h) / h ** 1.3
    return out * env


def _transients(t, sr, g, dev):
    seconds = float(t[-1]) + 1.0 / sr
    starts = _events(seconds, 0.5 / TRANSIENTS_PER_S, 1.5 / TRANSIENTS_PER_S,
                     g, dev)
    amps = _uniform(len(starts), 0.05, 0.35, g, dev)
    taus = _uniform(len(starts), 0.01, 0.06, g, dev)
    idx = torch.searchsorted(starts, t, right=True) - 1
    env = (amps[idx] * torch.exp(-(t - starts[idx]) / taus[idx])).float()
    return env * torch.randn(len(t), generator=g, device=dev)


def _silences(t, seconds, g, dev):
    """A 0/1 gate with one gap of 0.3-1.5 s every 30-90 s."""
    gate = torch.ones(len(t), dtype=torch.float32, device=dev)
    starts = _events(seconds, 30.0, 90.0, g, dev)[1:]
    lens = _uniform(len(starts), 0.3, 1.5, g, dev)
    for s, n in zip(starts.tolist(), lens.tolist()):
        gate[(t >= s) & (t < s + n)] = 0.0
    return gate


def _gains(layout, g, dev):
    """[C, voices + 2] gains of the voices, the transients and the bed.
    Stereo pans each voice; 5.1 (L R C LFE Ls Rs) puts the voices across
    the front, the bass alone in the LFE, and a pad and the bed in the
    surrounds."""
    V = len(VOICES)
    pans = _uniform(V + 1, 0.25, math.pi / 2 - 0.25, g, dev).float()
    left, right = torch.cos(pans), torch.sin(pans)
    rows = []
    for ch in layout:
        row = torch.zeros(V + 2, device=dev)
        if ch in ("L", "R"):
            row[:V + 1] = left if ch == "L" else right
        elif ch == "C":
            row[0], row[3], row[V] = 0.8, 0.4, 0.5
        elif ch == "LFE":
            row[BASS] = 1.0
        elif ch in ("Ls", "Rs"):
            row[1], row[V] = 0.4, 0.2
        else:
            raise ValueError(f"unknown channel {ch!r}")
        row[V + 1] = 0.0 if ch == "LFE" else 1.0
        rows.append(row)
    return torch.stack(rows)


def track(seconds: float, sample_rate: int, layout, seed: int, item: int,
          device) -> torch.Tensor:
    """Interleaved float32 [T·C] in [-PEAK, PEAK] on `device`."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(item_seed(seed, item))
    T = int(round(seconds * sample_rate))
    t = torch.arange(T, dtype=torch.float64, device=dev) / sample_rate
    voices = [_voice(t, sample_rate, spec, g, dev) for spec in VOICES]
    hits = _transients(t, sample_rate, g, dev)
    C = len(layout)
    gains = _gains(layout, g, dev)
    bed = NOISE_BED * torch.randn((C, T), generator=g, device=dev)
    # sums, not a product: the inputs must not follow the TF32 setting
    mix = gains[:, -1:] * bed                              # [C, T]
    for j, src in enumerate(voices + [hits]):
        mix += gains[:, j:j + 1] * src
    mix *= _silences(t, seconds, g, dev)
    mix *= PEAK / mix.abs().max().clamp_min(1e-6)
    return mix.T.contiguous().view(-1)


def to_pcm(x: torch.Tensor, bits: int) -> np.ndarray:
    """Host PCM of a track: int16 for 16 bits; for more, float32 of the
    `bits`-bit integer over 2^(bits-1), exact, as the codec's CLI reads a
    24-bit file."""
    full = float(1 << (bits - 1))
    ints = torch.round(x.double() * full).clamp(-full, full - 1)
    if bits == 16:
        return ints.to(torch.int16).cpu().numpy()
    return (ints / full).to(torch.float32).cpu().numpy()
