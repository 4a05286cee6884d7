"""The plain reference of the .glc codec, in plain torch and numpy.

It imports neither ``glc_tpu`` nor ``glc_tpu_torch``: it is written from
the codec's specification (the upstream encoder and its wire format,
src/codec.rs) and
works out again every table the program derives.  It serves two ends:

* `encode`, read back by `read_container`, gives what the program's
  container is judged against;
* with ``precision="tf32"``, and written by `write_container`, it is the
  control: the same arithmetic with every product's operands rounded to
  TF32, the precision one step below the float32 that the configurations
  state.

Precision ``"f64"``: each dot product (MDCT, band sums of squares) is
summed in float64.  The encode rounds the coefficients and band sums to
float32 and then follows the specification's float32 arithmetic, so it is
what a float32 codec with exactly rounded dot products writes.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

PRECISIONS = ("f64", "tf32")
MAX_BANDS = 50
# frames a block in `encode`: bounds its device memory
BLOCK_FRAMES = 4096


@dataclass(frozen=True)
class Codec:
    """The codec settings of a configuration file's ``codec`` group."""

    frame_size: int
    hop_size: int
    quality_factor: float
    noise_floor_db: float
    compression_threshold: float
    quantization_bits: int
    reference_compat: bool

    @classmethod
    def from_config(cls, cfg: dict) -> "Codec":
        return cls(**{k: cfg["codec"][k] for k in cls.__dataclass_fields__})

    @property
    def max_q(self) -> float:
        return float(1 << (self.quantization_bits - 1))


@dataclass
class Encoded:
    """One container, columnar: what the wire format holds."""

    sample_rate: int
    channels: int
    total_samples: int
    encoder_delay: int
    padding: int
    original_length: int
    nnz: np.ndarray       # int64 [F, C], 0 on raw frames
    k: np.ndarray         # int64 [K], stream order
    q: np.ndarray         # int64 [K]
    scales: np.ndarray    # float32 [F, C]
    raw_mask: np.ndarray  # bool [F]
    raw: np.ndarray       # int16 [R, C * frame_size], channel-major rows

    @property
    def frames(self) -> int:
        return self.nnz.shape[0]


# --- tables (codec.rs:104-183, 326-356), float32 as the specification ---

@lru_cache(maxsize=8)
def mdct_tables(n: int, frame_size: int):
    """(cos [n, frame_size], window [frame_size], norm): the angle in
    float32, left to right, its cosine in float64 rounded to float32."""
    f32 = np.float32
    pi, nf = f32(np.pi), f32(n)
    i = np.arange(frame_size, dtype=f32)
    k = np.arange(n, dtype=f32)
    angle = ((pi / nf) * (i + f32(0.5) + nf / f32(2.0)))[None, :] \
        * (k[:, None] + f32(0.5))
    cos = np.cos(angle.astype(np.float64)).astype(f32)
    window = np.sin(((pi * (i + f32(0.5))) / f32(frame_size))
                    .astype(np.float64)).astype(f32)
    return cos, window, np.sqrt(f32(2.0) / nf).astype(f32)


def _weight(freq: np.ndarray) -> np.ndarray:
    f32 = np.float32
    w = np.ones_like(freq)
    lo = freq < 100.0
    w[lo] = f32(0.3) + (freq[lo] / f32(100.0)) * f32(0.4)
    m = (freq >= 100.0) & (freq < 200.0)
    w[m] = f32(0.7) + ((freq[m] - f32(100.0)) / f32(100.0)) * f32(0.3)
    m = (freq >= 5000.0) & (freq < 10000.0)
    w[m] = f32(1.0) - ((freq[m] - f32(5000.0)) / f32(5000.0)) * f32(0.3)
    m = freq >= 10000.0
    w[m] = f32(0.7) - np.minimum((freq[m] - f32(10000.0)) / f32(12000.0),
                                 f32(1.0)) * f32(0.5)
    return np.maximum(w, f32(0.2))


def band_edges(n: int, sample_rate: int) -> list:
    """Simplified-Bark band edges (codec.rs:146-183), float32 steps."""
    f32 = np.float32
    edges, freq, nyq = [0], f32(0.0), f32(sample_rate) / f32(2.0)
    while freq < nyq and len(edges) < MAX_BANDS:
        b = int((freq / nyq) * f32(n))
        if edges[-1] < b < n:
            edges.append(b)
        step = 50.0 if freq < 500.0 else 100.0 if freq < 2000.0 \
            else 250.0 if freq < 8000.0 else 500.0
        freq = freq + f32(step)
    return edges + [n]


@lru_cache(maxsize=8)
def band_tables(n: int, sample_rate: int):
    """(mask [bands, n], inv_count [bands], pf [bands], band_of [n],
    inv_w [n]) over the real bands only."""
    f32 = np.float32
    k = np.arange(n, dtype=f32)
    weights = _weight((k / (f32(2.0) * f32(n))) * f32(sample_rate))
    edges = band_edges(n, sample_rate)
    bands = [(a, b) for a, b in zip(edges[:-1], edges[1:]) if a < b]
    mask = np.zeros((len(bands), n), f32)
    inv_count = np.zeros(len(bands), f32)
    pf = np.zeros(len(bands), f32)
    band_of = np.zeros(n, np.int64)
    for j, (a, b) in enumerate(bands):
        mask[j, a:b] = 1.0
        cnt = f32(b - a)
        inv_count[j] = f32(1.0) / cnt
        avg = f32(weights[a:b].sum(dtype=f32) / cnt)
        pf[j] = f32(1.0) / max(avg, f32(0.1))
        band_of[a:b] = j
    inv_w = (f32(1.0) / np.maximum(weights, f32(0.1))).astype(f32)
    return mask, inv_count, pf, band_of, inv_w


# --- products ---

def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits, to nearest, ties away
    from zero), as the tensor cores round their operands."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def product(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b of float32 operands: summed in float64 (``"f64"``, the result
    float64), or of TF32-rounded operands summed in float32 (``"tf32"``)."""
    if precision == "f64":
        return a.double() @ b.double()
    if precision == "tf32":
        with _no_tf32():
            return tf32(a) @ tf32(b)
    raise ValueError(f"precision {precision!r} is not one of {PRECISIONS}")


class _no_tf32:
    """The float32 product in full float32 while it runs: the emulated
    rounding is the only one."""

    def __enter__(self):
        self.saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.saved


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    t = torch.trunc(x)
    return t + torch.where(torch.abs(x - t) >= 0.5, torch.sign(x), 0.0)


# --- encode (codec.rs:421-565) ---

def geometry(total: int, channels: int, codec: Codec):
    """(T, F, padding, lead): channel 0's length, the frame count and the
    padding of reference src/codec.rs:427-455, 546."""
    hop, lead = codec.hop_size, codec.hop_size // 2
    T = -(-total // channels)
    rem = (lead + T) % hop
    P = lead + T + (hop - rem if rem else 0) + lead
    F = 1 if P < codec.frame_size else (P - codec.frame_size) // hop + 1
    return T, F, P - T - lead, lead


def encode(pcm: torch.Tensor, channels: int, sample_rate: int, codec: Codec,
           precision: str = "f64") -> Encoded:
    """Encode interleaved PCM (int16, or float32 in [-1, 1]) on its device."""
    C, n, fsz = channels, codec.hop_size, codec.frame_size
    dev = pcm.device
    total = pcm.numel()
    T, F, padding, lead = geometry(total, C, codec)
    x = pcm.to(torch.float32)
    if pcm.dtype == torch.int16:
        x = x / 32768.0
    flat = torch.zeros(T * C, dtype=torch.float32, device=dev)
    flat[:total] = x
    width = max((F + 1) * n, lead + T)
    planar = torch.zeros((C, width), dtype=torch.float32, device=dev)
    planar[:, lead:lead + T] = flat.view(T, C).T
    cos, window, norm = mdct_tables(n, fsz)
    cos_t = torch.from_numpy(cos).to(dev)
    window_t = torch.from_numpy(window).to(dev)
    mask, inv_count, pf, band_of, inv_w = (
        torch.from_numpy(a).to(dev) for a in band_tables(n, sample_rate))
    f32 = np.float32
    cf = float(f32(max(f32(1.0) - f32(codec.quality_factor), f32(0.01))))
    nf = float(f32(10.0 ** float(f32(codec.noise_floor_db) / f32(20.0))))
    raw_limit = float(f32(fsz * C * 2) * f32(codec.compression_threshold))

    nnz_l, k_l, q_l, sc_l, rm_l, raw_l = [], [], [], [], [], []
    for f0 in range(0, F, BLOCK_FRAMES):
        nf_ = min(BLOCK_FRAMES, F - f0)
        seg = planar[:, f0 * n:(f0 + nf_ + 1) * n]
        blocks = torch.cat([seg[:, :-n].reshape(C, nf_, n),
                            seg[:, n:].reshape(C, nf_, n)], -1).transpose(0, 1)
        win = blocks * window_t                                # [f, C, 2n]
        coeffs = (product(win.reshape(-1, fsz), cos_t.T, precision)
                  .to(torch.float32) * float(norm)).view(nf_, C, n)
        absc = coeffs.abs()
        scale = absc.amax(-1).clamp_min(1e-10)                 # [f, C]
        band_sq = product((coeffs * coeffs).reshape(-1, n), mask.T,
                          precision).to(torch.float32).view(nf_, C, -1)
        energy = torch.sqrt(band_sq * inv_count)
        thr = (((energy * 0.01) * cf) * pf)[..., band_of] * inv_w
        gmax = scale[..., None]
        thr = torch.where(absc > gmax * 0.3, torch.minimum(thr, gmax * 0.05),
                          thr)
        qf = _round_half_away((coeffs / gmax) * codec.max_q)
        qf = qf.clamp(-32768.0, 32767.0)
        keep = (absc > nf * gmax) & (absc > thr * gmax) & (qf != 0)
        nnz = keep.sum(-1)                                     # [f, C]
        size = (8 + 4 * nnz).sum(-1) + 8 + 4 * C + 64
        use_raw = size.to(torch.float32) >= raw_limit
        keep &= ~use_raw[:, None, None]
        f_i, c_i, k_i = torch.nonzero(keep, as_tuple=True)
        nnz_l.append(keep.sum(-1).cpu())
        k_l.append(k_i.cpu())
        q_l.append(qf[f_i, c_i, k_i].to(torch.int64).cpu())
        sc_l.append(scale.cpu())
        rm_l.append(use_raw.cpu())
        raw = torch.trunc((win[use_raw] * 32767.0).clamp(-32768.0, 32767.0))
        raw_l.append(raw.to(torch.int16).reshape(-1, C * fsz).cpu())
    cat = lambda parts: torch.cat(parts).numpy()
    return Encoded(sample_rate, C, total, lead, padding, total,
                   cat(nnz_l).astype(np.int64), cat(k_l), cat(q_l),
                   cat(sc_l), cat(rm_l), cat(raw_l))


# --- the wire format: bincode v1 (codec.rs:31-69, 774-786) ---

def write_container(e: Encoded, device="cpu") -> bytes:
    """The container's bytes, built with index scatters on `device`:
    header u32 rate | u16 channels | u64 total | u64 F; per frame u64 C,
    per channel u64 nnz and (u16 k, i16 q) pairs, u64 C, C f32 scales, u8
    0, or for a raw frame u64 0 | u64 0 | u8 1 | u64 L | L i16; then u32
    delay | u32 padding | u64 original length."""
    dev = torch.device(device)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    C, F = e.channels, e.frames
    L = e.raw.shape[1] if e.raw.size else 0
    nnz, raw_mask = t(e.nnz), t(e.raw_mask)
    sizes = torch.where(raw_mask, 25 + 2 * L,
                        8 + 8 * C + 4 * nnz.sum(1) + 8 + 4 * C + 1)
    off = 22 + torch.cumsum(sizes, 0) - sizes
    end = 22 + int(sizes.sum())
    out = torch.zeros(end + 16, dtype=torch.uint8, device=dev)
    as_bytes = lambda x, w: x.contiguous().view(torch.uint8).view(-1, w)
    u64 = lambda v: as_bytes(v.to(torch.int64), 8)

    def put(pos, data):
        w = data.shape[1]
        idx = pos.reshape(-1, 1) + torch.arange(w, device=dev)
        out[idx.reshape(-1)] = data.reshape(-1)

    head = struct.pack("<IHQQ", e.sample_rate, C, e.total_samples, F)
    out[:22] = t(np.frombuffer(bytearray(head), np.uint8))
    tail = struct.pack("<IIQ", e.encoder_delay, e.padding, e.original_length)
    out[end:] = t(np.frombuffer(bytearray(tail), np.uint8))
    comp = torch.nonzero(~raw_mask).reshape(-1)
    if comp.numel():
        coff, cnnz = off[comp], nnz[comp]
        put(coff, u64(torch.full_like(coff, C)))
        ch_size = 8 + 4 * cnnz
        ch_off = coff[:, None] + 8 + torch.cumsum(ch_size, 1) - ch_size
        put(ch_off, u64(cnnz.reshape(-1)))
        counts = cnnz.reshape(-1)
        if int(counts.sum()):
            rec = torch.repeat_interleave(torch.arange(len(counts), device=dev),
                                          counts)
            first = torch.cumsum(counts, 0) - counts
            within = torch.arange(len(rec), device=dev) - first[rec]
            words = (t(e.k) & 0xFFFF) | ((t(e.q) & 0xFFFF) << 16)
            put(ch_off.reshape(-1)[rec] + 8 + 4 * within,
                as_bytes(words.to(torch.int32), 4))
        sc_off = coff + 8 + ch_size.sum(1)
        put(sc_off, u64(torch.full_like(coff, C)))
        put(sc_off + 8, as_bytes(t(e.scales)[comp], 4 * C))
    raws = torch.nonzero(raw_mask).reshape(-1)
    if raws.numel():
        roff = off[raws]
        out[roff + 16] = 1
        put(roff + 17, u64(torch.full_like(roff, L)))
        put(roff + 25, as_bytes(t(e.raw), 2 * L))
    return out.cpu().numpy().tobytes()


class ContainerError(ValueError):
    pass


def read_container(data: bytes) -> Encoded:
    """Parse a container frame by frame; raises ContainerError on bytes the
    wire format does not allow."""
    u64 = struct.Struct("<Q").unpack_from
    try:
        sr, C, total = struct.unpack_from("<IHQ", data, 0)
        (F,) = u64(data, 14)
        if F > len(data):
            raise ContainerError(f"implausible frame count {F}")
        pos = 22
        nnz = np.zeros((F, C), np.int64)
        scales = np.zeros((F, C), np.float32)
        raw_mask = np.zeros(F, bool)
        spans, raws = [], []
        for f in range(F):
            (outer,) = u64(data, pos)
            pos += 8
            if outer == C and C:
                for c in range(C):
                    (cnt,) = u64(data, pos)
                    spans.append((pos + 8, cnt))
                    nnz[f, c] = cnt
                    pos += 8 + 4 * cnt
                (sl,) = u64(data, pos)
                scales[f] = np.frombuffer(data, "<f4", C, pos + 8)
                pos += 8 + 4 * C
                if sl != C or data[pos] != 0:
                    raise ContainerError(f"frame {f}: bad scales or tag")
                pos += 1
            elif outer == 0:
                (sl,) = u64(data, pos)
                (L,) = u64(data, pos + 9)
                if sl != 0 or data[pos + 8] != 1:
                    raise ContainerError(f"frame {f}: bad raw record")
                raws.append(np.frombuffer(data, "<i2", L, pos + 17))
                raw_mask[f] = True
                pos += 17 + 2 * L
            else:
                raise ContainerError(f"frame {f}: {outer} channels, not {C}")
        delay, padding, orig = struct.unpack_from("<IIQ", data, pos)
    except (struct.error, IndexError, ValueError) as err:
        raise ContainerError(f"malformed container: {err}") from err
    pairs = np.concatenate(
        [np.frombuffer(data, "<u2", 2 * cnt, p) for p, cnt in spans] or
        [np.empty(0, "<u2")]).reshape(-1, 2)
    raw = np.stack(raws) if raws else np.empty((0, 0), np.int16)
    return Encoded(sr, C, total, delay, padding, orig, nnz,
                   pairs[:, 0].astype(np.int64),
                   pairs[:, 1].view(np.int16).astype(np.int64),
                   scales, raw_mask, raw)
