"""Codec configuration constants.

Copied from ``glc_tpu/config.py`` (every field kept, so a ``glc_tpu``
config maps 1:1 through ``dataclasses.asdict`` and `config_from_dict`);
importing ``glc_tpu`` would load JAX, which the port never does.

Mirrors the compile-time constants of the reference implementation
(reference src/codec.rs:15-29).

Fields the port carries but never reads: ``compact_mode``,
``compact_bb_mult`` (the port compacts pairs with one ``masked_select``),
``segmented_batch`` (`Encoder.encode_many` runs its tracks one after
another and `Decoder.decode_many` its multi-chunk tracks, whatever the
field says) and ``use_pallas`` (on CUDA the hand-written IMDCT+window
kernel is the only path).  The comments on the fields below are the JAX
package's; the timings they quote were taken on a TPU v5e and say nothing
about the port.
"""

from dataclasses import dataclass


@dataclass(frozen=True)
class CodecConfig:
    # Transform geometry (codec.rs:15-16)
    frame_size: int = 2048  # 2N — samples per MDCT block
    hop_size: int = 1024    # N — hop, 50% overlap

    # Quantization (codec.rs:17, 24-25)
    quantization_bits: int = 16
    min_quantization_bits: int = 8
    max_quantization_bits: int = 16

    # Streaming (codec.rs:18-19)
    frames_per_chunk: int = 500
    decode_batch: int = 32

    # Lossy parameters (codec.rs:22-23)
    noise_floor_db: float = -48.0
    quality_factor: float = 0.7

    # Per-frame raw-PCM fallback threshold (codec.rs:29)
    compression_threshold: float = 0.85

    # --- Rebuild-specific knobs (not in the reference) ---
    # Reproduce the reference's quirky behaviors exactly (SURVEY.md §2.9):
    #  Q1  gapless trim in interleaved units (codec.rs:755-767)
    #  Q4  raw-PCM frames windowed once at encode, not re-windowed at decode
    #      (codec.rs:496-502 vs 626-643)
    #  Q13 raw-PCM stored channel-major (codec.rs:471-503) but read back
    #      interleaved (codec.rs:636) — scrambles stereo raw frames
    # Setting reference_compat=False fixes all three (clean-path mode).
    reference_compat: bool = True

    # Device batching: frames per jitted chunk (static shape → one compile).
    encode_chunk_frames: int = 4096
    # Decode chunks are deliberately SMALLER than encode's: a chunk is the
    # decode pipeline's overlap unit (chunk i+1's pack/upload/dispatch/
    # compute hide under chunk i's downloads), and a 60 s file in ONE
    # 2816-frame chunk has nothing to overlap — measured 68.6% of the
    # adjacent-probe link ceiling vs 104.9% at 1408 (2 chunks), 95.1% at
    # 512, on a v5e relay (r5 chunk sweep; median of 5 probed reps each).
    decode_chunk_frames: int = 1408
    # Smaller chunks for streaming consumers that do host work per chunk
    # (FLAC export): their math overlaps the next chunk's transfers, ~20%
    # faster end-to-end (measured on a v5e relay); bytes identical.
    stream_chunk_frames: int = 1024

    # Fused Pallas IMDCT+window kernel on the decode path (measured −27% on
    # the transform on a v5e, ops/pallas_kernels.py).  Off by default: its
    # accumulation order differs from the XLA einsum by ULPs, and byte-level
    # determinism of f32 decode output across code paths wins by default.
    use_pallas: bool = False

    # Segment-batched album paths for MULTI-segment tracks
    # (encode_interleaved_units_device / decode_chunks_packed_batch_carry_
    # device): every same-shape segment of every track in one lax.map
    # dispatch, carries chained on device.  Off by default: on a host link
    # where the WIRE is the constraint (this environment's relay), the
    # default paths beat or match it at 4×120 s — ENCODE's full-depth
    # interleaved pipeline measures ~1.1-1.3× vs the serial loop (batched
    # 0.75-0.9×), while DECODE is download-wire-bound: every structure
    # lands within wire-phase noise of the serial loop, the batched
    # dispatch 0.75-0.85× BELOW it — keeping the wire saturated beats
    # reducing dispatch count (STATUS.md round-4 measurements).  Turn on
    # for fast-interconnect deployments (PCIe)
    # where per-dispatch overhead dominates transfer time.  Both paths are
    # correctness-tested; encode is bit-identical either way.
    segmented_batch: bool = False

    # On-chip pair-compaction implementation (ops/encode.py
    # compact_pairs_any) — how the encode program packs kept (k, q) pairs
    # into the stream-ordered download buffer.  All modes are bit-identical;
    # they differ only in on-chip cost (the compaction was the dominant
    # on-chip encode cost, VERDICT r3 weak #5).  v5e slope-timed sweep on
    # the SHIPPED 2816-frame stereo encode segment's real q, bucket-pad
    # rows zeroed as the shipped programs do (ms per program):
    #   "shift:64" (monotone binary lane routing — no sort)   1.3
    #   "shift:<G>"  G=16 1.3, G=32 1.6, G=128 2.6, G=256 2.9
    #   "sort2:384" (row sort + P-slice + narrow group sort)  3.1
    #   "sort" (grouped sort + windowed scatter-add, G=16)    ~4.2
    #   "gather" (within-block sort + output-sized gathers)   ~20
    #   "blocked" (two-stage scatter, compact_bb_mult=5)      ~18
    #   "legacy" (single full element scatter)                ~27
    # (sort/gather/blocked/legacy scaled from the earlier 4096-frame
    # sweep — 5.3/28.5/26.2/39.5 ms at 1.45× the slots.)
    # The shift mode is a stable partition, not a sort: each kept element
    # hops left by its precomputed distance in log2(G·n) binary sweeps —
    # O(W·log W) selects vs the sorts' O(W·log² W) compare-exchanges, no
    # density-dependent branch, no key-width cap at any n.
    compact_mode: str = "shift"

    # Two-stage blocked compaction budget (compact_mode="blocked" only):
    # mean kept 128-wide blocks per (frame, channel) row the fast branch
    # accommodates (ops/encode.py _compact_pairs_auto).  The element scatter that packs kept (k, q)
    # pairs is the dominant on-chip encode cost (VERDICT r3 weak #5);
    # compacting BLOCKS first makes stage 2 scale with bb_mult/8 of the
    # legacy scatter.  v5e sweep on 60 s program material (forced, 4096-
    # frame stereo program): 5 → 34.0 ms, 6 → 39.2, 7 → 44.4, ≥8 ≡ full
    # coverage ≈ legacy 49.7, ≤4 overflows into the full branch (same
    # 49.7).  Content whose mean kept blocks exceed the budget takes that
    # full-coverage lax.cond branch on device (legacy cost, never
    # incomplete), so a too-small budget costs at most the legacy scatter
    # — 5 rides the measured density of program-like material with that
    # bounded downside.  Bit-identical at every setting.  0 = legacy
    # element scatter.
    compact_bb_mult: int = 5

    @property
    def n(self) -> int:
        """Number of MDCT coefficients per frame (= hop_size)."""
        return self.hop_size

    @property
    def max_q(self) -> float:
        """Fixed quantization denominator 2^(bits-1) (codec.rs:281,656)."""
        return float(1 << (self.quantization_bits - 1))


DEFAULT_CONFIG = CodecConfig()


def config_from_dict(d: dict) -> CodecConfig:
    """Build the port's config from ``dataclasses.asdict`` of a
    ``glc_tpu`` config (the field sets are identical)."""
    return CodecConfig(**d)
