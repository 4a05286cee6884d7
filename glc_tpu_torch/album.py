"""Album-level operations: gapless playlist decode and concatenated export.

Port of ``glc_tpu/album.py``.  Library form of the GUI's "gapless album
join" (reference src/ui.rs:291-402): decode every .glc in order,
concatenate the trimmed streams, export one lossless file.  The per-file
trims make the concatenation sample-exact at track boundaries — the
gapless contract (reference tests/test_codec.rs:139-170).

Without a progress callback `decode_playlist` decodes through
`Decoder.decode_many`, so each group of single-chunk tracks is one kernel
launch on the rows of all its tracks; with one it decodes track by track
with `decode_i16`, so the callback moves as each track ends.  On the card
the two give the same bytes (the kernel computes each row alike at any row
count); on the CPU they may differ by 1 LSB, the bound the JAX package
holds between its own programs.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional, Sequence, Union

import numpy as np

from .codec.decoder import Decoder
from .container.bincode import load_encoded
from .container.schema import Progress

PathLike = Union[str, Path]


def _load_playlist(paths: Sequence[PathLike]):
    """[(path, EncodedAudio)], rate, channels; raises ValueError on an
    empty playlist or a track whose rate or channel count differs from the
    first one's (ui.rs decodes them into one sink; resampling is not
    done)."""
    if not paths:
        raise ValueError("empty playlist")
    encodeds = []
    rate = channels = None
    for path in map(Path, paths):
        encoded = load_encoded(path)
        h = encoded.header
        if rate is None:
            rate, channels = h.sample_rate, h.channels
        elif (h.sample_rate, h.channels) != (rate, channels):
            raise ValueError(
                f"{path.name}: {h.sample_rate} Hz/{h.channels}ch does not "
                f"match playlist {rate} Hz/{channels}ch"
            )
        encodeds.append((path, encoded))
    return encodeds, rate, channels


def decode_playlist(
    paths: Sequence[PathLike],
    progress: Optional[Callable[[Progress], None]] = None,
    device=None,
):
    """Decode a playlist to one concatenated int16 stream.

    Returns (samples int16 interleaved, sample_rate, channels).  All files
    must share a sample rate and channel count.  `device` is the
    decoder's (None: `resolve_device`'s rule).
    """
    encodeds, rate, channels = _load_playlist(paths)
    dec = Decoder(channels, rate, device=device)
    if progress is None:
        parts = dec.decode_many([ea for _p, ea in encodeds])
    else:
        # an interactive consumer wants per-track movement
        parts = []
        for i, (path, ea) in enumerate(encodeds):
            progress(Progress.status(f"Decoding {path.name}"))
            parts.append(dec.decode_i16(ea))
            progress(Progress.decoding((i + 1) / len(encodeds) * 100.0))
    return np.concatenate(parts), rate, channels


def export_playlist_to_flac(
    paths: Sequence[PathLike],
    out_path: PathLike,
    compression_level: int = 5,
    progress: Optional[Callable[[Progress], None]] = None,
    device=None,
) -> None:
    """ui.rs:291-402 — decode all, concatenate, single FLAC export.

    Streams each track's decoded chunks (`decode_i16_stream` at
    ``stream_chunk_frames``) straight into the FLAC encoder, so the host's
    MD5/predictor/Rice work overlaps the device decode (bytes equal to
    decode-everything-then-encode).
    """
    from .flac.encoder import encode_flac_i16_streaming

    encodeds, rate, channels = _load_playlist(paths)
    dec = Decoder(channels, rate, device=device)
    total = sum(dec.decoded_length(ea) for _p, ea in encodeds)

    def chunks():
        for i, (path, ea) in enumerate(encodeds):
            if progress:
                progress(Progress.status(f"Decoding {path.name}"))
            yield from dec.decode_i16_stream(
                ea, chunk_frames=dec.config.stream_chunk_frames)
            if progress:
                progress(Progress.decoding((i + 1) / len(encodeds) * 100.0))

    data = encode_flac_i16_streaming(chunks(), rate, channels,
                                     compression_level, total // channels)
    if progress:
        progress(Progress.exporting(90.0))
    Path(out_path).write_bytes(data)
    if progress:
        progress(Progress.complete(f"Exported {len(paths)} tracks"))


def export_playlist_to_wav(
    paths: Sequence[PathLike],
    out_path: PathLike,
    progress: Optional[Callable[[Progress], None]] = None,
    device=None,
) -> None:
    """`decode_playlist`, written as one 16-bit WAV."""
    from .io.wav import write_wav_i16

    samples, rate, channels = decode_playlist(paths, progress, device)
    write_wav_i16(out_path, samples, rate, channels)
    if progress:
        progress(Progress.complete(f"Exported {len(paths)} tracks"))
