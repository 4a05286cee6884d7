"""`glc` command-line interface of the port (mirrors reference src/main.rs).

Port of ``glc_tpu/cli.py`` with the same arguments, printed lines and exit
codes:

    python -m glc_tpu_torch <file.wav|file.flac> ...                    Encode to .glc
    python -m glc_tpu_torch -d <file.glc> ... [--wav] [--flac-level N]  Decode .glc files
    python -m glc_tpu_torch -p <file.glc> ... [--ffplay]                Play .glc files (gapless)
    python -m glc_tpu_torch                                             Launch the GUI

Decoding writes FLAC by default (`Decoder.decode_i16_stream` feeding
`encode_flac_i16_streaming`), or WAV with ``--wav``.  Playback streams
`Decoder.decode_streaming`'s chunks to one sink (playback.py); with no
arguments the tkinter GUI starts, or, with no display, the usage is
printed.  Several input files are loaded first and encoded in batches
through `Encoder.encode_many` (`_encode_jobs`), as the JAX CLI does.  The
CLI takes no device argument: it runs on the card, or where
$GLC_TORCH_DEVICE says (``cpu``).
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import List


def is_lossless_audio_file(path: Path) -> bool:
    """main.rs:303-315"""
    ext = path.suffix[1:].lower() if path.suffix else ""
    return ext in ("wav", "flac")


def is_glc_file(path: Path) -> bool:
    """main.rs:317-328"""
    ext = path.suffix[1:].lower() if path.suffix else ""
    return ext == "glc"


def print_usage() -> None:
    """main.rs:330-352"""
    e = lambda s="": print(s, file=sys.stderr)
    e("Usage:")
    e("  glc <file.wav|file.flac> ...                    Encode audio files to .glc")
    e("  glc -d <file.glc> ... [--wav] [--flac-level N]  Decode .glc files")
    e("  glc -p <file.glc> ... [--ffplay]                Play .glc files (gapless)")
    e("  glc                                              Launch GUI (if ui feature enabled)")
    e()
    e("Options:")
    e("  -d, --decode       Decode .glc files to FLAC (default) or WAV")
    e("  -p, --play         Play .glc files using audio system (gapless for multiple files)")
    e("      --ffplay       Use ffplay for playback (sequential for multiple files)")
    e("      --wav          Output WAV format instead of FLAC")
    e("      --flac-level   Set FLAC compression level 0-8 (default: 5)")
    e()
    e("Examples:")
    e("  glc audio.wav                         # Encode to audio.glc")
    e("  glc -d file1.glc file2.glc --wav      # Decode multiple files to WAV")
    e("  glc -d file.glc --flac-level 8        # Decode with maximum FLAC compression")
    e("  glc -p track1.glc track2.glc          # Play multiple files gaplessly")
    e()
    e("Supported formats: WAV, FLAC (input), GLC (decode/play)")


def encode_file(input_path: Path) -> None:
    """main.rs:20-52 — the per-file encode API (load → encode → save, with
    the reference's printed lines).  16-bit sources (WAV or FLAC) take the
    exact int16 path.  The CLI's multi-file path batches through
    `_encode_jobs` instead; both share `_save_and_report`."""
    from .codec.encoder import Encoder
    from .io.audio import load_audio_for_encode

    print(f"Loading: {input_path.name!r}")
    samples, sample_rate, channels, is_pcm16 = load_audio_for_encode(
        input_path
    )
    print(f"Encoding: {sample_rate} Hz, {channels} channels, "
          f"{len(samples)} samples")

    encoder = Encoder(sample_rate)
    if is_pcm16:
        encoded = encoder.encode_pcm16(samples, channels)
    else:
        encoded = encoder.encode(samples, channels)
    _save_and_report(input_path, encoded)


def decode_file(input_path: Path, output_format: str, flac_level: int) -> None:
    """main.rs:54-113"""
    from .codec.decoder import Decoder
    from .container.bincode import load_encoded
    from .flac.encoder import encode_flac_i16_streaming
    from .io.wav import write_wav_i16

    print(f"Loading: {input_path.name!r}")
    encoded = load_encoded(input_path)
    print(f"Decoding: {encoded.header.sample_rate} Hz, "
          f"{encoded.header.channels} channels")

    decoder = Decoder(encoded.header.channels, encoded.header.sample_rate)
    if output_format == "flac":
        # streaming export: the MD5 and the predictor/Rice math run on a
        # worker thread while the device decodes the next chunks; the bytes
        # equal those of decode-then-encode
        channels = encoded.header.channels
        n_total = decoder.decoded_length(encoded)
        data = encode_flac_i16_streaming(
            decoder.decode_i16_stream(
                encoded,
                chunk_frames=decoder.config.stream_chunk_frames),
            encoded.header.sample_rate, channels, flac_level,
            n_total // channels,
        )
        print(f"Decoded {n_total} samples")
        output_path = input_path.with_suffix(".flac")
        output_path.write_bytes(data)
        print(f"Saved: {output_path.name!r} (FLAC, level {flac_level})")
        return

    samples = decoder.decode_i16(encoded)
    print(f"Decoded {len(samples)} samples")

    if output_format == "wav":
        output_path = input_path.with_suffix(".wav")
        write_wav_i16(output_path, samples, encoded.header.sample_rate,
                      encoded.header.channels)
        print(f"Saved: {output_path.name!r} (WAV)")
    else:
        raise ValueError(f"Unsupported output format: {output_format}")


def _main_decode(args: List[str]) -> int:
    """main.rs:364-457"""
    if not args:
        print("Error: -d requires at least one .glc file", file=sys.stderr)
        print_usage()
        return 1

    has_errors = False
    files_to_decode: List[Path] = []
    output_format = "flac"
    flac_level = 5
    i = 0
    while i < len(args):
        a = args[i]
        if a == "--wav":
            output_format = "wav"
            i += 1
        elif a == "--flac-level":
            if i + 1 >= len(args):
                print("Error: --flac-level requires a value (0-8)",
                      file=sys.stderr)
                return 1
            try:
                flac_level = int(args[i + 1])
                if flac_level < 0:
                    raise ValueError
            except ValueError:
                print("Error: Invalid FLAC level, must be 0-8", file=sys.stderr)
                return 1
            if flac_level > 8:
                print("Error: FLAC level must be 0-8", file=sys.stderr)
                return 1
            i += 2
        else:
            path = Path(a)
            if not path.exists():
                print(f"Error: File not found: {str(path)!r}", file=sys.stderr)
                has_errors = True
            elif not is_glc_file(path):
                print(f"Error: Not a .glc file: {str(path)!r}", file=sys.stderr)
                has_errors = True
            else:
                files_to_decode.append(path)
            i += 1

    if not files_to_decode:
        print("Error: No valid .glc files to decode", file=sys.stderr)
        return 1

    for path in files_to_decode:
        try:
            decode_file(path, output_format, flac_level)
        except Exception as e:
            print(f"Error decoding file: {e}", file=sys.stderr)
            has_errors = True

    return 1 if has_errors else 0


def _main_play(args: List[str]) -> int:
    """main.rs:460-543"""
    from .playback import play_file_with_ffplay, play_files_gapless

    if not args:
        print("Error: -p requires at least one .glc file", file=sys.stderr)
        print_usage()
        return 1

    use_ffplay = False
    files_to_play: List[Path] = []
    for a in args:
        if a == "--ffplay":
            use_ffplay = True
        else:
            path = Path(a)
            if not path.exists():
                print(f"Error: File not found: {str(path)!r}", file=sys.stderr)
                return 1
            if not is_glc_file(path):
                print(f"Error: Not a .glc file: {str(path)!r}", file=sys.stderr)
                return 1
            files_to_play.append(path)

    if not files_to_play:
        print("Error: No valid .glc files to play", file=sys.stderr)
        return 1

    if use_ffplay:
        for path in files_to_play:  # sequential, main.rs:512-527
            try:
                play_file_with_ffplay(path)
            except Exception as e:
                print(f"Error playing file: {e}", file=sys.stderr)
                return 1
    else:
        try:
            play_files_gapless(files_to_play)
        except Exception as e:
            print(f"Error playing files: {e}", file=sys.stderr)
            return 1
    return 0


# Flush the pending encode batch whenever this much decoded PCM is resident
# (glc_tpu/cli.py:229-232): a 100-track album must not hold every track's
# samples in host memory at once.
_ENCODE_BATCH_BYTES = 512 << 20


def _save_and_report(input_path: Path, encoded) -> None:
    """The save and 'Saved:' line of encode_file (main.rs:38-51)."""
    from .container.bincode import save_encoded

    output_path = input_path.with_suffix(".glc")
    save_encoded(encoded, output_path)
    input_size = input_path.stat().st_size
    output_size = output_path.stat().st_size
    ratio = output_size / input_size * 100.0
    print(f"Saved: {output_path.name!r} ({output_size} bytes, "
          f"{ratio:.1f}% of original)")


def _encode_jobs(jobs) -> bool:
    """Encode and save loaded (path, samples, rate, channels) jobs, the
    tracks of each rate in one `encode_many` call; returns True if any
    failed.  A failed batch is reported and its files are encoded one by
    one on the same device, so one bad file fails alone, as in the
    reference's serial loop (glc_tpu/cli.py:248-294)."""
    import numpy as np

    from .codec.encoder import Encoder

    has_errors = False
    by_rate: dict = {}
    for j, (_path, _samples, rate, _ch) in enumerate(jobs):
        by_rate.setdefault(rate, []).append(j)
    encoded_all = [None] * len(jobs)
    for rate, idxs in by_rate.items():
        enc = Encoder(rate)
        try:
            outs = enc.encode_many([(jobs[j][1], jobs[j][3]) for j in idxs])
            for j, ea in zip(idxs, outs):
                encoded_all[j] = ea
        except Exception as e:
            print(f"Warning: batched encode failed ({e}); "
                  f"retrying files serially", file=sys.stderr)
            for j in idxs:
                _path, samples, _rate, ch = jobs[j]
                try:
                    if samples.dtype == np.int16:
                        encoded_all[j] = enc.encode_pcm16(samples, ch)
                    else:
                        encoded_all[j] = enc.encode(samples, ch)
                except Exception as e2:
                    print(f"Error encoding file: {e2}", file=sys.stderr)
                    has_errors = True

    for j, (path, _samples, _rate, _ch) in enumerate(jobs):
        if encoded_all[j] is None:
            continue
        try:
            _save_and_report(path, encoded_all[j])
        except Exception as e:
            print(f"Error encoding file: {e}", file=sys.stderr)
            has_errors = True
    return has_errors


def _main_encode(args: List[str]) -> int:
    """main.rs:545-583 — same checks, messages and exit codes; the loaded
    files are encoded in batches (`_encode_jobs`).  'Saved' lines print
    after each flushed batch, in input order; resident PCM is bounded by
    `_ENCODE_BATCH_BYTES`."""
    from .io.audio import load_audio_for_encode

    has_errors = False
    jobs = []  # (path, samples, rate, channels)
    pending_bytes = 0
    for a in args:
        path = Path(a)
        if not path.exists():
            print(f"Error: File not found: {str(path)!r}", file=sys.stderr)
            has_errors = True
            continue
        if not is_lossless_audio_file(path):
            print(f"Error: Unsupported file type: {str(path)!r}",
                  file=sys.stderr)
            print("Supported formats: WAV, FLAC", file=sys.stderr)
            has_errors = True
            continue
        try:
            print(f"Loading: {path.name!r}")
            # 16-bit sources arrive as int16 and take the exact int16 path
            # inside encode_many
            samples, rate, channels, _is_pcm16 = load_audio_for_encode(path)
            print(f"Encoding: {rate} Hz, {channels} channels, "
                  f"{len(samples)} samples")
            jobs.append((path, samples, rate, channels))
            pending_bytes += samples.nbytes
        except Exception as e:
            print(f"Error encoding file: {e}", file=sys.stderr)
            has_errors = True
        if pending_bytes >= _ENCODE_BATCH_BYTES:
            has_errors |= _encode_jobs(jobs)
            jobs, pending_bytes = [], 0

    if jobs:
        has_errors |= _encode_jobs(jobs)
    return 1 if has_errors else 0


def main(argv: List[str] | None = None) -> int:
    """main.rs:354-613"""
    args = list(sys.argv[1:] if argv is None else argv)
    if args:
        first = args[0]
        if first in ("-d", "--decode"):
            return _main_decode(args[1:])
        if first in ("-p", "--play"):
            return _main_play(args[1:])
        return _main_encode(args)

    # GUI mode (main.rs:586-611); fall back to usage + exit 1 when no
    # GUI backend/display is available, like a build without the ui feature
    try:
        from .ui import run_gui
        return run_gui()
    except Exception:
        print_usage()
        return 1


if __name__ == "__main__":
    sys.exit(main())
