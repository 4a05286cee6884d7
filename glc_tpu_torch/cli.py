"""`glc` command-line interface of the port (mirrors reference src/main.rs).

Port of ``glc_tpu/cli.py`` with the same arguments, printed lines and exit
codes for what is ported:

    python -m glc_tpu_torch <file.wav> ...         Encode WAV files to .glc
    python -m glc_tpu_torch -d <file.glc> ... --wav  Decode .glc files to WAV

Not ported yet, and refused with exit code 2 instead of falling through:
FLAC export (``-d`` without ``--wav``, the default) and playback (``-p``).
FLAC input is reported as an error per file, and with no arguments the
usage is printed (the JAX package would try its GUI).  Files are encoded
one after another; the JAX CLI batches them, which changes only when its
"Saved" lines print.
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
    """main.rs:330-352, less what is not ported."""
    e = lambda s="": print(s, file=sys.stderr)
    e("Usage:")
    e("  glc <file.wav> ...                Encode audio files to .glc")
    e("  glc -d <file.glc> ... --wav       Decode .glc files to WAV")
    e()
    e("Options:")
    e("  -d, --decode       Decode .glc files (FLAC export is not ported yet)")
    e("      --wav          Output WAV format")
    e()
    e("Examples:")
    e("  glc audio.wav                         # Encode to audio.glc")
    e("  glc -d file1.glc file2.glc --wav      # Decode multiple files to WAV")
    e()
    e("Supported formats: WAV (input), GLC (decode)")


def load_wav_for_encode(path: Path):
    """(samples, sample_rate, channels, is_pcm16): int16 samples for 16-bit
    PCM WAVs (the encoder's exact half-upload path), float32 otherwise."""
    from .io.wav import read_wav, read_wav_pcm16

    if path.suffix.lower() != ".wav":
        raise ValueError("FLAC input is not ported yet")
    pcm16 = read_wav_pcm16(path)
    if pcm16 is not None:
        samples, rate, ch = pcm16
        return samples, rate, ch, True
    samples, rate, ch = read_wav(path)
    return samples, rate, ch, False


def encode_file(input_path: Path) -> None:
    """main.rs:20-52 — load → encode → save, with the reference's printed
    lines."""
    from .codec.encoder import Encoder
    from .container.bincode import save_encoded

    print(f"Loading: {input_path.name!r}")
    samples, sample_rate, channels, is_pcm16 = load_wav_for_encode(input_path)
    print(f"Encoding: {sample_rate} Hz, {channels} channels, "
          f"{len(samples)} samples")

    encoder = Encoder(sample_rate)
    if is_pcm16:
        encoded = encoder.encode_pcm16(samples, channels)
    else:
        encoded = encoder.encode(samples, channels)
    output_path = input_path.with_suffix(".glc")
    save_encoded(encoded, output_path)
    input_size = input_path.stat().st_size
    output_size = output_path.stat().st_size
    ratio = output_size / input_size * 100.0
    print(f"Saved: {output_path.name!r} ({output_size} bytes, "
          f"{ratio:.1f}% of original)")


def decode_file(input_path: Path) -> None:
    """main.rs:54-113, WAV output."""
    from .codec.decoder import Decoder
    from .container.bincode import load_encoded
    from .io.wav import write_wav_i16

    print(f"Loading: {input_path.name!r}")
    encoded = load_encoded(input_path)
    print(f"Decoding: {encoded.header.sample_rate} Hz, "
          f"{encoded.header.channels} channels")

    decoder = Decoder(encoded.header.channels, encoded.header.sample_rate)
    samples = decoder.decode_i16(encoded)
    print(f"Decoded {len(samples)} samples")

    output_path = input_path.with_suffix(".wav")
    write_wav_i16(output_path, samples, encoded.header.sample_rate,
                  encoded.header.channels)
    print(f"Saved: {output_path.name!r} (WAV)")


def _main_decode(args: List[str]) -> int:
    """main.rs:364-457"""
    if not args:
        print("Error: -d requires at least one .glc file", file=sys.stderr)
        print_usage()
        return 1

    has_errors = False
    files_to_decode: List[Path] = []
    output_format = "flac"
    i = 0
    while i < len(args):
        a = args[i]
        if a == "--wav":
            output_format = "wav"
            i += 1
        elif a == "--flac-level":  # validated as the JAX CLI does; unused
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

    if output_format == "flac":
        print("Error: FLAC export is not ported yet; pass --wav",
              file=sys.stderr)
        return 2
    if not files_to_decode:
        print("Error: No valid .glc files to decode", file=sys.stderr)
        return 1

    for path in files_to_decode:
        try:
            decode_file(path)
        except Exception as e:
            print(f"Error decoding file: {e}", file=sys.stderr)
            has_errors = True

    return 1 if has_errors else 0


def _main_encode(args: List[str]) -> int:
    """main.rs:545-583 — same checks, messages and exit codes."""
    has_errors = False
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
            encode_file(path)
        except Exception as e:
            print(f"Error encoding file: {e}", file=sys.stderr)
            has_errors = True
    return 1 if has_errors else 0


def main(argv: List[str] | None = None) -> int:
    """main.rs:354-613"""
    args = list(sys.argv[1:] if argv is None else argv)
    if not args:
        print_usage()
        return 1
    first = args[0]
    if first in ("-d", "--decode"):
        return _main_decode(args[1:])
    if first in ("-p", "--play"):
        print("Error: playback is not ported yet", file=sys.stderr)
        return 2
    return _main_encode(args)


if __name__ == "__main__":
    sys.exit(main())
