"""Playback adapters (mirrors reference src/playback.rs and the play paths
of src/main.rs:115-301).

Port of ``glc_tpu/playback.py``, with the same names, printed lines and
callbacks; the chunks come from the port's `Decoder.decode_streaming`, so
on the card every chunk runs the `imdct_window` kernel.

* `SamplesSource` — one decoded chunk of interleaved f32 samples plus the
  rate/channel metadata a sink needs (the rodio `Source` adapter,
  playback.rs:3-66).  This is the unit every playback path consumes: the
  streaming decoder's chunks become SamplesSources, and sinks append them
  back-to-back — which is exactly the gapless property (main.rs:152-161).
* `stream_playlist_sources` — the shared chunk source: decode a .glc
  playlist into a stream of SamplesSources (untrimmed streaming chunks,
  codec.rs:744-768 never trims the streaming path).
* `FfplaySink` — pipe f32le chunks to an ffplay child process
  (main.rs:218-274), the playback path that needs no audio device library.
* `AudioDeviceSink` — direct audio-device output via `sounddevice` or
  `simpleaudio` when one is importable (the rodio analog, main.rs:128-167);
  probed at runtime, never a hard dependency.
* `play_files_gapless` — the rodio-style gapless path: device sink when a
  backend exists, ffplay fallback otherwise, matching the reference's
  feature-gated fallback messaging (main.rs:181-198).

`stream_playlist_sources`, `drive_playlist`, `play_files_gapless` and
`play_file_with_ffplay` take the decoder's `device` (None:
`codec.device.resolve_device`'s rule).
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import threading
from pathlib import Path
from typing import Callable, Iterable, Iterator, List, Optional

import numpy as np


class SamplesSource:
    """reference src/playback.rs:3-66 — one chunk of interleaved f32 samples.

    Iterates per sample (the rodio `Source` protocol) and exposes
    `remaining()` for sinks that consume whole buffers at once.
    """

    def __init__(self, samples: np.ndarray, sample_rate: int, channels: int):
        self.samples = np.asarray(samples, np.float32)
        self.sample_rate = int(sample_rate)
        self.channels = int(channels)
        self.position = 0

    def __iter__(self) -> Iterator[float]:
        return self

    def __next__(self) -> float:
        if self.position >= len(self.samples):
            raise StopIteration
        v = float(self.samples[self.position])
        self.position += 1
        return v

    def remaining(self) -> np.ndarray:
        """Unconsumed samples as one array (bulk-sink fast path); advances
        the iterator to the end so per-sample and bulk reads compose."""
        out = self.samples[self.position :]
        self.position = len(self.samples)
        return out

    # rodio::Source-equivalent metadata (playback.rs:44-66)
    def current_frame_len(self) -> Optional[int]:
        return None

    def total_duration(self) -> Optional[float]:
        return None


def stream_playlist_sources(
    paths: Iterable[Path],
    stop: Optional[threading.Event] = None,
    on_file: Optional[Callable[[Path, int, int], None]] = None,
    on_error: Optional[Callable[[Path, str], None]] = None,
    device=None,
) -> Iterator[SamplesSource]:
    """Decode a .glc playlist into a stream of SamplesSource chunks.

    The shared chunk source behind every playback surface (CLI ffplay, CLI
    gapless, GUI player): one SamplesSource per streaming-decoder chunk, in
    playlist order, untrimmed — consecutive files' chunks appended
    back-to-back is the reference's gapless join (main.rs:152-161).

    `stop` aborts between chunks; `on_file(path, rate, channels)` fires as
    each file's header is read; a decode error reports via `on_error` and
    continues with the next playlist entry (the reference's closed-channel
    recv loop, main.rs:152-161).  However the stream ends, each file's
    producer thread has ended before the next file starts or the generator
    returns: none is left launching device work behind the consumer.
    """
    from .codec.decoder import Decoder
    from .container.bincode import load_encoded

    for path in paths:
        if stop is not None and stop.is_set():
            return
        encoded = load_encoded(path)
        rate = encoded.header.sample_rate
        channels = encoded.header.channels
        if on_file is not None:
            on_file(path, rate, channels)
        decoder = Decoder(channels, rate, device=device)
        rx = decoder.decode_streaming(encoded)
        try:
            while True:
                if stop is not None and stop.is_set():
                    return
                chunk = rx.get()
                if chunk.error is not None:
                    if on_error is not None:
                        on_error(path, chunk.error)
                    break
                yield SamplesSource(chunk.samples, rate, channels)
                if chunk.is_last:
                    break
        finally:
            rx.cancelled.set()  # release the producer if we bailed early
            rx.producer.join()


def ffplay_available() -> bool:
    return shutil.which("ffplay") is not None


def _probe_device_backend():
    """Runtime probe for a native audio-device library (the rodio analog).

    Returns ("sounddevice"|"simpleaudio", module) or None.  Neither is a
    dependency; without one, playback rides the ffplay pipe."""
    try:
        import sounddevice  # type: ignore[import-not-found]

        return ("sounddevice", sounddevice)
    except ImportError:
        pass
    try:
        import simpleaudio  # type: ignore[import-not-found]

        return ("simpleaudio", simpleaudio)
    except ImportError:
        pass
    return None


def audio_device_available() -> bool:
    return _probe_device_backend() is not None


class AudioDeviceSink:
    """Direct audio-device playback (reference rodio path, main.rs:128-167).

    Backend-probed: `sounddevice` streams f32 frames; `simpleaudio` plays
    i16 buffers sequentially (each waits for the previous — chunk order is
    the gapless contract).  Raises RuntimeError when no backend exists."""

    def __init__(self, sample_rate: int, channels: int, backend=None):
        self.sample_rate = int(sample_rate)
        self.channels = int(channels)
        backend = backend or _probe_device_backend()
        if backend is None:
            raise RuntimeError("no audio device backend available")
        self.backend_name, self._mod = backend
        self._play_obj = None
        if self.backend_name == "sounddevice":
            self._stream = self._mod.OutputStream(
                samplerate=self.sample_rate,
                channels=self.channels,
                dtype="float32",
            )
            self._stream.start()

    def write(self, samples: np.ndarray) -> bool:
        data = np.asarray(samples, np.float32)
        if data.size == 0:
            return True
        try:
            if self.backend_name == "sounddevice":
                self._stream.write(data.reshape(-1, self.channels))
            else:  # simpleaudio: sequential i16 buffers
                i16 = np.clip(data * 32767.0, -32768, 32767).astype("<i2")
                if self._play_obj is not None:
                    self._play_obj.wait_done()
                self._play_obj = self._mod.play_buffer(
                    i16.tobytes(), self.channels, 2, self.sample_rate
                )
            return True
        except Exception as e:
            print(f"Error writing to audio device: {e}", file=sys.stderr)
            return False

    def append(self, source: SamplesSource) -> bool:
        return self.write(source.remaining())

    def close(self) -> int:
        try:
            if self.backend_name == "sounddevice":
                self._stream.stop()
                self._stream.close()
            elif self._play_obj is not None:
                self._play_obj.wait_done()  # sleep_until_end (main.rs:167)
        except Exception:
            return 1
        return 0


class FfplaySink:
    """A child ffplay process fed f32le over stdin (main.rs:218-274).

    ffplay's output streams go to temp files, not pipes: ffplay rewrites a
    status line continuously, and an undrained 64 KB stderr pipe would fill
    after a few minutes and deadlock the stdin writes (a latent bug in the
    reference's Stdio::piped + wait_with_output approach)."""

    def __init__(self, sample_rate: int, channels: int):
        import tempfile

        self._out = tempfile.TemporaryFile()
        self._err = tempfile.TemporaryFile()
        self.proc = subprocess.Popen(
            [
                "ffplay",
                "-f", "f32le",
                "-ar", str(sample_rate),
                "-ac", str(channels),
                "-nodisp",
                "-autoexit",
                "-",
            ],
            stdin=subprocess.PIPE,
            stdout=self._out,
            stderr=self._err,
        )

    def write(self, samples: np.ndarray) -> bool:
        try:
            self.proc.stdin.write(
                np.asarray(samples, np.float32).astype("<f4").tobytes()
            )
            return True
        except (BrokenPipeError, OSError) as e:
            print(f"Error writing to ffplay: {e}", file=sys.stderr)
            return False

    def append(self, source: SamplesSource) -> bool:
        """Consume one SamplesSource chunk (the sink.append of main.rs:161)."""
        return self.write(source.remaining())

    def close(self) -> int:
        try:
            self.proc.stdin.close()
        except OSError:
            pass
        self.proc.wait()
        if self.proc.returncode != 0:
            print(f"ffplay exited with status: {self.proc.returncode}",
                  file=sys.stderr)
            try:
                self._err.seek(0)
                err = self._err.read()
                if err:
                    print("ffplay stderr:", file=sys.stderr)
                    print(err.decode(errors="replace"), file=sys.stderr)
            except OSError:
                pass
        self._out.close()
        self._err.close()
        return self.proc.returncode


def play_file_with_ffplay(input_path: Path, device=None) -> None:
    """main.rs:200-301 — stream one .glc file to ffplay."""
    print(f"Loading: {input_path.name!r}")
    sink = None
    chunks_sent = 0

    def on_file(path: Path, rate: int, channels: int) -> None:
        nonlocal sink
        print(f"Playing: {rate} Hz, {channels} channels (via ffplay)")
        print("Press Ctrl+C or close ffplay window to stop")
        try:
            sink = FfplaySink(rate, channels)
        except FileNotFoundError as e:
            print(f"Error: Failed to spawn ffplay: {e}", file=sys.stderr)
            print("Make sure ffplay is installed and in your PATH",
                  file=sys.stderr)
            raise

    def on_error(path: Path, err: str) -> None:
        print(f"Error decoding: {err}", file=sys.stderr)

    for source in stream_playlist_sources([input_path], on_file=on_file,
                                          on_error=on_error, device=device):
        chunks_sent += 1
        if not sink.append(source):
            break
    print(f"Sent {chunks_sent} chunks to ffplay")
    if sink is not None and sink.close() == 0:
        print("Playback finished")


def open_sink(sample_rate: int, channels: int):
    """Best-available playback sink: a native audio device when a backend
    library is importable (the rodio path, main.rs:128-132), the ffplay
    pipe otherwise."""
    if audio_device_available():
        return AudioDeviceSink(sample_rate, channels)
    return FfplaySink(sample_rate, channels)


def drive_playlist(
    file_paths: List[Path],
    sink_factory: Callable[[int, int], object],
    stop: Optional[threading.Event] = None,
    on_file: Optional[Callable[[Path, int, int], None]] = None,
    on_error: Optional[Callable[[Path, str], None]] = None,
    on_drained: Optional[Callable[[], None]] = None,
    device=None,
) -> bool:
    """The shared gapless-playback loop behind the CLI player and the GUI
    controller: one sink fed every SamplesSource chunk, restarted on
    rate/channel changes (the reference's rodio resamples per source,
    main.rs:152-161; our sinks are fixed-format, so gapless joins are
    preserved within runs of matching formats).

    Returns True if the playlist drained, False if a sink write failed.
    `on_file`/`on_error` are forwarded to `stream_playlist_sources`.
    `on_drained` fires after the last chunk is written but BEFORE the sink
    closes — sink close blocks until buffered audio finishes playing
    (FfplaySink waits on the child process), so anything the user should
    see during playback must print here.
    """
    sink = None
    sink_params = None

    def open_for(path: Path, rate: int, channels: int) -> None:
        nonlocal sink, sink_params
        if on_file is not None:
            on_file(path, rate, channels)
        params = (rate, channels)
        if params != sink_params:
            if sink is not None:
                sink.close()
            sink = sink_factory(*params)
            sink_params = params

    try:
        for source in stream_playlist_sources(file_paths, stop=stop,
                                              on_file=open_for,
                                              on_error=on_error,
                                              device=device):
            if not sink.append(source):
                return False
        if on_drained is not None:
            on_drained()
        return True
    finally:
        if sink is not None:
            sink.close()


def play_files_gapless(
    file_paths: List[Path],
    sink_factory: Optional[Callable[[int, int], object]] = None,
    stop: Optional[threading.Event] = None,
    device=None,
) -> None:
    """main.rs:115-171 — gapless playback of a .glc playlist.

    Consumes the shared chunk source (`stream_playlist_sources`) and appends
    every SamplesSource to one sink — untrimmed streaming chunks appended
    back-to-back is exactly the gapless property (main.rs:152-161).  The
    sink is an audio device when a backend library exists, else the ffplay
    pipe, matching the reference's feature-gated fallback (main.rs:181-198).
    """
    if not file_paths:
        raise ValueError("No files to play")
    if sink_factory is None:
        if not (audio_device_available() or ffplay_available()):
            print("Error: Playback support not available", file=sys.stderr)
            print("No audio backend found; install ffplay (ffmpeg) or use "
                  "-p --ffplay explicitly", file=sys.stderr)
            raise RuntimeError("Playback not available")
        sink_factory = open_sink

    def on_file(path: Path, rate: int, channels: int) -> None:
        print(f"Loading: {path.name!r}")
        print(f"Queueing: {rate} Hz, {channels} channels")

    def on_error(path: Path, err: str) -> None:
        # continue with the next playlist entry, like the reference's
        # closed-channel recv loop (main.rs:152-161)
        print(f"Error decoding {path.name}: {err}", file=sys.stderr)

    def on_drained() -> None:
        # printed while the sink is still playing its buffered tail — the
        # Ctrl+C hint must appear during playback, not after it ends
        print(f"Playing {len(file_paths)} files gaplessly. "
              "Press Ctrl+C to stop.")

    if not drive_playlist(file_paths, sink_factory, stop=stop,
                          on_file=on_file, on_error=on_error,
                          on_drained=on_drained, device=device):
        return
    print("Playback finished")
