"""Headless GUI controller: the encode/playlist/export state machine behind
the debug GUI, with no toolkit dependency.

Port of ``glc_tpu/controller.py`` over the port's encoder, playback loop
and album export; `CodecController(device=...)` says where they run (None:
`codec.device.resolve_device`'s rule).

The reference's egui app (reference src/ui.rs:16-469) mixes its state machine
into the frame callback; here the controller owns all state and worker
threads, and any view (tkinter in ui.py, or a test) polls `snapshot()` on a
timer — the moral equivalent of ui.rs's Arc<Mutex<...>> cells plus the 100 ms
repaint loop (ui.rs:472-505).  Every action is asynchronous and
continue-on-error, exactly like the reference's thread::spawn handlers.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional, Sequence


@dataclass
class ControllerSnapshot:
    """Point-in-time view state (what ui.rs renders each repaint)."""

    status: str
    detail: str
    encode_progress: Optional[float]
    export_progress: Optional[float]
    playing: bool
    selected_files: List[Path]
    encoded_files: List[Path]
    playlist: List[Path]


class CodecController:
    """Encode/playlist/playback/export state machine (ui.rs:90-469).

    View contract: call action methods from any thread; poll `snapshot()`
    for display.  Worker threads are daemons and publish state only through
    the internal lock.  `sink_factory(rate, channels)` is injectable so
    tests can capture the played stream with a mock sink; `device` is the
    encoder's, the playback decoder's and the export decoder's.
    """

    def __init__(self, sink_factory: Optional[Callable] = None, device=None):
        self._lock = threading.Lock()
        self._status = "Ready"
        self._detail = ""
        self._encode_progress: Optional[float] = None
        self._export_progress: Optional[float] = None
        self._stop_playback = threading.Event()
        self._playing = False
        self._sink_factory = sink_factory
        self._device = device

        self.selected_files: List[Path] = []
        self.encoded_files: List[Path] = []
        self.playlist: List[Path] = []

    # --- state publication ---

    def set_status(self, status: str, detail: str = "") -> None:
        with self._lock:
            self._status = status
            self._detail = detail

    def snapshot(self) -> ControllerSnapshot:
        with self._lock:
            return ControllerSnapshot(
                status=self._status,
                detail=self._detail,
                encode_progress=self._encode_progress,
                export_progress=self._export_progress,
                playing=self._playing,
                selected_files=list(self.selected_files),
                encoded_files=list(self.encoded_files),
                playlist=list(self.playlist),
            )

    def _set_encode_progress(self, v: Optional[float]) -> None:
        with self._lock:
            self._encode_progress = v

    def _set_export_progress(self, v: Optional[float]) -> None:
        with self._lock:
            self._export_progress = v

    # --- file/playlist management (ui.rs:610-670) ---

    def add_files(self, paths: Sequence[Path]) -> None:
        for p in map(Path, paths):
            if p not in self.selected_files:
                self.selected_files.append(p)

    def add_to_playlist(self, indices: Sequence[int]) -> None:
        for i in indices:
            if 0 <= i < len(self.encoded_files):
                self.playlist.append(self.encoded_files[i])

    def clear_playlist(self) -> None:
        self.playlist.clear()

    # --- async encode (ui.rs:90-156) ---

    def encode_selected(self, wait: bool = False) -> Optional[threading.Thread]:
        files = list(self.selected_files)
        if not files:
            self.set_status("No files selected")
            return None

        def work():
            from .codec.encoder import Encoder
            from .container.bincode import save_encoded
            from .io.audio import load_audio_for_encode

            for i, path in enumerate(files):
                try:
                    self.set_status(f"Encoding {path.name}...")
                    self._set_encode_progress(0.0)
                    samples, rate, ch, is_pcm16 = load_audio_for_encode(path)
                    self._set_encode_progress(50.0)
                    enc = Encoder(rate, device=self._device)
                    encoded = (enc.encode_pcm16(samples, ch)
                               if is_pcm16
                               else enc.encode(samples, ch))
                    self._set_encode_progress(90.0)
                    out = path.with_suffix(".glc")
                    save_encoded(encoded, out)
                    self._set_encode_progress(100.0)
                    self.encoded_files.append(out)
                    self.set_status(f"Encoded {i + 1}/{len(files)}", str(out))
                except Exception as e:  # continue-on-error like the CLI
                    self.set_status(f"Error encoding {path.name}", str(e))
            self._set_encode_progress(None)

        return self._run(work, wait)

    # --- async gapless playback (ui.rs:158-289) ---

    def play_gapless(self, wait: bool = False) -> Optional[threading.Thread]:
        files = list(self.playlist)
        with self._lock:
            if not files or self._playing:
                return None
            self._playing = True
        self._stop_playback.clear()

        def work():
            from .playback import (
                audio_device_available,
                drive_playlist,
                ffplay_available,
                open_sink,
            )

            sink_factory = self._sink_factory or open_sink
            errored = False
            try:
                if self._sink_factory is None and not (
                    audio_device_available() or ffplay_available()
                ):
                    self.set_status("No audio backend (install ffplay)")
                    return

                def on_file(path, rate, channels):
                    self.set_status(f"Playing {path.name}")

                def on_error(path, err):
                    nonlocal errored
                    errored = True
                    self.set_status("Decode error", err)
                    # a decode error ends GUI playback (the old view-thread
                    # returned here), leaving the error status visible
                    self._stop_playback.set()

                drained = drive_playlist(files, sink_factory,
                                         stop=self._stop_playback,
                                         on_file=on_file, on_error=on_error,
                                         device=self._device)
                if errored:
                    pass  # keep the "Decode error" status visible
                elif self._stop_playback.is_set():
                    # a user stop also drains the generator normally —
                    # report it as a stop, not a complete playthrough
                    self.set_status("Playback stopped")
                elif drained:
                    self.set_status("Playback finished")
                else:
                    self.set_status("Playback error",
                                    "audio sink write failed")
            except Exception as e:
                self.set_status("Playback error", str(e))
            finally:
                with self._lock:
                    self._playing = False

        return self._run(work, wait)

    def stop_playing(self) -> None:
        self._stop_playback.set()

    # --- async device test (ui.rs:406-469) ---

    def test_audio_device(self, flac_path,
                          wait: bool = False) -> Optional[threading.Thread]:
        def work():
            from .flac.decoder import read_flac
            from .playback import (
                audio_device_available,
                ffplay_available,
                open_sink,
            )

            sink_factory = self._sink_factory or open_sink
            try:
                if self._sink_factory is None and not (
                    audio_device_available() or ffplay_available()
                ):
                    self.set_status("No audio backend (install ffplay)")
                    return
                samples, rate, ch = read_flac(flac_path)
                self.set_status(f"Testing device with {Path(flac_path).name}")
                sink = sink_factory(rate, ch)
                try:
                    sink.write(samples)
                finally:
                    sink.close()
                self.set_status("Device test finished")
            except Exception as e:
                self.set_status("Device test error", str(e))

        return self._run(work, wait)

    # --- async album export (ui.rs:291-402) ---

    def export_playlist(self, out_path, compression_level: int = 5,
                        wait: bool = False) -> Optional[threading.Thread]:
        files = list(self.playlist)
        if not files:
            self.set_status("Playlist is empty")
            return None

        def work():
            from .album import export_playlist_to_flac
            from .container.schema import ProgressKind

            def on_progress(p):
                if p.kind in (ProgressKind.DECODING, ProgressKind.EXPORTING):
                    self._set_export_progress(float(p.value))
                elif p.kind == ProgressKind.STATUS:
                    self.set_status(str(p.value))

            try:
                export_playlist_to_flac(files, out_path,
                                        int(compression_level), on_progress,
                                        device=self._device)
                self._set_export_progress(100.0)
                self.set_status("Export complete", str(out_path))
            except Exception as e:
                self.set_status("Export error", str(e))
            finally:
                self._set_export_progress(None)

        return self._run(work, wait)

    # --- worker plumbing ---

    @staticmethod
    def _run(work, wait: bool) -> threading.Thread:
        t = threading.Thread(target=work, daemon=True)
        t.start()
        if wait:
            t.join()
        return t
