"""Debug GUI (mirrors reference src/ui.rs, feature `ui`).

Port of ``glc_tpu/ui.py``: the same tkinter view, over the port's
`CodecController` (controller.py).

The reference ships an egui desktop app as a debug tool (CHANGELOG.md calls
it a debug surface); this is the tkinter equivalent with the same feature
set and threading model:

* file picker → encode (background thread + progress bar, ui.rs:90-156)
* encoded-file list → playlist management (ui.rs:610-670)
* gapless playlist playback with a stop flag (ui.rs:158-289)
* playlist → single concatenated FLAC export with level slider 0-8
  (the "gapless album join", ui.rs:291-402)
* status rows updated via shared state polled on a timer (the reference's
  Arc<Mutex<String>> cells + repaint loop, ui.rs:21-22, 472-505)

All logic lives in the headless `CodecController` so it is unit-testable
without a display; this module is only the tkinter view: widgets, pickers,
and a 100 ms poll of `controller.snapshot()`.  tkinter is imported inside
`build_gui`, so the module imports with no display.

Launched by `glc` with no arguments when a display is available
(main.rs:586-611).  `build_gui` constructs the widget tree and returns the
root plus one poll step without entering mainloop, so the view's
listbox-sync and progress pack/forget logic is drivable under a virtual
display in tests (tests/test_torch_controller.py); `run_gui` is the
mainloop shell around it.
"""

from __future__ import annotations

from .controller import CodecController


def build_gui(ctl: CodecController):
    """Build the widget tree; returns (root, poll) where poll() runs ONE
    snapshot-sync cycle (the body of the 100 ms repaint loop) without
    rescheduling itself."""
    import tkinter as tk
    from tkinter import filedialog, ttk

    root = tk.Tk()
    root.title("Gapless Lossy Codec")  # main.rs:594
    root.geometry("900x700")           # main.rs:593

    # --- widgets ---
    frm = ttk.Frame(root, padding=8)
    frm.pack(fill="both", expand=True)

    status_var = tk.StringVar(value="Ready")
    detail_var = tk.StringVar(value="")

    ttk.Label(frm, text="Input files (WAV/FLAC)").pack(anchor="w")
    sel_list = tk.Listbox(frm, height=5)
    sel_list.pack(fill="x")

    row1 = ttk.Frame(frm)
    row1.pack(fill="x", pady=4)

    enc_progress = ttk.Progressbar(frm, maximum=100.0)

    ttk.Label(frm, text="Encoded files (.glc)").pack(anchor="w")
    enc_list = tk.Listbox(frm, height=5)
    enc_list.pack(fill="x")

    row2 = ttk.Frame(frm)
    row2.pack(fill="x", pady=4)

    ttk.Label(frm, text="Playlist").pack(anchor="w")
    play_list = tk.Listbox(frm, height=5)
    play_list.pack(fill="x")

    row3 = ttk.Frame(frm)
    row3.pack(fill="x", pady=4)

    level_var = tk.IntVar(value=5)  # FLAC level slider 0-8 (ui.rs:676-680)
    export_progress = ttk.Progressbar(frm, maximum=100.0)

    ttk.Label(frm, textvariable=status_var).pack(anchor="w", pady=(8, 0))
    ttk.Label(frm, textvariable=detail_var).pack(anchor="w")

    # --- actions (thin: pickers + controller calls) ---
    def pick_files():
        names = filedialog.askopenfilenames(
            filetypes=[("Lossless audio", "*.wav *.flac"),
                       ("All files", "*.*")]
        )
        before = len(ctl.selected_files)
        ctl.add_files(names)
        for p in ctl.selected_files[before:]:
            sel_list.insert("end", p.name)

    def add_to_playlist():
        before = len(ctl.playlist)
        ctl.add_to_playlist(list(enc_list.curselection()))
        for p in ctl.playlist[before:]:
            play_list.insert("end", p.name)

    def clear_playlist():
        ctl.clear_playlist()
        play_list.delete(0, "end")

    def test_audio_device():
        """ui.rs:406-469 — play an arbitrary FLAC to check the audio path."""
        name = filedialog.askopenfilename(
            filetypes=[("FLAC", "*.flac"), ("All files", "*.*")]
        )
        if name:
            ctl.test_audio_device(name)

    def export_playlist():
        """ui.rs:291-402 — decode all, concatenate, single FLAC export."""
        if not ctl.playlist:
            ctl.set_status("Playlist is empty")
            return
        out_name = filedialog.asksaveasfilename(
            defaultextension=".flac",
            filetypes=[("FLAC", "*.flac")],
        )
        if out_name:
            ctl.export_playlist(out_name, int(level_var.get()))

    ttk.Button(row1, text="Add files...", command=pick_files).pack(
        side="left")
    ttk.Button(row1, text="Encode", command=ctl.encode_selected).pack(
        side="left", padx=4)
    ttk.Button(row2, text="Add to playlist", command=add_to_playlist).pack(
        side="left")
    ttk.Button(row2, text="Clear playlist", command=clear_playlist).pack(
        side="left", padx=4)
    ttk.Button(row3, text="Play (gapless)", command=ctl.play_gapless).pack(
        side="left")
    ttk.Button(row3, text="Stop", command=ctl.stop_playing).pack(
        side="left", padx=4)
    ttk.Label(row3, text="FLAC level").pack(side="left", padx=(16, 2))
    tk.Scale(row3, from_=0, to=8, orient="horizontal",
             variable=level_var).pack(side="left")
    ttk.Button(row3, text="Export playlist → FLAC",
               command=export_playlist).pack(side="left", padx=8)
    ttk.Button(row1, text="Test audio device...",
               command=test_audio_device).pack(side="left", padx=8)

    def poll():
        """One cycle of the repaint loop (ui.rs:475-478)."""
        snap = ctl.snapshot()
        status_var.set(snap.status)
        detail_var.set(snap.detail)
        # sync the encoded-files listbox with results produced by worker
        # threads (tkinter widgets must only be touched from this thread)
        while enc_list.size() < len(snap.encoded_files):
            enc_list.insert("end", snap.encoded_files[enc_list.size()].name)
        if snap.encode_progress is not None:
            if not enc_progress.winfo_ismapped():
                enc_progress.pack(fill="x")
            enc_progress["value"] = snap.encode_progress
        elif enc_progress.winfo_ismapped():
            enc_progress.pack_forget()
        if snap.export_progress is not None:
            if not export_progress.winfo_ismapped():
                export_progress.pack(fill="x")
            export_progress["value"] = snap.export_progress
        elif export_progress.winfo_ismapped():
            export_progress.pack_forget()

    return root, poll


def run_gui() -> int:
    ctl = CodecController()
    root, poll = build_gui(ctl)

    def tick():
        poll()
        root.after(100, tick)  # 100 ms repaint loop (ui.rs:475-478)

    tick()
    root.mainloop()
    return 0
