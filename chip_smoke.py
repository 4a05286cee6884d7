#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (glc_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own line(s):

1. device — torch version, card name, and the card's name and power limit
   from nvidia-smi;
2. build  — builds (or loads) the hand-written imdct_window kernel from
   glc_tpu_torch/csrc/ and prints the seconds it took, and the registers,
   spills and shared memory the build gave it;
3. kernel — imdct_window (3xTF32 wgmma fed by TMA) against its plain
   PyTorch version at every edge of its 128-row tile (1, 63, 64, 65, 127,
   128, 129), at a ragged 1000, and at every row count the paths below
   launch it with (`path_rows`: each chunk's frames x 2 channels at the
   decode and the stream chunk sizes, on the 180 s file, the 10 s excerpt
   and the album tracks, and the stacked rows of every decode_many launch
   of the album phase): atol = rtol = 2e-5, both errors against a float64
   product, the kernel's no more than 2x the plain version's; median time
   of 20 runs
   after 3 warm-ups, with CUDA events.  The decode's calls of the kernel
   are recorded by row count, and the run fails if a path launched it at
   a row count this phase did not check;
4. main path — a 180 s, 44.1 kHz, 16-bit stereo signal (seeded tones with
   envelopes, 5 s of white noise, 1 s of silence) through
   Encoder.encode_pcm16 → save_encoded → load_encoded →
   Decoder.decode_i16 on the card, with the kernel's launch count read
   around this run only;
5. card vs CPU — the same input through the port on the CPU (plain
   versions): the containers agree within the pair contract
   (glc_tpu_torch/parity.py) and decode_i16 of the card's container is
   within 1 LSB on the card and on the CPU;
6. native — the shared C++ runtime (native/, built with make on first
   use): says whether it was built or loaded, and fails without it or
   without its frame packer, so that the export below is the shipped path;
7. export — the CLI's default decode on the 180 s container:
   decode_i16_stream(chunk_frames=1024) → encode_flac_i16_streaming(level
   5), timed after a warm-up call, with the kernel's launches of the timed
   call alone (one a chunk); the stream equals decode_i16 bit for bit, the
   bytes equal encode_flac_i16_with_level of decode_i16, and decode_flac
   gives back the samples, their format and their MD5;
8. cli — glc_tpu_torch.cli.main on a 10 s excerpt: WAV → .glc, .glc → FLAC
   (the default), FLAC → .glc; the FLAC holds decode_i16 of the .glc and
   the container from the FLAC equals Encoder.encode_pcm16 of its samples;
9. flac math — flac_block_stats on the card against its host twin, orders
   0-4, 4096-sample blocks at level 5's partition order, on the decoded
   180 s output: exactly equal;
10. stream — decode_streaming on the card: 500-frame chunks but the last,
   Progress ending in "complete", the trimmed concatenation equal to
   decode within 1e-6 and within 1 LSB of decode_i16;
11. album — the multi-track paths at the JAX package's album shapes
   (bench.py:891-898, :958-), 4 x 15 s (one encode segment and one decode
   chunk a track) and 4 x 120 s (two encode segments and four decode
   chunks a track) of stereo int16, each track from its own seed:
   Encoder.encode_many equals the per-file encode_pcm16 byte for byte,
   Decoder.decode_many equals the per-file decode_i16 bit for bit, with one
   kernel launch a group of single-chunk tracks and a chunk of each
   multi-chunk track, as `launch_rows` of tests/test_torch_album.py
   predicts from the frame counts; the walls of encode_many and
   decode_many beside the serial loops, medians of 11 alternating pairs
   after a warm-up; on the 120 s album, album.decode_playlist
   (through decode_many) and album.export_playlist_to_flac, whose bytes
   equal encode_flac_i16_with_level of the playlist and decode back to it;
   and the CLI encoding the four 15 s WAVs in one main([...]) call, through
   one encode_many, into the per-file containers.

Every path counts the kernel's launches from 0 just before it runs and
checks them just after.  Then one JSON line with the kernel table (its
launch count is the main path's), and as the last line
{"ok": true, "device": {...}}.  Any failed phase raises and exits non-zero;
without a CUDA device the script exits 1 and prints no result.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import glc_tpu_torch  # noqa: F401  (turns TF32 off: full-f32 matmuls)
from glc_tpu_torch import (
    Decoder, Encoder, load_encoded, save_encoded, serialize_encoded,
)
from glc_tpu_torch import album, cli, native
from glc_tpu_torch.codec.decoder import gapless_trim_bounds
from glc_tpu_torch.codec.encoder import upload_geometry
from glc_tpu_torch.codec.tables import chunk_size_for, get_codec_tables
from glc_tpu_torch.config import DEFAULT_CONFIG
from glc_tpu_torch.container.schema import ProgressKind
from glc_tpu_torch.flac import bitpack
from glc_tpu_torch.flac.decoder import decode_flac
from glc_tpu_torch.flac.encoder import (
    encode_flac_i16_streaming, encode_flac_i16_with_level,
)
from glc_tpu_torch.flac.ops import flac_block_stats, flac_block_stats_host
from glc_tpu_torch.io.wav import convert_f32_to_i16, write_wav_i16
from glc_tpu_torch.ops import decode as decode_ops
from glc_tpu_torch.ops import kernels
from glc_tpu_torch.ops.kernels import imdct_window, imdct_window_reference
from glc_tpu_torch.parity import check_containers

# the launch geometry of decode_many, kept beside the tests that hold the
# decoder to it
sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
from test_torch_album import launch_rows  # noqa: E402

SAMPLE_RATE = 44100
SECONDS = 180
KERNEL_TOL = 2e-5
KERNEL_EDGES = (1, 63, 64, 65, 127, 128, 129, 1000)
CLI_SECONDS = 10
ALBUM_TRACKS = 4
ALBUM_SECONDS = (15, 120)
WALL_RUNS = 11
FLAC_LEVEL = 5
STREAM_TOL = 1e-6


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{name}; count {torch.cuda.device_count()}")
    print(smi)  # the card's name and power limit, as nvidia-smi gives them
    return name, smi


def phase_build():
    """Builds the kernel; returns its design line for the kernel phase."""
    cached = kernels.library_path().exists()
    t0 = time.perf_counter()
    kernels.load_library()
    secs = time.perf_counter() - t0
    info = kernels.kernel_info()
    print(f"[build] {kernels.library_path().name}: "
          f"{'loaded' if cached else 'built'} in {secs:.2f} s")
    return (f"3xTF32 wgmma, TMA, {info['stages']} stages; "
            f"{info['registers']} regs/thread, {info['local_bytes']} B local, "
            f"smem {info['static_smem']} B static + {info['dynamic_smem']} B "
            f"dynamic")


def _median_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def frames_of(samples: int, channels: int = 2) -> int:
    """The frame count of a track of `samples` interleaved samples."""
    return upload_geometry(samples, channels, DEFAULT_CONFIG)[1]


def path_rows(pcm: np.ndarray) -> list[int]:
    """The row counts the paths launch imdct_window with: every chunk's
    frames x 2 channels, at the decode and the stream chunk sizes, on the
    180 s file, the CLI's 10 s excerpt and an album track of each length;
    and every decode_many launch of the album phase."""
    cfg = DEFAULT_CONFIG
    rows = set()
    for samples in (len(pcm), CLI_SECONDS * SAMPLE_RATE * 2,
                    *(s * SAMPLE_RATE * 2 for s in ALBUM_SECONDS)):
        F = frames_of(samples)
        for max_chunk in (cfg.decode_chunk_frames, cfg.stream_chunk_frames):
            chunk = chunk_size_for(F, max_chunk)
            rows.update(2 * min(chunk, F - s) for s in range(0, F, chunk))
    for seconds in ALBUM_SECONDS:
        tracks = [(2, frames_of(seconds * SAMPLE_RATE * 2))] * ALBUM_TRACKS
        rows.update(launch_rows(tracks, cfg.decode_chunk_frames))
    return sorted(rows, reverse=True)


LAUNCHED_ROWS: set[int] = set()


def record_launch_rows():
    """Route the decode's calls of the kernel wrapper through a recorder of
    their row counts; the wrapper itself, and its launch count, stay as
    they are."""
    wrapper = decode_ops.imdct_window

    def recorded(coeffs, *args):
        LAUNCHED_ROWS.add(coeffs.shape[0])
        return wrapper(coeffs, *args)

    decode_ops.imdct_window = recorded


def phase_kernel(tables, design: str, rows):
    n = tables.n
    rng = np.random.default_rng(1)
    table64 = tables.cos_table.double()
    window64 = tables.window.double()
    result = {}
    for B in rows:
        coeffs = torch.from_numpy(
            (rng.standard_normal((B, n)) * 0.1).astype(np.float32)
        ).cuda()
        args = (coeffs, tables.cos_table, tables.window, tables.norm_value)
        out = imdct_window(*args)
        ref = imdct_window_reference(*args)
        torch.cuda.synchronize()
        exact = ((coeffs.double() @ table64) * tables.norm_value) * window64
        err_kernel = (out.double() - exact).abs().max().item()
        err_plain = (ref.double() - exact).abs().max().item()
        diff = (out - ref).abs().max().item()
        torch.testing.assert_close(out, ref, atol=KERNEL_TOL, rtol=KERNEL_TOL)
        if err_kernel > 2 * err_plain:
            raise AssertionError(
                f"kernel error vs float64 {err_kernel:.3e} exceeds twice the "
                f"plain version's {err_plain:.3e}")
        ms = _median_ms(lambda: imdct_window(*args))
        plain_ms = _median_ms(lambda: imdct_window_reference(*args))
        print(f"[kernel] imdct_window ({design}) B={B}: "
              f"max|kernel-plain| {diff:.3e} "
              f"(tol {KERNEL_TOL}); vs float64: kernel {err_kernel:.3e}, "
              f"plain {err_plain:.3e}; median of 20: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms")
        result[B] = (diff, ms, plain_ms)
    return result


def make_signal(seconds: int = SECONDS, rate: int = SAMPLE_RATE,
                seed: int = 0) -> np.ndarray:
    """Interleaved int16 stereo from numpy.random.default_rng(seed): tones
    of six harmonics with a decaying envelope per 0.5 s note, 5 s of white
    noise from 60 s (it drives the raw-PCM fallback) and 1 s of silence
    from 120 s."""
    rng = np.random.default_rng(seed)
    T = seconds * rate
    t = np.arange(T) / rate
    note = (t // 0.5).astype(np.int64)
    env = np.exp(-4.0 * (t % 0.5))
    x = np.zeros((T, 2))
    for c in range(2):
        f0 = rng.uniform(110.0, 880.0, size=note[-1] + 1)[note]
        for h in range(1, 7):
            x[:, c] += (0.3 / h) * np.sin(2 * np.pi * h * f0 * t)
        x[:, c] *= env
    noise = slice(60 * rate, min(65 * rate, T))
    x[noise] = rng.uniform(-0.6, 0.6, size=x[noise].shape)
    x[120 * rate : 121 * rate] = 0.0
    return (x * 32767.0).astype(np.int16).reshape(-1)


def main_path(pcm: np.ndarray, device: str):
    """encode_pcm16 → save → load → decode_i16 on `device`; returns
    (encoded, decoded, encode seconds, decode seconds)."""
    enc = Encoder(SAMPLE_RATE, device=device)
    dec = Decoder(2, SAMPLE_RATE, device=device)
    t0 = time.perf_counter()
    encoded = enc.encode_pcm16(pcm, 2)
    t_enc = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "smoke.glc"
        save_encoded(encoded, path)
        loaded = load_encoded(path)
    t0 = time.perf_counter()
    out = dec.decode_i16(loaded)
    t_dec = time.perf_counter() - t0
    return loaded, out, t_enc, t_dec


def phase_main(pcm: np.ndarray):
    cfg = DEFAULT_CONFIG
    main_path(pcm[: 10 * SAMPLE_RATE * 2], "cuda")  # warm-up
    imdct_window.launches = 0
    encoded, out, t_enc, t_dec = main_path(pcm, "cuda")
    launches = imdct_window.launches

    F = encoded.frame_set.num_frames
    _T, F_plan, _pad, plan, _need = upload_geometry(len(pcm), 2, cfg)
    chunks = -(-F // chunk_size_for(F, cfg.decode_chunk_frames))
    raw_frames = int(encoded.frame_set.raw_mask.sum())
    if len(out) != len(pcm):
        raise AssertionError(f"decoded {len(out)} samples, input {len(pcm)}")
    if F != F_plan or [k for _s, k in plan] != [4096, 3840]:
        raise AssertionError(f"unexpected segment plan {plan} for {F} frames")
    if raw_frames == 0:
        raise AssertionError("the noise stretch produced no raw frames")
    if launches != chunks:
        raise AssertionError(
            f"imdct_window launched {launches} times for {chunks} chunks")
    audio_s = len(pcm) / 2 / SAMPLE_RATE
    print(f"[main] {audio_s:.0f} s stereo: {F} frames, segments "
          f"{[k for _s, k in plan]}, {raw_frames} raw frames, "
          f"{len(encoded.frame_set.pairs)} pairs; output {len(out)} samples "
          f"== input")
    print(f"[main] encode_pcm16 {t_enc:.3f} s ({audio_s / t_enc:.1f}x "
          f"realtime); decode_i16 {t_dec:.3f} s ({audio_s / t_dec:.1f}x "
          f"realtime); imdct_window launches {launches} == {chunks} chunks")
    return encoded, out, launches


def phase_cpu(pcm: np.ndarray, encoded_cuda, out_cuda):
    encoded_cpu, _out, t_enc, _t = main_path(pcm, "cpu")
    flips = check_containers(encoded_cuda, encoded_cpu)
    out_cpu = Decoder(2, SAMPLE_RATE, device="cpu").decode_i16(encoded_cuda)
    if len(out_cpu) != len(out_cuda):
        raise AssertionError("card and CPU decodes differ in length")
    d = np.abs(out_cpu.astype(np.int32) - out_cuda.astype(np.int32))
    if d.max() > 1:
        raise AssertionError(f"card vs CPU decode differs by {d.max()} LSB")
    print(f"[cpu] pairs card vs CPU: {flips['gate']} keep-gate and "
          f"{flips['pm1']} +-1 flips of {flips['kept']} kept "
          f"(rate {flips['rate']:.5%}, max |dq| {flips['max_dq']}); "
          f"decode_i16 card vs CPU: max {int(d.max())} LSB on "
          f"{int(np.count_nonzero(d))} of {len(d)} samples")


def phase_native():
    """The shared C++ runtime: built by make on first use, or loaded."""
    cached = native._SO_PATH.exists()
    t0 = time.perf_counter()
    lib = native.get_native()
    secs = time.perf_counter() - t0
    if lib is None:
        raise AssertionError(f"native library {native._SO_PATH} missing")
    for fn in ("glc_flac_pack_frames", "glc_flac_block_stats"):
        if not hasattr(lib, fn):
            raise AssertionError(f"native library lacks {fn}")
    print(f"[native] {native._SO_PATH.name}: "
          f"{'loaded' if cached else 'built'} in {secs:.2f} s")


def export_flac(dec: Decoder, encoded, parts=None) -> bytes:
    """The CLI's default decode (glc_tpu_torch/cli.py decode_file): the int16
    stream at stream_chunk_frames into the streaming FLAC encoder.  With
    `parts`, the stream's chunks are kept there too."""
    n_total = dec.decoded_length(encoded)

    def stream():
        for part in dec.decode_i16_stream(
                encoded, chunk_frames=dec.config.stream_chunk_frames):
            if parts is not None:
                parts.append(part)
            yield part

    return encode_flac_i16_streaming(stream(), SAMPLE_RATE, 2, FLAC_LEVEL,
                                     n_total // 2)


def phase_export(encoded, out):
    cfg = DEFAULT_CONFIG
    dec = Decoder(2, SAMPLE_RATE, device="cuda")
    t0 = time.perf_counter()
    warm = export_flac(dec, encoded)  # warm-up
    t_warm = time.perf_counter() - t0
    parts = []
    imdct_window.launches = 0
    t0 = time.perf_counter()
    data = export_flac(dec, encoded, parts)
    t_exp = time.perf_counter() - t0
    launches = imdct_window.launches

    F = encoded.frame_set.num_frames
    chunks = -(-F // chunk_size_for(F, cfg.stream_chunk_frames))
    if launches != chunks:
        raise AssertionError(
            f"export launched imdct_window {launches} times for {chunks} "
            f"chunks")
    stream = np.concatenate(parts)
    if not np.array_equal(stream, out):
        raise AssertionError("decode_i16_stream(1024) != decode_i16 on the "
                             "card")
    whole = encode_flac_i16_with_level(out, SAMPLE_RATE, 2, FLAC_LEVEL)
    if data != whole or warm != data:
        raise AssertionError("streamed FLAC bytes != whole-stream bytes")
    samples, rate, channels, bps = decode_flac(data)
    if (rate, channels, bps) != (SAMPLE_RATE, 2, 16):
        raise AssertionError(f"FLAC header says {rate} Hz, {channels} ch, "
                             f"{bps} bits")
    if not np.array_equal(samples, out.astype(np.int32)):
        raise AssertionError("decode_flac does not give back the samples")
    if data[26:42] != hashlib.md5(out.astype("<i2").tobytes()).digest():
        raise AssertionError("STREAMINFO MD5 is not the samples' MD5")
    audio_s = len(out) / 2 / SAMPLE_RATE
    print(f"[export] decode_i16_stream({cfg.stream_chunk_frames}) -> "
          f"encode_flac_i16_streaming(level {FLAC_LEVEL}) of {audio_s:.0f} s "
          f"stereo: {t_exp:.3f} s ({audio_s / t_exp:.1f}x realtime; warm-up "
          f"call {t_warm:.3f} s); {len(data)} bytes "
          f"({len(data) / (2 * len(out)):.3f} of the PCM); imdct_window "
          f"launches {launches} == {chunks} chunks of {len(parts)}; stream == "
          f"decode_i16, bytes == whole-stream, decode_flac and MD5 agree")
    return launches


def phase_cli(pcm: np.ndarray):
    """glc_tpu_torch.cli.main, as a user calls it, on a 10 s excerpt."""
    cfg = DEFAULT_CONFIG
    excerpt = np.ascontiguousarray(pcm[: CLI_SECONDS * SAMPLE_RATE * 2])
    with tempfile.TemporaryDirectory() as tmp:
        wav = Path(tmp) / "excerpt.wav"
        glc = wav.with_suffix(".glc")
        flac = wav.with_suffix(".flac")
        write_wav_i16(wav, excerpt, SAMPLE_RATE, 2)
        imdct_window.launches = 0
        rcs = [cli.main([str(wav)])]
        encoded = load_encoded(glc)
        rcs.append(cli.main(["-d", str(glc)]))
        launches = imdct_window.launches
        want = Decoder(2, SAMPLE_RATE, device="cuda").decode_i16(encoded)
        samples, rate, channels, _bps = decode_flac(flac.read_bytes())
        if not np.array_equal(samples, want.astype(np.int32)):
            raise AssertionError("CLI FLAC != decode_i16 of its .glc")
        wav.unlink()
        rcs.append(cli.main([str(flac)]))
        again = load_encoded(glc)
        if rcs != [0, 0, 0]:
            raise AssertionError(f"CLI exit codes {rcs}")
        ref = Encoder(SAMPLE_RATE, device="cuda").encode_pcm16(
            samples.astype(np.int16), channels)
        if serialize_encoded(again) != serialize_encoded(ref):
            raise AssertionError("FLAC input container != encode_pcm16 of "
                                 "its samples")
        F = encoded.frame_set.num_frames
        chunks = -(-F // chunk_size_for(F, cfg.stream_chunk_frames))
        if launches != chunks:
            raise AssertionError(f"the CLI decode launched imdct_window "
                                 f"{launches} times for {chunks} chunks")
    print(f"[cli] wav -> glc -> flac -> glc on {CLI_SECONDS} s: exit codes "
          f"{rcs}; FLAC == decode_i16, FLAC-input container == encode_pcm16; "
          f"imdct_window launches {launches} == {chunks} chunks")


def phase_flac_math(out: np.ndarray):
    bs = 4096
    blocks = len(out) // 2 // bs
    x = (out[: blocks * bs * 2].reshape(blocks, bs, 2).transpose(0, 2, 1)
         .reshape(-1, bs).astype(np.int32))
    xd = torch.from_numpy(x).cuda()
    for order in range(5):
        po = bitpack.partition_order(bs, order, FLAC_LEVEL)
        got = [t.cpu().numpy() for t in flac_block_stats(xd, order=order,
                                                         po=po)]
        want = flac_block_stats_host(x, order=order, po=po)
        for g, w in zip(got, want, strict=True):
            if g.dtype != w.dtype or not np.array_equal(g, w):
                raise AssertionError(
                    f"flac_block_stats order {order} differs on the card")
    print(f"[flac math] flac_block_stats on the card == host twin for "
          f"orders 0-4 on [{x.shape[0]}, {bs}] int32 blocks "
          f"(level {FLAC_LEVEL} partition orders)")


def phase_stream(encoded, out):
    cfg = DEFAULT_CONFIG
    dec = Decoder(2, SAMPLE_RATE, device="cuda")
    msgs = []
    imdct_window.launches = 0
    t0 = time.perf_counter()
    rx = dec.decode_streaming(encoded, msgs.append)
    chunks = []
    while True:
        c = rx.get(timeout=300)
        if c.error is not None:
            raise AssertionError(f"decode_streaming failed: {c.error}")
        chunks.append(c)
        if c.is_last:
            break
    t_stream = time.perf_counter() - t0
    launches = imdct_window.launches
    F = encoded.frame_set.num_frames
    want_chunks = -(-F // chunk_size_for(F, cfg.decode_chunk_frames))
    if launches != want_chunks:
        raise AssertionError(f"decode_streaming launched imdct_window "
                             f"{launches} times for {want_chunks} chunks")
    full_len = cfg.frames_per_chunk * cfg.n * 2
    if any(len(c.samples) != full_len for c in chunks[:-1]):
        raise AssertionError("a decode_streaming chunk is not 500 frames")
    if len(chunks) != F // cfg.frames_per_chunk + 1:
        raise AssertionError(f"{len(chunks)} chunks for {F} frames")
    if msgs[-1].kind is not ProgressKind.COMPLETE:
        raise AssertionError(f"last Progress is {msgs[-1].kind}")
    full = np.concatenate([c.samples for c in chunks])
    skip, limit = gapless_trim_bounds(len(full), encoded.gapless_info, 2,
                                      cfg.reference_compat)
    trimmed = full[skip : skip + limit]
    f32 = dec.decode(encoded)
    err = float(np.abs(trimmed - f32).max())
    if len(trimmed) != len(f32) or err > STREAM_TOL:
        raise AssertionError(f"stream vs decode: {err}")
    lsb = np.abs(convert_f32_to_i16(f32).astype(np.int32)
                 - out.astype(np.int32)).max()
    if lsb > 1:
        raise AssertionError(f"decode vs decode_i16: {lsb} LSB")
    print(f"[stream] decode_streaming: {len(chunks)} chunks of "
          f"{cfg.frames_per_chunk} frames but the last "
          f"({len(chunks[-1].samples)} samples), {len(msgs)} Progress "
          f"messages ending in {msgs[-1].kind.value}; trimmed == decode "
          f"within {err:.1e} (tol {STREAM_TOL}); decode vs decode_i16 "
          f"{lsb} LSB; {t_stream:.3f} s; imdct_window launches {launches} "
          f"== {want_chunks} chunks")


def _wall(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _walls(batched, serial) -> tuple[float, float]:
    """Medians of WALL_RUNS walls of two callables, in alternating order,
    after one warm-up call of each."""
    batched()
    serial()
    b, s = [], []
    for r in range(WALL_RUNS):
        for fn, out in ((batched, b), (serial, s))[:: 1 if r % 2 else -1]:
            out.append(_wall(fn))
    return float(np.median(b)), float(np.median(s))


def album_rows(many) -> list[int]:
    """The row counts decode_many launches the kernel with on `many`."""
    return launch_rows([(2, ea.frame_set.num_frames) for ea in many],
                       DEFAULT_CONFIG.decode_chunk_frames)


def phase_album(seconds: int, smi: str):
    """encode_many and decode_many of ALBUM_TRACKS tracks of `seconds`
    against the per-file calls; returns (items, containers, decoded
    tracks)."""
    items = [(make_signal(seconds, seed=seed), 2)
             for seed in range(1, ALBUM_TRACKS + 1)]
    F = frames_of(len(items[0][0]))
    plan = upload_geometry(len(items[0][0]), 2, DEFAULT_CONFIG)[3]
    chunks = -(-F // chunk_size_for(F, DEFAULT_CONFIG.decode_chunk_frames))
    if (len(plan), chunks) != ((1, 1) if seconds <= 30 else (2, 4)):
        raise AssertionError(f"{seconds} s: {len(plan)} segments, {chunks} "
                             f"chunks")
    enc = Encoder(SAMPLE_RATE, device="cuda")
    dec = Decoder(2, SAMPLE_RATE, device="cuda")
    solo = [enc.encode_pcm16(x, c) for x, c in items]
    many = enc.encode_many(items)
    for i, (a, b) in enumerate(zip(many, solo, strict=True)):
        if serialize_encoded(a) != serialize_encoded(b):
            raise AssertionError(f"{seconds} s track {i}: encode_many != "
                                 f"encode_pcm16")
    want = [dec.decode_i16(ea) for ea in solo]
    rows = album_rows(many)
    imdct_window.launches = 0
    outs = dec.decode_many(many)
    launches = imdct_window.launches
    if launches != len(rows):
        raise AssertionError(f"decode_many launched imdct_window {launches} "
                             f"times, the geometry says {len(rows)}")
    for i, (o, w) in enumerate(zip(outs, want, strict=True)):
        if not np.array_equal(o, w):
            raise AssertionError(f"{seconds} s track {i}: decode_many != "
                                 f"decode_i16 on the card")
    t_em, t_es = _walls(lambda: enc.encode_many(items),
                        lambda: [enc.encode_pcm16(x, c) for x, c in items])
    t_dm, t_ds = _walls(lambda: dec.decode_many(many),
                        lambda: [dec.decode_i16(ea) for ea in many])
    print(f"[album] {ALBUM_TRACKS} x {seconds} s stereo ({smi}): encode_many "
          f"== encode_pcm16 bytes, decode_many == decode_i16 bits; "
          f"imdct_window launches {launches} at rows {rows}; medians of "
          f"{WALL_RUNS}: encode_many {t_em:.4f} s vs serial {t_es:.4f} s "
          f"({t_es / t_em:.2f}x), decode_many {t_dm:.4f} s vs serial "
          f"{t_ds:.4f} s ({t_ds / t_dm:.2f}x)")
    return items, many, outs


def phase_album_export(many, outs):
    """album.decode_playlist and album.export_playlist_to_flac of the
    album's .glc files."""
    cfg = DEFAULT_CONFIG
    want = np.concatenate(outs)
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for i, ea in enumerate(many):
            paths.append(Path(tmp) / f"track{i}.glc")
            save_encoded(ea, paths[-1])
        rows = album_rows(many)
        imdct_window.launches = 0
        samples, rate, channels = album.decode_playlist(paths, device="cuda")
        launches = imdct_window.launches
        if launches != len(rows):
            raise AssertionError(f"decode_playlist launched imdct_window "
                                 f"{launches} times for {len(rows)}")
        if (rate, channels) != (SAMPLE_RATE, 2) or not np.array_equal(
                samples, want):
            raise AssertionError("decode_playlist != the decode_many tracks")
        flac = Path(tmp) / "album.flac"
        album.export_playlist_to_flac(paths, flac, FLAC_LEVEL,
                                      device="cuda")  # warm-up
        imdct_window.launches = 0
        t_exp = _wall(lambda: album.export_playlist_to_flac(
            paths, flac, FLAC_LEVEL, device="cuda"))
        exp_launches = imdct_window.launches
        data = flac.read_bytes()
    stream_chunks = sum(
        -(-ea.frame_set.num_frames // chunk_size_for(
            ea.frame_set.num_frames, cfg.stream_chunk_frames))
        for ea in many)
    if exp_launches != stream_chunks:
        raise AssertionError(f"export_playlist_to_flac launched imdct_window "
                             f"{exp_launches} times for {stream_chunks} "
                             f"chunks")
    if data != encode_flac_i16_with_level(want, SAMPLE_RATE, 2, FLAC_LEVEL):
        raise AssertionError("album FLAC != whole-playlist FLAC bytes")
    got, rate, channels, bps = decode_flac(data)
    if (rate, channels, bps) != (SAMPLE_RATE, 2, 16) or not np.array_equal(
            got, want.astype(np.int32)):
        raise AssertionError("decode_flac does not give back the playlist")
    audio_s = len(want) / 2 / SAMPLE_RATE
    print(f"[album] decode_playlist of {len(many)} tracks == the decode_many "
          f"tracks, imdct_window launches {launches}; "
          f"export_playlist_to_flac of {audio_s:.0f} s: {t_exp:.3f} s "
          f"({audio_s / t_exp:.1f}x realtime), {len(data)} bytes == "
          f"whole-playlist FLAC, decode_flac gives back the playlist; "
          f"imdct_window launches {exp_launches} == {stream_chunks} chunks")


def phase_album_cli(items):
    """glc_tpu_torch.cli.main on the album's tracks as WAV files, all in one
    call: one encode_many, the per-file containers."""
    calls = []
    real = Encoder.encode_many

    def counted(self, batch):
        calls.append(len(batch))
        return real(self, batch)

    ref = Encoder(SAMPLE_RATE, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        wavs = []
        for i, (x, c) in enumerate(items):
            wavs.append(Path(tmp) / f"track{i}.wav")
            write_wav_i16(wavs[-1], x, SAMPLE_RATE, c)
        Encoder.encode_many = counted
        try:
            rc = cli.main([str(w) for w in wavs])
        finally:
            Encoder.encode_many = real
        if rc != 0 or calls != [len(items)]:
            raise AssertionError(f"CLI exit code {rc}, encode_many calls "
                                 f"{calls}")
        for w, (x, c) in zip(wavs, items, strict=True):
            got = serialize_encoded(load_encoded(w.with_suffix(".glc")))
            if got != serialize_encoded(ref.encode_pcm16(x, c)):
                raise AssertionError(f"CLI {w.name} != encode_pcm16")
    print(f"[album] cli.main on {len(items)} WAVs: exit code 0, one "
          f"encode_many of {calls[0]} tracks, every .glc == encode_pcm16")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    name, smi = phase_device()
    design = phase_build()
    phase_native()
    tables = get_codec_tables(1024, 2048, SAMPLE_RATE, "cuda")
    pcm = make_signal()
    kern = phase_kernel(tables, design,
                        sorted(set(path_rows(pcm)) | set(KERNEL_EDGES),
                               reverse=True))
    record_launch_rows()
    encoded, out, launches = phase_main(pcm)
    phase_cpu(pcm, encoded, out)
    phase_export(encoded, out)
    phase_cli(pcm)
    phase_flac_math(out)
    phase_stream(encoded, out)
    short = phase_album(ALBUM_SECONDS[0], smi)
    _items, many, outs = phase_album(ALBUM_SECONDS[1], smi)
    phase_album_export(many, outs)
    phase_album_cli(short[0])
    unchecked = LAUNCHED_ROWS - set(kern)
    if not LAUNCHED_ROWS or unchecked:
        raise AssertionError(f"imdct_window launched at rows "
                             f"{sorted(unchecked)} not checked against plain")
    print(f"[kernel] the paths launched imdct_window at rows "
          f"{sorted(LAUNCHED_ROWS, reverse=True)}, each checked against the "
          f"plain version above")

    diff, ms, plain_ms = kern[2 * DEFAULT_CONFIG.decode_chunk_frames]
    print(json.dumps({"kernels": [{
        "name": "imdct_window",
        "route": "cuda",
        "source": "glc_tpu_torch/csrc/imdct_window.cu",
        "replaces": "glc_tpu/ops/pallas_kernels.py:47",
        "launches": launches,
        "max_abs_err": max(d for d, _m, _p in kern.values()),
        "ms": ms,
        "plain_ms": plain_ms,
        "rows_checked": sorted(kern, reverse=True),
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
