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
   PyTorch version at B = 2816 rows (one default decode chunk of stereo),
   at every edge of its 128-row tile (1, 63, 64, 65, 127, 128, 129) and at
   a ragged 1000: atol = rtol = 2e-5, both errors against a float64
   product, the kernel's no more than 2x the plain version's; median time
   of 20 runs after 3 warm-ups, with CUDA events;
4. main path — a 180 s, 44.1 kHz, 16-bit stereo signal (seeded tones with
   envelopes, 5 s of white noise, 1 s of silence) through
   Encoder.encode_pcm16 → save_encoded → load_encoded →
   Decoder.decode_i16 on the card, with the kernel's launch count read
   around this run only;
5. card vs CPU — the same input through the port on the CPU (plain
   versions): the containers agree within the pair contract
   (glc_tpu_torch/parity.py) and decode_i16 of the card's container is
   within 1 LSB on the card and on the CPU.

Then one JSON line with the kernel table, and as the last line
{"ok": true, "device": {...}}.  Any failed phase raises and exits non-zero;
without a CUDA device the script exits 1 and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import glc_tpu_torch  # noqa: F401  (turns TF32 off: full-f32 matmuls)
from glc_tpu_torch import Decoder, Encoder, load_encoded, save_encoded
from glc_tpu_torch.codec.encoder import upload_geometry
from glc_tpu_torch.codec.tables import chunk_size_for, get_codec_tables
from glc_tpu_torch.config import DEFAULT_CONFIG
from glc_tpu_torch.ops import kernels
from glc_tpu_torch.ops.kernels import imdct_window, imdct_window_reference
from glc_tpu_torch.parity import check_containers

SAMPLE_RATE = 44100
SECONDS = 180
KERNEL_TOL = 2e-5
KERNEL_ROWS = (2816, 1, 63, 64, 65, 127, 128, 129, 1000)


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
    return name


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


def phase_kernel(tables, design: str):
    n = tables.n
    rng = np.random.default_rng(1)
    table64 = tables.cos_table.double()
    window64 = tables.window.double()
    result = {}
    for B in KERNEL_ROWS:
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


def make_signal(seconds: int = SECONDS, rate: int = SAMPLE_RATE) -> np.ndarray:
    """Interleaved int16 stereo from numpy.random.default_rng(0): tones of
    six harmonics with a decaying envelope per 0.5 s note, 5 s of white
    noise from 60 s (it drives the raw-PCM fallback) and 1 s of silence
    from 120 s."""
    rng = np.random.default_rng(0)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    name = phase_device()
    design = phase_build()
    tables = get_codec_tables(1024, 2048, SAMPLE_RATE, "cuda")
    kern = phase_kernel(tables, design)
    pcm = make_signal()
    encoded, out, launches = phase_main(pcm)
    phase_cpu(pcm, encoded, out)

    diff, ms, plain_ms = kern[2816]
    print(json.dumps({"kernels": [{
        "name": "imdct_window",
        "route": "cuda",
        "source": "glc_tpu_torch/csrc/imdct_window.cu",
        "replaces": "glc_tpu/ops/pallas_kernels.py:47",
        "launches": launches,
        "max_abs_err": max(d for d, _m, _p in kern.values()),
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
