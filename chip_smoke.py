#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (glc_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own line(s):

1. device — torch version, card name, and the card's name and power limit
   from nvidia-smi;
2. warmup — glc_tpu_torch.warmup() on the card, the first work in the process:
   its seconds (the kernel library's nvcc build, one nvcc a source at
   once, included and printed apart), the library loaded after it, and a
   second call's seconds;
3. build  — the three hand-written kernels of glc_tpu_torch/csrc/
   (imdct_window, mdct_rows, band_energy): the registers, spills and
   shared memory the build gave each, each mdct_rows tile shape's, and the
   f64 path's two kernels' with their tiles and the blocks an SM holds
   (the run fails if one of the latter two spills, if an mdct_rows tile
   asks for other shared memory than kernels.mdct_smem_bytes says, or if
   an f64 build's tile or residency is not kernels.f64_plan's);
4. kernel — imdct_window (3xTF32 wgmma fed by TMA) against its plain
   PyTorch version at every edge of its 128-row tile (1, 63, 64, 65, 127,
   128, 129), at a ragged 1000, and at every row count the paths below
   launch it with (`path_rows`: each chunk's frames x 2 channels at the
   decode and the stream chunk sizes, on the 180 s file, the 10 s excerpt,
   the stereo album tracks and the playback phase's mono track, the
   stacked rows of every decode_many launch of the album phase, and each
   sharded rank's block, `sharded_rows`): atol =
   rtol = 2e-5, both errors against a float64 product, the kernel's no
   more than 2x the plain version's; median time of 20 runs after 3
   warm-ups, with CUDA events, of the kernel, the plain version and the
   one library call that computes the same function (torch.matmul at full
   f32 against the table with norm x window folded into its columns); and
   the bound (`kernel_bound`: the larger of the product's FLOPs at the
   TF32 peak and the bytes at the HBM rate).  The decode's calls of the
   kernel are recorded by row count, and the run fails if a path launched
   it at a row count this phase did not check;
5. encode kernels — mdct_rows (3xTF32 wgmma fed by TMA) and band_energy
   (a warp a row, each band cut into 33-bin compensated sums that the
   lanes take and fold in order, rows streamed by cp.async), the encode's
   row-invariant products, against their plain PyTorch versions at the
   tile edges and at every row count the encode paths launch them with
   (`encode_rows`: each segment's frames x channels of every encode below,
   at every segment size, and each sharded rank's block): mdct_rows at
   atol = rtol = 2e-5, band_energy at rtol 1e-5, both errors against a
   float64 product, the kernel's no more than 2x the plain version's;
   each launch's rows equal to the same rows of the largest launch; the
   times (medians of 20, CUDA events) of each kernel, its plain version and
   one library call (a full-f32 torch.matmul against the table with norm
   folded in; one torch.einsum of the squares against the band mask), and
   the bounds (`mdct_bound`, `band_bound`); the same three again as device
   times of 20 calls back to back (`bench.device_ms`: the host's call overhead
   hidden), each kernel time's share of the bound; for mdct_rows the plan
   the chooser takes at each row count and 3xTF32's floor (`mdct_floor`),
   and every plan the chooser can return (and each tile shape at 1 and 7
   blocks) on the same 8192 rows, bit for bit equal (`check_mdct_plans`);
   for band_energy, on rows with NaN and Inf squares, the plain version's
   NaN and +Inf bands.  Their calls are recorded by row count too;
6. main path — a 180 s, 44.1 kHz, 16-bit stereo signal (seeded tones with
   envelopes, 5 s of white noise, 1 s of silence) through
   Encoder.encode_pcm16 → save_encoded → load_encoded →
   Decoder.decode_i16 on the card, with the kernels' launch counts read
   around this run only (imdct_window one a decode chunk, mdct_rows and
   band_energy one an encode segment); then encode_pcm16's wall, median of
   11 after a warm-up;
7. card vs CPU — the same input through the port on the CPU (plain
   versions): the containers agree within the pair contract
   (glc_tpu_torch/parity.py), the flip rate printed, and decode_i16 of the
   card's container is within 1 LSB on the card and on the CPU;
8. invariance — the 180 s encode_pcm16 on the card at encode_chunk_frames
   4096, 512 and 1000 (2, 16 and 8 segments): the same bytes;
9. quality — bench.py's make_signal(5.0) and its quality_stereo_5s SNR
   (copied here), compat and clean, on the card and through the port on
   the CPU: within 0.2 dB of each other;
10. native — the shared C++ runtime (native/, built with make on first
   use): says whether it was built or loaded, and fails without it or
   without its frame packer, so that the export below is the shipped path;
11. export — the CLI's default decode on the 180 s container:
   decode_i16_stream(chunk_frames=1024) → encode_flac_i16_streaming(level
   5), timed after a warm-up call, with the kernel's launches of the timed
   call alone (one a chunk); the stream equals decode_i16 bit for bit, the
   bytes equal encode_flac_i16_with_level of decode_i16, and decode_flac
   gives back the samples, their format and their MD5;
12. cli — glc_tpu_torch.cli.main on a 10 s excerpt: WAV → .glc, .glc → FLAC
   (the default), FLAC → .glc; the FLAC holds decode_i16 of the .glc and
   the container from the FLAC equals Encoder.encode_pcm16 of its samples;
13. flac math — flac_block_stats on the card against its host twin, orders
   0-4, 4096-sample blocks at level 5's partition order, on the decoded
   180 s output: exactly equal;
14. stream — decode_streaming on the card: 500-frame chunks but the last,
   Progress ending in "complete", the trimmed concatenation equal to
   decode within 1e-6 and within 1 LSB of decode_i16;
15. album — the multi-track paths at the JAX package's album shapes
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
   one encode_many, into the per-file containers;
16. api — the JAX package's public API on the port: glc_tpu_torch.ops's
   encode_chunk_device on the 180 s signal's first segment (4096 frames,
   8192 rows; one mdct_rows and one band_energy launch) equal bit for bit
   to the Encoder's segment in the main path's container, and within the
   pair contract of the CPU port's chunk program; decode_chunk_device on
   the main path's first decode chunk (1408 frames, 2816 rows; one
   imdct_window launch) equal bit for bit to decode_i16's hops and its
   int16 output; then the `stats=` hooks of the 180 s encode_pcm16,
   decode_i16 and FLAC export and of the 4 x 120 s decode_many: output
   equal to the unhooked call's, the JAX package's keys, the transfer
   counts and launches tests/test_torch_api.py pins, and each call's wall
   unhooked and hooked with the hook's median pack_ms / disp_ms / wait_ms
   (medians of 11 alternating pairs);
17. sharded — glc_tpu_torch.parallel on the one card, in three worlds of
   spawned ranks, each rank on cuda:0: gloo 2 ranks (mesh 1 x 2), gloo 4
   ranks (2 x 2; the halo and the gathers through host memory) and NCCL 1
   rank (1 x 1; the gathers on the card).  After a warm-up, each world
   runs encode_album_sharded and decode_album_sharded of both albums (the
   f32 tracks) and roundtrip_step_sharded at its dry-run shape and at
   (4, 4).  Each container equals the serial Encoder.encode's bytes (else
   the flip rate, the first divergence and the MDCT row counts of both
   sides are printed, and the run fails); each decode is within rtol
   2e-6, atol 1e-7 of the serial Decoder.decode, of the original length
   (bit for bit equality printed); the ranks' results agree; the mse at
   (4, 4) agrees across worlds within 1e-6; each rank launches each of
   the three kernels at the rows `sharded_rows` predicts; the walls are
   printed beside the
   serial loops'.  A rank that fails, or a world not done in 300 s, fails
   the run;
18. playback — playback.play_files_gapless of the 120 s album's .glc files
   into a capture sink: one sink, the stream equal to the tracks'
   decode_streaming chunks bit for bit, each track's trimmed part within
   1e-6 of decode and 1 LSB of decode_i16, one launch a chunk; the time to
   the first sink append and the feed rate (audio seconds / wall seconds
   to the last append), medians of 5; a mono 15 s track appended (the sink
   restarts once); a sink that stops after its first chunk (one chunk
   written, no producer thread left, torch.cuda.synchronize() passes); and
   cli.main(["-p", ...]) and (["-p", "--ffplay", ...]) against a stub
   ffplay written into a temporary directory, whose bytes are the stream;
19. controller — CodecController on two 15 s WAVs: encode_selected equals
   encode_pcm16 byte for byte, play_gapless feeds the decode_streaming
   stream, export_playlist equals album.export_playlist_to_flac;
20. profile — GLC_PROFILE around two decode_i16 calls of the 180 s
   container: each torch.profiler trace holds the decode_i16 span and one
   imdct_window kernel event a chunk; the traced and untraced walls; and
   one play_files_gapless of the 480 s album under profiling.trace: the
   device's busy time (kernels, copies, memsets) and idle share inside
   the call's span;
21. bench — `python3 -m glc_tpu_torch.bench --quick` in a child process
   (the port's benchmark at short shapes: a 10 s trio, the 4 x 15 s album,
   3 rounds): exit code 0, and its last line, printed here, the flagship
   encode_realtime_factor_44k_stereo line under 1500 characters with
   "correct": true (the bench's own gate: card vs the port's CPU run);
21a. f64 path — the f64 path of mdct_rows and imdct_window at full size:
   the bench's 60 s signal (glc_tpu_torch/bench.py's make_signal_i16,
   44.1 kHz stereo) through encode_pcm16, decode_i16 and the FLAC export at
   hop 441 and 256, after a warm-up, each call's launches counted from 0
   around it (every product launch of the f64 path), the container within
   the pair contract of the CPU port's, the decode within 1 LSB of the
   CPU's, the FLAC holding decode_i16's samples; each wall (median of 5)
   beside the two f64 kernels' device time in a traced call;
22. geometry — the frame geometries other than the default hop of 1024
   (`GEOMETRIES`: hop 256, 441, 500, 735 and 2048 at 44.1 kHz, 960 at
   48 kHz; frame_size = 2·hop): 10 s of stereo through encode_pcm16 →
   decode_i16 on the card at each, the launches counted from 0 around it
   (one mdct_rows and one band_energy a segment, one imdct_window a
   chunk; at hop 256 and 441 the products' launches are all of their f64
   path, csrc/f64_rows.cuh, elsewhere none), the container within the
   pair contract of the CPU port's and
   the decode within 1 LSB of the CPU's; each kernel against its plain
   version at that n, at every row count those paths launched it with
   and at the timed rows (the error against float64 no more than twice
   plain's, each row the bits of the same row of the largest launch); at
   hop 960, 441, 735 and 256 the times of each kernel, its plain version and
   one library call beside the bound (M = 8192, B = 2816; the products'
   operations at the peak of the unit their path runs on, the FP64 tensor
   cores at the f64 hops, `bench.product_peak`), at the f64 hops also the
   same function's library call (torch.matmul on float64 copies: cuBLAS
   DGEMM; the widening timed apart), and of the copy into the padded
   pitch where the kernel makes one; the f64 builds' info line; and, at each n
   of `PATH_NS`, mdct_rows' and imdct_window's errors through the 3xTF32
   tile product and through their f64 path, each over plain's (the f64
   path's, and the path the wrappers take at that n, no more than
   twice), and both paths' times;
23. conformance — the sample rates and channel counts of the JAX
   package's suites (tests/test_comprehensive.py, tests/test_torture.py):
   10 s of program material (`program_material` of
   tests/test_torch_rates.py) at 8000, 22050, 44100, 48000 and 96000 Hz
   x 1, 2, 4 and 6 channels through encode_pcm16 -> decode_i16 on the
   card, the launches counted from 0 around each case, the container
   within the pair contract of the CPU port's and the decode within 1 LSB,
   each flip rate and worst LSB printed; two realistic files through
   cli.main (WAV -> .glc -> FLAC -> .glc): 120 s of 6-channel 48 kHz (a
   5.1 film stem: 24 576-row encode segments) and 60 s of 96 kHz stereo
   (a hi-res master), the FLAC holding decode_i16 of the .glc, the
   container from the FLAC equal to encode_pcm16 of its samples, both
   within the contract of the CPU port's, and the encode_pcm16 and
   decode_i16 walls, medians of 5 after a warm-up; tests/test_torture.py's
   30 seeded configurations on the card through the invariants of
   tests/test_torch_torture.py (chunk-size invariance bit for bit), each
   container within the contract of the CPU port's; the RFC 9639 byte
   literals and foreign streams of tests/test_torch_flac_conformance.py
   through the native and Python FLAC decoders; then each kernel against
   its plain version at every rate's tables (its band plan: 33 bands at
   8 kHz, 50 from 22.05 kHz) on every row count the phase launched it
   with there (the same checks as phase 22's), and each kernel's times
   there (M = 8192, B = 2816) beside plain's, the library call's and the
   bound, as phase 22 times them.

Every path counts the kernels' launches from 0 just before it runs and
checks them just after, and the run fails if a path launched a kernel at
the default n at a row count that phase 4 or 5 did not check (phase 22
checks its own n, phase 23 its own rates).  Then one JSON line with the
kernel table (launch counts from the main path; times, library time and
bound at its rows: B = 2816 for imdct_window, M = 8192 for the encode's
kernels; under
"geometry" each hop's launches, checked rows and, at 960, 441 and 735,
times; the f64 path's two kernels with their launches on the 60 s path
at hop 441 (phase 21a), errors and times from the geometry phase at hop
441, the float64 library call as library_ms and the f32 one beside it;
under "rates" each rate's launches,
checked rows, largest difference from plain and times in the
conformance phase, and under "conformance" its summary),
and as the last line
{"ok": true, "device": {...}}.  Any failed phase raises and exits non-zero;
without a CUDA device the script exits 1 and prints no result.

    python3 chip_smoke.py --encode-ab OTHER_CHECKOUT

times encode_pcm16 of the 180 s signal in this checkout and in another
(the parent commit's, say) instead, each in its own processes (`encode_ab`);

    python3 chip_smoke.py --encode-kernels-ab

times it in one process with the encode's kernels and with their plain
versions in their place, in alternating pairs (`encode_kernels_ab`);

    python3 chip_smoke.py --kernel-ab OTHER_CHECKOUT

runs mdct_rows and band_energy at every row count of the encode paths and
imdct_window at every row count of the decode paths, at the default n,
all three at a few row counts at hop 128, 256, 441 and 456, and at the
cuda tests' row counts at each of their n that takes the f64 path, on
the same seeded rows in this checkout and in another, in four processes
(other, this, this, other), fails unless the outputs are the same bits
everywhere, and prints each process's back-to-back and single-call times
(`kernel_ab`);

    python3 chip_smoke.py --mdct-plans

times every mdct_rows tile shape back to back at those row counts beside
the chooser's pick and torch.matmul, and samples the SM clock and power
while the largest launch runs (`mdct_plans`: the measurement behind
kernels.mdct_rows_plan);

    python3 chip_smoke.py --f64-plans

times every build of the f64 path (kernels.F64_TILES) of mdct_rows and
imdct_window at hop 441 and 256 at several row counts, each build's bits
checked against the wrapper's, beside the chooser's pick and a float64
torch.matmul, and fits each build's unit time (`f64_plans`: the
measurement behind kernels.F64_UNIT_US);

    python3 chip_smoke.py --path-sweep [OUT.json]

measures, at every n from 1 to 1024 and on several seeds' rows, each
product path's error against float64 over plain's (`path_sweep`: the
measurement behind kernels._F64_MAX_N, the n up to which mdct_rows and
imdct_window take their f64 path).
"""

from __future__ import annotations

import contextlib
import datetime
import hashlib
import importlib.util
import inspect
import io
import json
import multiprocessing
import os
import pickle
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

import glc_tpu_torch  # noqa: F401  (turns TF32 off: full-f32 matmuls)
from glc_tpu_torch import (
    Decoder, Encoder, deserialize_encoded, load_encoded, save_encoded,
    serialize_encoded,
)
from glc_tpu_torch import album, cli, native, parallel, playback, profiling
# the bench's bounds and peaks, kernel timing and seeded rows, quality
# signal and metrics, trace reading and playback sink, which this script
# shares
from glc_tpu_torch.bench import (
    PEAK_TF32_FLOPS, CaptureSink, band_bound, device_busy_ms, device_ms,
    kernel_bound, mdct_bound, quality_metrics, seeded_rows,
)
from glc_tpu_torch.bench import make_signal as make_quality_signal
from glc_tpu_torch.bench import make_signal_i16 as make_bench_signal_i16
from glc_tpu_torch.codec.decoder import (
    PRODUCER_NAME, chunk_pairs, gapless_trim_bounds,
)
from glc_tpu_torch.codec.encoder import upload_geometry
from glc_tpu_torch.codec.tables import (
    chunk_size_for, get_codec_tables, get_device_tables, pow2_bucket,
)
from glc_tpu_torch.config import DEFAULT_CONFIG
from glc_tpu_torch.container.schema import EncodedAudio, ProgressKind
from glc_tpu_torch.controller import CodecController
from glc_tpu_torch.flac import bitpack
from glc_tpu_torch.flac.decoder import decode_flac
from glc_tpu_torch.flac.pydecoder import decode_flac_python
from glc_tpu_torch.flac.encoder import (
    encode_flac_i16_streaming, encode_flac_i16_with_level,
)
from glc_tpu_torch.flac.ops import flac_block_stats, flac_block_stats_host
from glc_tpu_torch.io.wav import convert_f32_to_i16, write_wav_i16
from glc_tpu_torch.ops import decode as decode_ops
from glc_tpu_torch.ops import decode_chunk_device, encode_chunk_device
from glc_tpu_torch.ops.decode import to_i16
from glc_tpu_torch.ops.encode import frames_from_signal, planarize
from glc_tpu_torch.ops import mdct as mdct_ops
from glc_tpu_torch.ops import psycho as psycho_ops
from glc_tpu_torch.ops import kernels
from glc_tpu_torch.ops.kernels import (
    band_energy, band_energy_reference, imdct_window, imdct_window_reference,
    mdct_rows, mdct_rows_reference,
)
from glc_tpu_torch.parallel.mesh import mesh_shape
from glc_tpu_torch.parity import (
    MAX_FLIP_RATE, check_containers, dense_pair_flips,
)

# the launch geometry of decode_many, kept beside the tests that hold the
# decoder to it
sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
from test_torch_album import launch_rows  # noqa: E402
# the stats hooks' keys and counts, as the tests pin them
from test_torch_api import (  # noqa: E402
    DECODE_KEYS, ENCODE_KEYS, UPLOADS_PER_CHUNK, chunks_of, encode_down_n,
)
# the n of the cuda tests' every-n cases, whose rows --path-sweep also runs
from test_torch_kernels import GEOMETRY_NS as TEST_GEOMETRY_NS  # noqa: E402
from test_torch_kernels import GEOMETRY_ROWS as TEST_GEOMETRY_ROWS  # noqa: E402
# the conformance phase's program material, torture draws and invariants,
# and FLAC streams, as the tests hold the port to them
from test_torch_flac_conformance import FOREIGN, SPEC_VECTORS  # noqa: E402
from test_torch_flac_conformance import STREAM_B as FLAC_GOLDEN  # noqa: E402
from test_torch_flac_conformance import outcome as flac_outcome  # noqa: E402
from test_torch_rates import check_kernel_rows, program_material  # noqa: E402
from test_torch_torture import CASES as TORTURE_CASES  # noqa: E402
from test_torch_torture import (  # noqa: E402
    SMALL_CHUNK, check_invariants, torture_case,
)

SAMPLE_RATE = 44100
SECONDS = 180
KERNEL_TOL = 2e-5
BAND_RTOL = 1e-5       # sums of squares: positive, no cancellation
KERNEL_EDGES = (1, 63, 64, 65, 127, 128, 129, 1000)
PLAN_CHECK_ROWS = 8192  # the rows every mdct_rows plan runs on
KERNEL_NAMES = ("imdct_window", "mdct_rows", "band_energy")
INVARIANCE_CHUNKS = (4096, 512, 1000)  # encode_chunk_frames of phase 8
QUALITY_SECONDS = 5.0  # bench.py's quality_stereo_5s
QUALITY_TOL_DB = 0.2   # card vs CPU SNR
WARMUP_SECONDS = 60.0  # warmup()'s default
CLI_SECONDS = 10
ALBUM_TRACKS = 4
ALBUM_SECONDS = (15, 120)
WALL_RUNS = 11
FLAC_LEVEL = 5
STREAM_TOL = 1e-6
MONO_SECONDS = 15      # the mono track the playback phase appends
FEED_RUNS = 5          # timed playbacks of the 480 s playlist
# The sharded phase's worlds on the one card, (backend, ranks); each mesh is
# make_mesh's default for its rank count: (1, 2), (2, 2) and (1, 1).
SHARDED_WORLDS = (("gloo", 2), ("gloo", 4), ("nccl", 1))
SHARDED_TIMEOUT_S = 300  # a world's run, spawn included; collectives: 120 s
BENCH_TIMEOUT_S = 600    # bench --quick, the kernels' load included
# The round trip every world also runs, so that their mse compare: the
# 2 x 2 mesh's dry-run shape (B, K), which every world's mesh divides
ROUNDTRIP_COMMON = (4, 4)
MSE_RTOL = 1e-6
# The geometry phase's frame geometries (frame_size = 2·hop): (name, hop,
# sample rate); the hops at which it times the kernels, and at what rows;
# the n at which it holds the two product paths of mdct_rows and
# imdct_window apart (kernels.product_path; the cut kernels._F64_MAX_N is
# 456).  Hop 735 is 44.1 kHz's audio a 60 fps video frame: an odd hop above
# the cut, where the tile product reads padded copies.
GEOMETRIES = (("hop256_44k1", 256, 44100), ("hop441_44k1", 441, 44100),
              ("hop500_44k1", 500, 44100), ("hop735_44k1", 735, 44100),
              ("hop960_48k", 960, 48000), ("hop2048_44k1", 2048, 44100))
GEOMETRY_SECONDS = 10
GEOMETRY_TIMED = (960, 441, 735, 256)
GEOMETRY_TIMED_ROWS = {"imdct_window": 2816, "mdct_rows": 8192,
                       "band_energy": 8192}
PATH_NS = (1, 8, 120, 256, 441, 456, 457)
# The f64 path's kernels (csrc/f64_rows.cuh) in the JSON line, each with
# the wrapper that launches it, and the hop whose round trip and times
# that line reports
F64_KERNELS = {"imdct_window_f64": "imdct_window", "mdct_rows_f64": "mdct_rows"}
F64_HOP = 441
# The f64 path at full size (phase 21a): the bench's 60 s signal (44.1 kHz
# stereo) at these hops, all of whose products take the f64 path; the runs
# of each wall; how the trace names each f64 kernel (its epilogue)
F64_PATH_HOPS = (441, 256)
F64_PATH_SECONDS = 60
F64_PATH_RUNS = 5
F64_KERNEL_EVENTS = {"mdct_rows_f64": "Scale>", "imdct_window_f64": "Window>"}
# The conformance phase (23): the rates and channel counts of the JAX
# package's suites (tests/test_comprehensive.py, tests/test_torture.py),
# each case CONFORMANCE_SECONDS of program material; realistic files
# through the CLI, (label, seconds, rate, channels), and the runs of their
# walls
CONFORMANCE_RATES = (8000, 22050, 44100, 48000, 96000)
CONFORMANCE_CHANNELS = (1, 2, 4, 6)
CONFORMANCE_SECONDS = 10
FULL_SIZE = (("5.1 film stem", 120, 48000, 6),
             ("hi-res master", 60, 96000, 2))
FULL_SIZE_RUNS = 5
# --kernel-ab's other n (the parent's kernels took these hops too: 441
# and 456 at the f64 path's cut) and their row counts: the geometry
# phase's timed ones and a few edges; it also runs every n of the cuda
# tests that takes the f64 path, at the tests' row counts
AB_SMALL_NS = (128, 256, 441, 456)
AB_SMALL_ROWS = {"encode": [8192, 646, 63, 1], "decode": [2816, 63, 1]}


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


def phase_warmup():
    """glc_tpu_torch.warmup() on the card, first in the process: it builds
    the kernel library (the nvcc time is taken apart) and the native
    runtime, or loads them.  Returns its seconds."""
    cached = kernels.library_path().exists()
    built = []
    real_build = kernels._build

    def timed_build(path):
        built.append(_wall(lambda: real_build(path)))

    kernels._build = timed_build
    try:
        t_cold = _wall(lambda: glc_tpu_torch.warmup(device="cuda"))
    finally:
        kernels._build = real_build
    if kernels._lib is None:
        raise AssertionError("warmup() left the kernel library unloaded")
    if cached == bool(built):
        raise AssertionError(f"library cached {cached}, builds {built}")
    t_warm = _wall(lambda: glc_tpu_torch.warmup(device="cuda"))
    how = (f"loaded from {kernels.library_path().name}" if cached else
           f"built in {built[0]:.2f} s of it (nvcc, one a source at once)")
    print(f"[warmup] warmup(device='cuda', {WARMUP_SECONDS:.0f} s stereo, "
          f"FLAC) first in the process: {t_cold:.2f} s, the kernel library "
          f"{how}, loaded after it: True; a second call {t_warm:.3f} s")
    return t_cold


def phase_build(strict: bool = True):
    """The kernels' build (registers, spills, shared memory), each
    mdct_rows tile shape's and the f64 path's two kernels' (with their
    tiles and the blocks an SM holds): fails (if `strict`) on a spill, on a
    shared memory size that the plan model (kernels.mdct_smem_bytes) does
    not know, or on an f64 build whose tile or residency is not the one
    kernels.f64_plan plans with; returns a design line per kernel for the
    kernel phases."""
    info = kernels.kernel_info()
    designs = {}

    def built(i: dict) -> str:
        return (f"{i['registers']} regs/thread, {i['local_bytes']} B local "
                f"(spills), smem {i['static_smem']} B static + "
                f"{i['dynamic_smem']} B dynamic, {i['stages']} stages")

    for name in KERNEL_NAMES:
        i = info[name]
        how = {"band_energy": f"a warp a row, {kernels.BAND_CHUNK}-bin "
                              f"compensated items over {kernels.BAND_LANES} "
                              f"lanes folded in order, cp.async",
               "mdct_rows": "3xTF32 wgmma, TMA, ping-pong warpgroups, "
                            "persistent grid, tile shape by M",
               }.get(name, "3xTF32 wgmma, TMA")
        designs[name] = f"{how}; {built(i)}"
        print(f"[build] {name} ({kernels.library_path().name}): "
              f"{designs[name]}")
    faults = []
    for rows, cols in kernels.MDCT_TILES:
        i = info[f"mdct_rows{(rows, cols)}"]
        print(f"[build] mdct_rows tile {rows} x {cols}: {built(i)}")
        if i["local_bytes"]:
            faults.append(f"{(rows, cols)} spills {i['local_bytes']} B")
        if i["dynamic_smem"] != kernels.mdct_smem_bytes(rows, cols):
            faults.append(f"{(rows, cols)} asks for {i['dynamic_smem']} B, "
                          f"the plan model "
                          f"{kernels.mdct_smem_bytes(rows, cols)} B")
    for kernel in ("mdct_rows", "imdct_window"):
        lines = []
        for tile in kernels.F64_TILES:
            i = info[f"{kernel}_f64{tile}"]
            lines.append(f"tile {tile[0]} x {tile[1]}: {built(i)}, "
                         f"{i['resident_blocks']} blocks an SM")
            if i["local_bytes"]:
                faults.append(f"{kernel} f64 {tile} spills "
                              f"{i['local_bytes']} B")
            if (i["tile"] != tile
                    or i["resident_blocks"] != kernels.F64_RESIDENT[tile]):
                faults.append(f"{kernel} f64 build {i['tile']} holds "
                              f"{i['resident_blocks']} blocks an SM, the "
                              f"plan model's {tile} "
                              f"{kernels.F64_RESIDENT[tile]}")
        designs[f"{kernel}_f64"] = (
            "f64 mma.sync, 16-byte cp.async, tile by M (f64_plan); "
            + "; ".join(lines))
        print(f"[build] {kernel} f64 path: {designs[f'{kernel}_f64']}")
    if faults:
        if strict:
            raise AssertionError(f"mdct_rows: {faults}")
        print(f"[build] FAULTS: {faults}")
    return designs


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


def decode_chunks(eas, max_chunk: int) -> int:
    """The chunks (kernel launches) of a track-by-track decode of `eas`."""
    return sum(-(-ea.frame_set.num_frames // chunk_size_for(
        ea.frame_set.num_frames, max_chunk)) for ea in eas)


def path_rows(pcm: np.ndarray) -> list[int]:
    """The row counts the paths launch imdct_window with: every chunk's
    frames x its track's channels, at the decode and the stream chunk
    sizes, on the 180 s file, the CLI's 10 s excerpt, a stereo album track
    of each length, the playback phase's mono track, the quality phase's
    5 s and warmup()'s 60 s; and every decode_many launch of the album
    phase."""
    cfg = DEFAULT_CONFIG
    rows = set()
    tracks = [(len(pcm), 2), (CLI_SECONDS * SAMPLE_RATE * 2, 2),
              *((s * SAMPLE_RATE * 2, 2) for s in ALBUM_SECONDS),
              (MONO_SECONDS * SAMPLE_RATE, 1),
              (int(QUALITY_SECONDS * SAMPLE_RATE) * 2, 2),
              (int(WARMUP_SECONDS * SAMPLE_RATE) * 2, 2)]
    for samples, channels in tracks:
        F = frames_of(samples, channels)
        for max_chunk in (cfg.decode_chunk_frames, cfg.stream_chunk_frames):
            chunk = chunk_size_for(F, max_chunk)
            rows.update(channels * min(chunk, F - s)
                        for s in range(0, F, chunk))
    for seconds in ALBUM_SECONDS:
        tracks = [(2, frames_of(seconds * SAMPLE_RATE * 2))] * ALBUM_TRACKS
        rows.update(launch_rows(tracks, cfg.decode_chunk_frames))
    for _backend, ranks in SHARDED_WORLDS:
        rows.update(sharded_rows(ranks))
    return sorted(rows, reverse=True)


def sharded_rows(ranks: int) -> list[int]:
    """The row counts, in call order, each rank of a world of `ranks`
    launches imdct_window with in the sharded phase's checked run: one
    launch a rank for the decode of each album, on its [Bl, Kl] block of
    the [B, K] album (Bl·Kl·2 rows; parallel/album.py's geometry), then one
    for each round trip (C = 1): at the world's dry-run shape (B = 2d,
    K = 2f) and at ROUNDTRIP_COMMON."""
    d, f = mesh_shape(ranks)
    rows = []
    for seconds in ALBUM_SECONDS:
        K = pow2_bucket(frames_of(seconds * SAMPLE_RATE * 2), 1 << 30)
        K = -(-K // f) * f
        B = -(-ALBUM_TRACKS // d) * d
        rows.append((B // d) * (K // f) * 2)
    B, K = ROUNDTRIP_COMMON
    return rows + [2 * 2, (B // d) * (K // f)]


def encode_rows(pcm: np.ndarray) -> list[int]:
    """The row counts the encode paths launch mdct_rows and band_energy
    with: each segment's frames x channels (`serial_rows`) of the 180 s
    file at every segment size of the invariance phase, the 10 s excerpt
    (the main path's warm-up, the CLI), the album tracks, the mono track,
    the quality phase's 5 s and warmup()'s 60 s; and each sharded rank's
    block, whose rows are its decode's (`sharded_rows`)."""
    cfg = DEFAULT_CONFIG
    tracks = [(len(pcm), 2), (CLI_SECONDS * SAMPLE_RATE * 2, 2),
              *((s * SAMPLE_RATE * 2, 2) for s in ALBUM_SECONDS),
              (MONO_SECONDS * SAMPLE_RATE, 1),
              (int(QUALITY_SECONDS * SAMPLE_RATE) * 2, 2),
              (int(WARMUP_SECONDS * SAMPLE_RATE) * 2, 2)]
    rows = set()
    for samples, channels in tracks:
        rows.update(serial_rows(samples, channels))
    for k in INVARIANCE_CHUNKS:
        rows.update(serial_rows(len(pcm), 2,
                                replace(cfg, encode_chunk_frames=k)))
    for _backend, ranks in SHARDED_WORLDS:
        rows.update(sharded_rows(ranks))
    return sorted(rows, reverse=True)


# kernel -> the row counts the paths launched it with at the default n
LAUNCHED_ROWS: dict[str, set[int]] = {name: set() for name in KERNEL_NAMES}
# kernel -> {n: the row counts} at the geometry phase's other n
GEOMETRY_LAUNCHED: dict[str, dict[int, set[int]]] = {
    name: {} for name in KERNEL_NAMES}


# rate -> kernel -> the row counts the conformance phase launched it with
# (at the default n, at that rate's tables); the rate its calls go to
RATE_LAUNCHED: dict[int, dict[str, set[int]]] = {}
_RECORDING_RATE: list = [None]


def record_rows(name: str, rows: int, n: int) -> None:
    rate = _RECORDING_RATE[0]
    if rate is not None:
        if n != DEFAULT_CONFIG.n:
            raise AssertionError(f"{name} launched at n={n} in the "
                                 f"conformance phase")
        RATE_LAUNCHED.setdefault(rate, {k: set() for k in KERNEL_NAMES})[
            name].add(rows)
    elif n == DEFAULT_CONFIG.n:
        LAUNCHED_ROWS[name].add(rows)
    else:
        GEOMETRY_LAUNCHED[name].setdefault(n, set()).add(rows)


@contextlib.contextmanager
def recording_rate(rate: int):
    """Record the kernels' launched rows under `rate` in RATE_LAUNCHED
    (the conformance phase's, checked at that rate's tables) instead of
    LAUNCHED_ROWS, which phases 4 and 5 check at 44.1 kHz's."""
    _RECORDING_RATE[0] = rate
    try:
        yield
    finally:
        _RECORDING_RATE[0] = None


def record_launch_rows(record=record_rows):
    """Route the paths' calls of the three kernel wrappers on the card
    through `record(kernel, row count, n)` (a CPU call runs the plain
    version and is not recorded); the wrappers themselves, and their
    launch counts, stay as they are (the kernel phases call them
    directly)."""
    def wrap(module, name):
        wrapper = getattr(module, name)
        per_n = 2 if name == "mdct_rows" else 1  # win's rows are 2n wide

        def recorded(rows, *args):
            if rows.is_cuda:
                record(name, rows.shape[0], rows.shape[1] // per_n)
            return wrapper(rows, *args)

        setattr(module, name, recorded)

    wrap(decode_ops, "imdct_window")
    wrap(mdct_ops, "mdct_rows")
    wrap(psycho_ops, "band_energy")


def reset_launches() -> None:
    for fn in (imdct_window, mdct_rows, band_energy):
        fn.launches = 0
    for fn in (imdct_window, mdct_rows):
        fn.f64_launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches
            for fn in (imdct_window, mdct_rows, band_energy)}


def mdct_floor(M: int, n: int) -> float:
    """3xTF32's floor for mdct_rows on M rows (ms): its three TF32 products
    at the TF32 peak, three times the one product's operations bound."""
    return 3 * 2.0 * M * 2 * n * n / PEAK_TF32_FLOPS * 1e3


def card_sms() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def every_mdct_plan(M: int, n: int) -> list:
    """Every plan of mdct_rows on M rows that the chooser can return on this
    card (each tile shape with a grid of min(units, SMs)), and each tile
    shape with 1 and 7 blocks, which walk many units each."""
    plans = []
    for rows, cols in kernels.MDCT_TILES:
        units = kernels.mdct_units(M, n, rows, cols)[1]
        plans += [kernels.MdctPlan(rows, cols, grid)
                  for grid in sorted({min(units, card_sms()), 1, min(units, 7)},
                                     reverse=True)]
    return plans


def check_mdct_plans(tables, win) -> None:
    """mdct_rows with every plan (`every_mdct_plan`) on the same rows: the
    default plan's bits, each of them."""
    M, n = win.shape[0], tables.n
    args = (win, tables.cos_table, tables.norm)
    want = mdct_rows(*args)
    plans = every_mdct_plan(M, n)
    for plan in plans:
        got = mdct_rows(*args, plan=plan)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = (got != want).sum().item()
            raise AssertionError(f"mdct_rows plan {tuple(plan)} differs from "
                                 f"the default plan in {bad} of {got.numel()} "
                                 f"elements at M={M}")
    print(f"[encode kernels] mdct_rows at M={M}: every plan the chooser can "
          f"return here and each tile shape at 1 and 7 blocks "
          f"({len(plans)} plans: {[tuple(p) for p in plans]}) == the default "
          f"plan {tuple(kernels.mdct_rows_plan(M, n, card_sms()))} bit for bit")


def check_band_energy_non_finite(tables) -> None:
    """band_energy on rows of 0.01 holding NaN, Inf or squares that
    overflow: the plain version's NaN and +Inf bands (a band is +Inf if
    every non-finite square of its row lies in it and none is NaN, else
    NaN), the finite sums within BAND_RTOL; a finite sum that overflows is
    +Inf."""
    n = tables.n
    spots = [{500: np.inf}, {10: -np.inf}, {700: 3e19}, {200: np.nan},
             {400: np.inf, 900: -np.inf}, {5: np.inf, 600: np.inf},
             {500: np.inf, 501: np.nan}, {400: 1.5e19, 401: 1.5e19}, {}]
    rows = np.full((len(spots), n), 0.01, np.float32)
    for r, row in enumerate(spots):
        for k, v in row.items():
            rows[r, k] = v
    c = torch.from_numpy(rows).cuda()
    got = band_energy(c, tables.band_mask).cpu()
    want = band_energy_reference(c, tables.band_mask).cpu()
    finite = want.isfinite()
    if not (torch.equal(got.isnan(), want.isnan())
            and torch.equal(got.isposinf(), want.isposinf())):
        raise AssertionError(f"band_energy's NaN/Inf bands differ from "
                             f"plain's:\n{got}\n{want}")
    torch.testing.assert_close(got[finite], want[finite], rtol=BAND_RTOL,
                               atol=0.0)
    print(f"[encode kernels] band_energy on {len(spots)} rows with NaN, Inf "
          f"and overflowing squares: plain's NaN and +Inf bands "
          f"({int(got.isnan().sum())} NaN, {int(got.isposinf().sum())} +Inf), "
          f"finite sums within rtol {BAND_RTOL}")


def phase_encode_kernels(tables, designs: dict, rows):
    """mdct_rows and band_energy against their plain versions at each row
    count, their row invariance, and the times of the kernel, the plain
    version and one library call beside the bound, single calls and back
    to back; mdct_rows also with every plan on the same 8192 rows and its
    plan at each row count, band_energy on rows with non-finite squares.
    Returns {kernel: {M: (max|kernel-plain|, ms, plain ms, library ms,
    bound ms, bound by, device ms, device plain ms, device library ms)}}."""
    n = tables.n
    bands = tables.band_mask.shape[0]
    check_band_energy_non_finite(tables)
    M_max = max(rows)
    win_all = seeded_rows(M_max, 2 * n, 2, tables.window)
    check_mdct_plans(tables, win_all[-PLAN_CHECK_ROWS:].contiguous())
    coeffs_all = mdct_rows(win_all, tables.cos_table, tables.norm)
    sums_all = band_energy(coeffs_all, tables.band_mask)
    table64 = tables.cos_table.double()
    mask64 = tables.band_mask.double()
    table_norm = (tables.cos_table * tables.norm).T.contiguous()
    result = {"mdct_rows": {}, "band_energy": {}}
    for M in rows:
        win = win_all[M_max - M :].contiguous()  # the last M rows
        coeffs = mdct_rows(win, tables.cos_table, tables.norm)
        ref = mdct_rows_reference(win, tables.cos_table, tables.norm)
        lib = torch.matmul(win, table_norm)
        sums = band_energy(coeffs, tables.band_mask)
        sums_ref = band_energy_reference(coeffs, tables.band_mask)
        sums_lib = torch.einsum("mk,mk,bk->mb", coeffs, coeffs,
                                tables.band_mask)
        torch.cuda.synchronize()
        if not (torch.equal(coeffs, coeffs_all[M_max - M :])
                and torch.equal(sums, sums_all[M_max - M :])):
            raise AssertionError(f"M={M}: rows differ from the same rows of "
                                 f"the {M_max}-row launch")
        checks = (
            ("mdct_rows", coeffs, ref, lib,
             (win.double() @ table64.T) * tables.norm_value,
             dict(atol=KERNEL_TOL, rtol=KERNEL_TOL)),
            ("band_energy", sums, sums_ref, sums_lib,
             coeffs.double() ** 2 @ mask64.T, dict(atol=0.0, rtol=BAND_RTOL)),
        )
        for name, out, plain, library, exact, tol in checks:
            errs = [(t.double() - exact).abs().max().item()
                    for t in (out, plain, library)]
            diff = (out - plain).abs().max().item()
            torch.testing.assert_close(out, plain, **tol)
            if errs[0] > 2 * errs[1]:
                raise AssertionError(
                    f"{name} M={M}: error vs float64 {errs[0]:.3e} exceeds "
                    f"twice the plain version's {errs[1]:.3e}")
            if name == "mdct_rows":
                args = (win, tables.cos_table, tables.norm)
                fns = (lambda: mdct_rows(*args),
                       lambda: mdct_rows_reference(*args),
                       lambda: torch.matmul(win, table_norm))
                times = [_median_ms(fn) for fn in fns]
                device = [device_ms(fn) for fn in fns]
                bound = mdct_bound(M, n)
                lib_name = "torch.matmul, norm folded into the table"
                extra = (f"; plan {tuple(kernels.mdct_rows_plan(M, n, card_sms()))}"
                         f", 3xTF32 floor {mdct_floor(M, n):.4f} ms (the "
                         f"kernel back to back at "
                         f"{mdct_floor(M, n) / device[0]:.1%} of it)")
            else:
                args = (coeffs, tables.band_mask)
                times = [_median_ms(lambda: band_energy(*args)),
                         _median_ms(lambda: band_energy_reference(*args)),
                         _median_ms(lambda: torch.einsum(
                             "mk,mk,bk->mb", coeffs, coeffs,
                             tables.band_mask))]
                bound = band_bound(M, n, bands)
                lib_name = "torch.einsum of the squares and the mask"
                device = [device_ms(lambda: band_energy(*args)),
                          device_ms(lambda: band_energy_reference(*args)),
                          device_ms(lambda: torch.einsum(
                              "mk,mk,bk->mb", coeffs, coeffs,
                              tables.band_mask))]
                extra = ""
            print(f"[encode kernels] {name} ({designs[name]}) M={M}: "
                  f"max|kernel-plain| {diff:.3e} ({tol}); vs float64: kernel "
                  f"{errs[0]:.3e}, plain {errs[1]:.3e}, library "
                  f"{errs[2]:.3e}; == the rows of the {M_max}-row launch; "
                  f"median of 20: kernel {times[0]:.4f} ms "
                  f"({bound[0] / times[0]:.1%} of the bound), plain "
                  f"{times[1]:.4f} ms, library ({lib_name}) {times[2]:.4f} "
                  f"ms; bound {bound[0]:.4f} ms ({bound[1]})")
            print(f"[encode kernels] {name} M={M} back to back (device time "
                  f"a call, 20 queued, median of 5): kernel {device[0]:.4f} "
                  f"ms ({bound[0] / device[0]:.1%} of the bound), plain "
                  f"{device[1]:.4f} ms, library {device[2]:.4f} ms{extra}")
            result[name][M] = (diff, *times, *bound, *device)
    return result


def phase_kernel(tables, design: str, rows):
    """Kernel against plain at each row count; also the one library call
    that computes the same function (a full-f32 torch.matmul against the
    table with norm x window folded into its columns) and the bound.
    Returns {B: (max|kernel-plain|, ms, plain ms, library ms, bound ms,
    bound by)}."""
    n = tables.n
    rng = np.random.default_rng(1)
    table64 = tables.cos_table.double()
    window64 = tables.window.double()
    folded = tables.cos_table * (tables.norm_value * tables.window)
    result = {}
    for B in rows:
        coeffs = torch.from_numpy(
            (rng.standard_normal((B, n)) * 0.1).astype(np.float32)
        ).cuda()
        args = (coeffs, tables.cos_table, tables.window, tables.norm_value)
        out = imdct_window(*args)
        ref = imdct_window_reference(*args)
        lib = torch.matmul(coeffs, folded)
        torch.cuda.synchronize()
        exact = ((coeffs.double() @ table64) * tables.norm_value) * window64
        err_kernel = (out.double() - exact).abs().max().item()
        err_plain = (ref.double() - exact).abs().max().item()
        err_lib = (lib.double() - exact).abs().max().item()
        diff = (out - ref).abs().max().item()
        torch.testing.assert_close(out, ref, atol=KERNEL_TOL, rtol=KERNEL_TOL)
        if err_kernel > 2 * err_plain:
            raise AssertionError(
                f"kernel error vs float64 {err_kernel:.3e} exceeds twice the "
                f"plain version's {err_plain:.3e}")
        ms = _median_ms(lambda: imdct_window(*args))
        plain_ms = _median_ms(lambda: imdct_window_reference(*args))
        lib_ms = _median_ms(lambda: torch.matmul(coeffs, folded))
        bound_ms, bound_by = kernel_bound(B, n)
        print(f"[kernel] imdct_window ({design}) B={B}: "
              f"max|kernel-plain| {diff:.3e} "
              f"(tol {KERNEL_TOL}); vs float64: kernel {err_kernel:.3e}, "
              f"plain {err_plain:.3e}, library {err_lib:.3e}; median of 20: "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"(torch.matmul, folded table) {lib_ms:.4f} ms; bound "
              f"{bound_ms:.4f} ms ({bound_by})")
        result[B] = (diff, ms, plain_ms, lib_ms, bound_ms, bound_by)
    return result


def make_signal(seconds: int = SECONDS, rate: int = SAMPLE_RATE,
                seed: int = 0, channels: int = 2) -> np.ndarray:
    """Interleaved int16 (stereo by default) from
    numpy.random.default_rng(seed): tones of six harmonics with a decaying
    envelope per 0.5 s note, 5 s of white noise from 60 s (it drives the
    raw-PCM fallback) and 1 s of silence from 120 s."""
    rng = np.random.default_rng(seed)
    T = seconds * rate
    t = np.arange(T) / rate
    note = (t // 0.5).astype(np.int64)
    env = np.exp(-4.0 * (t % 0.5))
    x = np.zeros((T, channels))
    for c in range(channels):
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


def phase_main(pcm: np.ndarray, smi: str):
    cfg = DEFAULT_CONFIG
    main_path(pcm[: CLI_SECONDS * SAMPLE_RATE * 2], "cuda")  # warm-up
    reset_launches()
    encoded, out, t_enc, t_dec = main_path(pcm, "cuda")
    counts = launch_counts()
    launches = counts["imdct_window"]

    F = encoded.frame_set.num_frames
    _T, F_plan, _pad, plan, _need = upload_geometry(len(pcm), 2, cfg)
    chunks = decode_chunks([encoded], cfg.decode_chunk_frames)
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
    if counts["mdct_rows"] != len(plan) or counts["band_energy"] != len(plan):
        raise AssertionError(f"the encode's kernels launched {counts} for "
                             f"{len(plan)} segments")
    audio_s = len(pcm) / 2 / SAMPLE_RATE
    print(f"[main] {audio_s:.0f} s stereo: {F} frames, segments "
          f"{[k for _s, k in plan]}, {raw_frames} raw frames, "
          f"{len(encoded.frame_set.pairs)} pairs; output {len(out)} samples "
          f"== input")
    print(f"[main] encode_pcm16 {t_enc:.3f} s ({audio_s / t_enc:.1f}x "
          f"realtime); decode_i16 {t_dec:.3f} s ({audio_s / t_dec:.1f}x "
          f"realtime); imdct_window launches {launches} == {chunks} chunks; "
          f"mdct_rows and band_energy launches {counts['mdct_rows']}, "
          f"{counts['band_energy']} == {len(plan)} segments")
    walls = encode_walls(pcm, Encoder)
    print(f"[main] encode_pcm16 of {audio_s:.0f} s ({smi}), median of "
          f"{WALL_RUNS} after a warm-up: {np.median(walls) * 1e3:.2f} ms "
          f"(runs {min(walls) * 1e3:.2f}-{max(walls) * 1e3:.2f} ms)")
    return encoded, out, counts


def encode_walls(pcm: np.ndarray, encoder_cls) -> list[float]:
    """WALL_RUNS walls (s) of encode_pcm16 of the stereo `pcm` on the card,
    after a warm-up call."""
    enc = encoder_cls(SAMPLE_RATE, device="cuda")
    enc.encode_pcm16(pcm, 2)
    walls = []
    for _ in range(WALL_RUNS):
        t0 = time.perf_counter()
        enc.encode_pcm16(pcm, 2)
        walls.append(time.perf_counter() - t0)
    return walls


# One process of the encode A/B: the checkout in argv[1] first on the path,
# then this script's signal and timing, copied in (the checkout may be one
# whose package lacks names this script imports).
_AB_CHILD = """
import json, sys, time
import numpy as np
sys.path.insert(0, sys.argv[1])
import glc_tpu_torch
from glc_tpu_torch import Encoder
assert glc_tpu_torch.__file__.startswith(sys.argv[1]), glc_tpu_torch.__file__
SAMPLE_RATE, SECONDS, WALL_RUNS = {rate}, {seconds}, {runs}
{make_signal}
{encode_walls}
print(json.dumps(encode_walls(make_signal(), Encoder)))
"""


def encode_ab(other: Path, smi: str, rounds: int = 2) -> None:
    """encode_pcm16 of the 180 s signal on the card, this checkout against
    the checkout `other` (the parent commit, say), each in its own
    process, `rounds` times in the order other, this, this, other:
    WALL_RUNS walls a process after a warm-up call."""
    child = _AB_CHILD.format(
        rate=SAMPLE_RATE, seconds=SECONDS, runs=WALL_RUNS,
        make_signal=inspect.getsource(make_signal),
        encode_walls=inspect.getsource(encode_walls))
    here = Path(__file__).resolve().parent
    walls = {}
    for root in (other, here, here, other) * rounds:
        proc = subprocess.run([sys.executable, "-c", child, str(root)],
                              cwd=root, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode:
            raise AssertionError(f"encode A/B in {root}:\n{proc.stderr}")
        walls.setdefault(root, []).append(json.loads(proc.stdout.splitlines()[-1]))
    for root, runs in walls.items():
        print(f"[encode A/B] {root} ({smi}): encode_pcm16 of {SECONDS} s, "
              f"medians of {WALL_RUNS} in its {len(runs)} processes "
              + ", ".join(f"{np.median(w) * 1e3:.2f} ms (runs "
                          f"{min(w) * 1e3:.2f}-{max(w) * 1e3:.2f})"
                          for w in runs))


def encode_kernels_ab(smi: str, pairs: int = 21) -> None:
    """In one process, encode_pcm16 of the 180 s signal with the encode's
    kernels against the same encode with mdct_rows and band_energy swapped
    for their plain versions (the parent commit's cuBLAS products),
    `pairs` alternating pairs after a warm-up of each."""
    pcm = make_signal()
    enc = Encoder(SAMPLE_RATE, device="cuda")
    arms = {"kernels": (mdct_ops.mdct_rows, psycho_ops.band_energy),
            "plain": (mdct_rows_reference, band_energy_reference)}

    def wall(arm: str) -> float:
        mdct_ops.mdct_rows, psycho_ops.band_energy = arms[arm]
        try:
            return _wall(lambda: enc.encode_pcm16(pcm, 2))
        finally:
            mdct_ops.mdct_rows, psycho_ops.band_energy = arms["kernels"]

    walls = {arm: [] for arm in arms}
    for arm in arms:
        wall(arm)
    for i in range(pairs):
        for arm in (("kernels", "plain") if i % 2 else ("plain", "kernels")):
            walls[arm].append(wall(arm))
    won = sum(k < p for k, p in zip(walls["kernels"], walls["plain"]))
    print(f"[encode kernels A/B] encode_pcm16 of {SECONDS} s in one process "
          f"({smi}), {pairs} alternating pairs: with the kernels median "
          f"{np.median(walls['kernels']) * 1e3:.2f} ms (quartiles "
          f"{np.percentile(walls['kernels'], 25) * 1e3:.2f}-"
          f"{np.percentile(walls['kernels'], 75) * 1e3:.2f}), with the plain "
          f"versions {np.median(walls['plain']) * 1e3:.2f} ms (quartiles "
          f"{np.percentile(walls['plain'], 25) * 1e3:.2f}-"
          f"{np.percentile(walls['plain'], 75) * 1e3:.2f}); the kernels "
          f"faster in {won} of {pairs} pairs")


# --f64-plans: the hops and row counts at which it times every f64 build
F64_PLAN_NS = (441, 256)
F64_PLAN_ROWS = {"mdct_rows": (8192, 7312, 4096, 2048, 1292, 646, 63, 1),
                 "imdct_window": (2816, 1424, 1000, 646, 63, 1)}


def f64_launch(name: str, x: torch.Tensor, tables, plan) -> torch.Tensor:
    """One launch of `name`'s f64 kernel on rows x with the plan (rows,
    cols) given, through its C entry (the wrappers launch
    kernels.f64_plan's)."""
    lib = kernels.load_library()
    M, n = x.shape[0], tables.n
    stream = torch.cuda.current_stream().cuda_stream
    if name == "mdct_rows":
        out = torch.empty((M, n), device="cuda")
        rc = lib.glc_mdct_rows_f64(
            x.data_ptr(), kernels.f64_table_t(tables.cos_table).data_ptr(),
            tables.norm.data_ptr(), out.data_ptr(), M, n, *plan, stream)
    else:
        out = torch.empty((M, 2 * n), device="cuda")
        rc = lib.glc_imdct_window_f64(
            x.data_ptr(), kernels.f64_table(tables.cos_table).data_ptr(),
            tables.window.data_ptr(), out.data_ptr(), M, n,
            tables.norm_value, *plan, stream)
    if rc:
        raise AssertionError(f"{name} f64 plan {plan}: CUDA error {rc}")
    return out


def f64_plans(smi: str) -> None:
    """Device time (`device_ms`) of every f64 build (kernels.F64_TILES) of
    mdct_rows and imdct_window, a block a tile, at F64_PLAN_ROWS at each n
    of F64_PLAN_NS, each build's output the bits of the wrapper's, beside
    the chooser's pick and
    torch.matmul on float64 copies (cuBLAS DGEMM); then each build's unit
    time fitted over all of them (least squares of time on the model's
    rounds x k16 steps): the measurement behind kernels.F64_UNIT_US."""
    sms = card_sms()
    fit = {tile: ([], []) for tile in kernels.F64_TILES}
    for n in F64_PLAN_NS:
        tables = get_codec_tables(n, 2 * n, SAMPLE_RATE, "cuda")
        for name, rows in F64_PLAN_ROWS.items():
            N, K = (n, 2 * n) if name == "mdct_rows" else (2 * n, n)
            x_all = (seeded_rows(max(rows), 2 * n, 2, tables.window)
                     if name == "mdct_rows" else seeded_rows(max(rows), n, 1))
            wrapper = mdct_rows if name == "mdct_rows" else imdct_window
            rest = ((tables.cos_table, tables.norm) if name == "mdct_rows"
                    else (tables.cos_table, tables.window, tables.norm_value))
            t64 = tables.cos_table.double()
            b64 = t64.T.contiguous() if name == "mdct_rows" else t64
            for M in rows:
                x = x_all[-M:].clone()
                want = wrapper(x, *rest)
                x64 = x.double()
                times = {}
                for tile in kernels.F64_TILES:
                    tiles = kernels.f64_tiles(M, N, *tile)
                    slots = sms * kernels.F64_RESIDENT[tile]
                    if not torch.equal(f64_launch(name, x, tables, tile),
                                       want):
                        raise AssertionError(f"{name} n={n} M={M} build "
                                             f"{tile}: other bits")
                    times[tile] = device_ms(
                        lambda: f64_launch(name, x, tables, tile))
                    steps = -(-tiles // slots) * -(-K // 16)
                    fit[tile][0].append(steps)
                    fit[tile][1].append(times[tile])
                pick = kernels.f64_plan(M, N, K, sms)
                dgemm = device_ms(lambda: torch.matmul(x64, b64))
                bound = mdct_bound(M, n) if name == "mdct_rows" else \
                    kernel_bound(M, n)
                print(f"[f64 plans] {name} n={n} rows={M} ({smi}), back to "
                      f"back ms: " + ", ".join(
                          f"{r}x{c} {t:.4f}"
                          for (r, c), t in times.items())
                      + f"; the chooser's {pick} {times[pick]:.4f} ms "
                      f"({bound[0] / times[pick]:.1%} "
                      f"of the bound {bound[0]:.4f}); the fastest "
                      f"{min(times, key=times.get)}; float64 torch.matmul "
                      f"{dgemm:.4f} ms")
    units = {tile: float(np.dot(x, y) / np.dot(x, x)) * 1e3
             for tile, (x, y) in fit.items()}
    print(f"[f64 plans] ({smi}) unit µs a k16 step of a round, fitted: "
          + ", ".join(f"{tile} {u:.3f}" for tile, u in units.items())
          + f"; kernels.F64_UNIT_US {kernels.F64_UNIT_US}")


def mdct_plans(smi: str) -> None:
    """Device time (`device_ms`) of every mdct_rows tile shape, at the grid
    the chooser would give it, at each row count of the encode paths and
    the tile edges, beside the chooser's pick and one torch.matmul: the
    measurement behind kernels.mdct_rows_plan's model."""
    tables = get_codec_tables(1024, 2048, SAMPLE_RATE, "cuda")
    n = tables.n
    rows = sorted(set(encode_rows(make_signal())) | set(KERNEL_EDGES),
                  reverse=True)
    win_all = seeded_rows(max(rows), 2 * n, 2, tables.window)
    check_mdct_plans(tables, win_all[-PLAN_CHECK_ROWS:].contiguous())
    table_norm = (tables.cos_table * tables.norm).T.contiguous()
    for M in rows:
        win = win_all[-M:].contiguous()
        args = (win, tables.cos_table, tables.norm)
        times = {}
        for rows_, cols in kernels.MDCT_TILES:
            units = kernels.mdct_units(M, n, rows_, cols)[1]
            plan = kernels.MdctPlan(rows_, cols, min(units, card_sms()))
            times[(rows_, cols)] = device_ms(
                lambda: mdct_rows(*args, plan=plan))
        lib = device_ms(lambda: torch.matmul(win, table_norm))
        best = min(times, key=times.get)
        pick = tuple(kernels.mdct_rows_plan(M, n, card_sms()))
        print(f"[mdct plans] M={M} ({smi}), back to back: "
              + ", ".join(f"{r}x{c} {t:.4f}" for (r, c), t in times.items())
              + f" ms; fastest {best[0]}x{best[1]}, chooser {pick} "
              f"{times[pick[:2]]:.4f} ms ({times[pick[:2]] / times[best]:.3f}x "
              f"the fastest); torch.matmul {lib:.4f} ms; 3xTF32 floor "
              f"{mdct_floor(M, n):.4f} ms")
    # the SM clock and power while the largest launch runs for ~2 s
    win = win_all.contiguous()
    plan = kernels.mdct_rows_plan(len(win), n, card_sms())
    smi_log = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader", "-lms", "200"],
        stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 2.0:
            for _ in range(50):
                mdct_rows(win, tables.cos_table, tables.norm, plan=plan)
            torch.cuda.synchronize()
    finally:
        smi_log.terminate()
        samples = smi_log.communicate(timeout=60)[0].split("\n")
    print(f"[mdct plans] clocks.sm, clocks.max.sm, power.draw while "
          f"mdct_rows {tuple(plan)} runs on {len(win)} rows back to back: "
          f"{[s for s in samples if s]}")


# One process of the kernel A/B: the checkout in argv[1] first on the path;
# the rows and the timing copied in from this script.
_KERNEL_AB_CHILD = """
import hashlib, json, sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
import glc_tpu_torch
from glc_tpu_torch.codec.tables import get_codec_tables
from glc_tpu_torch.ops.kernels import band_energy, imdct_window, mdct_rows
assert glc_tpu_torch.__file__.startswith(sys.argv[1]), glc_tpu_torch.__file__
{seeded_rows}
{device_ms}
{median_ms}
out = {{"mdct_rows": {{}}, "imdct_window": {{}}, "band_energy": {{}}}}
for n, enc, dec in {shapes}:
    tables = get_codec_tables(n, 2 * n, {rate}, "cuda")
    win_all = seeded_rows(max(enc), 2 * n, 2, tables.window)
    coeffs_all = seeded_rows(max(enc), n, 3) * 0.5
    for M in enc:
        win = win_all[-M:].clone()  # 16-byte aligned at any n
        args = (win, tables.cos_table, tables.norm)
        y = mdct_rows(*args).cpu().numpy()
        out["mdct_rows"][f"{{n}} {{M}}"] = (
            hashlib.sha256(y.tobytes()).hexdigest(),
            device_ms(lambda: mdct_rows(*args)),
            _median_ms(lambda: mdct_rows(*args)))
        bargs = (coeffs_all[-M:].clone(), tables.band_mask)
        y = band_energy(*bargs).cpu().numpy()
        out["band_energy"][f"{{n}} {{M}}"] = (
            hashlib.sha256(y.tobytes()).hexdigest(),
            device_ms(lambda: band_energy(*bargs)),
            _median_ms(lambda: band_energy(*bargs)))
    for B in dec:
        args = (seeded_rows(B, n, 1), tables.cos_table, tables.window,
                tables.norm_value)
        y = imdct_window(*args).cpu().numpy()
        out["imdct_window"][f"{{n}} {{B}}"] = (
            hashlib.sha256(y.tobytes()).hexdigest(),
            device_ms(lambda: imdct_window(*args)),
            _median_ms(lambda: imdct_window(*args)))
print(json.dumps(out))
"""


def kernel_ab(other: Path, smi: str) -> None:
    """mdct_rows and band_energy at every row count of the encode paths and
    imdct_window at every row count of the decode paths (and the tile
    edges), at the default n; all three at AB_SMALL_ROWS at each n of
    AB_SMALL_NS, and at the cuda tests' row counts (TEST_GEOMETRY_ROWS) at
    each n of theirs that takes the f64 path; on the same seeded rows, in
    this checkout and in `other` (the parent commit's, say), each in its
    own process, in the order other, this, this, other.  The outputs'
    SHA-256 must agree in all four (bit for bit) at every n and row count,
    on either product path (`kernels.product_path`); each process's
    back-to-back device times and single-call times (medians of 20) are
    printed."""
    pcm = make_signal()
    enc = sorted(set(encode_rows(pcm)) | set(KERNEL_EDGES), reverse=True)
    dec = sorted(set(path_rows(pcm)) | set(KERNEL_EDGES), reverse=True)
    f64_ns = {n for n in TEST_GEOMETRY_NS if kernels.product_path(n) == "f64"}
    shapes = [(DEFAULT_CONFIG.n, enc, dec)]
    for n in sorted(set(AB_SMALL_NS) | f64_ns):
        rows = set(TEST_GEOMETRY_ROWS) if n in f64_ns else set()
        shapes.append((n, sorted(rows | set(AB_SMALL_ROWS["encode"]),
                                 reverse=True),
                       sorted(rows | set(AB_SMALL_ROWS["decode"]),
                              reverse=True)))
    child = _KERNEL_AB_CHILD.format(
        seeded_rows=inspect.getsource(seeded_rows),
        device_ms=inspect.getsource(device_ms),
        median_ms=inspect.getsource(_median_ms), rate=SAMPLE_RATE,
        shapes=shapes)
    here = Path(__file__).resolve().parent
    runs = []
    for root in (other, here, here, other):
        proc = subprocess.run([sys.executable, "-c", child, str(root)],
                              cwd=root, capture_output=True, text=True,
                              timeout=900)
        if proc.returncode:
            raise AssertionError(f"kernel A/B in {root}:\n{proc.stderr}")
        runs.append((root, json.loads(proc.stdout.splitlines()[-1])))
    for n, enc_n, dec_n in shapes:
        paths = {"band_energy": "one kernel"}
        for kernel in ("mdct_rows", "imdct_window"):
            paths[kernel] = kernels.product_path(n)
        for kernel, counts in (("mdct_rows", enc_n), ("band_energy", enc_n),
                               ("imdct_window", dec_n)):
            keys = [f"{n} {M}" for M in counts]
            differ = [k for k in keys
                      if len({r[kernel][k][0] for _root, r in runs}) != 1]
            for k in keys:
                print(f"[kernel A/B] {kernel} n={n} rows={k.split()[1]} "
                      f"({smi}; this checkout: {paths[kernel]}), back to "
                      f"back ms " + ", ".join(
                          f"{'this' if root == here else 'other'} "
                          f"{r[kernel][k][1]:.4f}" for root, r in runs)
                      + "; single calls, median of 20, ms " + ", ".join(
                          f"{'this' if root == here else 'other'} "
                          f"{r[kernel][k][2]:.4f}" for root, r in runs)
                      + f"; bits {'differ' if k in differ else 'equal'}")
            if differ:
                raise AssertionError(f"{kernel}: this checkout's bits differ "
                                     f"from {other}'s at (n, rows) {differ}")
            print(f"[kernel A/B] {kernel} n={n}: this checkout and {other} "
                  f"give {'different' if differ else 'the same'} bits at "
                  f"{len(differ) if differ else len(counts)} of {len(counts)} "
                  f"row counts, in 4 processes")
    kernel_ab_pairs(other, smi)


# The shapes at which kernel_ab_pairs times the two checkouts in one
# process: the f64 path's hops at the geometry phase's timed rows
AB_PAIR_NS = (441, 256)
AB_PAIRS = 21


def kernel_ab_pairs(other: Path, smi: str) -> None:
    """mdct_rows (M = 8192) and imdct_window (B = 2816) at each n of
    AB_PAIR_NS in one process, this checkout's wrappers and `other`'s
    (its ops/kernels.py loaded as a module of its own, its library built
    from its csrc/): AB_PAIRS alternating pairs of single calls (each timed
    by CUDA events around the call, the first of a pair alternating), then
    AB_PAIRS alternating pairs of back-to-back times (`device_ms`); prints
    each side's median and the pairs each side won; fails unless the two
    give the same bits."""
    spec = importlib.util.spec_from_file_location(
        "other_kernels", other / "glc_tpu_torch" / "ops" / "kernels.py")
    theirs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(theirs)

    def single(fn) -> float:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop)

    for n in AB_PAIR_NS:
        tables = get_codec_tables(n, 2 * n, SAMPLE_RATE, "cuda")
        M, B = (GEOMETRY_TIMED_ROWS["mdct_rows"],
                GEOMETRY_TIMED_ROWS["imdct_window"])
        cases = {
            "mdct_rows": (seeded_rows(M, 2 * n, 2, tables.window),
                          tables.cos_table, tables.norm),
            "imdct_window": (seeded_rows(B, n, 1), tables.cos_table,
                             tables.window, tables.norm_value)}
        for name, args in cases.items():
            fns = {"this": lambda: getattr(kernels, name)(*args),
                   "other": lambda: getattr(theirs, name)(*args)}
            if not torch.equal(fns["this"](), fns["other"]()):
                raise AssertionError(f"kernel A/B pairs: {name} n={n}: "
                                     f"other bits")
            for how, timer in (("single calls", single),
                               ("back to back", device_ms)):
                for fn in fns.values():  # warm-up
                    for _ in range(3):
                        fn()
                times = {"this": [], "other": []}
                for i in range(AB_PAIRS):
                    order = ("this", "other") if i % 2 else ("other", "this")
                    for side in order:
                        times[side].append(timer(fns[side]))
                won = sum(t < o for t, o in zip(times["this"],
                                                times["other"]))
                print(f"[kernel A/B pairs] {name} n={n} "
                      f"rows={args[0].shape[0]} ({smi}; f64 path), {how}, "
                      f"{AB_PAIRS} alternating "
                      f"pairs in one process: this checkout median "
                      f"{np.median(times['this']):.4f} ms (quartiles "
                      f"{np.percentile(times['this'], 25):.4f}-"
                      f"{np.percentile(times['this'], 75):.4f}), {other} "
                      f"median {np.median(times['other']):.4f} ms (quartiles "
                      f"{np.percentile(times['other'], 25):.4f}-"
                      f"{np.percentile(times['other'], 75):.4f}); this "
                      f"checkout faster in {won} of {AB_PAIRS} pairs; bits "
                      f"equal")


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


def phase_invariance(pcm: np.ndarray, encoded):
    """The 180 s encode_pcm16 on the card at every segment size of
    INVARIANCE_CHUNKS: the same bytes (tests/test_chunking.py:11-32 asks
    it of the JAX package), each segment one launch of each encode
    kernel."""
    want = serialize_encoded(encoded)
    parts = []
    for k in INVARIANCE_CHUNKS:
        cfg = replace(DEFAULT_CONFIG, encode_chunk_frames=k)
        plan = upload_geometry(len(pcm), 2, cfg)[3]
        reset_launches()
        data = serialize_encoded(
            Encoder(SAMPLE_RATE, config=cfg, device="cuda").encode_pcm16(pcm, 2))
        counts = launch_counts()
        if data != want:
            raise AssertionError(f"encode_chunk_frames={k}: the container "
                                 f"differs from the main path's")
        if counts["mdct_rows"] != len(plan) or counts["band_energy"] != len(plan):
            raise AssertionError(f"encode_chunk_frames={k}: launches {counts} "
                                 f"for {len(plan)} segments")
        parts.append(f"{k}: {len(plan)} segments of rows "
                     f"{sorted(set(serial_rows(len(pcm), 2, cfg)), reverse=True)}")
    print(f"[invariance] encode_pcm16 of {len(pcm) // 2 // SAMPLE_RATE} s on "
          f"the card at encode_chunk_frames " + "; ".join(parts) + ": the "
          f"same {len(want)} bytes at every size, one mdct_rows and one "
          f"band_energy launch a segment")


def phase_quality(smi: str):
    """quality_stereo_5s: compat and clean SNR on the card and through the
    port on the CPU, in this run."""
    sig = make_quality_signal(QUALITY_SECONDS)
    snr = {}
    for mode, cfg in (("compat", DEFAULT_CONFIG),
                      ("clean", replace(DEFAULT_CONFIG,
                                        reference_compat=False))):
        for device in ("cuda", "cpu"):
            enc = Encoder(SAMPLE_RATE, config=cfg, device=device)
            dec = Decoder(2, SAMPLE_RATE, config=cfg, device=device)
            snr[mode, device] = quality_metrics(
                sig, dec.decode(enc.encode(sig, 2)))["snr_db"]
        gap = abs(snr[mode, "cuda"] - snr[mode, "cpu"])
        if not np.isfinite(snr[mode, "cuda"]) or gap > QUALITY_TOL_DB:
            raise AssertionError(f"quality {mode}: card {snr[mode, 'cuda']} "
                                 f"dB, CPU {snr[mode, 'cpu']} dB")
    print(f"[quality] quality_stereo_5s (bench.py's signal and SNR) on the "
          f"card ({smi}) vs the port on the CPU: compat "
          f"{snr['compat', 'cuda']:.4f} vs {snr['compat', 'cpu']:.4f} dB, "
          f"clean {snr['clean', 'cuda']:.4f} vs {snr['clean', 'cpu']:.4f} dB "
          f"(within {QUALITY_TOL_DB} dB)")
    return snr


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


def export_flac(dec: Decoder, encoded, parts=None, stats=None) -> bytes:
    """The CLI's default decode (glc_tpu_torch/cli.py decode_file): the int16
    stream at stream_chunk_frames into the streaming FLAC encoder.  With
    `parts`, the stream's chunks are kept there too; `stats` goes to the
    stream's hook."""
    n_total = dec.decoded_length(encoded)

    def stream():
        for part in dec.decode_i16_stream(
                encoded, chunk_frames=dec.config.stream_chunk_frames,
                stats=stats):
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

    chunks = decode_chunks([encoded], cfg.stream_chunk_frames)
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
    return data


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
        chunks = decode_chunks([encoded], cfg.stream_chunk_frames)
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
    want_chunks = decode_chunks([encoded], cfg.decode_chunk_frames)
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
    stream_chunks = decode_chunks(many, cfg.stream_chunk_frames)
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


def hooked_walls(call) -> tuple[float, float, dict]:
    """WALL_RUNS alternating pairs of ``call(None)`` and ``call(stats)``
    (a fresh dict each) after a warm-up of each: the median walls (s)
    unhooked and hooked, and each key's median over the hooked runs."""
    call(None)
    call({})
    plain, hooked, splits = [], [], []
    for r in range(WALL_RUNS):
        for with_stats in (True, False)[:: 1 if r % 2 else -1]:
            st = {} if with_stats else None
            (hooked if with_stats else plain).append(_wall(lambda: call(st)))
            if with_stats:
                splits.append(st)
    return (float(np.median(plain)), float(np.median(hooked)),
            {k: float(np.median([st[k] for st in splits])) for k in splits[0]})


def check_hooked(name: str, got, want, stats: dict, keys, counts: dict,
                 launches: dict, want_launches: dict) -> None:
    """A hooked call against its unhooked output: equal, the JAX package's
    keys, the counts `counts`, the kernels launched as `want_launches`."""
    if isinstance(got, EncodedAudio):
        got = serialize_encoded(got)
    elif isinstance(got, np.ndarray):
        got = [got]
    same = (got == want if isinstance(got, bytes) else
            all(np.array_equal(a, b) for a, b in zip(got, want, strict=True)))
    if not same:
        raise AssertionError(f"{name}: hooked output != unhooked")
    if set(stats) != set(keys):
        raise AssertionError(f"{name}: keys {sorted(stats)}")
    if {k: stats[k] for k in counts} != counts:
        raise AssertionError(f"{name}: counts {stats}, the geometry says "
                             f"{counts}")
    if launches != want_launches:
        raise AssertionError(f"{name}: launches {launches}, want "
                             f"{want_launches}")


def api_chunk_programs(pcm: np.ndarray, encoded, out) -> str:
    """encode_chunk_device on the 180 s signal's first segment, and
    decode_chunk_device on the main path's first decode chunk, on the card:
    bit for bit the Encoder's and the Decoder's; the encode within the pair
    contract of the CPU port's.  One launch each of the path's kernels."""
    cfg = DEFAULT_CONFIG
    n, frame_size = cfg.n, cfg.frame_size
    fs = encoded.frame_set
    _T, F, _pad, plan, need = upload_geometry(len(pcm), 2, cfg)
    start, k = plan[0]
    valid = min(k, F - start)
    x = planarize(torch.from_numpy(pcm).cuda(), 2, cfg.hop_size // 2, n,
                  need).to(torch.float32) / 32768.0
    blocks = frames_from_signal(x[:, start * n : (start + valid + 1) * n], n)
    tabs = get_device_tables(n, frame_size, SAMPLE_RATE, "cuda")
    reset_launches()
    enc_out = encode_chunk_device(blocks, *tabs)
    torch.cuda.synchronize()
    enc_launches = launch_counts()
    q, nnz, scale, raw, use_raw = (t.cpu().numpy() for t in enc_out)
    if enc_launches != {"imdct_window": 0, "mdct_rows": 1, "band_energy": 1}:
        raise AssertionError(f"encode_chunk_device launched {enc_launches}")
    # the Encoder's segment as the container holds it: raw frames' q and
    # nnz zeroed and no scales stored for them, pairs in stream order, raw
    # rows channel-major (encoder.py)
    q = np.where(use_raw[:, None, None], 0, q).reshape(-1, n)
    nnz = np.where(use_raw[:, None], 0, nnz)
    rows, kk = np.nonzero(q)
    P = int(fs.nnz[:valid].sum())
    raw_rows = raw[use_raw].reshape(-1, 2 * frame_size)
    coded = ~use_raw
    checks = {
        "use_raw": np.array_equal(use_raw, fs.raw_mask[:valid]),
        "scales": np.array_equal(scale[coded].view(np.int32),
                                 fs.scales[:valid][coded].view(np.int32)),
        "nnz": np.array_equal(nnz, fs.nnz[:valid]),
        "pair k": np.array_equal(kk, fs.pairs["k"][:P]),
        "pair q": np.array_equal(q[rows, kk], fs.pairs["q"][:P]),
        "raw rows": np.array_equal(raw_rows, fs.raw_pcm[: len(raw_rows)]),
    }
    if not all(checks.values()):
        raise AssertionError(f"encode_chunk_device != the Encoder's first "
                             f"segment on the card: {checks}")
    cpu = encode_chunk_device(blocks.cpu(), *get_device_tables(
        n, frame_size, SAMPLE_RATE, "cpu"))
    q_cpu, use_raw_cpu = cpu[0].numpy(), cpu[4].numpy()
    q_card = enc_out[0].cpu().numpy()
    flips = dense_pair_flips(q_card, q_cpu)
    if (not np.array_equal(use_raw_cpu, enc_out[4].cpu().numpy())
            or flips["max_dq"] > 1 or flips["rate"] > MAX_FLIP_RATE):
        raise AssertionError(f"encode_chunk_device card vs CPU: {flips}")

    chunk = chunk_size_for(F, cfg.decode_chunk_frames)
    dvalid = min(chunk, F)
    pos, vals = chunk_pairs(fs, 0, dvalid, 0, n)
    qd = np.zeros(dvalid * 2 * n, np.int16)
    qd[pos] = vals
    is_raw = fs.raw_mask[:dvalid]
    ridx = np.flatnonzero(is_raw)
    stored = fs.raw_pcm[: len(ridx)]
    raw_dense = np.zeros((dvalid, 2, frame_size), np.int16)
    raw_dense[ridx] = (stored.reshape(-1, frame_size, 2).transpose(0, 2, 1)
                       if cfg.reference_compat  # channel-major (Q13)
                       else stored.reshape(-1, 2, frame_size))
    dec = Decoder(2, SAMPLE_RATE, device="cuda")
    reset_launches()
    hops, _carry = decode_chunk_device(
        qd.reshape(dvalid, 2, n), fs.scales[:dvalid], raw_dense, is_raw,
        np.zeros((2, n), np.float32), dvalid, *tabs[:3], max_q=cfg.max_q,
        window_raw=not cfg.reference_compat)
    torch.cuda.synchronize()
    dec_launches = launch_counts()
    if dec_launches != {"imdct_window": 1, "mdct_rows": 0, "band_energy": 0}:
        raise AssertionError(f"decode_chunk_device launched {dec_launches}")
    _valid, want = next(dec._chunks(encoded, chunk))
    flat = to_i16(hops).transpose(1, 2).reshape(-1).cpu().numpy()
    skip = gapless_trim_bounds((F + 1) * n * 2, encoded.gapless_info, 2,
                               cfg.reference_compat)[0]
    if not torch.equal(hops, want) or not np.array_equal(
            flat[skip:], out[: len(flat) - skip]):
        raise AssertionError("decode_chunk_device != decode_i16's first "
                             "chunk on the card")
    return (f"encode_chunk_device on segment 0 ({valid} frames, "
            f"{2 * valid} rows; launches {enc_launches}): "
            f"{', '.join(checks)} == the Encoder's segment bit for bit, "
            f"{P} pairs, {int(use_raw.sum())} raw frames; card vs CPU "
            f"{flips['gate']} keep-gate and {flips['pm1']} +-1 flips of "
            f"{flips['kept']} (rate {flips['rate']:.5%}); "
            f"decode_chunk_device on chunk 0 ({dvalid} frames, {2 * dvalid} "
            f"rows; launches {dec_launches}): hops == decode_i16's bit for "
            f"bit, int16 == its output")


def phase_api(pcm: np.ndarray, encoded, out, flac: bytes, many, outs,
              smi: str) -> dict:
    """The JAX package's public API on the port, on the card: the chunk
    programs (`api_chunk_programs`), then the `stats=` hooks of the 180 s
    encode_pcm16, decode_i16 and FLAC export and of the 4 x 120 s
    decode_many: output equal to the unhooked call's, keys and counts as
    tests/test_torch_api.py pins them, the kernels' launches; and each
    call's wall beside the hook's split (medians of WALL_RUNS alternating
    pairs).  Returns {call: (wall unhooked, wall hooked, split)}."""
    cfg = DEFAULT_CONFIG
    print(f"[api] {api_chunk_programs(pcm, encoded, out)}")
    enc = Encoder(SAMPLE_RATE, device="cuda")
    dec = Decoder(2, SAMPLE_RATE, device="cuda")
    segments = len(upload_geometry(len(pcm), 2, cfg)[3])
    chunks = chunks_of(encoded, cfg.decode_chunk_frames)
    stream_chunks = chunks_of(encoded, cfg.stream_chunk_frames)
    album_chunks = sum(chunks_of(ea, cfg.decode_chunk_frames) for ea in many)
    calls = {
        "encode_pcm16": (
            lambda st: enc.encode_pcm16(pcm, 2, stats=st),
            serialize_encoded(encoded), ENCODE_KEYS,
            {"up_n": 1, "down_n": encode_down_n(encoded, cfg)},
            {"imdct_window": 0, "mdct_rows": segments,
             "band_energy": segments}),
        "decode_i16": (
            lambda st: dec.decode_i16(encoded, stats=st), [out],
            DECODE_KEYS,
            {"up_n": UPLOADS_PER_CHUNK * chunks, "down_n": chunks},
            {"imdct_window": chunks, "mdct_rows": 0, "band_energy": 0}),
        "export": (
            lambda st: export_flac(dec, encoded, stats=st), flac, DECODE_KEYS,
            {"up_n": UPLOADS_PER_CHUNK * stream_chunks,
             "down_n": stream_chunks},
            {"imdct_window": stream_chunks, "mdct_rows": 0,
             "band_energy": 0}),
        "decode_many": (
            lambda st: dec.decode_many(many, stats=st), outs, DECODE_KEYS,
            {"up_n": UPLOADS_PER_CHUNK * album_chunks,
             "down_n": album_chunks},
            {"imdct_window": album_chunks, "mdct_rows": 0,
             "band_energy": 0}),
    }
    result = {}
    for name, (call, want, keys, counts, want_launches) in calls.items():
        stats: dict = {}
        reset_launches()
        got = call(stats)
        torch.cuda.synchronize()
        check_hooked(name, got, want, stats, keys, counts, launch_counts(),
                     want_launches)
        t_plain, t_hooked, split = hooked_walls(call)
        result[name] = (t_plain, t_hooked, split)
        stages = ", ".join(f"{k} {v:.3f}" for k, v in split.items()
                           if k.endswith("_ms"))
        print(f"[api] {name} ({smi}), medians of {WALL_RUNS} alternating "
              f"pairs: wall {t_plain * 1e3:.2f} ms unhooked, "
              f"{t_hooked * 1e3:.2f} ms hooked; split {stages} ms; "
              f"{counts} == the geometry's; output == unhooked; launches "
              f"{want_launches}")
    return result


def untrimmed(path: Path) -> np.ndarray:
    """A .glc file's decode_streaming chunks on the card, joined."""
    ea = load_encoded(path)
    rx = Decoder(ea.header.channels, ea.header.sample_rate,
                 device="cuda").decode_streaming(ea)
    parts = []
    while True:
        c = rx.get(timeout=300)
        if c.error is not None:
            raise AssertionError(f"decode_streaming failed: {c.error}")
        parts.append(c.samples)
        if c.is_last:
            return np.concatenate(parts)


def play(paths, stop=None, sink_cls=CaptureSink):
    """playback.play_files_gapless of `paths` on the card into `sink_cls`
    sinks, its printed lines kept; returns (sinks, seconds from the call to
    the first append, to the last, kernel launches, printed lines)."""
    log: list = []
    printed = io.StringIO()
    imdct_window.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        playback.play_files_gapless(
            paths, lambda r, c: sink_cls(r, c, log), stop=stop,
            device="cuda")
    launches = imdct_window.launches
    first = min(s.times[0] for s in log if s.times) - t0
    last = max(s.times[-1] for s in log if s.times) - t0
    return log, first, last, launches, printed.getvalue().splitlines()


def producers() -> list:
    return [t for t in threading.enumerate()
            if t.name == PRODUCER_NAME and t.is_alive()]


def phase_playback(many, outs, smi: str):
    """Gapless playback of the 120 s album's .glc files: the stream, the
    per-track trims, a format change, a stop, `glc -p` against a stub
    ffplay, and the time to the first append and the feed rate."""
    cfg = DEFAULT_CONFIG
    n = cfg.n
    chunks = decode_chunks(many, cfg.decode_chunk_frames)
    audio_s = sum(len(o) for o in outs) / 2 / SAMPLE_RATE
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        paths = []
        for i, ea in enumerate(many):
            paths.append(tmp / f"track{i}.glc")
            save_encoded(ea, paths[-1])
        want = np.concatenate([untrimmed(p) for p in paths])

        # 1. one sink, the tracks' streams back to back, bit for bit
        log, first, last, launches, printed = play(paths)
        if len(log) != 1 or not log[0].closed:
            raise AssertionError(f"{len(log)} sinks for one format")
        stream = log[0].stream()
        if not np.array_equal(stream, want):
            raise AssertionError("played stream != the tracks' "
                                 "decode_streaming chunks")
        if launches != chunks or printed[-1] != "Playback finished":
            raise AssertionError(f"playback launched imdct_window {launches} "
                                 f"times for {chunks} chunks; last line "
                                 f"{printed[-1]!r}")
        o, errs, lsbs = 0, [], []
        for ea, out in zip(many, outs, strict=True):
            length = (ea.frame_set.num_frames + 1) * n * 2
            skip, limit = gapless_trim_bounds(length, ea.gapless_info, 2,
                                              cfg.reference_compat)
            part = stream[o + skip : o + skip + limit]
            o += length
            f32 = Decoder(2, SAMPLE_RATE, device="cuda").decode(ea)
            errs.append(float(np.abs(part - f32).max()))
            lsbs.append(int(np.abs(convert_f32_to_i16(part).astype(np.int32)
                                   - out.astype(np.int32)).max()))
            if len(part) != len(f32) or errs[-1] > STREAM_TOL or lsbs[-1] > 1:
                raise AssertionError(f"a trimmed track: {errs[-1]} vs decode, "
                                     f"{lsbs[-1]} LSB vs decode_i16")
        if o != len(stream):
            raise AssertionError("the stream is not the tracks' streams")
        print(f"[playback] play_files_gapless of {len(paths)} x "
              f"{ALBUM_SECONDS[1]} s: one "
              f"sink, stream == the tracks' decode_streaming chunks bit for "
              f"bit; trimmed tracks vs decode max {max(errs):.1e} (tol "
              f"{STREAM_TOL}), vs decode_i16 max {max(lsbs)} LSB; "
              f"imdct_window launches {launches} == {chunks} chunks")

        firsts, feeds = [first], [audio_s / last]
        for _ in range(FEED_RUNS):
            log, first, last, _launches, _printed = play(paths)
            if len(log[0].stream()) != len(want):
                raise AssertionError("a timed playback lost samples")
            firsts.append(first)
            feeds.append(audio_s / last)
        print(f"[playback] {smi}: time to the first sink append, median of "
              f"{FEED_RUNS}: {np.median(firsts[1:]) * 1e3:.2f} ms "
              f"(runs {', '.join(f'{t * 1e3:.2f}' for t in firsts[1:])}; the "
              f"checked first call {firsts[0] * 1e3:.2f} ms)")
        print(f"[playback] {smi}: feed rate on the {audio_s:.0f} s playlist "
              f"(audio seconds / wall seconds to the last append), median "
              f"of {FEED_RUNS}: {np.median(feeds[1:]):.1f}x realtime (runs "
              f"{', '.join(f'{f:.1f}' for f in feeds[1:])}; the checked "
              f"first call {feeds[0]:.1f}x)")

        # 2. a mono track appended: the sink restarts once
        mono = make_signal(MONO_SECONDS, seed=ALBUM_TRACKS + 1, channels=1)
        mono_ea = Encoder(SAMPLE_RATE, device="cuda").encode_pcm16(mono, 1)
        mono_path = tmp / "mono.glc"
        save_encoded(mono_ea, mono_path)
        mono_chunks = decode_chunks([mono_ea], cfg.decode_chunk_frames)
        log, _f, _l, launches, _p = play(paths + [mono_path])
        formats = [(s.sample_rate, s.channels, s.closed) for s in log]
        if formats != [(SAMPLE_RATE, 2, True), (SAMPLE_RATE, 1, True)]:
            raise AssertionError(f"sinks {formats}")
        if not (np.array_equal(log[0].stream(), want)
                and np.array_equal(log[1].stream(), untrimmed(mono_path))):
            raise AssertionError("a format change altered the stream")
        if launches != chunks + mono_chunks:
            raise AssertionError(f"{launches} launches for "
                                 f"{chunks} + {mono_chunks} chunks")
        print(f"[playback] + a mono {MONO_SECONDS} s track: the sink "
              f"restarted once ({formats[0][:2]} -> {formats[1][:2]}), both "
              f"streams bit for bit; imdct_window launches {launches} == "
              f"{chunks} + {mono_chunks} chunks (the mono one at "
              f"{mono_ea.frame_set.num_frames} rows)")

        # 3. a stop after the first chunk
        stop = threading.Event()

        class StopSink(CaptureSink):
            def append(self, source):
                ok = super().append(source)
                stop.set()
                return ok

        t0 = time.perf_counter()
        log, _f, _l, _launches, _p = play(paths, stop=stop,
                                          sink_cls=StopSink)
        written = sum(len(s.parts) for s in log)
        while producers() and time.perf_counter() - t0 < 5:
            time.sleep(0.01)
        left = producers()
        t_stop = time.perf_counter() - t0
        torch.cuda.synchronize()
        if written != 1 or left:
            raise AssertionError(f"stop: {written} chunks written, "
                                 f"{len(left)} producers alive")
        print(f"[playback] a sink that stops after its first chunk: 1 chunk "
              f"written, no producer thread alive {t_stop:.3f} s after the "
              f"call began, torch.cuda.synchronize() passes")

        # 4. glc -p and glc -p --ffplay against a stub ffplay
        phase_play_cli(tmp, paths, want, chunks)


def phase_play_cli(tmp: Path, paths, want: np.ndarray, chunks: int):
    """cli.main(["-p", ...]) and (["-p", "--ffplay", ...]) with an `ffplay`
    first on PATH that appends its stdin to a file, and the audio device
    probe off: the file holds the played stream as f32le."""
    stub_dir = tmp / "bin"
    stub_dir.mkdir()
    stub = stub_dir / "ffplay"
    stub.write_text('#!/bin/sh\ncat >> "$GLC_SMOKE_FFPLAY_OUT"\n')
    stub.chmod(0o755)
    sink_file = tmp / "ffplay.f32"
    saved_env = {k: os.environ.get(k)
                 for k in ("PATH", "GLC_SMOKE_FFPLAY_OUT")}
    probe = playback._probe_device_backend
    os.environ["PATH"] = f"{stub_dir}{os.pathsep}{os.environ.get('PATH', '')}"
    os.environ["GLC_SMOKE_FFPLAY_OUT"] = str(sink_file)
    playback._probe_device_backend = lambda: None
    try:
        for flags in ([], ["--ffplay"]):
            printed = io.StringIO()
            imdct_window.launches = 0
            with contextlib.redirect_stdout(printed):
                rc = cli.main(["-p", *flags, *map(str, paths)])
            launches = imdct_window.launches
            got = np.fromfile(sink_file, "<f4")
            sink_file.unlink()
            lines = printed.getvalue().splitlines()
            if rc != 0 or lines[-1] != "Playback finished":
                raise AssertionError(f"glc -p {flags}: exit code {rc}, last "
                                     f"line {lines[-1]!r}")
            if not np.array_equal(got, want):
                raise AssertionError(f"glc -p {flags}: the stub's bytes != "
                                     f"the played stream")
            if launches != chunks:
                raise AssertionError(f"glc -p {flags}: {launches} launches "
                                     f"for {chunks} chunks")
            print(f"[playback] cli.main(['-p', {', '.join(map(repr, flags))}"
                  f"{', ' if flags else ''}<{len(paths)} files>]): exit code "
                  f"0, the stub ffplay got {got.nbytes} bytes == the played "
                  f"stream as f32le; imdct_window launches {launches}")
    finally:
        playback._probe_device_backend = probe
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_controller(short_items, short_many):
    """CodecController on the card over two WAVs of the 15 s album:
    encode_selected, play_gapless, export_playlist."""
    cfg = DEFAULT_CONFIG
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        wavs = []
        for i, (x, c) in enumerate(short_items[:2]):
            wavs.append(tmp / f"ctl{i}.wav")
            write_wav_i16(wavs[-1], x, SAMPLE_RATE, c)
        log: list = []
        ctl = CodecController(
            sink_factory=lambda r, c: CaptureSink(r, c, log), device="cuda")
        ctl.add_files(wavs)
        ctl.encode_selected(wait=True)
        snap = ctl.snapshot()
        glcs = [w.with_suffix(".glc") for w in wavs]
        if snap.status != "Encoded 2/2" or snap.encoded_files != glcs:
            raise AssertionError(f"encode_selected: {snap}")
        for g, ea in zip(glcs, short_many, strict=False):
            if serialize_encoded(load_encoded(g)) != serialize_encoded(ea):
                raise AssertionError(f"{g.name} != encode_pcm16")

        ctl.add_to_playlist([0, 1])
        imdct_window.launches = 0
        ctl.play_gapless(wait=True)
        play_launches = imdct_window.launches
        snap = ctl.snapshot()
        eas = [load_encoded(g) for g in glcs]
        want_play = decode_chunks(eas, cfg.decode_chunk_frames)
        if snap.status != "Playback finished" or len(log) != 1:
            raise AssertionError(f"play_gapless: {snap.status}, "
                                 f"{len(log)} sinks")
        if not np.array_equal(log[0].stream(),
                              np.concatenate([untrimmed(g) for g in glcs])):
            raise AssertionError("play_gapless stream != decode_streaming")
        if play_launches != want_play:
            raise AssertionError(f"play_gapless: {play_launches} launches "
                                 f"for {want_play} chunks")

        imdct_window.launches = 0
        ctl.export_playlist(tmp / "ctl.flac", FLAC_LEVEL, wait=True)
        exp_launches = imdct_window.launches
        want_exp = decode_chunks(eas, cfg.stream_chunk_frames)
        if ctl.snapshot().status != "Export complete":
            raise AssertionError(f"export_playlist: {ctl.snapshot()}")
        album.export_playlist_to_flac(glcs, tmp / "ref.flac", FLAC_LEVEL,
                                      device="cuda")
        if (tmp / "ctl.flac").read_bytes() != (tmp / "ref.flac").read_bytes():
            raise AssertionError("export_playlist != export_playlist_to_flac")
        if exp_launches != want_exp:
            raise AssertionError(f"export_playlist: {exp_launches} launches "
                                 f"for {want_exp} chunks")
    print(f"[controller] on 2 x {ALBUM_SECONDS[0]} s WAVs: encode_selected "
          f"== encode_pcm16 bytes; play_gapless 'Playback finished', stream "
          f"== decode_streaming, imdct_window launches {play_launches}; "
          f"export_playlist == album.export_playlist_to_flac bytes, "
          f"imdct_window launches {exp_launches}")


def phase_profile(encoded, out):
    """GLC_PROFILE around two decode_i16 calls of the 180 s container: each
    torch.profiler trace holds the decode_i16 span and one imdct_window
    kernel event a chunk; the walls say what tracing costs (the first call
    also starts CUPTI)."""
    cfg = DEFAULT_CONFIG
    dec = Decoder(2, SAMPLE_RATE, device="cuda")
    chunks = decode_chunks([encoded], cfg.decode_chunk_frames)
    walls, found = [], []
    with tempfile.TemporaryDirectory() as tmp:
        traces = Path(tmp) / "decode_i16"
        os.environ["GLC_PROFILE"] = tmp
        try:
            for _ in range(2):
                imdct_window.launches = 0
                t0 = time.perf_counter()
                got = dec.decode_i16(encoded)
                walls.append(time.perf_counter() - t0)
                launches = imdct_window.launches
                if not np.array_equal(got, out) or launches != chunks:
                    raise AssertionError(f"traced decode_i16: {launches} "
                                         f"launches for {chunks} chunks, or "
                                         f"output != untraced")
                new = [f for f in traces.glob("*.pt.trace.json")
                       if f not in {g for g, _e, _s in found}]
                if len(new) != 1:
                    raise AssertionError(f"GLC_PROFILE wrote {len(new)} "
                                         f"traces for one call")
                found.append((new[0], json.loads(new[0].read_text())[
                    "traceEvents"], new[0].stat().st_size))
        finally:
            os.environ.pop("GLC_PROFILE")
    t_plain = float(np.median([_wall(lambda: dec.decode_i16(encoded))
                               for _ in range(5)]))
    for _f, events, _size in found:
        spans = [e for e in events if e.get("name") == "decode_i16"]
        kernel_events = [e for e in events if e.get("cat") == "kernel"]
        ours = [e for e in kernel_events
                if "imdct_window" in e.get("name", "")]
        if not spans or len(ours) != chunks:
            cats = sorted({str(e.get("cat")) for e in events})
            raise AssertionError(
                f"trace: {len(spans)} decode_i16 spans, {len(ours)} "
                f"imdct_window kernel events of {len(kernel_events)} kernel "
                f"events, for {chunks} chunks; categories {cats}")
    print(f"[profile] GLC_PROFILE around decode_i16 of 180 s, twice: each "
          f"trace ({', '.join(str(sz) for _f, _e, sz in found)} bytes) holds "
          f"the decode_i16 span and {chunks} imdct_window kernel events == "
          f"{chunks} chunks; output == untraced; wall traced "
          f"{walls[0]:.3f} s (first, CUPTI starts) and {walls[1]:.3f} s, "
          f"untraced {t_plain:.4f} s (median of 5)")


def phase_play_profile(many, smi: str):
    """One play_files_gapless of the 480 s album under profiling.trace:
    the device's busy time and idle share inside the call's span."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        paths = []
        for i, ea in enumerate(many):
            paths.append(tmp / f"track{i}.glc")
            save_encoded(ea, paths[-1])
        log: list = []
        traces = tmp / "trace"
        with profiling.trace(str(traces)), contextlib.redirect_stdout(
                io.StringIO()):
            with profiling.annotate("play_files_gapless"):
                playback.play_files_gapless(
                    paths, lambda r, c: CaptureSink(r, c, log),
                    device="cuda")
        (trace,) = traces.glob("*.pt.trace.json")
        events = json.loads(trace.read_text())["traceEvents"]
    (span,) = [e for e in events if e.get("name") == "play_files_gapless"
               and e.get("cat") == "user_annotation"]
    t0, t1 = span["ts"], span["ts"] + span["dur"]
    busy = device_busy_ms(events, t0, t1)
    kernels_ms = device_busy_ms(
        [e for e in events if e.get("cat") == "kernel"
         and "imdct_window" in e.get("name", "")], t0, t1)
    print(f"[profile] play_files_gapless of the 480 s album under "
          f"profiling.trace ({smi}): span {span['dur'] / 1e3:.2f} ms, device "
          f"busy {busy:.3f} ms (imdct_window {kernels_ms:.3f} ms), idle "
          f"share {1 - busy / (span['dur'] / 1e3):.4f}")


def phase_bench(smi: str) -> dict:
    """`python3 -m glc_tpu_torch.bench --quick` in a child process, from
    this checkout: exit code 0, and its last line the flagship metric line
    with "correct": true, which is printed here.  Returns that line."""
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "glc_tpu_torch.bench", "--quick"], cwd=root,
        capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    secs = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    if proc.returncode or not lines:
        raise AssertionError(f"bench --quick: exit code {proc.returncode}\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    last = json.loads(lines[-1])
    if (last.get("metric") != "encode_realtime_factor_44k_stereo"
            or last.get("correct") is not True
            or len(lines[-1]) >= 1500):
        raise AssertionError(f"bench --quick's last line: {lines[-1]}")
    print(f"[bench] python3 -m glc_tpu_torch.bench --quick ({smi}): exit "
          f"code 0 in {secs:.1f} s, {len(lines)} lines; its last line "
          f"({len(lines[-1])} characters, correct: true):")
    print(lines[-1])
    return last


def album_f32(pcm: np.ndarray) -> np.ndarray:
    """An int16 album track as f32, i16 / 2^15: what encode_pcm16 divides
    by on the device."""
    return pcm.astype(np.float32) / np.float32(32768.0)


def serial_rows(samples: int, channels: int = 2,
                cfg=DEFAULT_CONFIG) -> list[int]:
    """The MDCT row counts of the serial encode of a track of `samples`
    interleaved samples: each segment's frames x channels."""
    _T, F, _pad, plan, _need = upload_geometry(samples, channels, cfg)
    return [channels * min(k, F - start) for start, k in plan]


def check_sharded_album(inputs: Path, seconds: int, encs, outs,
                        tracks) -> dict:
    """The sharded album results of one album against the serial ones in
    `inputs`: each container equal to the serial encode's bytes, or else
    within the pair contract; each decode within rtol 2e-6, atol 1e-7 of
    the serial decode (tests/test_album_sharded.py:59), of the original
    length.  Returns the counts and errors it found."""
    equal, flips, errs, bit_equal, first = 0, [], [], True, None
    for i, (ea, x, o) in enumerate(zip(encs, tracks, outs, strict=True)):
        want = (inputs / f"album{seconds}_{i}.glc").read_bytes()
        if serialize_encoded(ea) == want:
            equal += 1
        else:
            serial = deserialize_encoded(want)
            flips.append(check_containers(ea, serial))
            if first is None:
                first = (i, *first_divergence(ea.frame_set,
                                              serial.frame_set))
        ref = np.load(inputs / f"decoded{seconds}_{i}.npy")
        if len(o) != len(x) or len(ref) != len(x):
            raise AssertionError(f"{seconds} s track {i}: sharded decode "
                                 f"{len(o)} samples, serial {len(ref)}, "
                                 f"original {len(x)}")
        np.testing.assert_allclose(o, ref, rtol=2e-6, atol=1e-7)
        errs.append(float(np.abs(o - ref).max()))
        bit_equal = bit_equal and np.array_equal(o, ref)
    return {"equal": equal, "flips": flips, "max_err": max(errs),
            "bit_equal": bit_equal, "first": first}


def first_divergence(fa, fb, n: int = 1024) -> tuple:
    """Where two FrameSets of one shape first differ: the first
    (frame, channel, k, q_a, q_b) whose dense q differs, or None, and the
    number of (frame, channel) scales that differ."""
    F, C = fa.nnz.shape
    dense = []
    for fs in (fa, fb):
        rows = np.repeat(np.arange(F * C), fs.nnz.reshape(-1))
        d = np.zeros(F * C * n, np.int32)
        d[rows * n + fs.pairs["k"].astype(np.int64)] = fs.pairs["q"]
        dense.append(d)
    diff = np.flatnonzero(dense[0] != dense[1])
    pair = None
    if len(diff):
        j = int(diff[0])
        pair = (j // (C * n), j // n % C, j % n, int(dense[0][j]),
                int(dense[1][j]))
    return pair, int(np.count_nonzero(fa.scales != fb.scales))


def sharded_rank_run(inputs: Path) -> dict:
    """The sharded phase on one rank: a warm-up of the album calls on the
    4 x 15 s album, then the checked and timed run (encode_album_sharded
    and decode_album_sharded of each album, the round trips) with the
    kernel's launches counted from 0 and their rows recorded.  Rank 0
    also checks the albums against the serial results in `inputs`."""
    rank, ranks = dist.get_rank(), dist.get_world_size()
    mesh = parallel.make_mesh(ranks, device_type="cuda")
    d, f = mesh.shape
    tables = get_codec_tables(1024, 2048, SAMPLE_RATE, "cuda")
    tracks = {s: [album_f32(np.load(inputs / f"album{s}_{i}.npy"))
                  for i in range(ALBUM_TRACKS)] for s in ALBUM_SECONDS}
    serial = {s: [deserialize_encoded((inputs / f"album{s}_{i}.glc")
                                      .read_bytes())
                  for i in range(ALBUM_TRACKS)] for s in ALBUM_SECONDS}
    warm = ALBUM_SECONDS[0]
    parallel.encode_album_sharded(mesh, tracks[warm], 2, SAMPLE_RATE)
    parallel.decode_album_sharded(mesh, serial[warm])
    rows: dict = {name: [] for name in KERNEL_NAMES}
    record_launch_rows(lambda name, m, _n: rows[name].append(m))
    reset_launches()
    res = {"mesh": tuple(mesh.shape),
           "device": str(torch.cuda.current_device())}
    digest = hashlib.sha256()
    for s in ALBUM_SECONDS:
        dist.barrier()
        t0 = time.perf_counter()
        encs = parallel.encode_album_sharded(mesh, tracks[s], 2, SAMPLE_RATE)
        t_enc = time.perf_counter() - t0
        dist.barrier()
        t0 = time.perf_counter()
        outs = parallel.decode_album_sharded(mesh, serial[s])
        t_dec = time.perf_counter() - t0
        for ea in encs:
            digest.update(serialize_encoded(ea))
        for o in outs:
            digest.update(o.tobytes())
        res[s] = {"t_enc": t_enc, "t_dec": t_dec}
        if rank == 0:
            res[s].update(check_sharded_album(inputs, s, encs, outs,
                                              tracks[s]))
    for B, K in ((2 * d, 2 * f), ROUNDTRIP_COMMON):
        blocks = np.random.default_rng(0).standard_normal(
            (B, K, 1, 2048)).astype(np.float32) * 0.1
        mse, hops = parallel.roundtrip_step_sharded(
            mesh, blocks, np.zeros((B, 1, 1024), np.float32), tables)
        if not np.isfinite(float(mse)) or tuple(hops.shape) != (B, K, 1, 1024):
            raise AssertionError(f"round trip ({B}, {K}): mse {float(mse)}, "
                                 f"hops {tuple(hops.shape)}")
        res[(B, K)] = float(mse)
        digest.update(hops.cpu().numpy().tobytes())
    res.update(launches=launch_counts(), rows=rows, digest=digest.hexdigest())
    return res


def _sharded_rank(rank: int, backend: str, ranks: int, inputs: str,
                  workdir: str) -> None:
    """One spawned rank of a sharded-phase world: its results go to
    rank<r>.pkl in `workdir`, a failure's traceback to rank<r>.err."""
    out = Path(workdir)
    try:
        torch.cuda.set_device(0)
        dist.init_process_group(
            backend, store=dist.FileStore(str(out / "store"), ranks),
            rank=rank, world_size=ranks,
            timeout=datetime.timedelta(seconds=120))
        try:
            res = sharded_rank_run(Path(inputs))
        finally:
            dist.destroy_process_group()
        (out / f"rank{rank}.pkl").write_bytes(pickle.dumps(res))
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def run_world(backend: str, ranks: int, inputs: Path, workdir: Path):
    """Spawn a world's ranks, wait for them (SHARDED_TIMEOUT_S in all) and
    return each rank's results; a rank that fails or hangs fails the run,
    and no rank outlives the call."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_sharded_rank,
                         args=(r, backend, ranks, str(inputs), str(workdir)))
             for r in range(ranks)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + SHARDED_TIMEOUT_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    errs = {f.name: f.read_text() for f in sorted(workdir.glob("*.err"))}
    codes = [p.exitcode for p in procs]
    if hung or errs or any(codes):
        raise AssertionError(
            f"{backend} world of {ranks}: hung ranks {hung}, exit codes "
            f"{codes}\n" + "\n".join(f"{k}:\n{v}" for k, v in errs.items()))
    return [pickle.loads((workdir / f"rank{r}.pkl").read_bytes())
            for r in range(ranks)]


def phase_sharded(albums, smi: str) -> dict:
    """glc_tpu_torch.parallel on the one card: encode_album_sharded and
    decode_album_sharded of both albums and the round trip, in a gloo
    world of 2 ranks (mesh 1 x 2), one of 4 (2 x 2) and an NCCL world of 1
    (1 x 1), each rank computing on cuda:0.  `albums` maps seconds to the
    album phase's items.  Returns world -> (per-rank launches, rows)."""
    enc = Encoder(SAMPLE_RATE, device="cuda")
    dec = Decoder(2, SAMPLE_RATE, device="cuda")
    summary, mses, unequal = {}, {}, []
    with tempfile.TemporaryDirectory() as tmp:
        inputs = Path(tmp)
        serial_walls = {}
        for s, items in albums.items():
            f32 = [album_f32(x) for x, _c in items]
            serial = [enc.encode(x, 2) for x in f32]
            for i, ((x, _c), ea) in enumerate(zip(items, serial)):
                np.save(inputs / f"album{s}_{i}.npy", x)
                (inputs / f"album{s}_{i}.glc").write_bytes(
                    serialize_encoded(ea))
                np.save(inputs / f"decoded{s}_{i}.npy", dec.decode(ea))
            serial_walls[s] = (
                _wall(lambda: [enc.encode(x, 2) for x in f32]),
                _wall(lambda: [dec.decode(ea) for ea in serial]))
        for backend, ranks in SHARDED_WORLDS:
            workdir = inputs / f"{backend}{ranks}"
            workdir.mkdir()
            t0 = time.perf_counter()
            per_rank = run_world(backend, ranks, inputs, workdir)
            t_world = time.perf_counter() - t0
            first = per_rank[0]
            shape = mesh_shape(ranks)
            want_rows = sharded_rows(ranks)
            name = f"{backend} {ranks} rank{'s' if ranks > 1 else ''} {shape}"
            if first["mesh"] != shape:
                raise AssertionError(f"{name}: mesh {first['mesh']}")
            if len({r["digest"] for r in per_rank}) != 1:
                raise AssertionError(f"{name}: the ranks' results differ")
            for r, res in enumerate(per_rank):
                for kernel in KERNEL_NAMES:
                    got = res["rows"][kernel]
                    if got != want_rows or res["launches"][kernel] != len(got):
                        raise AssertionError(
                            f"{name} rank {r}: {kernel} launched "
                            f"{res['launches'][kernel]} times at rows {got}, "
                            f"the geometry says {want_rows}")
                    LAUNCHED_ROWS[kernel].update(got)
            mses[name] = first[ROUNDTRIP_COMMON]
            summary[name] = {"launches": [[r["launches"][k]
                                           for k in KERNEL_NAMES]
                                          for r in per_rank],
                             "rows": want_rows}
            how = ("no halo; the gathers through NCCL on the card"
                   if backend == "nccl" else
                   "the halo and the gathers through host memory")
            d, f = shape
            parts = []
            for s, rows in zip(ALBUM_SECONDS, want_rows):
                c = first[s]
                flips = ""
                if c["flips"]:
                    track, pair, scales = c["first"]
                    flips = (f", {len(c['flips'])} within the pair contract "
                             f"(flip rates "
                             f"{[round(x['rate'], 6) for x in c['flips']]}; "
                             f"track {track}: first differing pair (frame, "
                             f"channel, k, q sharded, q serial) {pair}, "
                             f"{scales} scales differ)")
                    unequal.append(f"{name} {s} s: {c['equal']}/"
                                   f"{ALBUM_TRACKS} tracks byte-equal{flips}")
                parts.append(
                    f"{ALBUM_TRACKS} x {s} s: encode == serial "
                    f"Encoder.encode bytes on {c['equal']}/{ALBUM_TRACKS} "
                    f"tracks{flips} (MDCT rows: {rows} a rank vs the serial "
                    f"segments' {serial_rows(s * SAMPLE_RATE * 2)}); decode "
                    f"vs serial Decoder.decode max |diff| {c['max_err']:.3e} "
                    f"(rtol 2e-6, atol 1e-7), bit for bit {c['bit_equal']}, "
                    f"lengths == originals")
            print(f"[sharded] {name}, shards on cuda:{first['device']} "
                  f"({how}): " + "; ".join(parts) + f"; round trip mse "
                  f"{first[(2 * d, 2 * f)]:.9f} at (B, K) = "
                  f"{(2 * d, 2 * f)}, {mses[name]:.9f} at "
                  f"{ROUNDTRIP_COMMON}; launches per rank of each kernel "
                  f"(imdct_window, mdct_rows, band_energy) "
                  f"{summary[name]['launches']} at rows {want_rows}; world "
                  f"{t_world:.1f} s, spawn included")
            print(f"[sharded] {name} ({smi}), one call each after a warm-up, "
                  f"not claimed (the ranks share one card): " + "; ".join(
                      f"{ALBUM_TRACKS} x {s} s encode_album_sharded "
                      f"{first[s]['t_enc']:.4f} s, decode_album_sharded "
                      f"{first[s]['t_dec']:.4f} s (serial loops: encode "
                      f"{serial_walls[s][0]:.4f} s, decode "
                      f"{serial_walls[s][1]:.4f} s)" for s in ALBUM_SECONDS))
    if unequal:
        raise AssertionError("sharded album encode != serial Encoder.encode: "
                             + "; ".join(unequal))
    ref = next(iter(mses.values()))
    if any(abs(m - ref) > MSE_RTOL * abs(ref) for m in mses.values()):
        raise AssertionError(f"round trip mse differs across worlds: {mses}")
    print(f"[sharded] round trip mse at {ROUNDTRIP_COMMON} equal across "
          f"worlds within {MSE_RTOL} relative: {mses}")
    return summary


def geometry_round_trip(hop: int, rate: int, smi: str) -> dict:
    """The GEOMETRY_SECONDS stereo encode_pcm16 → decode_i16 on the card
    at hop `hop` (frame_size 2·hop), with the kernels' launches counted
    around it: one mdct_rows and one band_energy launch a segment, one
    imdct_window launch a decode chunk, the products' launches all of
    their f64 path where `kernels.product_path(hop)` says so, else none.
    The container within the pair contract of the CPU port's, the card's
    decode within 1 LSB of the CPU port's decode of the same container.
    Returns the launch counts, the f64 path's as `F64_KERNELS` names it."""
    cfg = replace(DEFAULT_CONFIG, hop_size=hop, frame_size=2 * hop)
    pcm = make_signal(GEOMETRY_SECONDS, rate=rate, seed=hop)
    plan = upload_geometry(len(pcm), 2, cfg)[3]
    enc = Encoder(rate, config=cfg, device="cuda")
    dec = Decoder(2, rate, config=cfg, device="cuda")
    reset_launches()
    encoded = enc.encode_pcm16(pcm, 2)
    out = dec.decode_i16(encoded)
    counts = launch_counts()
    f64 = kernels.product_path(hop) == "f64"
    for name, of in F64_KERNELS.items():
        counts[name] = getattr(kernels, of).f64_launches
    chunks = decode_chunks([encoded], cfg.decode_chunk_frames)
    want = {"imdct_window": chunks, "mdct_rows": len(plan),
            "band_energy": len(plan), "imdct_window_f64": chunks * f64,
            "mdct_rows_f64": len(plan) * f64}
    if counts != want:
        raise AssertionError(f"hop {hop}: launches {counts}, the geometry "
                             f"says {want}")
    if len(out) != len(pcm):
        raise AssertionError(f"hop {hop}: decoded {len(out)} samples of "
                             f"{len(pcm)}")
    flips = check_containers(
        encoded, Encoder(rate, config=cfg, device="cpu").encode_pcm16(pcm, 2),
        n=hop)
    out_cpu = Decoder(2, rate, config=cfg, device="cpu").decode_i16(encoded)
    d = np.abs(out_cpu.astype(np.int32) - out.astype(np.int32))
    if d.max() > 1:
        raise AssertionError(f"hop {hop}: card vs CPU decode differs by "
                             f"{d.max()} LSB")
    print(f"[geometry] hop {hop} at {rate} Hz, {GEOMETRY_SECONDS} s stereo "
          f"({smi}): {encoded.frame_set.num_frames} frames, segments "
          f"{[k for _s, k in plan]}, {chunks} decode chunks; launches "
          f"{counts}; card vs CPU: {flips['gate']} keep-gate and "
          f"{flips['pm1']} +-1 flips of {flips['kept']} kept (rate "
          f"{flips['rate']:.5%}), decode_i16 max {int(d.max())} LSB")
    return counts


def geometry_kernel_checks(n: int, rate: int, rows: dict,
                           tag: str = "geometry") -> dict:
    """Each kernel against its plain version at n and `rate`'s tables on
    the row counts `rows[kernel]` (`check_kernel_rows` of
    tests/test_torch_rates.py: within KERNEL_TOL, band_energy BAND_RTOL,
    the error against float64 no more than twice plain's, each launch's
    rows the bits of the same rows of the largest launch).  Returns each
    kernel's largest |kernel - plain|."""
    worst = check_kernel_rows(rate, rows, n)
    top = max(max(r) for r in rows.values())
    print(f"[{tag}] n={n} ({rate} Hz tables), each kernel against plain: "
          + "; ".join(f"{k} at rows {sorted(r, reverse=True)}, "
                      f"max|kernel-plain| {worst[k]:.3e}"
                      for k, r in rows.items())
          + f"; errors vs float64 within twice plain's, rows == the "
          f"{top}-row launch's")
    return worst


def geometry_times(n: int, rate: int, smi: str,
                   tag: str = "geometry") -> dict:
    """The times (medians of 20 single calls, and back to back:
    `device_ms`) of each kernel at n, its plain version and one library
    call, beside the bound, at M = 8192 (mdct_rows, band_energy) and
    B = 2816 (imdct_window); and the copy into the padded pitch where the
    kernel makes one (`kernels.padded_rows`).  Where the products take
    their f64 path (`kernels.product_path`), also the same function's
    library call: torch.matmul on float64 copies of the operands (cuBLAS
    DGEMM on the f64 tensor cores), the widening of the row operand made
    outside the timed call and timed apart.  Returns {kernel: {...}}."""
    tables = get_codec_tables(n, 2 * n, rate, "cuda")
    M, B = GEOMETRY_TIMED_ROWS["mdct_rows"], GEOMETRY_TIMED_ROWS["imdct_window"]
    win = seeded_rows(M, 2 * n, 2, tables.window)
    coeffs = mdct_rows(win, tables.cos_table, tables.norm)
    dec = seeded_rows(B, n, 1)
    table_norm = (tables.cos_table * tables.norm).T.contiguous()
    folded = tables.cos_table * (tables.norm_value * tables.window)
    mask = tables.band_mask
    f64 = kernels.product_path(n) == "f64"
    if f64:  # the same functions in f64: DGEMM on widened operands
        win64, dec64 = win.double(), dec.double()
        table_norm64 = (tables.cos_table.double() * tables.norm_value).T
        folded64 = tables.cos_table.double() * (
            tables.norm_value * tables.window.double())
        widen = {"mdct_rows": (lambda: torch.matmul(win64, table_norm64),
                               lambda: win.double()),
                 "imdct_window": (lambda: torch.matmul(dec64, folded64),
                                  lambda: dec.double())}
    calls = {
        "mdct_rows": (
            lambda: mdct_rows(win, tables.cos_table, tables.norm),
            lambda: mdct_rows_reference(win, tables.cos_table, tables.norm),
            lambda: torch.matmul(win, table_norm), mdct_bound(M, n), win),
        "band_energy": (
            lambda: band_energy(coeffs, mask),
            lambda: band_energy_reference(coeffs, mask),
            lambda: torch.einsum("mk,mk,bk->mb", coeffs, coeffs, mask),
            band_bound(M, n, mask.shape[0]), None),
        "imdct_window": (
            lambda: imdct_window(dec, tables.cos_table, tables.window,
                                 tables.norm_value),
            lambda: imdct_window_reference(dec, tables.cos_table,
                                           tables.window, tables.norm_value),
            lambda: torch.matmul(dec, folded), kernel_bound(B, n), dec),
    }
    out = {}
    for name, (kern, plain, lib, bound, padded) in calls.items():
        ms = [_median_ms(fn) for fn in (kern, plain, lib)]
        device = [device_ms(fn) for fn in (kern, plain, lib)]
        rows = B if name == "imdct_window" else M
        copy = ""
        entry = {"rows": rows, "ms": ms[0], "plain_ms": ms[1],
                 "library_ms": ms[2], "bound_ms": bound[0],
                 "bound_by": bound[1], "device_ms": device[0],
                 "device_plain_ms": device[1], "device_library_ms": device[2]}
        if (padded is not None and padded.shape[1] % 4
                and kernels.product_path(n) == "tiles"):
            copy_ms = _median_ms(lambda: kernels.padded_rows(padded))
            entry["pad_copy_ms"] = copy_ms
            copy = (f"; of it, the copy of {tuple(padded.shape)} to pitch "
                    f"{kernels.row_pitch(padded.shape[1])} {copy_ms:.4f} ms")
        dgemm = ""
        if f64 and name in widen:
            dgemm_fn, cast_fn = widen[name]
            entry.update(library_f64_ms=_median_ms(dgemm_fn),
                         device_library_f64_ms=device_ms(dgemm_fn),
                         cast_f64_ms=device_ms(cast_fn))
            dgemm = (f"; the same function in f64 (torch.matmul on float64 "
                     f"copies, cuBLAS DGEMM): {entry['library_f64_ms']:.4f} "
                     f"ms, back to back {entry['device_library_f64_ms']:.4f}"
                     f" ms, the widening of {tuple(padded.shape)} apart "
                     f"{entry['cast_f64_ms']:.4f} ms")
        out[name] = entry
        print(f"[{tag}] {name} n={n} rows={rows} ({rate} Hz tables; {smi}), "
              f"median of 20: "
              f"kernel {ms[0]:.4f} ms ({bound[0] / ms[0]:.1%} of the bound), "
              f"plain {ms[1]:.4f} ms, library {ms[2]:.4f} ms; back to back: "
              f"kernel {device[0]:.4f} ms ({bound[0] / device[0]:.1%} of the "
              f"bound), plain {device[1]:.4f} ms, library {device[2]:.4f} ms; "
              f"bound {bound[0]:.4f} ms ({bound[1]}){copy}{dgemm}")
    return out


def product_paths(smi: str) -> None:
    """Both products of mdct_rows and imdct_window at each n of PATH_NS:
    the 3xTF32 tile product and the f64 path (csrc/f64_rows.cuh), each
    chosen by the wrappers' `path`, on the last 1, 63 and 8192 of the
    geometry checks' rows (`seeded_rows` seeds 2 and 1).  Each path's
    result within KERNEL_TOL of plain; the f64 path's error against
    float64, and that of the path the wrappers take at n
    (`kernels.product_path`), no more than twice plain's, else the run
    fails.  Prints every error ratio and both paths' times at 8192 rows."""
    for n in PATH_NS:
        tables = get_codec_tables(n, 2 * n, SAMPLE_RATE, "cuda")
        t64, w64 = tables.cos_table.double(), tables.window.double()
        win_all = seeded_rows(8192, 2 * n, 2, tables.window)
        dec_all = seeded_rows(8192, n, 1)
        calls = {
            "mdct_rows": (
                lambda x, **kw: mdct_rows(x, tables.cos_table, tables.norm,
                                          **kw),
                lambda x: mdct_rows_reference(x, tables.cos_table,
                                              tables.norm),
                lambda x: (x.double() @ t64.T) * tables.norm_value, win_all),
            "imdct_window": (
                lambda x, **kw: imdct_window(x, tables.cos_table,
                                             tables.window, tables.norm_value,
                                             **kw),
                lambda x: imdct_window_reference(
                    x, tables.cos_table, tables.window, tables.norm_value),
                lambda x: ((x.double() @ t64) * tables.norm_value) * w64,
                dec_all),
        }
        taken = kernels.product_path(n)
        ratios, times = {}, {}
        for name, (kern, plain, exact_of, x_all) in calls.items():
            for M in (1, 63, 8192):
                x = x_all[-M:].clone()
                ref = plain(x)
                exact = exact_of(x)
                err_plain = (ref.double() - exact).abs().max().item()
                for path in kernels.PRODUCT_PATHS:
                    out = kern(x, path=path)
                    torch.testing.assert_close(out, ref, atol=KERNEL_TOL,
                                               rtol=KERNEL_TOL)
                    err = (out.double() - exact).abs().max().item()
                    ratios[(name, path, M)] = r = (
                        err / err_plain if err_plain else
                        (0.0 if err == 0 else float("inf")))
                    if r > 2 and path in ("f64", taken):
                        raise AssertionError(
                            f"{name} n={n} M={M} path {path}: error vs "
                            f"float64 {err:.3e} exceeds twice plain's "
                            f"{err_plain:.3e}")
            for path in kernels.PRODUCT_PATHS:
                times[(name, path)] = device_ms(
                    lambda: kern(x_all, path=path))
        print(f"[geometry] n={n} ({smi}), the wrappers take {taken}; error "
              f"vs float64 over plain's at rows 1/63/8192: " + "; ".join(
                  f"{name} {path} " + "/".join(
                      f"{ratios[(name, path, M)]:.2f}" for M in (1, 63, 8192))
                  for name in calls for path in kernels.PRODUCT_PATHS)
              + "; back to back at 8192 rows: " + ", ".join(
                  f"{name} {path} {times[(name, path)]:.4f} ms"
                  for name in calls for path in kernels.PRODUCT_PATHS))


# The n and the generator seeds of --path-sweep: every n to the codec's
# default, SWEEP_SEEDS rows from torch's generator on the card at each, and
# at the n the cuda tests and this script check the numpy rows they use
# (`seeded_rows`: seed n, the tests' own, 1 and 2).
SWEEP_NS = range(1, 1025)
SWEEP_SEEDS = range(8)
SWEEP_ROWS = (1, 63, 64, 65, 646, 1292, 8192)


def _suffix_max(err: torch.Tensor) -> torch.Tensor:
    """[M] per-row errors → for each m, the largest error of rows m..M-1."""
    return torch.flip(torch.cummax(torch.flip(err, (0,)), 0).values, (0,))


def path_ratios(n: int, data: dict) -> dict:
    """For each of mdct_rows and imdct_window and each product path, the
    (error against float64) / (plain version's error) at each row count
    of SWEEP_ROWS, taken as the last M rows of `data` (as the cuda tests
    and `geometry_kernel_checks` take them): {(kernel, path): {M: ratio}}."""
    tables = get_codec_tables(n, 2 * n, SAMPLE_RATE, "cuda")
    t64, w64 = tables.cos_table.double(), tables.window.double()
    win, dec = data["mdct_rows"], data["imdct_window"]
    calls = {
        "mdct_rows": (
            lambda x, **kw: mdct_rows(x, tables.cos_table, tables.norm, **kw),
            lambda x: mdct_rows_reference(x, tables.cos_table, tables.norm),
            lambda x: (x.double() @ t64.T) * tables.norm_value, win),
        "imdct_window": (
            lambda x, **kw: imdct_window(x, tables.cos_table, tables.window,
                                         tables.norm_value, **kw),
            lambda x: imdct_window_reference(x, tables.cos_table,
                                             tables.window, tables.norm_value),
            lambda x: ((x.double() @ t64) * tables.norm_value) * w64, dec),
    }
    out = {}
    for name, (kern, plain, exact_of, x) in calls.items():
        exact = exact_of(x)
        plain_err = {}
        for M in SWEEP_ROWS:
            ref = plain(x[-M:].contiguous()).double()
            plain_err[M] = (ref - exact[-M:]).abs().max().item()
        for path in kernels.PRODUCT_PATHS:
            rows_err = _suffix_max((kern(x, path=path).double() - exact)
                                   .abs().amax(1)).cpu()
            out[(name, path)] = ratio = {}
            for M in SWEEP_ROWS:
                err = rows_err[len(x) - M].item()
                ratio[M] = err / plain_err[M] if plain_err[M] else \
                    (0.0 if err == 0 else float("inf"))
    return out


def path_sweep(smi: str, out_path: str | None) -> None:
    """The measurement behind kernels._F64_MAX_N: at every n of SWEEP_NS
    and every row count of SWEEP_ROWS, each product path's error ratio
    (`path_ratios`) on every seed's rows.  Prints, for each path and row
    count, the n at which it passed twice plain's error on some seed and
    on how many; the largest n at which the tile product did (the cut)
    beside the wrappers' cut; and the worst ratio of each path at a few n.
    Writes every ratio to `out_path` as JSON."""
    exact_ns = set(TEST_GEOMETRY_NS) | set(PATH_NS) | {
        hop for _name, hop, _rate in GEOMETRIES}
    per_n = {}
    for n in SWEEP_NS:
        tables = get_codec_tables(n, 2 * n, SAMPLE_RATE, "cuda")
        gen = torch.Generator(device="cuda")
        datas = []
        for seed in SWEEP_SEEDS:
            gen.manual_seed(seed)
            datas.append((f"torch{seed}", {
                "mdct_rows": torch.randn((8192, 2 * n), generator=gen,
                                         device="cuda") * 0.1 * tables.window,
                "imdct_window": torch.randn((8192, n), generator=gen,
                                            device="cuda") * 0.1}))
        if n in exact_ns:
            for seed in sorted({n, 1, 2}):
                datas.append((f"numpy{seed}", {
                    "mdct_rows": seeded_rows(8192, 2 * n, seed, tables.window),
                    "imdct_window": seeded_rows(8192, n, seed)}))
        per_n[n] = cell = {}
        for label, data in datas:
            for (name, path), ratio in path_ratios(n, data).items():
                for M, r in ratio.items():
                    cell.setdefault(f"{name} {path}", {}).setdefault(
                        M, {})[label] = r
    cut = max((n for n in SWEEP_NS for name in ("mdct_rows", "imdct_window")
               for M in SWEEP_ROWS
               if max(per_n[n][f"{name} tiles"][M].values()) > 2), default=0)
    print(f"[path sweep] ({smi}) the largest n at which the tile product "
          f"passed twice plain's error: {cut}; the wrappers take the f64 "
          f"path at n <= {kernels._F64_MAX_N}")
    for path in kernels.PRODUCT_PATHS:
        for M in SWEEP_ROWS:
            broken = {n: sum(r > 2 for name in ("mdct_rows", "imdct_window")
                             for r in per_n[n][f"{name} {path}"][M].values())
                      for n in SWEEP_NS}
            broken = {n: k for n, k in broken.items() if k}
            print(f"[path sweep] ({smi}) {path}, M={M}: passes twice plain's "
                  f"error at {len(broken)} of {len(SWEEP_NS)} n (largest "
                  f"{max(broken, default=None)}); n: cases {broken}")
    for n in (1, 2, 4, 8, 16, 32, 64, 128, 256, 257, 384, 441, 456, 457,
              512, 735, 960, 1024):
        if n in per_n:
            print(f"[path sweep] n={n}, worst over seeds at M = "
                  f"{'/'.join(map(str, SWEEP_ROWS))}: " + "; ".join(
                      f"{key} " + "/".join(
                          f"{max(per_n[n][key][M].values()):.2f}"
                          for M in SWEEP_ROWS)
                      for key in per_n[n]))
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps(
            {"card": smi, "rows": SWEEP_ROWS, "cut": cut, "ratios": per_n}))


def f64_kernels_ms(fn, span: str) -> tuple[float, dict]:
    """One call of `fn` under the profiler as the span `span`: its wall
    (ms) and the card's time in each f64 kernel (`F64_KERNEL_EVENTS`)
    inside it."""
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp), profiling.annotate(span):
            fn()
        (trace,) = Path(tmp).glob("*.pt.trace.json")
        events = json.loads(trace.read_text())["traceEvents"]
    (sp,) = [e for e in events if e.get("name") == span
             and e.get("cat") == "user_annotation"]
    t0, t1 = sp["ts"], sp["ts"] + sp["dur"]
    return sp["dur"] / 1e3, {
        name: device_busy_ms(
            [e for e in events if e.get("cat") == "kernel"
             and "f64rows::rows_kernel" in e.get("name", "")
             and mark in e["name"]], t0, t1)
        for name, mark in F64_KERNEL_EVENTS.items()}


def phase_f64_path(smi: str) -> dict:
    """The f64 path at full size: the bench's 60 s signal (`make_signal_i16`
    of glc_tpu_torch/bench.py, 44.1 kHz stereo) through
    Encoder.encode_pcm16, Decoder.decode_i16 and the FLAC export
    (`export_flac`) on the card at each hop of F64_PATH_HOPS, after a
    warm-up; each call's launches counted from 0 around it (one mdct_rows
    and one band_energy launch a segment, one imdct_window launch a decode
    or stream chunk, the products' all of their f64 path); the container
    within the pair contract of the CPU port's, decode_i16 within 1 LSB of
    the CPU port's decode of the same container, the export's FLAC
    decoding to decode_i16's samples; each wall (median of F64_PATH_RUNS)
    beside the two f64 kernels' device time in one traced call
    (`f64_kernels_ms`).  Returns {hop: launches, walls, kernel times}."""
    pcm = make_bench_signal_i16(F64_PATH_SECONDS)
    out_all = {}
    for hop in F64_PATH_HOPS:
        if kernels.product_path(hop) != "f64":
            raise AssertionError(f"hop {hop} does not take the f64 path")
        cfg = replace(DEFAULT_CONFIG, hop_size=hop, frame_size=2 * hop)
        plan = upload_geometry(len(pcm), 2, cfg)[3]
        enc = Encoder(SAMPLE_RATE, config=cfg, device="cuda")
        dec = Decoder(2, SAMPLE_RATE, config=cfg, device="cuda")
        encoded = enc.encode_pcm16(pcm, 2)  # warm-up of all three calls
        dec.decode_i16(encoded)
        export_flac(dec, encoded)
        calls = {"encode": lambda: enc.encode_pcm16(pcm, 2),
                 "decode": lambda: dec.decode_i16(encoded),
                 "export": lambda: export_flac(dec, encoded)}
        results, counts = {}, {}
        for name, call in calls.items():
            reset_launches()
            results[name] = call()
            counts[name] = {**launch_counts(), **{
                f64: getattr(kernels, wrapper).f64_launches
                for f64, wrapper in F64_KERNELS.items()}}
        chunks = decode_chunks([encoded], cfg.decode_chunk_frames)
        stream = decode_chunks([encoded], cfg.stream_chunk_frames)
        want = {"encode": (len(plan), len(plan), 0),
                "decode": (0, 0, chunks), "export": (0, 0, stream)}
        for name, (segs, bands, imdct) in want.items():
            c = counts[name]
            got = (c["mdct_rows"], c["band_energy"], c["imdct_window"],
                   c["mdct_rows_f64"], c["imdct_window_f64"])
            if got != (segs, bands, imdct, segs, imdct):
                raise AssertionError(
                    f"hop {hop} {name}: launches {c}, the geometry says "
                    f"{segs} segments, {imdct} imdct_window chunks, all f64")
        if serialize_encoded(results["encode"]) != serialize_encoded(encoded):
            raise AssertionError(f"hop {hop}: two encodes of one input differ")
        flips = check_containers(
            encoded,
            Encoder(SAMPLE_RATE, config=cfg, device="cpu").encode_pcm16(
                pcm, 2), n=hop)
        out = results["decode"]
        out_cpu = Decoder(2, SAMPLE_RATE, config=cfg,
                          device="cpu").decode_i16(encoded)
        lsb = int(np.abs(out_cpu.astype(np.int32)
                         - out.astype(np.int32)).max())
        if lsb > 1 or len(out) != len(pcm):
            raise AssertionError(f"hop {hop}: card vs CPU decode {lsb} LSB, "
                                 f"{len(out)} of {len(pcm)} samples")
        samples, rate, channels, _bps = decode_flac(results["export"])
        if (rate, channels) != (SAMPLE_RATE, 2) or not np.array_equal(
                samples, out.astype(np.int32)):
            raise AssertionError(f"hop {hop}: the FLAC export does not hold "
                                 f"decode_i16's samples")
        walls, traced = {}, {}
        for name, call in calls.items():
            walls[name] = float(np.median(
                [_wall(call) * 1e3 for _ in range(F64_PATH_RUNS)]))
            traced[name] = f64_kernels_ms(call, f"f64_path_{name}")
        out_all[hop] = {"launches": counts, "walls_ms": walls,
                        "flip_rate": flips["rate"], "lsb": lsb,
                        "traced": {k: {"wall_ms": w, "kernels_ms": ms}
                                   for k, (w, ms) in traced.items()}}
        print(f"[f64 path] hop {hop}, the bench's {F64_PATH_SECONDS} s 44.1 "
              f"kHz stereo ({smi}): segments {[k for _s, k in plan]}, "
              f"{chunks} decode and {stream} stream chunks; card vs CPU "
              f"{flips['gate']} keep-gate and {flips['pm1']} +-1 flips of "
              f"{flips['kept']} kept (rate {flips['rate']:.5%}), decode_i16 "
              f"max {lsb} LSB, the FLAC holds decode_i16's samples; "
              + "; ".join(
                  f"{name}: wall {walls[name]:.2f} ms (median of "
                  f"{F64_PATH_RUNS}), launches mdct_rows_f64 "
                  f"{counts[name]['mdct_rows_f64']}, imdct_window_f64 "
                  f"{counts[name]['imdct_window_f64']}; traced call "
                  f"{traced[name][0]:.2f} ms, of it on the card "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in
                              traced[name][1].items())
                  + f" ({sum(traced[name][1].values()) / walls[name]:.2%} "
                  f"of the median wall)"
                  for name in calls))
    return out_all


def phase_geometry(smi: str) -> dict:
    """The frame geometries of GEOMETRIES through the card's kernels: each
    round trip with its launches counted (`geometry_round_trip`), each
    kernel against plain at every row count those paths launched it with
    and at the timed rows (`geometry_kernel_checks`), the times at
    GEOMETRY_TIMED (`geometry_times`) and both product paths at PATH_NS
    (`product_paths`).  Returns {kernel: {n: launches, errors and
    times}}, the f64 path's kernels (`F64_KERNELS`) at the hops that take
    it."""
    info = kernels.kernel_info()
    for kernel in ("mdct_rows", "imdct_window"):
        print(f"[geometry] {kernel}'s f64 path (csrc/f64_rows.cuh; {smi}): "
              + "; ".join(
                  f"tile {i['tile'][0]} x {i['tile'][1]}: {i['registers']} "
                  f"regs/thread, {i['local_bytes']} B local (spills), smem "
                  f"{i['static_smem']} B static + {i['dynamic_smem']} B "
                  f"dynamic, {i['stages']} stages, {i['resident_blocks']} "
                  f"blocks an SM"
                  for i in (info[f"{kernel}_f64{t}"]
                            for t in kernels.F64_TILES)))
    launches = {}
    for _name, hop, rate in GEOMETRIES:
        launches[hop] = geometry_round_trip(hop, rate, smi)
    result = {name: {} for name in (*KERNEL_NAMES, *F64_KERNELS)}
    for _name, hop, rate in GEOMETRIES:
        rows = {name: GEOMETRY_LAUNCHED[name].get(hop, set())
                | {GEOMETRY_TIMED_ROWS[name]} for name in KERNEL_NAMES}
        if not all(GEOMETRY_LAUNCHED[name].get(hop) for name in KERNEL_NAMES):
            raise AssertionError(f"hop {hop}: a kernel's launches were not "
                                 f"recorded: {GEOMETRY_LAUNCHED}")
        err = geometry_kernel_checks(hop, rate, rows)
        times = (geometry_times(hop, rate, smi) if hop in GEOMETRY_TIMED
                 else {})
        for name in result:
            wrapper = F64_KERNELS.get(name, name)
            if name in F64_KERNELS and not launches[hop][name]:
                continue
            result[name][hop] = {"launches": launches[hop][name],
                                 "rows_checked": sorted(rows[wrapper],
                                                        reverse=True),
                                 "max_abs_err": err[wrapper],
                                 **times.get(wrapper, {})}
    product_paths(smi)
    return result


def conformance_case(rate: int, channels: int, smi: str) -> dict:
    """CONFORMANCE_SECONDS of `program_material` at `rate` and `channels`
    through encode_pcm16 -> decode_i16 on the card, the launches counted
    from 0 around it (one mdct_rows and one band_energy launch a segment,
    one imdct_window launch a decode chunk, none of the f64 path) and their
    rows recorded under the rate; the container within the pair contract
    of the CPU port's, the decode within 1 LSB of the CPU port's decode of
    the same container.  Returns the counts, flip rate and worst LSB."""
    cfg = DEFAULT_CONFIG
    pcm = program_material(CONFORMANCE_SECONDS, rate, channels,
                           seed=rate + channels)
    plan = upload_geometry(len(pcm), channels, cfg)[3]
    enc = Encoder(rate, device="cuda")
    dec = Decoder(channels, rate, device="cuda")
    with recording_rate(rate):
        reset_launches()
        encoded = enc.encode_pcm16(pcm, channels)
        out = dec.decode_i16(encoded)
        counts = launch_counts()
        f64 = mdct_rows.f64_launches + imdct_window.f64_launches
    chunks = decode_chunks([encoded], cfg.decode_chunk_frames)
    want = {"imdct_window": chunks, "mdct_rows": len(plan),
            "band_energy": len(plan)}
    if counts != want or f64:
        raise AssertionError(f"{rate} Hz x {channels}: launches {counts} "
                             f"(f64 path {f64}), the geometry says {want}")
    if len(out) != len(pcm):
        raise AssertionError(f"{rate} Hz x {channels}: decoded {len(out)} "
                             f"samples of {len(pcm)}")
    flips = check_containers(
        encoded, Encoder(rate, device="cpu").encode_pcm16(pcm, channels))
    out_cpu = Decoder(channels, rate, device="cpu").decode_i16(encoded)
    d = np.abs(out_cpu.astype(np.int32) - out.astype(np.int32))
    if d.max() > 1:
        raise AssertionError(f"{rate} Hz x {channels}: card vs CPU decode "
                             f"differs by {d.max()} LSB")
    print(f"[conformance] {rate} Hz x {channels} ch, {CONFORMANCE_SECONDS} s "
          f"({smi}): {encoded.frame_set.num_frames} frames, "
          f"{int(encoded.frame_set.raw_mask.sum())} raw; launches {counts}; "
          f"card vs CPU: {flips['gate']} keep-gate and {flips['pm1']} +-1 "
          f"flips of {flips['kept']} kept (rate {flips['rate']:.5%}), "
          f"decode_i16 max {int(d.max())} LSB on {int(np.count_nonzero(d))} "
          f"of {len(d)} samples")
    return {"launches": counts, "flip_rate": flips["rate"],
            "max_lsb": int(d.max())}


def _median_wall(fn, runs: int = FULL_SIZE_RUNS) -> float:
    """The median wall (s) of `runs` calls of fn after a warm-up call."""
    fn()
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls))


def conformance_full_size(label: str, seconds: int, rate: int,
                          channels: int, smi: str) -> dict:
    """A realistic file through cli.main as a user calls it: its WAV ->
    .glc -> FLAC (the default) -> .glc on the card, launches counted from
    0 around each call and their rows recorded under the rate.  The FLAC
    holds decode_i16 of the .glc; the container from the FLAC equals
    encode_pcm16 of its samples; each container within the pair contract
    of the CPU port's encode of the same samples; decode_i16 within 1 LSB
    of the CPU's.  Then the encode_pcm16 and decode_i16 walls on the card,
    medians of FULL_SIZE_RUNS after a warm-up, and one call of each with
    the `stats=` hook (where the host's time goes)."""
    cfg = DEFAULT_CONFIG
    pcm = program_material(seconds, rate, channels, seed=seconds)
    plan = upload_geometry(len(pcm), channels, cfg)[3]
    with tempfile.TemporaryDirectory() as tmp:
        wav = Path(tmp) / "full.wav"
        glc, flac = wav.with_suffix(".glc"), wav.with_suffix(".flac")
        write_wav_i16(wav, pcm, rate, channels)
        with recording_rate(rate):
            reset_launches()
            rcs = [cli.main([str(wav)])]
            enc_counts = launch_counts()
            encoded = load_encoded(glc)
            reset_launches()
            rcs.append(cli.main(["-d", str(glc)]))
            dec_counts = launch_counts()
            want = Decoder(channels, rate, device="cuda").decode_i16(encoded)
            samples, frate, fch, bps = decode_flac(flac.read_bytes())
            wav.unlink()
            rcs.append(cli.main([str(flac)]))
            again = load_encoded(glc)
            ref = Encoder(rate, device="cuda").encode_pcm16(
                samples.astype(np.int16), channels)
    chunks = decode_chunks([encoded], cfg.stream_chunk_frames)
    if rcs != [0, 0, 0]:
        raise AssertionError(f"{label}: CLI exit codes {rcs}")
    if enc_counts != {"imdct_window": 0, "mdct_rows": len(plan),
                      "band_energy": len(plan)}:
        raise AssertionError(f"{label}: the CLI encode launched {enc_counts} "
                             f"for {len(plan)} segments")
    if dec_counts != {"imdct_window": chunks, "mdct_rows": 0,
                      "band_energy": 0}:
        raise AssertionError(f"{label}: the CLI decode launched {dec_counts} "
                             f"for {chunks} chunks")
    if (frate, fch, bps) != (rate, channels, 16) or not np.array_equal(
            samples, want.astype(np.int32)):
        raise AssertionError(f"{label}: the CLI's FLAC != decode_i16 of its "
                             f".glc")
    if serialize_encoded(again) != serialize_encoded(ref):
        raise AssertionError(f"{label}: the FLAC input's container != "
                             f"encode_pcm16 of its samples")
    cpu = Encoder(rate, device="cpu")
    flips = [check_containers(encoded, cpu.encode_pcm16(pcm, channels)),
             check_containers(again, cpu.encode_pcm16(
                 samples.astype(np.int16), channels))]
    out_cpu = Decoder(channels, rate, device="cpu").decode_i16(encoded)
    d = np.abs(out_cpu.astype(np.int32) - want.astype(np.int32))
    if d.max() > 1:
        raise AssertionError(f"{label}: card vs CPU decode differs by "
                             f"{d.max()} LSB")
    enc = Encoder(rate, device="cuda")
    dec = Decoder(channels, rate, device="cuda")
    st_enc, st_dec = {}, {}
    with recording_rate(rate):
        t_enc = _median_wall(lambda: enc.encode_pcm16(pcm, channels))
        t_dec = _median_wall(lambda: dec.decode_i16(encoded))
        enc.encode_pcm16(pcm, channels, stats=st_enc)
        dec.decode_i16(encoded, stats=st_dec)
    split = "; ".join(
        f"{what} " + ", ".join(f"{k} {v:.2f}" for k, v in sorted(st.items()))
        for what, st in (("encode", st_enc), ("decode", st_dec)))
    rows = sorted({channels * k for _s, k in plan}, reverse=True)
    print(f"[conformance] {label}: {seconds} s, {rate} Hz, {channels} ch "
          f"through cli.main (wav -> glc -> flac -> glc): exit codes {rcs}; "
          f"{encoded.frame_set.num_frames} frames, encode segments of rows "
          f"{rows}, {chunks} stream chunks; launches encode {enc_counts}, "
          f"decode {dec_counts}; FLAC == decode_i16, FLAC-input container "
          f"== encode_pcm16; card vs CPU flips {flips[0]['rate']:.5%} "
          f"(WAV), {flips[1]['rate']:.5%} (FLAC), decode_i16 max "
          f"{int(d.max())} LSB")
    print(f"[conformance] {label} ({smi}), medians of {FULL_SIZE_RUNS} after "
          f"a warm-up: encode_pcm16 {t_enc * 1e3:.2f} ms "
          f"({seconds / t_enc:.1f}x realtime), decode_i16 {t_dec * 1e3:.2f} "
          f"ms ({seconds / t_dec:.1f}x realtime); one hooked call each "
          f"(stats=, host ms and copies): {split}")
    return {"flip_rate": max(f["rate"] for f in flips),
            "max_lsb": int(d.max()), "encode_ms": t_enc * 1e3,
            "decode_ms": t_dec * 1e3, "encode_stats": st_enc,
            "decode_stats": st_dec}


def conformance_torture(smi: str) -> dict:
    """tests/test_torture.py's 30 seeded configurations on the card,
    through `check_invariants` of tests/test_torch_torture.py (structure,
    byte-stable serialization, exact length, finite output, chunk-size
    invariance bit for bit, decode_i16 within 1 LSB of the f32 decode's
    conversion), each container within the pair contract of the CPU
    port's; launched rows recorded under each case's rate."""
    worst = 0.0
    for case in range(TORTURE_CASES):
        samples, channels, rate = torture_case(case)
        with recording_rate(rate):
            ea = check_invariants(samples, channels, rate, "cuda",
                                  exact_chunks=True)
        flips = check_containers(
            ea, Encoder(rate, device="cpu").encode(samples, channels))
        worst = max(worst, flips["rate"])
    print(f"[conformance] torture ({smi}): {TORTURE_CASES} of "
          f"{TORTURE_CASES} seeded configurations pass every invariant on "
          f"the card (decode_chunk_frames={SMALL_CHUNK} bit for bit); "
          f"worst card vs CPU flip rate {worst:.5%}")
    return {"cases": TORTURE_CASES, "flip_rate": worst}


def conformance_flac() -> int:
    """The RFC 9639 byte literals and the foreign streams of
    tests/test_torch_flac_conformance.py through the port's native
    decode_flac and decode_flac_python: the exact samples and parameters;
    a corrupted CRC rejected by both; the level-0 golden framing and the
    published CRC check values.  Returns the streams decoded."""
    decoders = {"native": decode_flac, "python": decode_flac_python}
    checked = 0
    cases = [(name, stream, expected, ch, 16)
             for name, (stream, expected, ch) in SPEC_VECTORS.items()]
    cases += [(name, build(bitpack), expected, ch, bits)
              for name, (build, expected, ch, bits) in FOREIGN.items()]
    for name, data, expected, ch, bits in cases:
        for dname, decode in decoders.items():
            got = flac_outcome(decode, data)
            if got[1:] != (44100, ch, bits) or not np.array_equal(
                    got[0], np.asarray(expected, np.int64)):
                raise AssertionError(f"flac {name} ({dname}): {got}")
            checked += 1
        bad = bytearray(data)
        bad[-1] ^= 0xFF
        for dname, decode in decoders.items():
            if not isinstance(flac_outcome(decode, bytes(bad))[0], str):
                raise AssertionError(f"flac {name} ({dname}): a corrupted "
                                     f"CRC was accepted")
    if encode_flac_i16_with_level(np.arange(-8, 8, dtype=np.int16), 44100, 1,
                                  0) != FLAC_GOLDEN:
        raise AssertionError("flac: level 0 framing != RFC 9639 stream B")
    if (bitpack.crc8(b"123456789"), bitpack.crc16(b"123456789")) != (
            0xF4, 0xFEE8):
        raise AssertionError("flac: CRC check values")
    print(f"[conformance] FLAC on this machine: {len(cases)} streams "
          f"({len(SPEC_VECTORS)} RFC 9639 literals, {len(FOREIGN)} foreign) "
          f"x {len(decoders)} decoders exact, each with a corrupted CRC "
          f"rejected; level 0 framing == the RFC's bytes; CRC-8/16 check "
          f"values")
    return checked


def phase_conformance(smi: str) -> dict:
    """The JAX package's suites' rates, channel counts and random
    configurations on the card: the CONFORMANCE_RATES x
    CONFORMANCE_CHANNELS matrix (`conformance_case`), the FULL_SIZE files
    through the CLI (`conformance_full_size`), the torture sweep
    (`conformance_torture`) and FLAC conformance (`conformance_flac`);
    then each kernel against its plain version at every rate's tables on
    every row count those paths launched it with there
    (`geometry_kernel_checks`), and its times there beside plain's, the
    library call's and the bound (`geometry_times`: band_energy's work
    plan follows the rate's bands).  Returns {kernel: {rate: launches,
    rows checked, largest |kernel - plain|, times}} and the phase's
    summary."""
    RATE_LAUNCHED.clear()
    launches = {}
    matrix = {}
    for rate in CONFORMANCE_RATES:
        for channels in CONFORMANCE_CHANNELS:
            res = conformance_case(rate, channels, smi)
            matrix[f"{rate}x{channels}"] = res
            per = launches.setdefault(rate, dict.fromkeys(KERNEL_NAMES, 0))
            for name in KERNEL_NAMES:
                per[name] += res["launches"][name]
    full = {label: conformance_full_size(label, seconds, rate, channels, smi)
            for label, seconds, rate, channels in FULL_SIZE}
    torture = conformance_torture(smi)
    flac_checked = conformance_flac()
    result = {name: {} for name in KERNEL_NAMES}
    for rate in sorted(RATE_LAUNCHED):
        rows = RATE_LAUNCHED[rate]
        if not all(rows.values()):
            raise AssertionError(f"{rate} Hz: a kernel's launches were not "
                                 f"recorded: {rows}")
        err = geometry_kernel_checks(DEFAULT_CONFIG.n, rate, rows,
                                     tag="conformance")
        times = geometry_times(DEFAULT_CONFIG.n, rate, smi,
                               tag="conformance")
        for name in KERNEL_NAMES:
            result[name][rate] = {
                "launches": launches.get(rate, {}).get(name, 0),
                "rows_checked": sorted(rows[name], reverse=True),
                "max_abs_err": err[name], **times[name]}
    for rate in (8000, 22050, 96000):
        for name in KERNEL_NAMES:
            if not result[name].get(rate, {}).get("launches"):
                raise AssertionError(f"{name} not launched at {rate} Hz")
    summary = {
        "cases": len(matrix),
        "max_flip_rate": max(r["flip_rate"] for r in matrix.values()),
        "max_lsb": max(r["max_lsb"] for r in matrix.values()),
        "full_size": full, "torture": torture, "flac_streams": flac_checked}
    print(f"[conformance] {len(matrix)} rate x channel cases, worst flip rate "
          f"{summary['max_flip_rate']:.5%}, worst {summary['max_lsb']} LSB; "
          f"every launched row count checked against plain at its rate's "
          f"tables ({sorted(RATE_LAUNCHED)} Hz)")
    return {"kernels": result, "summary": summary}


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    name, smi = phase_device()
    if argv[:1] == ["--encode-ab"] and len(argv) == 2:
        encode_ab(Path(argv[1]).resolve(), smi)
        return 0
    if argv == ["--encode-kernels-ab"]:
        encode_kernels_ab(smi)
        return 0
    if argv[:1] == ["--kernel-ab"] and len(argv) == 2:
        kernel_ab(Path(argv[1]).resolve(), smi)
        return 0
    if argv == ["--mdct-plans"]:
        phase_build(strict=False)
        mdct_plans(smi)
        return 0
    if argv == ["--f64-plans"]:
        phase_build(strict=False)
        f64_plans(smi)
        return 0
    if argv[:1] == ["--path-sweep"] and len(argv) <= 2:
        path_sweep(smi, argv[1] if len(argv) == 2 else None)
        return 0
    if argv:
        print("usage: python3 chip_smoke.py [--encode-ab OTHER_CHECKOUT | "
              "--encode-kernels-ab | --kernel-ab OTHER_CHECKOUT | "
              "--mdct-plans | --f64-plans | --path-sweep [OUT.json]]",
              file=sys.stderr)
        return 2
    record_launch_rows()
    phase_warmup()
    designs = phase_build()
    phase_native()
    tables = get_codec_tables(1024, 2048, SAMPLE_RATE, "cuda")
    pcm = make_signal()
    kern = {"imdct_window": phase_kernel(
        tables, designs["imdct_window"],
        sorted(set(path_rows(pcm)) | set(KERNEL_EDGES), reverse=True))}
    kern.update(phase_encode_kernels(
        tables, designs,
        sorted(set(encode_rows(pcm)) | set(KERNEL_EDGES), reverse=True)))
    encoded, out, launches = phase_main(pcm, smi)
    phase_cpu(pcm, encoded, out)
    phase_invariance(pcm, encoded)
    phase_quality(smi)
    flac = phase_export(encoded, out)
    phase_cli(pcm)
    phase_flac_math(out)
    phase_stream(encoded, out)
    short = phase_album(ALBUM_SECONDS[0], smi)
    items, many, outs = phase_album(ALBUM_SECONDS[1], smi)
    phase_album_export(many, outs)
    phase_album_cli(short[0])
    phase_api(pcm, encoded, out, flac, many, outs, smi)
    sharded = phase_sharded(
        {ALBUM_SECONDS[0]: short[0], ALBUM_SECONDS[1]: items}, smi)
    phase_playback(many, outs, smi)
    phase_controller(short[0], short[1])
    phase_profile(encoded, out)
    phase_play_profile(many, smi)
    phase_bench(smi)
    f64_path = phase_f64_path(smi)
    geometry = phase_geometry(smi)
    conformance = phase_conformance(smi)
    for kernel in KERNEL_NAMES:
        unchecked = LAUNCHED_ROWS[kernel] - set(kern[kernel])
        if not LAUNCHED_ROWS[kernel] or unchecked:
            raise AssertionError(f"{kernel} launched at rows "
                                 f"{sorted(unchecked)} not checked against "
                                 f"plain")
        print(f"[kernel] the paths launched {kernel} at rows "
              f"{sorted(LAUNCHED_ROWS[kernel], reverse=True)}, each checked "
              f"against the plain version above")

    # kernel: (source, what it replaces, the main path's rows to report)
    table = {
        "imdct_window": ("glc_tpu_torch/csrc/imdct_window.cu",
                         "glc_tpu/ops/pallas_kernels.py:48",
                         2 * DEFAULT_CONFIG.decode_chunk_frames),
        "mdct_rows": ("glc_tpu_torch/csrc/mdct_rows.cu",
                      "glc_tpu/ops/mdct.py:67 (XLA einsum, not a Pallas "
                      "kernel)", 2 * DEFAULT_CONFIG.encode_chunk_frames),
        "band_energy": ("glc_tpu_torch/csrc/band_energy.cu",
                        "glc_tpu/ops/psycho.py:155 (XLA einsum, not a "
                        "Pallas kernel)", 2 * DEFAULT_CONFIG.encode_chunk_frames),
    }
    entries = []
    for kernel, (source, replaces, rows) in table.items():
        _diff, ms, plain_ms, lib_ms, bound_ms, bound_by, *device = (
            kern[kernel][rows])
        entries.append({
            "name": kernel,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[kernel],
            "max_abs_err": max(k[0] for k in kern[kernel].values()),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": lib_ms,
            "rows": rows,
            "rows_checked": sorted(kern[kernel], reverse=True),
        })
        if device:
            entries[-1].update(zip(("device_ms", "device_plain_ms",
                                    "device_library_ms"), device))
        entries[-1]["geometry"] = geometry[kernel]
        entries[-1]["rates"] = conformance["kernels"][kernel]
    # the f64 path's kernels: launches from the 60 s path at F64_HOP, the
    # library call the same function's (float64 torch.matmul), the f32
    # one beside it
    for kernel, wrapper in F64_KERNELS.items():
        at = geometry[kernel][F64_HOP]
        entries.append({
            "name": kernel,
            "route": "cuda",
            "source": "glc_tpu_torch/csrc/f64_rows.cuh",
            "replaces": table[wrapper][1],
            "launches": sum(c[kernel] for c in
                            f64_path[F64_HOP]["launches"].values()),
            "max_abs_err": max(g["max_abs_err"]
                               for g in geometry[kernel].values()),
            **{key: at[key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "rows",
                "device_ms", "device_plain_ms", "cast_f64_ms")},
            "library_ms": at["library_f64_ms"],
            "device_library_ms": at["device_library_f64_ms"],
            "library_f32_ms": at["library_ms"],
            "device_library_f32_ms": at["device_library_ms"],
            "hop": F64_HOP,
            "design": designs[kernel],
            "f64_path": {hop: {"launches": {
                call: c[kernel] for call, c in r["launches"].items()},
                "walls_ms": r["walls_ms"],
                "traced": r["traced"]} for hop, r in f64_path.items()},
            "geometry": geometry[kernel],
        })
    entries[0]["sharded"] = sharded
    entries[0]["conformance"] = conformance["summary"]
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
