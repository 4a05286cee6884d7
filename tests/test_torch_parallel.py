"""The port's sharded paths (glc_tpu_torch.parallel) in torch.distributed
worlds on the CPU, against the port's serial paths and against the JAX
package's sharded functions on the same numpy-seeded inputs.

Each world starts once for the module: a gloo world of 8 ranks (mesh
2 × 4) and one of 2 ranks (mesh 1 × 2), rendezvoused through a FileStore
under pytest's tmp dir, so xdist workers never share a port.  Every rank
runs every case (`run_cases`); rank 0 also runs the port's serial
references in its own process and sends all results back, with a digest
of every rank's sharded results.  The JAX side runs here, on the 8
virtual CPU devices of tests/conftest.py; the spawned ranks import this
module, so it imports JAX only inside the tests.

Bounds, each with its reason:
- Sharded encode against the serial encode: equal, bytes and arrays.  On
  the CPU the encode's products run in fixed blocks of rows
  (ops/mdct.py::fixed_rows_matmul), so a frame's result does not depend
  on the shard it rides in, at one thread count: the ranks and the serial
  references both run with one thread.  On the card the kernels
  mdct_rows and band_energy compute each row alike at any row count.
- Against the JAX package's encodes: the pair contract (parity.py), with
  scales within rtol 1e-6 and use_raw equal.
- Decode: hops and tail within atol 1e-5 (tests/test_sharding.py), album
  streams within rtol 2e-6, atol 1e-7 of the serial decode
  (tests/test_album_sharded.py) and within 1 LSB of the JAX package's
  once both are int16.
- Round trip: mse within rtol 1e-5 of the JAX package's, and within 1e-6
  relative across meshes.

The `cuda` test runs the same cases on cuda:0 in a 2-rank gloo world.  It
skips here; on the card's machine, which has no JAX, run it with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_parallel.py
"""

import datetime
import hashlib
import multiprocessing
import os
import pickle
import sys
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent))
from utils import generate_sine_wave, generate_white_noise  # noqa: E402

from glc_tpu_torch import Decoder, Encoder, serialize_encoded  # noqa: E402
from glc_tpu_torch.codec.tables import (  # noqa: E402
    get_codec_tables, get_device_tables,
)
from glc_tpu_torch.container.schema import (  # noqa: E402
    PAIR_DTYPE, AudioHeader, EncodedAudio, FrameSet, GaplessInfo,
)
from glc_tpu_torch.io.wav import convert_f32_to_i16  # noqa: E402
from glc_tpu_torch.ops import decode as decode_ops  # noqa: E402
from glc_tpu_torch.ops import (  # noqa: E402
    decode_chunk_device, encode_chunk_device,
)
from glc_tpu_torch.ops.encode import encode_math  # noqa: E402
from glc_tpu_torch.parallel import (  # noqa: E402
    decode_album_sharded, decode_chunk_sharded, encode_album_sharded,
    encode_chunk_sharded, make_mesh, roundtrip_step_sharded,
)
from glc_tpu_torch.parallel.mesh import mesh_shape  # noqa: E402
from glc_tpu_torch.parallel.sharded import (  # noqa: E402
    Shard, check_tables, shard_device,
)
from glc_tpu_torch.parity import check_containers, dense_pair_flips  # noqa: E402

RATE = 44100
N, FRAME = 1024, 2048
# name: (ranks, mesh shape, device type)
WORLDS = {"2x4": (8, (2, 4), "cpu"), "1x2": (2, (1, 2), "cpu")}
CUDA_WORLD = (2, (1, 2), "cuda")
WORLD_TIMEOUT_S = 300


# --- inputs, from seeds, alike in every process ---

def encode_blocks():
    """tests/test_sharding.py:44-47: B = 2, K = 8, C = 2, seed 0."""
    rng = np.random.default_rng(0)
    return rng.standard_normal((2, 8, 2, FRAME), np.float32) * 0.1


def decode_inputs():
    """tests/test_sharding.py:68-77: seed 1, a raw frame at k = 3, a
    random carry."""
    rng = np.random.default_rng(1)
    B, K, C = 2, 8, 2
    q = rng.integers(-2000, 2000, (B, K, C, N)).astype(np.int16)
    scales = rng.random((B, K, C)).astype(np.float32) + 0.1
    raw = np.zeros((B, K, C, FRAME), np.int16)
    is_raw = np.zeros((B, K), bool)
    is_raw[:, 3] = True
    raw[:, 3] = rng.integers(-3000, 3000, (B, C, FRAME)).astype(np.int16)
    carry = rng.standard_normal((B, C, N)).astype(np.float32)
    return q, scales, raw, is_raw, carry


def roundtrip_inputs():
    """tests/test_sharding.py:97-100: seed 2, C = 1."""
    rng = np.random.default_rng(2)
    blocks = rng.standard_normal((2, 8, 1, FRAME), np.float32) * 0.1
    return blocks, np.zeros((2, 1, N), np.float32)


def album():
    """tests/test_album_sharded.py:30-35: three stereo tracks of 0.3, 0.5
    and 0.2 s, the last one noise (raw-PCM path)."""
    return [generate_sine_wave(440.0, RATE, 2, 0.3),
            generate_sine_wave(660.0, RATE, 2, 0.5),
            generate_white_noise(RATE, 2, 0.2, 99) * np.float32(0.5)]


def short_album():
    """tests/test_review_regressions.py:58-59: a 0.3 s track and one
    shorter than a frame."""
    return [generate_sine_wave(660.0, RATE, 2, 0.3),
            generate_sine_wave(440.0, RATE, 2, 0.002)]


def hostile_container():
    """A mono container whose frame 1 holds 300 pairs on 8 positions (the
    last of each position must win) and an out-of-range k (skipped,
    codec.rs:661), beside a well-formed frame: the album decode scatters
    as the serial decode does."""
    rng = np.random.default_rng(4)
    F, dup = 3, 300
    nnz = np.zeros((F, 1), np.int64)
    nnz[1, 0] = dup + 1
    nnz[2, 0] = 4
    pairs = np.zeros(dup + 5, PAIR_DTYPE)
    pairs["k"][:dup] = rng.integers(0, 8, dup)
    pairs["q"][:dup] = rng.integers(-3000, 3000, dup)
    pairs["k"][dup] = N + 7  # out of range
    pairs["q"][dup] = 999
    pairs["k"][dup + 1 :] = [1, 2, 3, 4]
    pairs["q"][dup + 1 :] = [100, -100, 50, -50]
    fs = FrameSet(nnz, pairs, np.ones((F, 1), np.float32), np.zeros(F, bool),
                  np.empty((0, FRAME), np.int16))
    return EncodedAudio(AudioHeader(RATE, 1, 4096), fs,
                        GaplessInfo(512, 0, 4096))


def _np(ts):
    return tuple(t.cpu().numpy() for t in ts)


# --- the ranks ---

def run_cases(world: int, device_type: str) -> dict:
    """Every case on this rank.  Returns {"sharded": ..., "serial": ...,
    "rows": ..., "sub": ...}: "sharded" holds what every rank must agree
    on; "serial" the port's serial references (rank 0 only); "rows" the
    row counts of this rank's imdct_window calls per case; "sub" the
    results on a mesh of the first two ranks (None on the others)."""
    rank = dist.get_rank()
    sharded, serial, rows = {}, {}, {}
    mesh = make_mesh(world, device_type=device_type)
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device_type == "cuda" else torch.device("cpu")
    tables = get_codec_tables(N, FRAME, RATE, dev)
    seen = []
    wrapper = decode_ops.imdct_window

    def recorded(coeffs, *args):
        seen.append(coeffs.shape[0])
        return wrapper(coeffs, *args)

    decode_ops.imdct_window = recorded

    def record(name, fn):
        seen.clear()
        out = fn()
        rows[name] = list(seen)
        return out

    def error(fn):
        try:
            fn()
        except ValueError as e:
            return str(e)
        return None

    sharded["mesh"] = (tuple(mesh.shape), mesh.mesh_dim_names,
                       mesh.device_type)
    sharded["mesh_errors"] = (error(lambda: make_mesh(world + 1)),
                              error(lambda: make_mesh(world, shape=(3, 3))))
    blocks = encode_blocks()
    sharded["encode"] = _np(encode_chunk_sharded(mesh, blocks, tables))
    sharded["encode_error"] = error(lambda: encode_chunk_sharded(
        mesh, encode_blocks()[:, :7], tables))
    dec = decode_inputs()
    sharded["decode"] = _np(record("decode", lambda: decode_chunk_sharded(
        mesh, *dec, tables)))
    rt_blocks, rt_carry = roundtrip_inputs()
    mse, hops = record("roundtrip", lambda: roundtrip_step_sharded(
        mesh, rt_blocks, rt_carry, tables))
    sharded["roundtrip"] = (float(mse), hops.cpu().numpy())
    tracks = album()
    sharded["album_encode"] = [serialize_encoded(ea) for ea in
                               encode_album_sharded(mesh, tracks, 2, RATE)]
    enc = Encoder(RATE, device=dev)
    encoded = [enc.encode(s, 2) for s in tracks]
    sharded["album_decode"] = record("album_decode", lambda: (
        decode_album_sharded(mesh, encoded)))
    sharded["album_roundtrip_lengths"] = [len(o) for o in decode_album_sharded(
        mesh, encode_album_sharded(mesh, tracks, 2, RATE))]
    mono = [Encoder(r, device=dev).encode(
        generate_sine_wave(440.0, r, 1, 0.2), 1) for r in (RATE, 48000)]
    sharded["album_format_error"] = error(
        lambda: decode_album_sharded(mesh, mono))
    sharded["album_subsets"] = [
        [serialize_encoded(ea) for ea in encode_album_sharded(mesh, t, 2, RATE)]
        for t in ([tracks[0]], tracks[:3])]
    sharded["album_short"] = [
        serialize_encoded(ea) for ea in
        encode_album_sharded(mesh, short_album(), 2, RATE)]
    sharded["album_hostile"] = decode_album_sharded(mesh, [hostile_container()])

    # a mesh of the first two ranks; the others are not in it
    sub_mesh = make_mesh(2, device_type=device_type)
    if rank < 2:
        sub = float(roundtrip_step_sharded(sub_mesh, rt_blocks, rt_carry,
                                           tables)[0])
    else:
        sub = error(lambda: roundtrip_step_sharded(sub_mesh, rt_blocks,
                                                   rt_carry, tables))
    decode_ops.imdct_window = wrapper

    if rank == 0:
        serial_dec = Decoder(2, RATE, device=dev)
        serial["encode"] = _np(encode_math(
            torch.from_numpy(blocks.reshape(-1, 2, FRAME)).to(dev),
            tables.cos_table, tables.window, tables.norm, tables.band_mask,
            tables.band_inv_count, tables.band_pf, tables.band_of,
            tables.inv_w))
        q, scales, raw, is_raw, carry = dec
        per_stream = []
        for b in range(q.shape[0]):
            idx = np.flatnonzero(is_raw[b])
            out, _new = decode_ops.decode_stacked(
                torch.from_numpy(q[b]).to(dev),
                torch.from_numpy(scales[b]).to(dev),
                torch.from_numpy(idx).to(dev),
                torch.from_numpy(raw[b][idx]).to(dev),
                torch.from_numpy(carry[b : b + 1]).to(dev), [q.shape[1]],
                True, tables)
            per_stream.append(out.cpu().numpy())
        serial["decode"] = (np.stack([o[:-1] for o in per_stream]),
                            np.stack([o[-1] for o in per_stream]))
        # tests/test_sharding.py's single-device references
        dtabs = get_device_tables(N, FRAME, RATE, dev)
        serial["encode_chunk_device"] = _np(encode_chunk_device(
            blocks.reshape(-1, 2, FRAME), *dtabs))
        per_stream = [_np(decode_chunk_device(
            q[b], scales[b], raw[b], is_raw[b], carry[b], q.shape[1],
            *dtabs[:3])) for b in range(q.shape[0])]
        serial["decode_chunk_device"] = tuple(np.stack(t)
                                              for t in zip(*per_stream))
        serial["album_encode"] = [serialize_encoded(ea) for ea in encoded]
        serial["album_decode"] = [serial_dec.decode(ea) for ea in encoded]
        serial["album_short"] = [serialize_encoded(enc.encode(s, 2))
                                 for s in short_album()]
        serial["album_hostile"] = [Decoder(1, RATE, device=dev).decode(
            hostile_container())]
    return {"sharded": sharded, "serial": serial, "rows": rows, "sub": sub}


def _rank_main(rank: int, world: int, device_type: str, out_dir: str) -> None:
    out = Path(out_dir)
    try:
        torch.set_num_threads(1)
        if device_type == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(
            "gloo", store=dist.FileStore(str(out / "store"), world),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=120))
        try:
            res = run_cases(world, device_type)
            digest = hashlib.sha256(pickle.dumps(res["sharded"])).hexdigest()
            digests = [None] * world
            dist.all_gather_object(digests, digest)
            subs = [None] * world
            dist.all_gather_object(subs, res["sub"])
            res.update(digests=digests, subs=subs)
        finally:
            dist.destroy_process_group()
        if rank == 0:
            (out / "results.pkl").write_bytes(pickle.dumps(res))
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def start_world(spec, out_dir: Path):
    """Spawn the ranks of a world; returns them, running."""
    world, _shape, device_type = spec
    out_dir.mkdir(parents=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, device_type, str(out_dir)))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def finish_world(procs, out_dir: Path) -> dict:
    """Join the ranks (killing any left after WORLD_TIMEOUT_S) and return
    rank 0's results; raise if a rank failed."""
    for p in procs:
        p.join(WORLD_TIMEOUT_S)
    hung = [i for i, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errs = {f.name: f.read_text() for f in sorted(out_dir.glob("*.err"))}
    codes = [p.exitcode for p in procs]
    if hung or errs or any(codes):
        raise AssertionError(f"world in {out_dir} failed: hung ranks {hung}, "
                             f"exit codes {codes}\n" + "\n".join(
                                 f"{k}:\n{v}" for k, v in errs.items()))
    return pickle.loads((out_dir / "results.pkl").read_bytes())


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """name -> rank 0's results, both worlds run side by side."""
    base = tmp_path_factory.mktemp("worlds")
    started = {name: start_world(spec, base / name)
               for name, spec in WORLDS.items()}
    return {name: finish_world(procs, base / name)
            for name, procs in started.items()}


@pytest.fixture(scope="module")
def jax_results():
    """world name -> the JAX package's sharded results on its mesh."""
    import jax

    from glc_tpu.codec.tables import get_device_tables
    from glc_tpu.parallel import (
        decode_chunk_sharded as jdecode,
        encode_album_sharded as jencode_album,
        encode_chunk_sharded as jencode,
        make_mesh as jmake_mesh,
        roundtrip_step_sharded as jroundtrip,
    )

    assert len(jax.devices()) >= 8
    tables = get_device_tables(N, FRAME, RATE)
    tracks = album()
    out = {}
    for name, (world, _shape, _dev) in WORLDS.items():
        mesh = jmake_mesh(world)
        mse, hops = jroundtrip(mesh, *roundtrip_inputs(), tables)
        out[name] = {
            "encode": tuple(np.asarray(t) for t in
                            jencode(mesh, encode_blocks(), tables)),
            "decode": tuple(np.asarray(t) for t in
                            jdecode(mesh, *decode_inputs(), tables)),
            "roundtrip": (float(mse), np.asarray(hops)),
            "album_encode": jencode_album(mesh, tracks, 2, RATE),
            "mesh": mesh,
        }
    return out


def _containers(blobs):
    from glc_tpu_torch import deserialize_encoded

    return [deserialize_encoded(b) for b in blobs]


PARAM_WORLDS = pytest.mark.parametrize("name", list(WORLDS))


# --- mesh ---

@pytest.mark.parametrize("n", range(1, 10))
def test_mesh_shape_rule(n):
    """The pure shape rule against the JAX rule (glc_tpu/parallel/
    mesh.py:33-44), for every n, one axis, and explicit shapes."""
    want = (2, n // 2) if n % 2 == 0 and n >= 4 else (1, n)
    assert mesh_shape(n) == want
    assert mesh_shape(n, ("frames",)) == (n,)
    assert mesh_shape(n, shape=(1, n)) == (1, n)
    with pytest.raises(ValueError, match="does not cover"):
        mesh_shape(n, shape=(n + 1, 1))


def test_mesh_shape_rule_matches_jax():
    from glc_tpu.parallel import make_mesh as jmake_mesh

    for n in range(1, 9):
        assert tuple(jmake_mesh(n).devices.shape) == mesh_shape(n)
    assert tuple(jmake_mesh(8, shape=(4, 2)).devices.shape) == mesh_shape(
        8, shape=(4, 2))


def test_make_mesh_needs_a_world():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(2, device_type="cpu")


def test_cuda_mesh_never_computes_on_the_cpu(monkeypatch):
    """A CUDA mesh in a process without a card raises, and a shard on the
    card refuses CPU tables: no step falls back to the CPU."""
    class CudaMesh:
        device_type = "cuda"

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shard_device(CudaMesh())
    on_card = Shard(0, 1, 0, 2, torch.device("cuda", 0))
    with pytest.raises(ValueError, match="the tables are on cpu"):
        check_tables(get_codec_tables(N, FRAME, RATE, "cpu"), on_card)


@PARAM_WORLDS
def test_mesh_shapes(worlds, name):
    """tests/test_sharding.py:37-41 in each world, and both errors."""
    res = worlds[name]
    world, shape, _dev = WORLDS[name]
    assert res["sharded"]["mesh"] == (shape, ("data", "frames"), "cpu")
    too_many, bad_shape = res["sharded"]["mesh_errors"]
    assert too_many == f"requested {world + 1} devices, only {world} present"
    assert bad_shape == f"mesh shape (3, 3) does not cover {world} devices"


@PARAM_WORLDS
def test_every_rank_gets_the_same_results(worlds, name):
    digests = worlds[name]["digests"]
    assert len(digests) == WORLDS[name][0] and len(set(digests)) == 1


@PARAM_WORLDS
def test_mesh_of_the_first_ranks(worlds, name):
    """make_mesh(2) holds ranks 0 and 1, as JAX takes the first devices:
    they compute on it (the mse of the full mesh's, the sums being
    float64), and the other ranks are refused."""
    res = worlds[name]
    subs = res["subs"]
    full = res["sharded"]["roundtrip"][0]
    assert subs[0] == subs[1]
    assert abs(subs[0] - full) <= 1e-6 * full
    assert subs[2:] == [f"rank {r} is not in the mesh"
                        for r in range(2, len(subs))]


# --- sharded steps (tests/test_sharding.py) ---

@PARAM_WORLDS
def test_sharded_encode_matches_serial(worlds, name):
    """Exact against the port's encode_math on the flattened blocks, at
    any shard size (2x4: 4 rows a rank against 32; 1x2: 16)."""
    res = worlds[name]
    for got, want in zip(res["sharded"]["encode"], res["serial"]["encode"],
                         strict=True):
        assert np.array_equal(got.reshape(want.shape), want)
    assert "not divisible by the 'frames' axis" in res["sharded"][
        "encode_error"]


@PARAM_WORLDS
def test_sharded_encode_matches_encode_chunk_device(worlds, name):
    """tests/test_sharding.py:44-65 on the port: the sharded encode equals
    the single-device chunk program on the flattened stream axis, exactly
    (the encode's products are row-invariant, module docstring)."""
    res = worlds[name]
    for got, want in zip(res["sharded"]["encode"],
                         res["serial"]["encode_chunk_device"], strict=True):
        assert np.array_equal(got.reshape(want.shape), want)


@PARAM_WORLDS
def test_sharded_decode_matches_decode_chunk_device(worlds, name):
    """tests/test_sharding.py:67-88 on the port: each stream of the sharded
    decode against `decode_chunk_device` with its carry, hops and tail
    within atol 1e-5, that test's bound."""
    hops, tail = worlds[name]["sharded"]["decode"]
    want_hops, want_tail = worlds[name]["serial"]["decode_chunk_device"]
    np.testing.assert_allclose(hops, want_hops, atol=1e-5)
    np.testing.assert_allclose(tail, want_tail, atol=1e-5)


@PARAM_WORLDS
def test_sharded_encode_matches_jax(worlds, jax_results, name):
    q, nnz, scale, raw, use_raw = worlds[name]["sharded"]["encode"]
    jq, jnnz, jscale, jraw, juse_raw = jax_results[name]["encode"]
    assert q.shape == jq.shape and q.dtype == jq.dtype == np.int16
    np.testing.assert_array_equal(use_raw, juse_raw)
    np.testing.assert_allclose(scale, jscale, rtol=1e-6)
    np.testing.assert_array_equal(raw, jraw)
    flips = dense_pair_flips(q, jq)
    assert flips["max_dq"] <= 1 and flips["rate"] <= 0.01
    assert np.array_equal(nnz, (q != 0).sum(-1))
    assert np.array_equal(jnnz, (jq != 0).sum(-1))


@PARAM_WORLDS
def test_sharded_decode_matches_serial_and_jax(worlds, jax_results, name):
    """One imdct_window call a rank, on Bl·Kl·C rows."""
    res = worlds[name]
    hops, tail = res["sharded"]["decode"]
    s_hops, s_tail = res["serial"]["decode"]
    j_hops, j_tail = jax_results[name]["decode"]
    for want_hops, want_tail in ((s_hops, s_tail), (j_hops, j_tail)):
        np.testing.assert_allclose(hops, want_hops, atol=1e-5)
        np.testing.assert_allclose(tail, want_tail, atol=1e-5)
    d, f = WORLDS[name][1]
    assert res["rows"]["decode"] == [(2 // d) * (8 // f) * 2]


@PARAM_WORLDS
def test_roundtrip_step(worlds, jax_results, name):
    res = worlds[name]
    mse, hops = res["sharded"]["roundtrip"]
    j_mse, j_hops = jax_results[name]["roundtrip"]
    assert np.isfinite(mse) and hops.shape == (2, 8, 1, N)
    np.testing.assert_allclose(mse, j_mse, rtol=1e-5)
    np.testing.assert_allclose(hops, j_hops, atol=1e-5)
    d, f = WORLDS[name][1]
    assert res["rows"]["roundtrip"] == [(2 // d) * (8 // f)]


def test_roundtrip_mse_is_mesh_independent(worlds):
    a, b = (worlds[name]["sharded"]["roundtrip"][0] for name in WORLDS)
    assert abs(a - b) <= 1e-6 * a


# --- album (tests/test_album_sharded.py, test_review_regressions.py) ---

@PARAM_WORLDS
def test_album_encode_matches_serial(worlds, name):
    res = worlds[name]
    assert res["sharded"]["album_encode"] == res["serial"]["album_encode"]


@PARAM_WORLDS
def test_album_encode_matches_jax(worlds, jax_results, name):
    got = _containers(worlds[name]["sharded"]["album_encode"])
    for ea, jea in zip(got, jax_results[name]["album_encode"], strict=True):
        check_containers(ea, jea)


@PARAM_WORLDS
def test_album_decode_matches_serial_and_jax(worlds, jax_results, name):
    """The port's serial containers, decoded sharded by both packages."""
    import glc_tpu
    from glc_tpu.parallel import decode_album_sharded as jdecode_album

    res = worlds[name]
    outs = res["sharded"]["album_decode"]
    jouts = jdecode_album(jax_results[name]["mesh"], [
        glc_tpu.deserialize_encoded(b) for b in res["serial"]["album_encode"]])
    for out, want, jout, src in zip(outs, res["serial"]["album_decode"],
                                    jouts, album(), strict=True):
        assert len(out) == len(src)
        np.testing.assert_allclose(out, want, rtol=2e-6, atol=1e-7)
        lsb = np.abs(convert_f32_to_i16(out).astype(np.int32)
                     - convert_f32_to_i16(np.asarray(jout)).astype(np.int32))
        assert lsb.max() <= 1
    # one launch a rank, on its [Bl, Kl] block of the album: 3 tracks
    # padded to the 'data' axis, K = 32 (22 frames at most)
    d, f = WORLDS[name][1]
    assert res["rows"]["album_decode"] == [-(-3 // d) * (32 // f) * 2]


@PARAM_WORLDS
def test_album_roundtrip_gapless_lengths(worlds, name):
    lengths = worlds[name]["sharded"]["album_roundtrip_lengths"]
    assert lengths == [len(s) for s in album()]


@PARAM_WORLDS
def test_album_mismatched_format_rejected(worlds, name):
    assert worlds[name]["sharded"]["album_format_error"] == (
        "album tracks must share sample rate/channels")


@PARAM_WORLDS
def test_album_single_track_and_nondivisible_batch(worlds, name):
    res = worlds[name]
    serial = res["serial"]["album_encode"]
    single, three = res["sharded"]["album_subsets"]
    assert single == serial[:1] and three == serial


@PARAM_WORLDS
def test_album_sharded_short_track(worlds, name):
    res = worlds[name]
    assert res["sharded"]["album_short"] == res["serial"]["album_short"]


@PARAM_WORLDS
def test_album_decode_hostile_container(worlds, name):
    """Duplicate pairs last-wins and an out-of-range k skipped, as the
    serial decode does."""
    res = worlds[name]
    (out,), (want,) = (res["sharded"]["album_hostile"],
                       res["serial"]["album_hostile"])
    assert len(out) == len(want) == 3584
    np.testing.assert_allclose(out, want, rtol=2e-6, atol=1e-7)


# --- on the card ---

@pytest.mark.cuda
def test_cuda_sharded_cases(tmp_path):
    """The cases above on cuda:0 in a 2-rank gloo world (the halo and the
    gathers through host memory, the shards on the card with the hand
    kernels).  Decode: within the bounds above.  Encode: bytes equal to
    the serial encode, as on the CPU (the encode's kernels compute each
    row alike at a shard's row count and at a segment's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = finish_world(start_world(CUDA_WORLD, tmp_path / "w"), tmp_path / "w")
    sh, se = res["sharded"], res["serial"]
    assert len(set(res["digests"])) == 1
    assert sh["mesh"] == ((1, 2), ("data", "frames"), "cuda")
    hops, tail = sh["decode"]
    np.testing.assert_allclose(hops, se["decode"][0], atol=1e-5)
    np.testing.assert_allclose(tail, se["decode"][1], atol=1e-5)
    assert np.isfinite(sh["roundtrip"][0])
    for got, want in zip(sh["encode"], se["encode"], strict=True):
        np.testing.assert_array_equal(got.reshape(want.shape), want)
    for got, want in zip(sh["encode"], se["encode_chunk_device"],
                         strict=True):
        np.testing.assert_array_equal(got.reshape(want.shape), want)
    np.testing.assert_allclose(hops, se["decode_chunk_device"][0], atol=1e-5)
    np.testing.assert_allclose(tail, se["decode_chunk_device"][1], atol=1e-5)
    for got, want in zip(sh["album_encode"] + sh["album_short"],
                         se["album_encode"] + se["album_short"], strict=True):
        assert got == want
    for out, want in zip(sh["album_decode"] + sh["album_hostile"],
                         se["album_decode"] + se["album_hostile"],
                         strict=True):
        np.testing.assert_allclose(out, want, rtol=2e-6, atol=1e-7)
    assert sh["album_roundtrip_lengths"] == [len(s) for s in album()]
    assert res["rows"]["decode"] == [8 * 2]
