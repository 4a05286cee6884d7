"""A bank of short mono clips through `Decoder.decode_many`: the stacked
single-chunk groups (one pass and one `imdct_window` launch for every
clip of a chunk-size rung) against the benchmark's plain reference decoder
(`glcbench/reference_decode.py`: plain torch, IMDCT sums in float64), on
the CPU, and the groups on the ``stats=`` hook and the profiler.

The bank: seeded mono clips of 0.3 s to 13 s on four rungs of
`chunk_size_for` (three of them share the 128-frame rung), a clip of
exactly the 1408-frame decode chunk (the largest single-chunk clip) and one
of 1409 frames (two chunks, so the multi-chunk pipeline runs in the same
call), and a clip of white noise, whose every frame falls back to raw PCM.
The containers are written by the reference encoder (`glcbench/
reference.py`, float64), so the bytes do not depend on the port's encoder.

Limits, each with its reason:

- Every clip exactly as long as the reference's: the gapless trim.
- `lsb_mismatch_share` ≤ 0.01: the port's float32 product and the
  reference's float64 sums put a sample on the other side of an integer
  about once in 1000-2000 samples (0.0005-0.001 on this bank); 0.01 leaves
  ten times that.  The raw clip is exact.
- `max_lsb` ≤ 1: one rounding of the float32 sum moves a sample by at most
  one step.

The reference with TF32 operands (its ``"tf32"`` control, one step below
float32) fails both on every clip that codes an IMDCT frame.

The `cuda` case skips here; on the card's machine, which has no JAX, run
it with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_bank.py
"""

import dataclasses
import json
import types
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import profile

import glc_tpu_torch as glc
from glc_tpu_torch import profiling
from glc_tpu_torch.codec import device as device_mod
from glc_tpu_torch.codec.decoder import GROUP_KEYS, PAIR_KEYS, STATS_KEYS
from glc_tpu_torch.codec.tables import chunk_size_for
from glcbench import compare_decode, material, reference, reference_decode

RATE = 44100
HOP = 1024
CHUNK = 1408
SEED = 2**31 + 2021
CLIP_SECONDS = (0.3, 1.0, 2.5, 3.5, 7.0, 13.0)
EDGE_FRAMES = (CHUNK, CHUNK + 1)
LIMITS = {"lsb_mismatch_share": 0.01, "max_lsb": 1.0}
UPLOADS_PER_PASS = 5
CONFIG = Path(__file__).resolve().parent.parent / "glcbench" / "configs" \
    / "cd_stereo_44k1.json"


def clips() -> list:
    """The bank's int16 PCM, mono: the seeded clips, the two clips at the
    chunk's edge (F·1024 samples make F frames), the noise clip."""
    pcm = [material.to_pcm(material.track(s, RATE, ["C"], SEED, i, "cpu"), 16)
           for i, s in enumerate(CLIP_SECONDS)]
    pcm += [material.to_pcm(material.track(F * HOP / RATE, RATE, ["C"], SEED,
                                           len(pcm) + j, "cpu"), 16)
            for j, F in enumerate(EDGE_FRAMES)]
    g = torch.Generator().manual_seed(SEED)
    noise = (torch.randn(RATE, generator=g) * 8000).clamp(-32768, 32767)
    return pcm + [noise.to(torch.int16).numpy()]


@pytest.fixture(scope="module")
def pcm():
    torch.set_num_threads(4)
    return clips()


def codec_of(compat: bool) -> reference.Codec:
    cfg = json.loads(CONFIG.read_text())
    return dataclasses.replace(reference.Codec.from_config(cfg),
                               reference_compat=compat)


@pytest.fixture(scope="module", params=[True, False],
                ids=["compat", "clean"])
def bank(request, pcm):
    """(codec, the containers' bytes) in one ``reference_compat`` mode."""
    codec = codec_of(request.param)
    return codec, [reference.write_container(reference.encode(
        torch.from_numpy(x), 1, RATE, codec)) for x in pcm]


def decoder(codec, device) -> glc.Decoder:
    config = glc.CodecConfig(reference_compat=codec.reference_compat)
    assert config.decode_chunk_frames == CHUNK
    return glc.Decoder(1, RATE, config=config, device=device)


def frames(data: bytes) -> int:
    return glc.deserialize_encoded(data).frame_set.num_frames


def test_the_bank_covers_the_rungs_the_edges_and_raw_frames(bank):
    codec, datas = bank
    F = [frames(d) for d in datas]
    rungs = [chunk_size_for(f, CHUNK) for f in F]
    assert F[0] <= 13 and F[-3:-1] == list(EDGE_FRAMES)
    assert Counter(rungs)[128] >= 3 and len(set(rungs)) >= 5
    assert F[-3] == rungs[-3] and F[-2] > rungs[-2]
    raw = reference.read_container(datas[-1]).raw_mask
    assert raw.all()


def worst(outs, datas, codec, precision="f64") -> dict:
    """Each number of `compare_decode`, worst over the bank; a clip of
    another length than the reference's reads the worst."""
    return compare_decode.worst_of([
        compare_decode.decoded_numbers(out, reference_decode.decode_i16(
            d, codec, precision)) for out, d in zip(outs, datas)])


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_decode_many_matches_the_reference(bank, device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    codec, datas = bank
    dec = decoder(codec, device)
    outs = dec.decode_many([glc.deserialize_encoded(d) for d in datas])
    for out, d in zip(outs, datas, strict=True):
        ref = reference_decode.decode_i16(d, codec)
        assert out.dtype == np.int16 and out.shape == ref.shape
    nums = worst(outs, datas, codec)
    assert all(nums[k] <= LIMITS[k] for k in LIMITS), nums
    # the noise clip's raw frames (quirks Q4, Q13) and its trim (Q1) exactly
    np.testing.assert_array_equal(
        outs[-1], reference_decode.decode_i16(datas[-1], codec))


def test_the_tf32_control_fails_a_limit(bank):
    codec, datas = bank
    control = [reference_decode.decode_i16(d, codec, "tf32") for d in datas]
    nums = worst(control, datas, codec)
    assert any(nums[k] > LIMITS[k] for k in LIMITS), nums
    for c, d in zip(control[:-1], datas[:-1]):  # every clip with IMDCT frames
        one = compare_decode.decoded_numbers(
            c, reference_decode.decode_i16(d, codec))
        assert all(one[k] > LIMITS[k] for k in LIMITS), one


def expected_counts(datas) -> dict:
    """The hook's counts worked out from the clips' frame counts and
    rungs: a group a (channels, rung) of single-chunk clips, a pass a group
    and a chunk of the multi-chunk clips, 5 uploads and 1 download a
    pass; and every pair of the containers handed to the card once."""
    F = [frames(d) for d in datas]
    single = [f for f in F if f <= chunk_size_for(f, CHUNK)]
    groups = len({chunk_size_for(f, CHUNK) for f in single})
    chunks = sum(-(-f // chunk_size_for(f, CHUNK)) for f in F
                 if f > chunk_size_for(f, CHUNK))
    return {"up_n": UPLOADS_PER_PASS * (groups + chunks),
            "down_n": groups + chunks, "group_n": groups,
            "group_tracks_n": len(single), "group_rows_n": sum(single),
            "pairs_n": sum(len(glc.deserialize_encoded(d).frame_set.pairs)
                           for d in datas)}


def test_the_hook_counts_the_groups_and_changes_no_byte(bank):
    codec, datas = bank
    dec = decoder(codec, "cpu")
    eas = [glc.deserialize_encoded(d) for d in datas]
    plain = dec.decode_many(eas)
    stats: dict = {}
    got = dec.decode_many(eas, stats=stats)
    for a, b in zip(got, plain, strict=True):
        assert a.tobytes() == b.tobytes()
    assert set(stats) == set(STATS_KEYS + PAIR_KEYS + GROUP_KEYS)
    want = expected_counts(datas)
    assert {k: stats[k] for k in want} == want
    assert want["group_n"] >= 5 and want["down_n"] > want["group_n"]
    assert all(stats[k] > 0 for k in ("pack_ms", "disp_ms", "wait_ms"))
    # one dict sums two calls
    dec.decode_many(eas, stats=stats)
    assert {k: stats[k] for k in want} == {k: 2 * v for k, v in want.items()}


@pytest.mark.parametrize("with_stats", [False, True])
def test_the_groups_are_spans_under_a_profiler(bank, with_stats):
    """A group packs once, dispatches twice (the uploads and launch; the
    download) and waits once, as a chunk of the multi-chunk clip does."""
    codec, datas = bank
    dec = decoder(codec, "cpu")
    eas = [glc.deserialize_encoded(d) for d in datas]
    plain = dec.decode_many(eas)
    with profile() as prof:
        got = dec.decode_many(eas, stats={} if with_stats else None)
    for a, b in zip(got, plain, strict=True):
        np.testing.assert_array_equal(a, b)
    names = Counter(e.name for e in prof.events()
                    if e.name.startswith("glc."))
    passes = expected_counts(datas)["down_n"]
    assert names == {"glc.decode.pack": passes,
                     "glc.decode.disp": 2 * passes,
                     "glc.decode.wait": passes}


def test_without_the_hook_or_a_profiler_no_clock_is_read(bank, monkeypatch):
    codec, datas = bank
    dec = decoder(codec, "cpu")
    eas = [glc.deserialize_encoded(d) for d in datas]
    plain = dec.decode_many(eas)

    def boom(*_a, **_k):
        raise AssertionError("a stage read the clock or opened a span")

    monkeypatch.setattr(profiling, "stage", boom)
    monkeypatch.setattr(device_mod, "time",
                        types.SimpleNamespace(perf_counter=boom))
    for a, b in zip(dec.decode_many(eas), plain, strict=True):
        np.testing.assert_array_equal(a, b)
