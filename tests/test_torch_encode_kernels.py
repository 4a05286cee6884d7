"""The encode's two kernels (glc_tpu_torch.ops.kernels.mdct_rows and
band_energy) against the JAX package's einsums, and the encode's
independence of how the frames are cut into segments, on both packages.

`mdct_rows` replaces the XLA einsum of glc_tpu/ops/mdct.py:67 and
`band_energy` the one of glc_tpu/ops/psycho.py:155.  On the CPU each
wrapper computes its plain version, and the CPU encode runs its products
in fixed row blocks (ops/mdct.py::fixed_rows_matmul); the tests here hold
the plain versions to the JAX package, a CPU model of band_energy's
compensated in-order sum to the plain version and to float64, the
wrappers' input checks, and tests/test_chunking.py's encode cases on both
packages.  Bounds, each with its reason:
- mdct_rows_reference against the JAX mdct: atol = rtol = 2e-5, the bar of
  tests/test_pallas.py (both are full-f32 products, summed in other
  orders);
- band_energy_reference against the JAX einsum: rtol 1e-5 (sums of
  squares are positive, so no cancellation);
- the port's container against itself at other segment sizes: bytes
  equal; against the JAX package's: the pair contract (parity.py).

The tests marked `cuda` run the kernels and need a card: they skip here.
On the card's machine, which has no JAX, run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_encode_kernels.py

(this module imports the JAX package only inside the tests that use it).
"""

import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from utils import generate_frequency_sweep, generate_white_noise  # noqa: E402

import glc_tpu_torch  # noqa: E402,F401  (full-f32 matmul settings)
from glc_tpu_torch import DEFAULT_CONFIG, Encoder, serialize_encoded  # noqa: E402
from glc_tpu_torch.codec.tables import get_codec_tables  # noqa: E402
from glc_tpu_torch.ops import kernels  # noqa: E402
from glc_tpu_torch.ops.kernels import (  # noqa: E402
    band_energy, band_energy_reference, band_ranges, cos_split, mdct_rows,
    mdct_rows_reference, split_tf32, table_split,
)
from glc_tpu_torch.parity import check_containers  # noqa: E402

N, FRAME, RATE = 1024, 2048, 44100
TOL = 2e-5
ROWS = [1, 63, 129, 1292]
EDGES = [1, 63, 64, 65, 127, 128, 129, 1000, 8192]
CHUNKS = [4096, 512, 1000]  # tests/test_chunking.py's two, and a ragged one


@pytest.fixture(scope="module")
def tables():
    return get_codec_tables(N, FRAME, RATE, "cpu")


def _win(M: int, tb, seed: int = 0) -> torch.Tensor:
    """Windowed blocks [M, 2n]: seeded normal samples times the window."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((M, FRAME)) * 0.1).astype(np.float32)
    return torch.from_numpy(x) * tb.window.cpu()


def _coeffs(M: int, seed: int = 1) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal((M, N)) * 0.05)
                            .astype(np.float32))


# --- the plain versions against the JAX package ---

@pytest.mark.parametrize("M", ROWS)
def test_mdct_rows_reference_matches_jax_mdct(tables, M):
    from glc_tpu.ops.mdct import get_mdct_tables, mdct

    mt = get_mdct_tables(N, FRAME)
    win = _win(M, tables, seed=M)
    want = np.asarray(mdct(win.numpy(), mt.cos_table, mt.norm))
    got = mdct_rows_reference(win, tables.cos_table, tables.norm)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    # the wrapper takes the plain version on the CPU, and launches nothing
    before = mdct_rows.launches
    assert torch.equal(mdct_rows(win, tables.cos_table, tables.norm), got)
    assert mdct_rows.launches == before


@pytest.mark.parametrize("M", ROWS)
def test_band_energy_reference_matches_jax_einsum(tables, M):
    import jax.numpy as jnp
    from jax.lax import Precision

    from glc_tpu.ops.psycho import get_perceptual_tables

    pt = get_perceptual_tables(N, RATE)
    c = _coeffs(M, seed=M)
    sq = c.numpy() * c.numpy()
    want = np.asarray(jnp.einsum("...n,bn->...b", sq, pt.band_mask,
                                 precision=Precision.HIGHEST))
    got = band_energy_reference(c, tables.band_mask)
    assert got.shape == (M, pt.band_mask.shape[0])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)
    before = band_energy.launches
    assert torch.equal(band_energy(c, tables.band_mask), got)
    assert band_energy.launches == before


# --- band_energy's arithmetic, modelled on the CPU ---

def band_energy_model(coeffs: np.ndarray, ranges: np.ndarray) -> np.ndarray:
    """csrc/band_energy.cu in numpy float32: each band's squares added in
    ascending k, each square and add rounded on its own, the rounding error
    of each add found by TwoSum and summed beside it."""
    f32 = np.float32
    out = np.zeros((coeffs.shape[0], len(ranges)), f32)
    for b, (lo, hi) in enumerate(ranges):
        s = np.zeros(coeffs.shape[0], f32)
        err = np.zeros(coeffs.shape[0], f32)
        for k in range(lo, hi):
            x = coeffs[:, k] * coeffs[:, k]
            t = (s + x).astype(f32)
            xv = (t - s).astype(f32)
            e = ((s - (t - xv)) + (x - xv)).astype(f32)
            err = (err + e).astype(f32)
            s = t
        out[:, b] = s + err
    return out


def test_band_ranges_are_the_band_edges(tables):
    from glc_tpu_torch.ops.psycho import get_perceptual_tables

    edges = get_perceptual_tables(N, RATE).band_edges
    r = band_ranges(tables.band_mask)
    assert r.dtype == torch.int32 and r.shape == (tables.band_mask.shape[0], 2)
    nb = len(edges) - 1
    np.testing.assert_array_equal(r[:nb, 0].numpy(), edges[:-1])
    np.testing.assert_array_equal(r[:nb, 1].numpy(), edges[1:])
    assert not r[nb:].any()  # the padding bands are empty
    assert band_ranges(tables.band_mask) is r  # made once per mask


def test_band_ranges_refuse_a_split_band(tables):
    mask = tables.band_mask.clone()
    lo, hi = band_ranges(mask)[3].tolist()
    mask[3, (lo + hi) // 2] = 0.0
    with pytest.raises(ValueError, match="run of ones"):
        band_ranges(mask)


@pytest.mark.parametrize("M", [1, 129])
def test_band_energy_model_matches_plain_and_float64(tables, M):
    c = _coeffs(M, seed=7 + M)
    model = band_energy_model(c.numpy(), band_ranges(tables.band_mask).numpy())
    plain = band_energy_reference(c, tables.band_mask).numpy()
    np.testing.assert_allclose(model, plain, rtol=1e-5, atol=0)
    exact = (c.double() ** 2 @ tables.band_mask.double().T).numpy()
    err_model = np.abs(model - exact).max()
    err_plain = np.abs(plain - exact).max()
    assert err_model <= 2 * err_plain


# --- the wrappers' checks, the same on either device ---

def _misaligned(shape) -> torch.Tensor:
    """A contiguous f32 tensor whose data starts 4 bytes past 16."""
    flat = torch.zeros(int(np.prod(shape)) + 4)
    start = next(i for i in range(1, 4) if (flat[i:].data_ptr() % 16) == 4)
    return flat[start : start + int(np.prod(shape))].view(shape)


def test_mdct_rows_rejects_bad_inputs(tables):
    table, norm = tables.cos_table, tables.norm
    good = _win(4, tables)
    bad = [
        (good.double(), table, norm, TypeError),          # dtype
        (good[:, :N].contiguous(), table, norm, ValueError),  # width
        (good.reshape(2, 2, FRAME), table, norm, ValueError),   # not rows
        (_win(8, tables)[::2], table, norm, ValueError),   # not contiguous
        (_misaligned((4, FRAME)), table, norm, ValueError),  # alignment
        (good.to("meta"), table.to("meta"), norm, ValueError),  # device
        (good, table.to("meta"), norm, ValueError),        # table elsewhere
        (good, table, norm.double(), ValueError),          # norm dtype
    ]
    for win, t, s, err in bad:
        with pytest.raises(err):
            mdct_rows(win, t, s)


def test_band_energy_rejects_bad_inputs(tables):
    mask = tables.band_mask
    good = _coeffs(4)
    bad = [
        (good.double(), mask, TypeError),                 # dtype
        (good[:, : N // 2].contiguous(), mask, ValueError),  # width
        (good[None], mask, ValueError),                   # not rows
        (_coeffs(8)[::2], mask, ValueError),              # not contiguous
        (_misaligned((4, N)), mask, ValueError),          # alignment
        (good.to("meta"), mask.to("meta"), ValueError),   # device
        (good, mask.to("meta"), ValueError),              # mask elsewhere
        (good, mask[0], ValueError),                      # mask not 2-D
    ]
    for c, m, err in bad:
        with pytest.raises(err):
            band_energy(c, m)


def test_cos_split_is_its_own_cache(tables):
    """mdct_rows reads the table's own split, imdct_window the transposed
    one; each is made once per table, and neither is the other's."""
    table = tables.cos_table.clone()
    before = (cos_split.splits, table_split.splits)
    hi, lo = cos_split(table)
    assert hi.shape == lo.shape == (N, FRAME)
    assert torch.equal(hi, split_tf32(table)[0])
    t_hi, _t_lo = table_split(table)
    assert t_hi.shape == (FRAME, N)
    assert cos_split(table)[0] is hi
    assert (cos_split.splits, table_split.splits) == (before[0] + 1,
                                                      before[1] + 1)


# --- tests/test_chunking.py's encode cases, on both packages ---

def _sweep():
    return generate_frequency_sweep(100.0, 8000.0, RATE, 1, 30.0)


def _tone_noise_tone():
    tone = generate_frequency_sweep(200.0, 2000.0, RATE, 1, 10.0)
    noise = generate_white_noise(RATE, 1, 10.0, 11)
    return np.concatenate([tone, noise, tone]).astype(np.float32)


SIGNALS = {"sweep": _sweep, "with_raw_frames": _tone_noise_tone}


@pytest.fixture(scope="module")
def chunked():
    """signal -> {encode_chunk_frames: (port container, glc_tpu container)},
    each a mono encode on the CPU."""
    from glc_tpu import CodecConfig as JaxConfig
    from glc_tpu import Encoder as JaxEncoder

    out = {}
    for name, make in SIGNALS.items():
        samples = make()
        out[name] = {
            k: (Encoder(RATE, config=replace(DEFAULT_CONFIG,
                                             encode_chunk_frames=k),
                        device="cpu").encode(samples, 1),
                JaxEncoder(RATE, config=JaxConfig(encode_chunk_frames=k))
                .encode(samples, 1))
            for k in CHUNKS}
    return out


@pytest.mark.parametrize("name", list(SIGNALS))
def test_port_encode_is_segmentation_invariant(chunked, name):
    """tests/test_chunking.py:11-32 on the port: the same bytes at every
    segment size (4096 frames: one segment; 512 and 1000: several, the
    last one ragged)."""
    ports = {k: serialize_encoded(p) for k, (p, _j) in chunked[name].items()}
    assert len(set(ports.values())) == 1
    if name == "with_raw_frames":
        assert int(chunked[name][4096][0].frame_set.raw_mask.sum()) > 0


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("name", list(SIGNALS))
def test_port_encode_matches_jax_at_segment_size(chunked, name, chunk):
    from glc_tpu import serialize_encoded as jax_serialize

    from glc_tpu_torch import deserialize_encoded

    port, jax_ea = chunked[name][chunk]
    jax_ea = deserialize_encoded(jax_serialize(jax_ea))
    flips = check_containers(port, jax_ea)
    assert flips["rate"] <= 0.01


# --- on the card ---

@pytest.fixture
def cuda_tables():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return get_codec_tables(N, FRAME, RATE, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("M", EDGES)
def test_cuda_mdct_rows_matches_plain(cuda_tables, M):
    tb = cuda_tables
    win = _win(M, tb, seed=M).cuda()
    before = mdct_rows.launches
    out = mdct_rows(win, tb.cos_table, tb.norm)
    assert mdct_rows.launches == before + 1
    ref = mdct_rows_reference(win, tb.cos_table, tb.norm)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=TOL, rtol=TOL)
    exact = (win.double() @ tb.cos_table.double().T) * tb.norm_value
    err_kernel = (out.double() - exact).abs().max().item()
    err_plain = (ref.double() - exact).abs().max().item()
    assert err_kernel <= 2 * err_plain
    # a float norm gives the same bits as the table's norm tensor
    assert torch.equal(mdct_rows(win, tb.cos_table, tb.norm_value), out)


@pytest.mark.cuda
@pytest.mark.parametrize("M", EDGES)
def test_cuda_band_energy_matches_plain(cuda_tables, M):
    tb = cuda_tables
    c = _coeffs(M, seed=M).cuda()
    before = band_energy.launches
    out = band_energy(c, tb.band_mask)
    assert band_energy.launches == before + 1
    ref = band_energy_reference(c, tb.band_mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=0)
    exact = c.double() ** 2 @ tb.band_mask.double().T
    err_kernel = (out.double() - exact).abs().max().item()
    err_plain = (ref.double() - exact).abs().max().item()
    assert err_kernel <= 2 * err_plain
    model = band_energy_model(c.cpu().numpy(),
                              band_ranges(tb.band_mask.cpu()).numpy())
    np.testing.assert_array_equal(out.cpu().numpy(), model)


@pytest.mark.cuda
def test_cuda_kernels_are_row_invariant(cuda_tables):
    """Rows taken from an 8192-row launch equal the same rows launched at
    1, 127 and 1292 rows, bit for bit, at any offset."""
    tb = cuda_tables
    win = _win(8192, tb, seed=3).cuda()
    coeffs = mdct_rows(win, tb.cos_table, tb.norm)
    sums = band_energy(coeffs, tb.band_mask)
    for M in (1, 127, 1292):
        for start in (0, 8192 - M, 4001 % (8192 - M + 1)):
            rows = slice(start, start + M)
            c = mdct_rows(win[rows].contiguous(), tb.cos_table, tb.norm)
            assert torch.equal(c, coeffs[rows])
            s = band_energy(coeffs[rows].contiguous(), tb.band_mask)
            assert torch.equal(s, sums[rows])


@pytest.mark.cuda
def test_cuda_encode_is_segmentation_invariant(cuda_tables):
    """tests/test_chunking.py's encode cases on the card: the same bytes at
    every segment size, and within the pair contract of the CPU's."""
    for name, make in SIGNALS.items():
        samples = make()
        datas = {}
        for k in CHUNKS:
            cfg = replace(DEFAULT_CONFIG, encode_chunk_frames=k)
            datas[k] = Encoder(RATE, config=cfg, device="cuda").encode(
                samples, 1)
        assert len({serialize_encoded(ea) for ea in datas.values()}) == 1, name
        cpu = Encoder(RATE, device="cpu").encode(samples, 1)
        assert check_containers(datas[4096], cpu)["rate"] <= 0.01


@pytest.mark.cuda
def test_cuda_sharded_album_encode_equals_serial(cuda_tables, tmp_path):
    """encode_album_sharded on a 1 x 1 mesh (one [B, K] block of 4 x 1024
    frames a launch) against the serial Encoder.encode (one segment a
    track, of its own row count): the same bytes."""
    import torch.distributed as dist

    from glc_tpu_torch import parallel

    rng = np.random.default_rng(5)
    tracks = [generate_frequency_sweep(f0, 6000.0, RATE, 2, s)
              + (rng.standard_normal(2 * RATE * s) * 0.01).astype(np.float32)
              for f0, s in ((100.0, 3), (300.0, 7), (60.0, 12))]
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = parallel.make_mesh(1, device_type="cuda")
        encs = parallel.encode_album_sharded(mesh, tracks, 2, RATE)
    finally:
        dist.destroy_process_group()
    enc = Encoder(RATE, device="cuda")
    for x, ea in zip(tracks, encs, strict=True):
        assert serialize_encoded(ea) == serialize_encoded(enc.encode(x, 2))


def test_kernel_names_match_the_sources():
    """Each kernel the loader binds has a source under csrc/ and a wrapper
    with a launch count."""
    assert {p.stem for p in kernels.sources()} == set(kernels.KERNELS)
    for name in kernels.KERNELS:
        assert getattr(kernels, name).launches >= 0
        assert callable(getattr(kernels, f"{name}_reference"))
