"""``band_energy`` (the masking model's band sums of squares): the least
time the card could take for the rows the window's traffic needs, over
the device time of the kernels named in `KERNELS`."""

UNIT = "%"
LAYER = "hand kernels"
MOVES = "encode_rate"

# H100 SXM, NVIDIA's data sheet, dense:
# f32 CUDA cores 67 TFLOP/s; HBM3 3.35 TB/s
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
KERNELS = ("band_energy_kernel",)


def bound_s(rows: int, n: int, bands: int) -> float:
    """a square and an add a bin, 2·rows·n operations; the rows'
    coefficients in, one sum a band out, the band mask once."""
    return max(2.0 * rows * n / PEAK_FLOPS,
               4.0 * (rows * n + rows * bands + bands * n) / PEAK_BYTES)


def read(ctx):
    """The share (%) of the bound in the kernels' device time, or None."""
    tr = ctx["trace"]
    if tr is None or ctx["direction"] != "encode":
        return None
    t = tr.kernel_s(KERNELS)
    if t <= 0:
        return None
    return 100.0 * bound_s(ctx["rows"], ctx["n"], ctx["bands"]) / t
