"""``imdct_window`` (the decode's IMDCT and synthesis window, hop 1024's
3xTF32 tile product): the least time the card could take for the rows the
window's traffic needs, over the device time of the kernels named in
`KERNELS`."""

UNIT = "%"
LAYER = "hand kernels"
MOVES = "decode_rate"

# H100 SXM, NVIDIA's data sheet, dense:
# TF32 tensor cores 495 TFLOP/s; HBM3 3.35 TB/s
PEAK_FLOPS = 495e12
PEAK_BYTES = 3.35e12
KERNELS = ("imdct_window_kernel", "imdct_window_ragged_kernel")


def bound_s(rows: int, n: int) -> float:
    """rows x n coefficients into rows x 2n windowed samples:
    2·rows·n·2n operations; the rows' bytes in and out, the table and the
    window once."""
    return max(2.0 * rows * n * 2 * n / PEAK_FLOPS,
               4.0 * (rows * n + rows * 2 * n + n * 2 * n + 2 * n)
               / PEAK_BYTES)


def read(ctx):
    """The share (%) of the bound in the kernels' device time, or None."""
    tr = ctx["trace"]
    if tr is None or ctx["direction"] != "decode":
        return None
    t = tr.kernel_s(KERNELS)
    if t <= 0:
        return None
    return 100.0 * bound_s(ctx["rows"], ctx["n"]) / t
