"""Device milliseconds per minute of audio encoded, in the traced window,
outside the hand kernels: the torch operators, copies and memsets."""

UNIT = "ms/min"
LAYER = "torch device ops"
MOVES = "encode_rate"

HAND = ("mdct_rows_kernel", "band_energy_kernel")


def read(ctx):
    """Milliseconds per minute of audio in the traced window, or None."""
    tr = ctx["trace"]
    if tr is None or ctx["direction"] != "encode" or not tr.busy_s:
        return None
    return (tr.busy_s - tr.kernel_s(HAND)) * 1e3 / (ctx["audio_s"] / 60.0)
