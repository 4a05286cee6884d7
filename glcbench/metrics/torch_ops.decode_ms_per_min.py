"""Device milliseconds per minute of audio decoded, in the traced window,
outside the hand kernel ``imdct_window``: the torch operators, copies and
memsets."""

UNIT = "ms/min"
LAYER = "torch device ops"
MOVES = "decode_rate"

HAND = ("imdct_window_kernel", "imdct_window_ragged_kernel")


def read(ctx):
    """Milliseconds per minute of audio in the traced window, or None."""
    tr = ctx["trace"]
    if tr is None or ctx["direction"] != "decode" or not tr.busy_s:
        return None
    return (tr.busy_s - tr.kernel_s(HAND)) * 1e3 / (ctx["audio_s"] / 60.0)
