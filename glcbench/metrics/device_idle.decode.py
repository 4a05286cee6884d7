"""The share of the traced window in which the card ran nothing, in a
decode cell: 100 x (1 - busy / window)."""

UNIT = "%"
LAYER = "device"
MOVES = "decode_rate"


def read(ctx):
    tr = ctx["trace"]
    if tr is None or ctx["direction"] != "decode" or not tr.busy_s:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
