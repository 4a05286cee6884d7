"""The decode's stacked single-chunk passes (the program's ``stats=`` hook,
count ``group_n``: one ``imdct_window`` launch for every group of
single-chunk tracks of one channel count and chunk size) per minute of
audio in the traced window.  Fewer passes a minute of audio mean more
tracks batched into each."""

UNIT = "launches/min"
LAYER = "host orchestration"
MOVES = "decode_rate"


def read(ctx):
    """Passes per minute of audio in the traced window, or None where the
    program's hook has no such count."""
    n = ctx["stats"].get("group_n") if ctx["direction"] == "decode" \
        else None
    if n is None or not ctx["audio_s"]:
        return None
    return n / (ctx["audio_s"] / 60.0)
