"""The decode's ``wait_ms`` (the program's ``stats=`` hook, span
``glc.decode.wait``: blocked on each chunk's download, and its gapless
trim) per minute of audio in the traced window."""

UNIT = "ms/min"
LAYER = "host orchestration"
MOVES = "decode_rate"


def read(ctx):
    """Milliseconds per minute of audio in the traced window, or None."""
    ms = ctx["stats"].get("wait_ms") if ctx["direction"] == "decode" \
        else None
    if ms is None or not ctx["audio_s"]:
        return None
    return ms / (ctx["audio_s"] / 60.0)
