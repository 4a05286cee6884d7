"""The decode's ``pack_ms`` (the program's ``stats=`` hook, span
``glc.decode.pack``: each chunk's inputs built on the host, the pairs'
positions and values, the scales and the raw rows) per minute of audio
in the traced window."""

UNIT = "ms/min"
LAYER = "host orchestration"
MOVES = "decode_rate"


def read(ctx):
    """Milliseconds per minute of audio in the traced window, or None."""
    ms = ctx["stats"].get("pack_ms") if ctx["direction"] == "decode" \
        else None
    if ms is None or not ctx["audio_s"]:
        return None
    return ms / (ctx["audio_s"] / 60.0)
