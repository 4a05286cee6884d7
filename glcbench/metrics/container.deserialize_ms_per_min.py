"""Host milliseconds in ``deserialize_encoded`` per minute of audio decoded:
the benchmark's clock around each call's deserializes in the traced
window."""

UNIT = "ms/min"
LAYER = "container"
MOVES = "decode_rate"


def read(ctx):
    """Milliseconds per minute of audio in the traced window, or None."""
    ms = ctx["host_ms"].get("deserialize") if ctx["direction"] == "decode" \
        else None
    if ms is None or not ctx["audio_s"]:
        return None
    return ms / (ctx["audio_s"] / 60.0)
