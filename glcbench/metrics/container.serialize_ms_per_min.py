"""Host milliseconds in ``serialize_encoded`` per minute of audio encoded:
the benchmark's clock around each track's call in the traced window."""

UNIT = "ms/min"
LAYER = "container"
MOVES = "encode_rate"


def read(ctx):
    """Milliseconds per minute of audio in the traced window, or None."""
    ms = ctx["host_ms"].get("serialize")
    if ms is None or not ctx["audio_s"]:
        return None
    return ms / (ctx["audio_s"] / 60.0)
