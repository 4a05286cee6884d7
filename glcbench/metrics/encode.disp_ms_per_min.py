"""The encode's ``disp_ms`` (the program's ``stats=`` hook: issuing the
upload and each segment's launches, up to the pair counts the segment waits
for) per minute of audio in the traced window."""

UNIT = "ms/min"
LAYER = "host orchestration"
MOVES = "encode_rate"


def read(ctx):
    """Milliseconds per minute of audio in the traced window, or None."""
    ms = ctx["stats"].get("disp_ms") if ctx["direction"] == "encode" else None
    if ms is None or not ctx["audio_s"]:
        return None
    return ms / (ctx["audio_s"] / 60.0)
