"""The encode's ``assemble_ms`` (the program's ``stats=`` hook, span
``glc.encode.assemble``: the concatenates of the segments' pairs and raw
rows, the container object, the release of the segments' parts) per minute
of audio in the traced window."""

UNIT = "ms/min"
LAYER = "host orchestration"
MOVES = "encode_rate"


def read(ctx):
    """Milliseconds per minute of audio in the traced window, or None."""
    ms = ctx["stats"].get("assemble_ms") if ctx["direction"] == "encode" \
        else None
    if ms is None or not ctx["audio_s"]:
        return None
    return ms / (ctx["audio_s"] / 60.0)
