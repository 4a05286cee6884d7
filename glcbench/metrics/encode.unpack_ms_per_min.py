"""The encode's ``unpack_ms`` (the program's ``stats=`` hook, span
``glc.encode.unpack``: each segment's downloads scattered into the
per-frame arrays, ``pairs_from_words``, the raw rows' reshape) per minute
of audio in the traced window."""

UNIT = "ms/min"
LAYER = "host orchestration"
MOVES = "encode_rate"


def read(ctx):
    """Milliseconds per minute of audio in the traced window, or None."""
    ms = ctx["stats"].get("unpack_ms") if ctx["direction"] == "encode" \
        else None
    if ms is None or not ctx["audio_s"]:
        return None
    return ms / (ctx["audio_s"] / 60.0)
