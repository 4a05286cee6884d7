"""The decode's ``disp_ms`` (the program's ``stats=`` hook, span
``glc.decode.disp``: issuing each chunk's uploads, its launches and its
download that does not block) per minute of audio in the traced
window."""

UNIT = "ms/min"
LAYER = "host orchestration"
MOVES = "decode_rate"


def read(ctx):
    """Milliseconds per minute of audio in the traced window, or None."""
    ms = ctx["stats"].get("disp_ms") if ctx["direction"] == "decode" \
        else None
    if ms is None or not ctx["audio_s"]:
        return None
    return ms / (ctx["audio_s"] / 60.0)
