"""The encode's host time in no key of the ``stats=`` hook (the benchmark's
clock around each per-track encode less the hook's ``disp_ms`` and
``wait_ms``: pairs_from_words, the concatenates, the container object) per
minute of audio in the traced window."""

UNIT = "ms/min"
LAYER = "host orchestration"
MOVES = "encode_rate"


def read(ctx):
    """Milliseconds per minute of audio in the traced window, or None."""
    wall, st = ctx["host_ms"].get("encode"), ctx["stats"]
    if wall is None or "disp_ms" not in st or not ctx["audio_s"]:
        return None
    return (wall - st["disp_ms"] - st["wait_ms"]) / (ctx["audio_s"] / 60.0)
