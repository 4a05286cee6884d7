"""The decode's host time in no key of the ``stats=`` hook: the
benchmark's clock around each ``decode_many`` less the hook's ``pack_ms``,
``disp_ms`` and ``wait_ms`` (the grouping of the tracks, the per-track
concatenates of the trimmed chunks, the single-chunk groups' copies), per
minute of audio in the traced window."""

UNIT = "ms/min"
LAYER = "host orchestration"
MOVES = "decode_rate"

KEYS = ("pack_ms", "disp_ms", "wait_ms")


def read(ctx):
    """Milliseconds per minute of audio in the traced window, or None."""
    if ctx["direction"] != "decode" or not ctx["audio_s"]:
        return None
    wall, st = ctx["host_ms"].get("decode"), ctx["stats"]
    if wall is None or any(k not in st for k in KEYS):
        return None
    return (wall - sum(st[k] for k in KEYS)) / (ctx["audio_s"] / 60.0)
