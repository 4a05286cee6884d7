"""The encode's host time in none of its stages, as the program's own
clock sees it: the ``stats=`` hook's ``wall_ms`` (span ``glc.encode``)
less ``prep_ms``, ``disp_ms``, ``wait_ms``, ``unpack_ms`` and
``assemble_ms``, per minute of audio in the traced window."""

UNIT = "ms/min"
LAYER = "host orchestration"
MOVES = "encode_rate"

STAGES = ("prep_ms", "disp_ms", "wait_ms", "unpack_ms", "assemble_ms")


def read(ctx):
    """Milliseconds per minute of audio in the traced window, or None."""
    st = ctx["stats"]
    if ctx["direction"] != "encode" or not ctx["audio_s"] \
            or any(k not in st for k in ("wall_ms", *STAGES)):
        return None
    staged = sum(st[k] for k in STAGES)
    return (st["wall_ms"] - staged) / (ctx["audio_s"] / 60.0)
