"""Profiling hooks.

Port of ``glc_tpu/profiling.py`` on ``torch.profiler`` in place of
``jax.profiler``.  The host pipelines annotate their phases, so a trace
attributes time to codec stages:

    with glc_tpu_torch.profiling.trace("/tmp/glc-trace"):
        encoder.encode(samples, 2)

or set GLC_PROFILE=/tmp/glc-trace to trace every call of
`Encoder.encode` / `encode_pcm16` ("encode"), `Encoder.encode_many`
("encode_many"), `Decoder.decode_i16` ("decode_i16") and `Decoder.decode`
("decode") into ``$GLC_PROFILE/<name>``, each call as one span of its name.
The trace is a Chrome trace (``*.pt.trace.json``) that TensorBoard's
profile plugin and Perfetto open; it holds the device's kernels and copies
when a CUDA card is present.  Spans of other threads than the caller's
(the producer of `decode_streaming`) show only through their device work.

Inside the calls, while any profiler records, the program's stages are
ranges named ``glc.<area>.<stage>`` (`codec.device.StageClock`, which times
the same stages for the ``stats=`` hooks) and ``glc.container.serialize``
(`span`), ``cpu_op`` events of the trace (`stage`).  With no profiler
recording a stage costs one check.
"""

from __future__ import annotations

import contextlib
import os

import torch


class _Range:
    """A profiler range `rf` named `name` and, on CUDA, an NVTX range of
    the same name, so `nsys` sees it too."""

    __slots__ = ("rf", "name", "nvtx")

    def __init__(self, rf, name: str):
        self.rf, self.name = rf, name
        self.nvtx = torch.cuda.is_available()

    def __enter__(self):
        self.rf.__enter__()
        if self.nvtx:
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc):
        if self.nvtx:
            torch.cuda.nvtx.range_pop()
        return self.rf.__exit__(*exc)


def annotate(name: str):
    """Label a host-side phase in the profiler timeline (a
    ``user_annotation`` event); on CUDA also an NVTX range (next to no cost
    when no trace is active)."""
    return _Range(torch.profiler.record_function(name), name)


# record_function's C++ form: about a third of its cost under a recording
# profiler, and under a microsecond of it inside the range, where
# record_function keeps ~10 µs; its events are ``cpu_op``s.
_FAST_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast",
                      torch.profiler.record_function)


def stage(name: str):
    """The range of a program stage (`codec.device.StageClock`,
    `serialize_encoded`): `annotate`'s, on record_function's C++ form, so
    the range holds the stage's own time.  The trace holds it as a
    ``cpu_op`` event named `name`."""
    return _Range(_FAST_RANGE(name), name)


# What a stage is while nothing records: a context manager that does
# nothing, shared.
OFF = contextlib.nullcontext()


def recording() -> bool:
    """Whether a profiler (``torch.profiler``, ``emit_nvtx``) records."""
    return torch.autograd._profiler_enabled()


def span(name: str):
    """`stage(name)` while a profiler records, else `OFF`."""
    return stage(name) if recording() else OFF


def trace(log_dir: str):
    """Context manager capturing a torch.profiler trace of the enclosed
    calls into `log_dir`: CPU activity, and CUDA activity when a card is
    present."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(log_dir))


@contextlib.contextmanager
def _traced(log_dir: str, name: str):
    with trace(log_dir), annotate(name):
        yield


def maybe_trace(name: str):
    """Trace into $GLC_PROFILE/<name>, the call as one span `name`, if the
    env var is set, else no-op."""
    d = os.environ.get("GLC_PROFILE")
    if not d:
        return contextlib.nullcontext()
    return _traced(os.path.join(d, name), name)
