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
"""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def annotate(name: str):
    """Label a host-side phase in the profiler timeline; on CUDA also an
    NVTX range, so `nsys` sees the phase (next to no cost when no trace is
    active)."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


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
