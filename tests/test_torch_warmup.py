"""The port's warmup() (glc_tpu_torch/warmup.py) against the JAX package's
(glc_tpu/warmup.py): the same warm signal, the same entry points, and no
silent CPU run."""

import importlib

import numpy as np
import pytest
import torch

import glc_tpu_torch
from glc_tpu_torch.codec.device import DEVICE_ENV

# the module: the package's `warmup` attribute is the function, as in glc_tpu
warmup_mod = importlib.import_module("glc_tpu_torch.warmup")


@pytest.mark.parametrize("seconds, channels", [(1.0, 1), (2.0, 2)])
def test_program_material_matches_jax(seconds, channels):
    from glc_tpu.warmup import _program_material

    want = _program_material(seconds, 44100, channels)
    got = warmup_mod._program_material(seconds, 44100, channels)
    assert got.dtype == want.dtype == np.int16
    assert np.array_equal(got, want)


def test_warmup_is_public():
    assert "warmup" in glc_tpu_torch.__all__
    assert glc_tpu_torch.warmup is warmup_mod.warmup


@pytest.mark.parametrize("flac", [True, False])
def test_warmup_runs_the_entry_points_on_the_cpu(monkeypatch, flac):
    calls = []
    for cls, name in ((warmup_mod.Encoder, "encode_pcm16"),
                      (warmup_mod.Decoder, "decode_i16")):
        real = getattr(cls, name)

        def spy(self, *args, _real=real, _name=name, **kw):
            calls.append((_name, self.device.type))
            return _real(self, *args, **kw)

        monkeypatch.setattr(cls, name, spy)
    real_flac = warmup_mod.encode_flac_i16_streaming

    def flac_spy(*args, **kw):
        data = real_flac(*args, **kw)
        calls.append(("flac", data[:4]))
        return data

    monkeypatch.setattr(warmup_mod, "encode_flac_i16_streaming", flac_spy)
    assert glc_tpu_torch.warmup(seconds=1.0, flac=flac, device="cpu") is None
    want = [("encode_pcm16", "cpu"), ("decode_i16", "cpu")]
    if flac:
        want.append(("flac", b"fLaC"))  # the stream into the FLAC writer
    assert calls == want


def test_warmup_without_a_card_raises(monkeypatch):
    """As resolve_device(None) does: the port never warms the CPU unasked."""
    monkeypatch.delenv(DEVICE_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        glc_tpu_torch.warmup(seconds=1.0)
