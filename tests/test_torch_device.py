"""Where the port runs: `codec.device.resolve_device` and the entry points
that use it.  An entry point runs on the CUDA card unless its caller asks
for the CPU (``device="cpu"``, or GLC_TORCH_DEVICE=cpu where it takes no
device argument); with no card and no such request it raises instead of
running on the CPU.  `torch.cuda.is_available` is patched, so the cases
with a card run here too (building a ``cuda`` torch.device needs none)."""

import numpy as np
import pytest
import torch

import glc_tpu_torch.cli as torch_cli
from glc_tpu_torch import Decoder, Encoder, album, save_encoded
from glc_tpu_torch.codec.device import DEVICE_ENV, resolve_device
from glc_tpu_torch.controller import CodecController
from glc_tpu_torch.io.wav import write_wav_i16
from glc_tpu_torch.playback import stream_playlist_sources


@pytest.fixture
def card(monkeypatch):
    """Patch whether a card is present; clear the variable."""
    monkeypatch.delenv(DEVICE_ENV, raising=False)

    def set_card(present: bool):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: present)

    return set_card


@pytest.mark.parametrize("present,env,arg,want", [
    (True, None, None, "cuda"),
    (True, None, "cpu", "cpu"),
    (True, "cpu", None, "cpu"),
    (True, "cpu", "cuda", "cuda"),
    (False, None, "cpu", "cpu"),
    (False, "cpu", None, "cpu"),
    (False, "cuda", None, "cuda"),
    (False, None, torch.device("cpu"), "cpu"),
])
def test_resolve_device(card, monkeypatch, present, env, arg, want):
    card(present)
    if env is not None:
        monkeypatch.setenv(DEVICE_ENV, env)
    assert resolve_device(arg) == torch.device(want)


def test_no_card_and_no_request_raises(card):
    """The message says how to ask for the CPU."""
    card(False)
    with pytest.raises(RuntimeError) as err:
        resolve_device()
    assert "device='cpu'" in str(err.value)
    assert f"{DEVICE_ENV}=cpu" in str(err.value)


@pytest.fixture
def glc(tmp_path):
    pcm = (np.sin(np.arange(8000) / 9.0) * 9000).astype(np.int16)
    path = tmp_path / "a.glc"
    save_encoded(Encoder(44100, device="cpu").encode_pcm16(pcm, 1), path)
    return path


@pytest.mark.parametrize("make", [
    lambda glc: Encoder(44100),
    lambda glc: Decoder(2, 44100),
    lambda glc: album.decode_playlist([glc]),
    lambda glc: album.export_playlist_to_flac([glc], glc.with_suffix(".flac")),
    lambda glc: next(stream_playlist_sources([glc])),
], ids=["Encoder", "Decoder", "decode_playlist", "export_playlist_to_flac",
        "stream_playlist_sources"])
def test_entry_points_do_not_fall_back_to_the_cpu(card, glc, make):
    card(False)
    with pytest.raises(RuntimeError, match=DEVICE_ENV):
        make(glc)


def test_cli_without_a_card_does_not_use_the_cpu(card, glc, capsys):
    """The encode raises the error (as the JAX CLI lets an encoder's
    construction raise); the decode reports it as a failed file."""
    card(False)
    pcm = (np.sin(np.arange(8000) / 9.0) * 9000).astype(np.int16)
    wav = glc.with_name("b.wav")
    write_wav_i16(wav, pcm, 44100, 1)
    with pytest.raises(RuntimeError, match=DEVICE_ENV):
        torch_cli.main([str(wav)])
    assert not wav.with_suffix(".glc").exists()
    assert torch_cli.main(["-d", str(glc)]) == 1
    assert "Error decoding file: no CUDA device" in capsys.readouterr().err
    assert not glc.with_suffix(".flac").exists()


def test_controller_without_a_card_reports_the_error(card, tmp_path):
    card(False)
    pcm = (np.sin(np.arange(8000) / 9.0) * 9000).astype(np.int16)
    write_wav_i16(tmp_path / "a.wav", pcm, 44100, 1)
    ctl = CodecController()
    ctl.add_files([tmp_path / "a.wav"])
    ctl.encode_selected(wait=True)
    snap = ctl.snapshot()
    assert snap.status == "Error encoding a.wav"
    assert DEVICE_ENV in snap.detail
    assert snap.encoded_files == []
