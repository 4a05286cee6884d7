"""Album decode traffic: whole calls of many tracks through the program's
multi-track decode, one client in a closed loop, as one `glc` process
plays or converts a library's albums back to PCM: container bytes in host
memory, through ``deserialize_encoded`` a track and one
``Decoder.decode_many`` a call, to trimmed int16 a track in host memory
(``album.decode_playlist``'s path).

The traffic file's parameters are those of `album` (the pool, the calls,
the check), and ``host_threads``: the threads of torch's host pool that the
client process gives the program (``torch.set_num_threads``), as a
converter that runs one ``glc`` process a core sets ``OMP_NUM_THREADS``.
Under torch's default pool, a thread a core, a decode call keeps four or
five cores busy for one core's work, and the window's wall swings with
whatever else runs on the host.  ``check.limits`` holds the
numbers of `compare_decode`.  The
pool's containers are written by the plain reference (`reference.encode`
at float64, then `reference.write_container`) from the same seeded tracks
that `album` encodes, so the input bytes do not depend on the program's
encoder.
"""

from __future__ import annotations

import time

import torch

from .. import compare_decode, reference, reference_decode
from .album import Album


class AlbumDecode(Album):
    """One cell of album decode traffic on `device`."""

    direction = "decode"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        super().__init__(cfg, traffic, seed, device)
        if traffic.get("host_threads"):
            torch.set_num_threads(int(traffic["host_threads"]))

    # --- the pool ---

    def make_item(self, i: int) -> bytes:
        """Track i of the pool: the reference's container of `album`'s
        track i."""
        pcm = torch.from_numpy(super().make_item(i)).to(self.device)
        enc = reference.encode(pcm, self.C, self.rate, self.codec)
        return reference.write_container(enc, self.device)

    # --- the program ---

    def start_program(self) -> None:
        """Load the program's kernels and native library, and make its
        decoder for this configuration."""
        import glc_tpu_torch as glc
        from glc_tpu_torch.native import get_native

        if self.device.type == "cuda":
            from glc_tpu_torch.ops.kernels import load_library
            load_library()
        get_native()
        known = glc.CodecConfig.__dataclass_fields__
        config = glc.CodecConfig(**{k: v for k, v in self.cfg["codec"].items()
                                    if k in known})
        self.glc = glc
        self.program = glc.Decoder(self.C, self.rate, config=config,
                                   device=self.device)

    def call(self, idxs) -> list:
        """One call of the window: the tracks' int16 streams, in order."""
        encs = [self.glc.deserialize_encoded(self.items[i]) for i in idxs]
        return self.program.decode_many(encs)

    def traced_call(self, idxs, acc: dict) -> list:
        """`call` with the program's ``stats=`` hook summed into
        ``acc["stats"]``, and host milliseconds and a profiler span around
        the deserializes (``glcbench.deserialize``) and the decode
        (``glcbench.decode``)."""
        host = acc["host_ms"]

        def timed(name, fn):
            with torch.profiler.record_function(f"glcbench.{name}"):
                t0 = time.perf_counter()
                out = fn()
                host[name] = host.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            return out

        encs = timed("deserialize", lambda: [
            self.glc.deserialize_encoded(self.items[i]) for i in idxs])
        return timed("decode", lambda: self.program.decode_many(
            encs, stats=acc["stats"]))

    # --- the reference ---

    def reference_outputs(self, idxs, precision: str) -> list:
        """The reference decoder in the program's place, at `precision`:
        the control where that is ``"tf32"``."""
        return [reference_decode.decode_i16(self.items[i], self.codec,
                                            precision, self.device)
                for i in idxs]

    def numbers(self, answers, details: list = None) -> dict:
        """The numbers of `compare_decode`, worst over `answers` ((track,
        output) pairs; an output None is an answer that never came).
        `details`, if given, receives each answer's counts."""
        readings = []
        for i, out in answers:
            ref = reference_decode.decode_i16(self.items[i], self.codec,
                                              "f64", self.device)
            detail = {"track": i}
            readings.append(compare_decode.decoded_numbers(out, ref, detail))
            if details is not None:
                details.append(detail)
        return compare_decode.worst_of(readings)


def make(cfg: dict, traffic: dict, seed: int, device) -> AlbumDecode:
    return AlbumDecode(cfg, traffic, seed, device)
