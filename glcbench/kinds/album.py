"""Album traffic: whole calls of many tracks through the program's
multi-track encode, one client in a closed loop, as one `glc` process
converts a library: host PCM in, through ``Encoder.encode_many`` and
``serialize_encoded`` a track, to container bytes in host memory (the
CLI's multi-file encode).

The traffic file's parameters:

* ``item_seconds`` [lo, hi] and ``pool_items`` — the pool holds one track
  of each of ``pool_items`` lengths spread evenly over [lo, hi]; the seed
  orders them and draws their material (`material.track`), so every seed
  carries the same work;
* ``items_per_call`` and ``plan`` — ``"albums"``: the pool cut, in the
  seed's order, into albums of ``items_per_call`` tracks, which the calls
  take in turn; ``"draw"``: each call takes ``items_per_call`` different
  tracks from a stream of the seed's permutations of the pool, so every
  track comes equally often;
* ``check`` — ``items``: how many answers of the window, drawn from the
  seed, the reference judges besides the pool's longest track; ``limits``:
  each number of `compare` and its limit.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import compare, material, reference

PLANS = ("albums", "draw")


class Album:
    """One cell of album traffic on `device`: its pool, its calls, the
    program's entry point, and the reference that judges them."""

    direction = "encode"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        if traffic["plan"] not in PLANS:
            raise ValueError(f"plan must be one of {PLANS}")
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.codec = reference.Codec.from_config(cfg)
        self.rate = cfg["sample_rate"]
        self.layout = cfg["channel_layout"]
        self.C = len(self.layout)
        self.k = traffic["items_per_call"]
        lo, hi = traffic["item_seconds"]
        lengths = np.linspace(lo, hi, traffic["pool_items"])
        order = np.random.default_rng([self.seed, 0]).permutation(len(lengths))
        self.seconds = [float(lengths[i]) for i in order]
        self.items: list = [None] * len(self.seconds)
        self.program = None

    # --- the pool ---

    def make_item(self, i: int) -> np.ndarray:
        """Track i of the pool: host PCM."""
        x = material.track(self.seconds[i], self.rate, self.layout,
                           self.seed, i, self.device)
        return material.to_pcm(x, self.cfg["bits_per_sample"])

    def make_pool(self, indices=None) -> None:
        for i in range(len(self.items)) if indices is None else indices:
            if self.items[i] is None:
                self.items[i] = self.make_item(i)

    def samples(self, i: int) -> int:
        """Interleaved samples of track i."""
        return int(round(self.seconds[i] * self.rate)) * self.C

    def audio_s(self, idxs) -> float:
        return sum(self.samples(i) for i in idxs) / (self.C * self.rate)

    def rows(self, idxs) -> int:
        """Frames x channels of the tracks: the rows each hand kernel of
        the encode takes, counted from the traffic's shapes."""
        return sum(reference.geometry(self.samples(i), self.C, self.codec)[1]
                   for i in idxs) * self.C

    def calls(self):
        """The calls' track indices, without end."""
        if self.traffic["plan"] == "albums":
            while True:
                yield from self.warm_calls()
        rng = np.random.default_rng([self.seed, 2])
        stream: list = []
        while True:
            while len(stream) < self.k:
                perm = list(rng.permutation(len(self.items)))
                if set(perm[:self.k - len(stream)]) & set(stream):
                    continue
                stream += perm
            yield [int(i) for i in stream[:self.k]]
            stream = stream[self.k:]

    def warm_calls(self) -> list:
        """Every track once, in calls of up to ``items_per_call``: the
        albums of the ``"albums"`` plan."""
        n = len(self.items)
        return [list(range(a, min(a + self.k, n))) for a in range(0, n, self.k)]

    def longest(self) -> int:
        return int(np.argmax(self.seconds))

    # --- the program ---

    def start_program(self) -> None:
        """Load the program's kernels and native library, and make its
        encoder for this configuration."""
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
        self.program = glc.Encoder(self.rate, config=config,
                                   device=self.device)

    def stop_program(self) -> None:
        self.program = None

    def call(self, idxs) -> list:
        """One call of the window: the outputs of the tracks, in order."""
        encs = self.program.encode_many([(self.items[i], self.C)
                                         for i in idxs])
        return [self.glc.serialize_encoded(e) for e in encs]

    def traced_call(self, idxs, acc: dict) -> list:
        """`call` with the program's ``stats=`` hook summed into
        ``acc["stats"]``, host milliseconds per step into ``acc["host_ms"]``
        and a profiler span around each step.  It runs the tracks one at a
        time through the per-file entry that ``encode_many`` runs, since
        ``encode_many`` takes no ``stats=``."""
        glc, rf = self.glc, torch.profiler.record_function
        host, stats = acc["host_ms"], acc["stats"]

        def timed(name, fn):
            with rf(f"glcbench.{name}"):
                t0 = time.perf_counter()
                out = fn()
                host[name] = host.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            return out

        outs = []
        for i in idxs:
            pcm = self.items[i]
            entry = (self.program.encode_pcm16 if pcm.dtype == np.int16
                     else self.program.encode)
            e = timed("encode", lambda: entry(pcm, self.C, stats=stats))
            outs.append(timed("serialize", lambda: glc.serialize_encoded(e)))
        return outs

    # --- the reference ---

    def reference_outputs(self, idxs, precision: str) -> list:
        """The reference in the program's place, at `precision`: the
        control where that is ``"tf32"``."""
        outs = []
        for i in idxs:
            pcm = torch.from_numpy(self.items[i]).to(self.device)
            enc = reference.encode(pcm, self.C, self.rate, self.codec,
                                   precision)
            outs.append(reference.write_container(enc, self.device))
        return outs

    def numbers(self, answers, details: list = None) -> dict:
        """The numbers of `compare`, worst over `answers` ((track, output)
        pairs; an output None is an answer that never came).  `details`, if
        given, receives each answer's counts (`compare`)."""
        readings = []
        for i, out in answers:
            ref = reference.encode(torch.from_numpy(self.items[i])
                                   .to(self.device), self.C, self.rate,
                                   self.codec)
            try:
                got = None if out is None else reference.read_container(out)
            except reference.ContainerError:
                got = None
            detail = {"track": i}
            readings.append(compare.encoded_numbers(
                got, ref, self.codec.hop_size, self.codec.frame_size, detail,
                self.device))
            if details is not None:
                details.append(detail)
        return compare.worst_of(readings, compare.ENCODE_NUMBERS)


def make(cfg: dict, traffic: dict, seed: int, device) -> Album:
    return Album(cfg, traffic, seed, device)
