"""Multi-device scale-out: device meshes, sharded codec steps, OLA halo.

Port of ``glc_tpu/parallel``.  The reference's entire concurrency model is
shared-memory CPU threads (rayon frame parallelism + a crossbeam streaming
channel, SURVEY.md §2.8).  Here it is data parallelism over a
``torch.distributed`` world, laid out as a `DeviceMesh` with a 'data' and
a 'frames' axis:

* encode is embarrassingly parallel over frames → shard the frame axis,
  no collectives until the results are gathered;
* decode's overlap-add couples adjacent frames by exactly one hop → a
  1-hop halo exchange (each 'frames' shard sends its last second half to
  its right neighbour) is the only communication.

Every rank of the mesh calls each function with the same full inputs and
gets the full result back (SPMD, where the JAX package's ``shard_map`` is
single-controller).  The caller starts the world
(``torch.distributed.init_process_group``); a gloo world can share one
card among its ranks, an NCCL world needs a card a rank.

There is deliberately no TP/PP/EP analog here: the codec has no weight
matrices to shard and no layer pipeline (SURVEY.md §5 "long-context/
sequence parallelism").
"""

from .album import decode_album_sharded, encode_album_sharded
from .mesh import make_mesh
from .sharded import (
    decode_chunk_sharded,
    encode_chunk_sharded,
    roundtrip_step_sharded,
)

__all__ = [
    "make_mesh",
    "encode_chunk_sharded",
    "decode_chunk_sharded",
    "roundtrip_step_sharded",
    "encode_album_sharded",
    "decode_album_sharded",
]
