"""Multi-chip scale-out: device meshes, sharded codec steps, OLA halo.

The reference's entire concurrency model is shared-memory CPU threads (rayon
frame parallelism + a crossbeam streaming channel, SURVEY.md §2.8).  The
accelerator equivalent is data parallelism over a `jax.sharding.Mesh`:

* encode is embarrassingly parallel over frames → shard the frame axis,
  no collectives at all;
* decode's overlap-add couples adjacent frames by exactly one hop → a 1-hop
  halo exchange (`ppermute` of each shard's last second-half) is the only
  communication, carried by NVLink between GPUs.

There is deliberately no TP/PP/EP analog here: the codec has no weight
matrices to shard and no layer pipeline — documenting that is part of the
design (SURVEY.md §5 "long-context/sequence parallelism").
"""

from .album import decode_album_sharded, encode_album_sharded
from .check import check_mesh
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
    "check_mesh",
]
