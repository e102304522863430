"""Sharded codec steps over a device mesh (shard_map + XLA collectives).

Layouts (B = independent streams, K = frames per stream):

* encode: blocks [B, K, C, 2n], B sharded over 'data', K over 'frames'.
  Embarrassingly parallel — no collectives (SURVEY.md §2.8: the rayon
  frame loop becomes pure data parallelism).
* decode: overlap-add couples frame f to f−1 only, so each 'frames' shard
  needs its left neighbor's last second-half: one `ppermute` of a [Bl, C, n]
  halo per step, the mesh expression of the reference's sequential overlap
  buffer (codec.rs:688-705).
* roundtrip_step: encode → decode → reconstruction MSE (psum) in a single
  shard_map — the "full training step" used by the multi-chip dry run.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.decode import blocks_from_frames
from ..ops.encode import encode_math


def _tables_tuple(tb):
    # DeviceTables field order matches encode_math's parameter order
    return tuple(tb)


def encode_chunk_sharded(mesh: Mesh, blocks, tables, **params):
    """Encode blocks [B, K, C, 2n] with B over 'data', K over 'frames'.

    Pure pjit data parallelism: sharding constraints in, XLA partitions the
    matmuls, no communication.
    """
    spec = NamedSharding(mesh, P("data", "frames"))
    rep = NamedSharding(mesh, P())
    blocks = jax.device_put(blocks, NamedSharding(mesh, P("data", "frames", None, None)))
    tbs = tuple(jax.device_put(t, rep) for t in _tables_tuple(tables))

    @partial(jax.jit, static_argnames=tuple(params.keys()) or None,
             out_shardings=(
                 NamedSharding(mesh, P("data", "frames", None, None)),  # q
                 NamedSharding(mesh, P("data", "frames", None)),        # nnz
                 NamedSharding(mesh, P("data", "frames", None)),        # scale
                 NamedSharding(mesh, P("data", "frames", None, None)),  # raw
                 spec,                                                  # use_raw
             ))
    def run(blocks, *tbs, **kw):
        return encode_math(blocks, *tbs, **kw)

    return run(blocks, *tbs, **params)


def _ola_with_halo(blocks, carry, n: int, nshards: int):
    """Local overlap-add with a 1-hop left halo over the 'frames' axis.

    blocks: [Bl, Kl, C, 2n] local shard.  carry: [Bl, C, n] — the global
    stream's incoming overlap (applies to the first 'frames' shard only).
    Returns (hops [Bl, Kl, C, n], tail [Bl, C, n] replicated-correct).
    """
    second = blocks[..., n:]
    last = second[:, -1]  # [Bl, C, n]
    if nshards > 1:
        # send my last hop to my right neighbor (no wraparound)
        prev = jax.lax.ppermute(
            last, "frames", [(i, i + 1) for i in range(nshards - 1)]
        )
    else:
        prev = jnp.zeros_like(last)
    fidx = jax.lax.axis_index("frames")
    prev = jnp.where(fidx == 0, carry, prev)
    prev_rows = jnp.concatenate([prev[:, None], second[:, :-1]], axis=1)
    hops = blocks[..., :n] + prev_rows
    # global tail = last shard's final second-half, replicated via masked psum
    tail = jax.lax.psum(
        jnp.where(fidx == nshards - 1, last, jnp.zeros_like(last)), "frames"
    )
    return hops, tail


def decode_chunk_sharded(
    mesh: Mesh, q, scales, raw_pcm, is_raw, carry, tables,
    *, max_q: float = 32768.0, window_raw: bool = False,
):
    """Decode frames [B, K, C, n] sharded (B over 'data', K over 'frames').

    Returns (hops [B, K, C, n], tail [B, C, n]).  The only collective is the
    1-hop `ppermute` halo inside `_ola_with_halo`.
    """
    n = q.shape[-1]
    nshards = mesh.shape["frames"]
    cos_table, window, norm = tables.cos_table, tables.window, tables.norm

    def local(q, sc, raw, is_raw, carry, cos_table, window, norm):
        blocks = blocks_from_frames(
            q, sc, raw, is_raw, cos_table, window, norm,
            max_q=max_q, window_raw=window_raw,
        )
        return _ola_with_halo(blocks, carry, n, nshards)

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P("data", "frames", None, None),
            P("data", "frames", None),
            P("data", "frames", None, None),
            P("data", "frames"),
            P("data", None, None),
            P(), P(), P(),
        ),
        out_specs=(P("data", "frames", None, None), P("data", None, None)),
    )
    return jax.jit(fn)(q, scales, raw_pcm, is_raw, carry,
                       cos_table, window, norm)


def roundtrip_step_sharded(
    mesh: Mesh, blocks, carry, tables, **params
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Full pipeline step for the multi-chip dry run: encode → decode →
    reconstruction error, in one shard_map over the ('data', 'frames') mesh.

    blocks: [B, K, C, 2n] input frames; returns (mse scalar, hops).
    Collectives: ppermute (OLA halo) + psum (loss reduction) — the complete
    communication footprint of the codec.
    """
    n = blocks.shape[-1] // 2
    nshards = mesh.shape["frames"]

    def local(blocks, carry, *tbs):
        q, nnz, scale, raw, use_raw = encode_math(blocks, *tbs, **params)
        cos_table, window, norm = tbs[0], tbs[1], tbs[2]
        rec = blocks_from_frames(
            q, scale, raw, use_raw, cos_table, window, norm
        )
        hops, _tail = _ola_with_halo(rec, carry, n, nshards)
        # Princen-Bradley: analysis+synthesis windowing with 50% OLA
        # reconstructs the UNwindowed signal (sin window: w[t]² + w[t+n]² = 1),
        # so the reconstruction target is the raw first half of each block.
        ref_hops = blocks[..., :n]
        err = hops - ref_hops
        local_sse = jnp.sum(err * err)
        local_count = jnp.asarray(err.size, jnp.float32)
        sse = jax.lax.psum(jax.lax.psum(local_sse, "frames"), "data")
        count = jax.lax.psum(jax.lax.psum(local_count, "frames"), "data")
        return sse / count, hops

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P("data", "frames", None, None),
            P("data", None, None),
            P(), P(), P(), P(), P(), P(), P(), P(),
        ),
        out_specs=(P(), P("data", "frames", None, None)),
    )
    return jax.jit(fn)(blocks, carry, *_tables_tuple(tables))
