"""Device-side decode pipeline: dequantize → IMDCT → window → overlap-add.

Replaces the reference's batch-parallel decode + sequential overlap buffer
(reference src/codec.rs:615-729) with one batched IMDCT matmul and a *shifted
add*: overlap-add with 50% hop is associative —

    hop[f] = first_half(block[f]) + second_half(block[f-1])

so the whole chunk is two slices and one add, with a single [C, n] carry
between chunks (and the same carry is the 1-hop halo exchanged between devices
when the frame axis is sharded, see glc.parallel).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .mdct import imdct


_PREFIX_GRAIN = 128


@partial(jax.jit, static_argnames=("k",))
def _take_prefix(x: jnp.ndarray, *, k: int) -> jnp.ndarray:
    return x[:k]


def start_host_copy(arr):
    """Kick off the device→host copy of a dispatched result so the later
    np.asarray finds it local — downloads overlap later device work instead
    of waiting on each transfer serially.  Shared by every
    host pipeline (decoder chunks/batches, encoder segment/batch fetches)."""
    try:
        arr.copy_to_host_async()
    except AttributeError:
        pass  # backend lacks async copies; np.asarray copies synchronously
    return arr


def prefix_rows(valid: int, cap: int) -> int:
    """Row count of the device-side prefix: `valid` rounded up to the
    128-row grain, capped — shared by take_prefix_device (leading axis) and
    decode_many's batched hop-axis slice."""
    return min(-(-valid // _PREFIX_GRAIN) * _PREFIX_GRAIN, cap)


def take_prefix_device(x: jnp.ndarray, valid: int) -> jnp.ndarray:
    """Device-side prefix of the leading axis, bucketed to 128-frame
    granularity so only O(K/128) tiny slice programs ever compile.

    Downloading np.asarray(x)[:valid] would pull the chunk's padding frames
    over the link (up to 6 MB of zeros for a 2584-frame file in a
    4096-frame chunk); slicing on device first keeps the download within
    one bucket (≤127 frames) of the real data.
    """
    K = x.shape[0]
    k = prefix_rows(valid, K)
    if k >= K:
        return x
    return _take_prefix(x, k=k)


def blocks_from_frames(
    q: jnp.ndarray,        # [..., C, n] int16
    scales: jnp.ndarray,   # [..., C] f32
    raw_pcm: jnp.ndarray,  # [..., C, frame_size] int16
    is_raw: jnp.ndarray,   # [...] bool
    cos_table: jnp.ndarray,
    window: jnp.ndarray,
    norm,
    *,
    max_q: float = 32768.0,
    window_raw: bool = False,
) -> jnp.ndarray:
    """Dequantize + IMDCT + window + raw-PCM select → blocks [..., C, 2n].

    Pure local math (no cross-frame coupling) — reused verbatim inside
    shard_map bodies by glc.parallel.sharded.
    """
    sc = jnp.maximum(scales, np.float32(1e-12))
    coeffs = (q.astype(jnp.float32) / np.float32(max_q)) * sc[..., None]
    out = imdct(coeffs, cos_table, norm) * window
    raw_f = raw_pcm.astype(jnp.float32) / np.float32(32767.0)
    if window_raw:
        raw_f = raw_f * window
    return jnp.where(is_raw[..., None, None], raw_f, out)


@partial(jax.jit, static_argnames=("max_q", "window_raw"))
def decode_chunk_device(
    q: jnp.ndarray,          # [K, C, n] int16 dense quantized coeffs
    scales: jnp.ndarray,     # [K, C] f32
    raw_pcm: jnp.ndarray,    # [K, C, frame_size] int16 (zeros where not raw)
    is_raw: jnp.ndarray,     # [K] bool
    carry: jnp.ndarray,      # [C, n] f32 — second half of the previous block
    num_valid: jnp.ndarray,  # scalar i32 — frames actually present in chunk
    cos_table: jnp.ndarray,
    window: jnp.ndarray,
    norm: jnp.ndarray,
    *,
    max_q: float = 32768.0,
    window_raw: bool = False,
):
    """Returns (hops f32 [K, C, n], new_carry f32 [C, n]).

    Semantics per reference src/codec.rs:620-729:
      * coeff = (q / 2^15) · max(scale, 1e-12)  (codec.rs:653-663)
      * MDCT frames: IMDCT then synthesis window (codec.rs:669-675)
      * raw frames: i16/32767, NOT re-windowed (codec.rs:626-643, quirk Q4;
        pass window_raw=True for the clean Princen-Bradley path)
      * overlap-add: hop[i] = overlap[i] + block[i], overlap ← block[n:2n]
        (codec.rs:688-705), expressed as a shifted add
    """
    K, C, n = q.shape

    blocks = blocks_from_frames(
        q, scales, raw_pcm, is_raw, cos_table, window, norm,
        max_q=max_q, window_raw=window_raw,
    )

    first = blocks[..., :n]
    second = blocks[..., n:]
    prev = jnp.concatenate([carry[None], second[:-1]], axis=0)
    hops = first + prev
    new_carry = jnp.take(second, jnp.maximum(num_valid - 1, 0), axis=0)
    return hops, new_carry


@partial(jax.jit, static_argnames=("K", "C", "n", "budget", "rbudget",
                                   "max_q", "window_raw",
                                   "out_i16", "out_interleave",
                                   "append_carry"))
def decode_chunk_packed_device(
    words: jnp.ndarray,      # [budget + K*C//2 + K*C + K (+ raw)] int32
    carry: jnp.ndarray,      # [C, n] f32
    num_valid: jnp.ndarray,  # scalar i32
    cos_table: jnp.ndarray,
    window: jnp.ndarray,
    norm: jnp.ndarray,
    *,
    K: int,
    C: int,
    n: int,
    budget: int,
    rbudget: int,
    max_q: float = 32768.0,
    window_raw: bool = False,
    out_i16: bool = False,
    out_interleave: bool = False,
    append_carry: bool = False,
):
    """Transfer-minimal decode: the host uploads ONE packed int32 buffer per
    chunk — raw frames included — and the dense scatter happens in device
    memory.  One upload per chunk instead of six (pos/vals/scales/raw_rows/
    raw_idx/is_raw) pays the fixed per-transfer cost once.

    `words` layout (all sections 4-byte aligned, sizes static):
      * [0 : budget)                 — kv words: (k << 16) | (q & 0xFFFF),
        the stream-ordered (index, value) pairs — the same packed format
        the encoder downloads.  Fill entries carry k = 0xFFFF (≥ n) and
        are dropped.  The pair→frame mapping is NOT uploaded: it is
        reconstructed on device from the nnz section (scatter row-starts +
        cumsum), because stream order is row-major over (frame, channel)
        (codec.rs:462-541).
      * [budget : budget + K*C//2)   — per-(frame,channel) nnz as packed
        u16 pairs (row-major).
      * [... : ... + K*C)            — bitcast f32 scales [K, C].
      * [... : ... + K)              — is_raw flags (0/1).
      * when rbudget > 0, the raw section follows:
        [... : ... + rbudget)        — raw frame indices (fill = K, dropped)
        [... : end)                  — raw rows [rbudget, C, 2n] as packed
        i16 pairs.

    out_i16=True applies the exporters' f32→i16 conversion on device
    (×32767, clamp, truncate toward zero — audio.rs:9-16) before download,
    halving output transfer for file-export paths (within 1 LSB of the
    host-side conversion; the differently-fused program can shift hops by
    ±1 ulp).  Callers download a prefix via `take_prefix_device` so chunk
    padding never crosses the link.

    out_interleave=True returns hops as [K, n, C] (interleaved sample
    order): the relayout is cheap on device, while the equivalent host
    transpose of a downloaded [K, C, n] chunk is a strided copy on the
    host's critical path.  Values are identical — it is a pure layout change
    applied after all arithmetic.

    append_carry=True returns hops with ONE extra row: the new carry (the
    stream's overlap tail, codec.rs:722-732) written at row `num_valid`,
    converted/laid out exactly like the hops.  The final chunk's download
    then carries the tail instead of a second transfer for 8 KB.  new_carry is still returned as f32 for chaining.
    """
    return _decode_packed_body(
        words, carry, num_valid, cos_table, window, norm,
        K=K, C=C, n=n, budget=budget, rbudget=rbudget, max_q=max_q,
        window_raw=window_raw, out_i16=out_i16,
        out_interleave=out_interleave, append_carry=append_carry,
    )


def _decode_packed_body(
    words, carry, num_valid, cos_table, window, norm, *,
    K, C, n, budget, rbudget, max_q, window_raw,
    out_i16, out_interleave, append_carry,
):
    """Traced body shared by the single-chunk and batched packed decodes."""
    frame_size = 2 * n
    o0 = budget
    o1 = o0 + (K * C) // 2
    o2 = o1 + K * C
    raw_words = words[o2 + K :]
    kv = words[:o0]
    nnz = jax.lax.bitcast_convert_type(
        words[o0:o1], jnp.uint16
    ).reshape(K * C).astype(jnp.int32)
    scales = jax.lax.bitcast_convert_type(
        words[o1:o2], jnp.float32
    ).reshape(K, C)
    is_raw = words[o2 : o2 + K] != 0

    # pair → (frame·channel) row mapping: pairs are stream-ordered, so row
    # boundaries are the exclusive cumsum of nnz; scatter-add a 1 at each
    # row start, cumsum over the budget axis → row index per pair.  Empty
    # rows stack their starts (add, not set) and are skipped correctly.
    ends = jnp.cumsum(nnz)
    starts = jnp.concatenate([jnp.zeros(1, jnp.int32), ends[:-1]])
    fc = (
        jnp.cumsum(
            jnp.zeros(budget, jnp.int32).at[starts].add(1, mode="drop")
        )
        - 1
    )
    k = (kv >> 16) & 0xFFFF
    v16 = kv & 0xFFFF
    vals = jnp.where(v16 >= 32768, v16 - 65536, v16).astype(jnp.int16)
    # out-of-range k (reference skips them, codec.rs:661) and fill slots
    # (k = 0xFFFF) must not leak into a neighboring row's coefficients
    pos = jnp.where(k < n, fc * n + k, K * C * n)

    q = (
        jnp.zeros(K * C * n, jnp.int16)
        .at[pos].set(vals, mode="drop")
        .reshape(K, C, n)
    )
    if rbudget:
        raw_idx = raw_words[:rbudget]
        raw_rows = jax.lax.bitcast_convert_type(
            raw_words[rbudget:], jnp.int16
        ).reshape(rbudget, C, frame_size)
        raw = (
            jnp.zeros((K, C, frame_size), jnp.int16)
            .at[raw_idx].set(raw_rows, mode="drop")
        )
    else:
        raw = jnp.zeros((K, C, frame_size), jnp.int16)
    hops, new_carry = decode_chunk_device(
        q, scales, raw, is_raw, carry, num_valid, cos_table, window, norm,
        max_q=max_q, window_raw=window_raw,
    )
    if append_carry:
        # row `num_valid` ← new_carry, BEFORE the i16/interleave epilogue so
        # the tail goes through byte-identical conversion with the hops
        hops = jnp.concatenate(
            [hops, jnp.zeros((1, C, n), hops.dtype)], axis=0
        )
        hops = jax.lax.dynamic_update_slice(
            hops, new_carry[None].astype(hops.dtype), (num_valid, 0, 0)
        )
    if out_i16:
        # barriers pin both the f32 hops and the f32 product so XLA cannot
        # evaluate ×32767 in excess precision before trunc — keeps
        # decode_i16 bit-identical to host-side convert_f32_to_i16(decode())
        hops = jax.lax.optimization_barrier(hops)
        prod = jax.lax.optimization_barrier(hops * np.float32(32767.0))
        hops = jnp.trunc(
            jnp.clip(prod, np.float32(-32768.0), np.float32(32767.0))
        ).astype(jnp.int16)
    if out_interleave:
        hops = hops.transpose(0, 2, 1)   # [K, n, C] — interleaved order
    return hops, new_carry


@partial(jax.jit, static_argnames=("K", "C", "n", "budget", "rbudget",
                                   "max_q", "window_raw",
                                   "out_i16", "out_interleave",
                                   "append_carry"))
def decode_chunks_packed_batch_device(
    words_b: jnp.ndarray,     # [B, W] — B single-chunk tracks, same buckets
    num_valid: jnp.ndarray,   # [B] int32
    cos_table: jnp.ndarray,
    window: jnp.ndarray,
    norm: jnp.ndarray,
    *,
    K: int,
    C: int,
    n: int,
    budget: int,
    rbudget: int,
    max_q: float = 32768.0,
    window_raw: bool = False,
    out_i16: bool = False,
    out_interleave: bool = False,
    append_carry: bool = False,
):
    """Batched multi-track packed decode — the decode-side album analog of
    encode_interleaved_batch_device: B same-bucket single-chunk tracks cost
    ONE upload, ONE dispatch, and ONE download instead of B of each.

    Every track decodes from a zero carry (they are single-chunk by
    construction).  `lax.map`, not `vmap`, for the same reason as the
    encode batch: the batch axis must not change the per-track math, so
    each track runs the identical traced body in a device loop and the
    result matches the single-track program.

    Returns hops [B, K(+1), ...] — layout per the flags, as in
    decode_chunk_packed_device (the per-track new_carry is dropped:
    append_carry delivers each track's tail as its extra hop row).
    """
    zero_carry = jnp.zeros((C, n), jnp.float32)

    def body(t):
        words, valid = t
        hops, _carry = _decode_packed_body(
            words, zero_carry, valid, cos_table, window, norm,
            K=K, C=C, n=n, budget=budget, rbudget=rbudget, max_q=max_q,
            window_raw=window_raw, out_i16=out_i16,
            out_interleave=out_interleave, append_carry=append_carry,
        )
        return hops

    return jax.lax.map(body, (words_b, num_valid))


@partial(jax.jit, static_argnames=("K", "C", "n", "budget", "rbudget",
                                   "max_q", "window_raw",
                                   "out_i16", "out_interleave",
                                   "append_carry"))
def decode_chunks_packed_batch_carry_device(
    words_b: jnp.ndarray,     # [B, W] — chunk s of B multi-chunk tracks
    carries: jnp.ndarray,     # [B, C, n] f32 — per-track carry chain
    num_valid: jnp.ndarray,   # [B] int32 (0 for tracks already finished)
    cos_table: jnp.ndarray,
    window: jnp.ndarray,
    norm: jnp.ndarray,
    *,
    K: int,
    C: int,
    n: int,
    budget: int,
    rbudget: int,
    max_q: float = 32768.0,
    window_raw: bool = False,
    out_i16: bool = False,
    out_interleave: bool = False,
    append_carry: bool = False,
):
    """Segment-level batched decode for MULTI-chunk tracks: chunk s of every
    track in one dispatch, with each track's overlap carry chained exactly
    as the serial path chains it (reference src/codec.rs:688-705 — the
    sequential overlap buffer — becomes a [B, C, n] tensor that flows
    device-side between the per-segment batched dispatches).  One upload + one dispatch per segment INDEX instead of per
    (track, segment).

    `lax.map`, not `vmap`, like every other batch program here: the batch
    axis must not change the per-track math (the body is the identical
    traced single-chunk body, so per-track output matches the serial
    program's).  Tracks shorter than the group's segment count ride along
    with num_valid=0 — their rows compute garbage the host never downloads,
    and their carries are never used again.

    Returns (hops [B, K(+1), ...], new_carries [B, C, n]).
    """

    def body(t):
        words, carry, valid = t
        return _decode_packed_body(
            words, carry, valid, cos_table, window, norm,
            K=K, C=C, n=n, budget=budget, rbudget=rbudget, max_q=max_q,
            window_raw=window_raw, out_i16=out_i16,
            out_interleave=out_interleave, append_carry=append_carry,
        )

    return jax.lax.map(body, (words_b, carries, num_valid))
