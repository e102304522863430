"""FLAC encoder: device residual/Rice math + native bit packing.

API mirrors the reference (reference src/flac.rs:946-1088):

    data = encode_flac_with_level(samples, sample_rate, channels, level)
    data = encode_flac(samples, sample_rate, channels)         # level 5
    export_to_flac_with_level(path, samples, rate, ch, level)
    export_to_flac(path, samples, rate, ch)

Semantics preserved: 16-bit samples (f32 ×32767, clamp, truncate), block size
by level (0-2 → 1152, 3-8 → 4096, clamped to [16, total]), fixed predictors
only with order by level, independent channels always (Q7), partitioned Rice
with 4-bit parameters capped at 14 (the escape path is dead code, Q6),
MD5 of the interleaved little-endian i16 stream.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import queue
import threading
from pathlib import Path
from typing import Union

import jax
import numpy as np

from ..io.audio import convert_f32_to_i16
from ..native import get_native
from . import bitpack
from .ops import flac_block_stats, flac_block_stats_host, rice_params_from_sums

# The fixed-predictor/Rice math is exact integer arithmetic; it runs on host
# by default because the samples must be host-resident regardless (MD5 +
# bit packing are inherently host work), so the device kernel only ADDS a
# full round-trip of blocks up / residuals down.  The device kernel
# (flac_block_stats, same math) stays behind GLC_FLAC_DEVICE_MATH=1; which
# side wins on the GPU is not yet measured.
_USE_DEVICE_MATH = os.environ.get("GLC_FLAC_DEVICE_MATH") == "1"


class FlacError(ValueError):
    pass


_LEVEL_BLOCK_SIZE = {0: 1152, 1: 1152, 2: 1152, 3: 4096, 4: 4096, 5: 4096,
                     6: 4096, 7: 4096, 8: 4096}


def _block_group_stats(x_blocks: np.ndarray, gbs: int, level: int):
    """Residuals + Rice params for a group of deinterleaved blocks
    [Fg, C, gbs] int32.  Returns (res flat int32, params flat int8) in the
    packer's layout.  The single home of the predictor/Rice math dispatch —
    used by the batch framer and both streaming paths.

    GLC_FLAC_DEVICE_MATH=1 applies here too, which on the STREAMING path
    means one device round-trip per 16-block group."""
    order = bitpack.predictor_order(gbs, level)
    po = bitpack.partition_order(gbs, order, level)
    Fg, C, _ = x_blocks.shape
    if order == 0:
        return (np.zeros(Fg * C * gbs, np.int32),
                np.zeros(Fg * C * (1 << po), np.int8))
    flat = x_blocks.reshape(Fg * C, gbs)
    if _USE_DEVICE_MATH:
        res_full, lo, hi = flac_block_stats(
            jax.device_put(flat), order=order, po=po
        )
        res_full, lo, hi = (np.asarray(res_full), np.asarray(lo),
                            np.asarray(hi))
    else:
        res_full, lo, hi = _block_stats_fast(flat, order, po)
    params = rice_params_from_sums(lo, hi, gbs, order, po)
    return res_full.reshape(-1), params.reshape(-1)


def _block_stats_fast(flat: np.ndarray, order: int, po: int):
    """Host block stats: native single-pass C++ when available (≈7× less
    memory traffic than the numpy diff cascade), numpy twin otherwise.  Bit-identical either way (exact int32 arithmetic;
    tests/test_flac.py::test_native_block_stats_matches_numpy pins it)."""
    lib = get_native()
    if lib is not None and hasattr(lib, "glc_flac_block_stats"):
        c = ctypes
        B, bs = flat.shape
        xc = np.ascontiguousarray(flat, np.int32)
        res = np.empty((B, bs), np.int32)
        P = 1 << po
        lo = np.empty((B, P), np.int32)
        hi = np.empty((B, P), np.int32)
        rc = lib.glc_flac_block_stats(
            xc.ctypes.data_as(c.POINTER(c.c_int32)),
            B, bs, order, po,
            res.ctypes.data_as(c.POINTER(c.c_int32)),
            lo.ctypes.data_as(c.POINTER(c.c_int32)),
            hi.ctypes.data_as(c.POINTER(c.c_int32)),
        )
        if rc == 0:
            return res, lo, hi
    return flac_block_stats_host(flat, order=order, po=po)


def _compute_frame_data(i16: np.ndarray, channels: int, level: int):
    """Frame the stream and run the block math.

    Returns (block_sizes int32 [F], residuals flat int32, rice_params flat
    int8) in the packer's layout: residuals frame-major then channel-major
    with bs entries per channel (warm-up slots zeroed); params frame-major,
    channel-major, partition-major.
    """
    total = len(i16) // channels
    bs = max(min(_LEVEL_BLOCK_SIZE[level], total), 16)  # flac.rs:983-995

    # Frame split mirrors flac.rs:1021-1049: full blocks then one partial.
    F0 = total // bs
    last = total - F0 * bs
    block_sizes = [bs] * F0 + ([last] if last > 0 else [])

    res_parts = []
    rp_parts = []
    if F0 > 0:
        full = (
            i16[: F0 * bs * channels]
            .reshape(F0, bs, channels)
            .transpose(0, 2, 1)
            .astype(np.int32)
        )
        r, p = _block_group_stats(full, bs, level)
        res_parts.append(r)
        rp_parts.append(p)
    if last > 0:
        part = (
            i16[F0 * bs * channels : (F0 * bs + last) * channels]
            .reshape(1, last, channels)
            .transpose(0, 2, 1)
            .astype(np.int32)
        )
        r, p = _block_group_stats(part, last, level)
        res_parts.append(r)
        rp_parts.append(p)

    residuals = (
        np.concatenate(res_parts) if res_parts else np.empty(0, np.int32)
    )
    rice_params = (
        np.concatenate(rp_parts) if rp_parts else np.empty(0, np.int8)
    )
    return np.asarray(block_sizes, np.int32), residuals, rice_params


def encode_flac_with_level(
    samples: np.ndarray,
    sample_rate: int,
    channels: int,
    compression_level: int,
) -> bytes:
    """flac.rs:946-1052"""
    i16 = convert_f32_to_i16(samples)  # flac.rs:955-958, same trunc cast
    return encode_flac_i16_with_level(i16, sample_rate, channels,
                                      compression_level)


def encode_flac_i16_with_level(
    i16: np.ndarray,
    sample_rate: int,
    channels: int,
    compression_level: int,
) -> bytes:
    """Entry for already-16-bit samples (skips the f32 conversion) — used by
    the decode→export fast path, where the decoder emits i16 directly."""
    i16 = np.asarray(i16, np.int16)
    total = len(i16) // channels
    if total < 16:
        raise FlacError(
            f"FLAC requires at least 16 samples per channel, got {total}"
        )
    if not (0 <= compression_level <= 8):
        raise FlacError(
            f"Invalid compression level {compression_level}, must be 0-8"
        )

    md5 = hashlib.md5(i16.astype("<i2").tobytes()).digest()  # flac.rs:304-318
    block_sizes, residuals, rice_params = _compute_frame_data(
        i16, channels, compression_level
    )
    return _pack(i16, channels, sample_rate, compression_level, md5,
                 block_sizes, residuals, rice_params)


def _pack(i16, channels, sample_rate, compression_level, md5,
          block_sizes, residuals, rice_params) -> bytes:
    """Assemble the FLAC byte stream: native single-pass packer when the
    library is available, byte-identical Python fallback otherwise."""
    lib = get_native()
    if lib is not None:
        c = ctypes
        out_ptr = c.POINTER(c.c_uint8)()
        out_len = c.c_int64()
        i16c = np.ascontiguousarray(i16, "<i2")
        resc = np.ascontiguousarray(residuals, np.int32)
        rpc = np.ascontiguousarray(rice_params, np.int8)
        bsc = np.ascontiguousarray(block_sizes, np.int32)
        rc = lib.glc_flac_pack(
            i16c.ctypes.data_as(c.POINTER(c.c_int16)),
            len(i16c), channels, sample_rate, compression_level,
            (c.c_uint8 * 16).from_buffer_copy(md5),
            bsc.ctypes.data_as(c.POINTER(c.c_int32)), len(bsc),
            resc.ctypes.data_as(c.POINTER(c.c_int32)),
            rpc.ctypes.data_as(c.POINTER(c.c_int8)),
            c.byref(out_ptr), c.byref(out_len),
        )
        if rc != 0:
            raise FlacError(f"native FLAC packer failed: {rc}")
        try:
            return bytes(c.cast(
                out_ptr, c.POINTER(c.c_uint8 * out_len.value)
            ).contents)
        finally:
            lib.glc_free(out_ptr)

    return bitpack.pack_stream(
        i16, channels, sample_rate, compression_level, md5,
        block_sizes, residuals, rice_params,
    )


def _pack_frames_native(lib, i16, channels, sample_rate, level,
                        block_sizes, first_frame, residuals,
                        rice_params) -> bytes:
    """Pack a RANGE of frames (no stream header) via glc_flac_pack_frames.

    FLAC frames are byte-aligned and self-contained, so groups packed as
    their stats complete concatenate into exactly the bytes the
    whole-stream packer emits."""
    c = ctypes
    out_ptr = c.POINTER(c.c_uint8)()
    out_len = c.c_int64()
    i16c = np.ascontiguousarray(i16, "<i2")
    resc = np.ascontiguousarray(residuals, np.int32)
    rpc = np.ascontiguousarray(rice_params, np.int8)
    bsc = np.ascontiguousarray(block_sizes, np.int32)
    rc = lib.glc_flac_pack_frames(
        i16c.ctypes.data_as(c.POINTER(c.c_int16)), len(i16c), channels,
        sample_rate, level,
        bsc.ctypes.data_as(c.POINTER(c.c_int32)), len(bsc),
        first_frame,
        resc.ctypes.data_as(c.POINTER(c.c_int32)),
        rpc.ctypes.data_as(c.POINTER(c.c_int8)),
        c.byref(out_ptr), c.byref(out_len),
    )
    if rc != 0:
        raise FlacError(f"native FLAC frame packer failed: {rc}")
    try:
        return bytes(c.cast(
            out_ptr, c.POINTER(c.c_uint8 * out_len.value)
        ).contents)
    finally:
        lib.glc_free(out_ptr)


def _streaminfo_header(channels: int, sample_rate: int, nominal_bs: int,
                       total_per_channel: int, md5: bytes) -> bytes:
    """The 42-byte fLaC + STREAMINFO prefix, bit-for-bit what the native
    whole-stream packer writes (glc_native.cpp flac_pack_impl; reference
    flac.rs:907-944): min/max block size = nominal, frame sizes unknown."""
    v = 0
    for val, n in ((nominal_bs, 16), (nominal_bs, 16), (0, 24), (0, 24),
                   (sample_rate, 20), (channels - 1, 3), (15, 5),
                   (total_per_channel, 36)):
        v = (v << n) | (val & ((1 << n) - 1))
    return b"fLaC" + bytes([0x80, 0, 0, 34]) + v.to_bytes(18, "big") + md5


def encode_flac_i16_streaming(
    chunks,
    sample_rate: int,
    channels: int,
    compression_level: int,
    total_per_channel: int,
) -> bytes:
    """Encode from an iterator of int16 interleaved chunks, byte-identical
    to `encode_flac_i16_with_level` over their concatenation.

    The MD5, the per-block predictor/Rice math, AND (with the native
    library) the frame bit-packing all run incrementally as chunks arrive,
    so a producer that is waiting on device transfers (the decode→export
    path, `Decoder.decode_i16_stream`) overlaps this host work with its
    own stalls.  FLAC frames are byte-aligned and self-contained, so
    packing each group as its stats complete and joining header + chunks
    at end-of-stream emits exactly the whole-stream packer's bytes; only
    the 42-byte STREAMINFO header needs end-of-stream data (the MD5).
    Without the native library the bit-packing remains one final _pack.

    `total_per_channel` must be the exact final per-channel sample count
    (known up front from the container header): the block size depends on
    it (flac.rs:983-995), so it cannot be inferred mid-stream.

    The per-chunk host work (MD5 + predictor/Rice block math) runs on ONE
    worker thread fed in stream order through a bounded queue: run inline,
    it would block the producer loop from pulling the next chunk — and the
    producer's pulls are what issue the decode's device dispatches and
    async host copies, so inline math serializes against the link instead
    of overlapping it.  numpy, hashlib, and the native packer all release
    the GIL, so on a 1-core host the worker's math timeshares into the
    main thread's transfer WAITS rather than its runnable time.  A single
    FIFO worker preserves chunk order, so the bytes are identical to the
    inline path (GLC_FLAC_NO_WORKER=1 forces inline; the streaming-
    equivalence tests pin byte identity either way).
    """
    if total_per_channel < 16:
        raise FlacError(
            f"FLAC requires at least 16 samples per channel, got "
            f"{total_per_channel}"
        )
    if not (0 <= compression_level <= 8):
        raise FlacError(
            f"Invalid compression level {compression_level}, must be 0-8"
        )
    bs = max(min(_LEVEL_BLOCK_SIZE[compression_level], total_per_channel), 16)
    group = bs * channels * 16  # process 16 blocks at a time

    # Incremental frame packing: with the native library, each group's
    # frames are PACKED as their stats complete (on the same worker),
    # overlapping the bit-pack with later chunks' transfers — the final
    # step is just header + join.  Frames are byte-aligned and
    # self-contained, so the bytes are identical to the whole-stream
    # packer's (GLC_FLAC_WHOLE_PACK=1 forces the old single final _pack;
    # the streaming-equivalence tests pin byte identity either way).
    lib = get_native()
    incremental = (
        lib is not None
        and hasattr(lib, "glc_flac_pack_frames")
        and os.environ.get("GLC_FLAC_WHOLE_PACK") != "1"
    )

    md5 = hashlib.md5()
    parts = []
    total_len = 0
    pending = []
    pending_len = 0
    res_parts = []
    rp_parts = []
    frame_bytes = []
    frames_packed = 0

    def emit_group(buf: np.ndarray, gbs: int, r, p):
        """Pack the group's frames now (incremental) or defer to _pack."""
        nonlocal frames_packed
        if incremental:
            G = len(buf) // (gbs * channels)
            frame_bytes.append(_pack_frames_native(
                lib, buf, channels, sample_rate, compression_level,
                np.full(G, gbs, np.int32), frames_packed, r, p,
            ))
            frames_packed += G
        else:
            res_parts.append(r)
            rp_parts.append(p)

    def process(buf: np.ndarray):
        """buf: [G·bs·channels] interleaved — G whole blocks."""
        G = len(buf) // (bs * channels)
        blocks = (
            buf.reshape(G, bs, channels).transpose(0, 2, 1).astype(np.int32)
        )
        r, p = _block_group_stats(blocks, bs, compression_level)
        emit_group(buf, bs, r, p)

    def ingest(chunk: np.ndarray):
        nonlocal pending, pending_len, total_len
        md5.update(chunk.astype("<i2").tobytes())
        total_len += len(chunk)
        if not incremental:
            parts.append(chunk)
        pending.append(chunk)
        pending_len += len(chunk)
        while pending_len >= group:
            buf = np.concatenate(pending) if len(pending) > 1 else pending[0]
            process(buf[:group])
            rest = buf[group:]
            pending = [rest] if len(rest) else []
            pending_len = len(rest)

    if os.environ.get("GLC_FLAC_NO_WORKER") == "1":
        for chunk in chunks:
            ingest(np.asarray(chunk, np.int16))
    else:
        err: list = []
        q: "queue.Queue" = queue.Queue(maxsize=8)

        def run():
            while True:
                c = q.get()
                if c is None:
                    return
                if err:
                    continue  # drain the queue; the error is already fatal
                try:
                    ingest(c)
                except BaseException as e:  # propagate to the main thread
                    err.append(e)

        t = threading.Thread(target=run, daemon=True,
                             name="flac-stream-math")
        t.start()
        try:
            for chunk in chunks:
                if err:
                    break
                q.put(np.asarray(chunk, np.int16))
        finally:
            q.put(None)
            t.join()
        if err:
            raise err[0]

    total = total_len // channels
    if total != total_per_channel:
        raise FlacError(
            f"stream length {total} != declared total {total_per_channel}"
        )
    # remaining whole blocks, then the partial tail block (flac.rs:1021-1049)
    if pending_len:
        buf = np.concatenate(pending) if len(pending) > 1 else pending[0]
        whole = (len(buf) // (bs * channels)) * bs * channels
        if whole:
            process(buf[:whole])
        tail = buf[whole:]
        last = len(tail) // channels
        if last > 0:
            # slice exactly last*channels — a ragged interleaved stream
            # (len % channels != 0, which frame_signal accepts on encode)
            # leaves a fractional sample the batch framer also drops
            tb = np.ascontiguousarray(tail[: last * channels])
            blocks = (
                tb.reshape(1, last, channels)
                .transpose(0, 2, 1)
                .astype(np.int32)
            )
            r, p = _block_group_stats(blocks, last, compression_level)
            emit_group(tb, last, r, p)

    F0 = total // bs
    last = total - F0 * bs
    block_sizes = np.asarray(
        [bs] * F0 + ([last] if last > 0 else []), np.int32
    )
    if incremental:
        nominal = int(block_sizes[0]) if len(block_sizes) else 0
        return _streaminfo_header(
            channels, sample_rate, nominal, total, md5.digest()
        ) + b"".join(frame_bytes)

    i16 = np.concatenate(parts) if parts else np.empty(0, np.int16)
    residuals = (
        np.concatenate(res_parts) if res_parts else np.empty(0, np.int32)
    )
    rice_params = (
        np.concatenate(rp_parts) if rp_parts else np.empty(0, np.int8)
    )
    return _pack(i16, channels, sample_rate, compression_level,
                 md5.digest(), block_sizes, residuals, rice_params)


def encode_flac(samples: np.ndarray, sample_rate: int, channels: int) -> bytes:
    """flac.rs:1055-1062 — default level 5."""
    return encode_flac_with_level(samples, sample_rate, channels, 5)


def export_to_flac_with_level(
    path: Union[str, Path],
    samples: np.ndarray,
    sample_rate: int,
    channels: int,
    compression_level: int,
) -> None:
    """flac.rs:1064-1077"""
    Path(path).write_bytes(
        encode_flac_with_level(samples, sample_rate, channels,
                               compression_level)
    )


def export_to_flac_i16_with_level(
    path: Union[str, Path],
    i16: np.ndarray,
    sample_rate: int,
    channels: int,
    compression_level: int,
) -> None:
    Path(path).write_bytes(
        encode_flac_i16_with_level(i16, sample_rate, channels,
                                   compression_level)
    )


def export_to_flac(
    path: Union[str, Path],
    samples: np.ndarray,
    sample_rate: int,
    channels: int,
) -> None:
    """flac.rs:1079-1088"""
    export_to_flac_with_level(path, samples, sample_rate, channels, 5)
