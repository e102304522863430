"""Album-scale multi-device encode/decode: batch files over the 'data' mesh
axis, frames over the 'frames' axis.

The reference's album operations are serial loops — the GUI decodes playlist
entries one by one and concatenates (reference src/ui.rs:291-402), and its
only scale-out knob is the rayon pool (tests/test_performance.rs:134-156).
Here an album is a batch: each file's frames become one row of a
[B, K, C, 2n] tensor, `shard_map` lays B over 'data' and K over 'frames',
and the per-file results are reassembled into ordinary containers/streams.
Files are independent at encode (no collectives); decode needs only the
1-hop overlap-add halo along 'frames' (glc.parallel.sharded).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
from jax.sharding import Mesh

from ..codec.encoder import frame_signal, zero_extend
from ..codec.decoder import gapless_trim
from ..codec.tables import get_device_tables, pow2_bucket
from ..config import CodecConfig, DEFAULT_CONFIG
from ..container.schema import (
    PAIR_DTYPE,
    AudioHeader,
    EncodedAudio,
    FrameSet,
    GaplessInfo,
)
from .sharded import decode_chunk_sharded, encode_chunk_sharded


def _album_geometry(num_frames: Sequence[int], mesh: Mesh,
                    floor: int = 16) -> Tuple[int, int]:
    """(B_padded, K_padded): batch padded to the 'data' shard count, frame
    axis to a power-of-two multiple of the 'frames' shard count."""
    d = mesh.shape["data"]
    f = mesh.shape["frames"]
    B = len(num_frames)
    Bp = ((B + d - 1) // d) * d
    K = pow2_bucket(max(num_frames), 1 << 30, floor=floor)
    K = ((K + f - 1) // f) * f
    return Bp, K


def encode_album_sharded(
    mesh: Mesh,
    signals: Sequence[np.ndarray],
    channels: int,
    sample_rate: int,
    config: Optional[CodecConfig] = None,
) -> List[EncodedAudio]:
    """Encode an album (list of interleaved f32 streams, one per track) in a
    single sharded device call.

    Equivalent to `[Encoder(rate).encode(s, ch) for s in signals]` — the
    same math (glc.ops.encode.encode_math), batched [B, K, C, 2n] over
    the mesh instead of file-serial.  Pure data parallelism: encode has no
    cross-frame coupling (SURVEY.md §2.8).
    """
    cfg = config or DEFAULT_CONFIG
    hop, frame_size, n = cfg.hop_size, cfg.frame_size, cfg.n
    C = int(channels)
    tb = get_device_tables(n, frame_size, sample_rate)

    framed = [frame_signal(np.asarray(s, np.float32), C, cfg) for s in signals]
    num_frames = [F for _, F, _, _ in framed]
    Bp, K = _album_geometry(num_frames, mesh)

    blocks = np.zeros((Bp, K, C, frame_size), np.float32)
    for b, (padded, F, _, _) in enumerate(framed):
        # 50%-overlap framing (codec.rs:462-481, un-windowed; the window is
        # applied inside encode_math).  The padded length is hop-aligned
        # plus the trailing hop/2 (codec.rs:434-447), so frame by stride,
        # not reshape.  Very short tracks pad to less than one frame_size —
        # zero-extend so every frame's window is in bounds (the serial
        # encoder extends its resident signal with the same helper).
        padded = zero_extend(padded, (F - 1) * hop + frame_size)
        win = np.lib.stride_tricks.sliding_window_view(
            padded, frame_size, axis=1
        )[:, ::hop]                                   # [C, F', 2n]
        blocks[b, :F] = win[:, :F].transpose(1, 0, 2)

    params = dict(
        quality=cfg.quality_factor,
        noise_floor_db=cfg.noise_floor_db,
        compression_threshold=cfg.compression_threshold,
        max_q=cfg.max_q,
    )
    q_d, nnz_d, scale_d, raw_d, use_raw_d = encode_chunk_sharded(
        mesh, blocks, tb, **params
    )
    q = np.asarray(q_d)
    nnz = np.asarray(nnz_d)
    scales = np.asarray(scale_d)
    raw = np.asarray(raw_d)
    use_raw = np.asarray(use_raw_d)

    out: List[EncodedAudio] = []
    for b, ((padded, F, padding, _T), sig) in enumerate(zip(framed, signals)):
        total = len(sig)
        m_raw = use_raw[b, :F]
        nnz_b = np.where(m_raw[:, None], 0, nnz[b, :F]).astype(np.int64)
        q_b = np.where(m_raw[:, None, None], np.int16(0), q[b, :F])
        fidx, cidx, kpos = np.nonzero(q_b)
        pairs = np.empty(len(kpos), PAIR_DTYPE)
        pairs["k"] = kpos.astype(np.uint16)
        pairs["q"] = q_b[fidx, cidx, kpos]
        # channel-major raw rows, the container layout (Q13)
        raw_rows = raw[b, :F][m_raw].reshape(-1, C * frame_size)
        fs = FrameSet(nnz_b, pairs, scales[b, :F], m_raw, raw_rows,
                      frame_size)
        out.append(
            EncodedAudio(
                header=AudioHeader(sample_rate, C, total),
                frame_set=fs,
                gapless_info=GaplessInfo(
                    encoder_delay=hop // 2,
                    padding=padding,
                    original_length=total,
                ),
            )
        )
    return out


def decode_album_sharded(
    mesh: Mesh,
    encoded_list: Sequence[EncodedAudio],
    config: Optional[CodecConfig] = None,
) -> List[np.ndarray]:
    """Decode an album in a single sharded device call; returns the trimmed
    interleaved f32 stream per track (what `Decoder.decode` yields per file,
    reference src/codec.rs:744-768).

    The frame axis carries the 1-hop overlap-add halo (`ppermute`); tracks
    are independent rows of the 'data' axis.
    """
    cfg = config or DEFAULT_CONFIG
    n = cfg.n
    if not encoded_list:
        return []
    rate = encoded_list[0].header.sample_rate
    C = encoded_list[0].header.channels
    for ea in encoded_list:
        if (ea.header.sample_rate, ea.header.channels) != (rate, C):
            raise ValueError("album tracks must share sample rate/channels")
    frame_size = 2 * n
    tb = get_device_tables(n, frame_size, rate)

    num_frames = [ea.frame_set.num_frames for ea in encoded_list]
    Bp, K = _album_geometry(num_frames, mesh)

    q = np.zeros((Bp, K, C, n), np.int16)
    scales = np.zeros((Bp, K, C), np.float32)
    raw = np.zeros((Bp, K, C, frame_size), np.int16)
    is_raw = np.zeros((Bp, K), bool)
    for b, ea in enumerate(encoded_list):
        fs = ea.frame_set
        F = fs.num_frames
        # dense scatter per track, without the chunking — album decode is
        # one sharded call
        q[b, :F] = fs.dense_q()
        scales[b, :F] = fs.scales
        is_raw[b, :F] = fs.raw_mask
        R = int(fs.raw_mask.sum())
        if R:
            rows = fs.raw_pcm
            if cfg.reference_compat:
                # interleaved read-back of channel-major data (Q13)
                rows = rows.reshape(-1, frame_size, C).transpose(0, 2, 1)
            else:
                rows = rows.reshape(-1, C, frame_size)
            raw[b, np.flatnonzero(fs.raw_mask)] = rows

    carry = np.zeros((Bp, C, n), np.float32)
    hops_d, tail_d = decode_chunk_sharded(
        mesh, q, scales, raw, is_raw, carry, tb,
        max_q=cfg.max_q, window_raw=not cfg.reference_compat,
    )
    hops = np.asarray(hops_d)
    tail = np.asarray(tail_d)

    out: List[np.ndarray] = []
    for b, ea in enumerate(encoded_list):
        F = ea.frame_set.num_frames
        flat = hops[b, :F].transpose(0, 2, 1).reshape(-1)
        # final chunk appends the stream's own tail: the second half of its
        # LAST frame, not the batch-padded one — recompute locally from the
        # hop after frame F-1, which for padded rows is hops[b, F] when
        # F < K (the padded frame's first half is 0, so hop F == tail).
        if F < K:
            tail_b = hops[b, F].T.reshape(-1)
        else:
            tail_b = tail[b].T.reshape(-1)
        full = np.concatenate([flat, tail_b])
        out.append(
            gapless_trim(full, ea.gapless_info, C, cfg.reference_compat)
        )
    return out
