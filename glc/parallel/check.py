"""Mesh check: the sharded paths against the single-device codec.

Shared by the multi-device tests and `chip_smoke.py --four-cards`.  It runs
(1) one sharded round-trip step (encode → decode with the `ppermute` OLA
halo → `psum` loss) and (2) the album pipelines, `encode_album_sharded` /
`decode_album_sharded`, against the serial `Encoder` / `Decoder`, which run
the shipped packed device programs on one device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .album import decode_album_sharded, encode_album_sharded
from .mesh import make_mesh
from .sharded import roundtrip_step_sharded


def check_mesh(n_devices: int, tracks: Sequence[np.ndarray],
               channels: int = 2, sample_rate: int = 44100,
               decode_atol: float = 1e-7) -> dict:
    """Run the mesh check over the first `n_devices` devices.

    `tracks` are interleaved float32 signals.  Raises ValueError when fewer
    devices exist, and AssertionError when the sharded encode is not
    bit-identical to the serial one or the sharded decode differs from the
    serial decode by more than rtol 2e-6 plus `decode_atol`.  The default
    is the 1-ulp scale that holds on the CPU backend, where both programs
    sum the IMDCT in the same order.  On GPUs the sharded and the serial
    IMDCT are matmuls of other shapes, summed in another order, so the
    caller passes the transform's own error bound there.  Returns what was
    compared.
    """
    from ..codec.tables import get_device_tables
    from ..container.bincode import serialize_encoded
    from ..codec.decoder import Decoder
    from ..codec.encoder import Encoder

    mesh = make_mesh(n_devices)
    data_shards = mesh.shape["data"]
    frame_shards = mesh.shape["frames"]

    tables = get_device_tables(1024, 2048, sample_rate)
    rng = np.random.default_rng(0)
    B, K = 2 * data_shards, 2 * frame_shards
    blocks = rng.standard_normal((B, K, 1, 2048)).astype(np.float32) * 0.1
    carry = np.zeros((B, 1, 1024), np.float32)
    mse, hops = roundtrip_step_sharded(mesh, blocks, carry, tables)
    mse = float(mse)
    # every comparison runs before any can fail, so one failed run reports
    # all of them
    problems = []
    if not np.isfinite(mse) or np.asarray(hops).shape != (B, K, 1, 1024):
        problems.append(f"sharded round-trip step: loss {mse}, hops "
                        f"{np.asarray(hops).shape}")
    sharded = encode_album_sharded(mesh, tracks, channels, sample_rate)
    enc = Encoder(sample_rate)
    serial = [enc.encode(s, channels) for s in tracks]
    for i, (ea_sh, ea_1) in enumerate(zip(sharded, serial)):
        if serialize_encoded(ea_sh) != serialize_encoded(ea_1):
            q_sh, q_1 = ea_sh.frame_set.dense_q(), ea_1.frame_set.dense_q()
            differ = (float(np.mean(q_sh != q_1))
                      if q_sh.shape == q_1.shape else 1.0)
            problems.append(
                f"sharded encode of track {i} is not bit-identical to the "
                f"serial encode ({differ:.3e} of its quantized coefficients "
                f"differ)"
            )

    outs_sh = decode_album_sharded(mesh, serial)
    dec = Decoder(channels, sample_rate)
    max_diff = 0.0
    for i, (ea, out_sh, src) in enumerate(zip(serial, outs_sh, tracks)):
        out_1 = dec.decode(ea)
        if len(out_sh) != len(src) or len(out_1) != len(src):
            problems.append(f"track {i}: decoded length differs")
            continue
        max_diff = max(max_diff, float(np.abs(out_sh - out_1).max(initial=0)))
        if not np.allclose(out_sh, out_1, rtol=2e-6, atol=decode_atol):
            problems.append(
                f"sharded decode of track {i} differs from the serial decode "
                f"beyond rtol 2e-6, atol {decode_atol:g} (max |diff| "
                f"{max_diff:.3e})"
            )
    if problems:
        raise AssertionError("; ".join(problems))
    return {
        "mesh": dict(mesh.shape),
        "roundtrip_mse": mse,
        "tracks": len(tracks),
        "encode_bit_identical": True,
        "decode_max_abs_diff": max_diff,
    }
