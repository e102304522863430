"""upload_geometry / frame_plan invariants.

upload_geometry is the single source of truth for the encoder's transfer
shapes, shared by the serial path, encode_many's grouping, and bench's
stage attribution — these properties pin it against frame_signal (the
array-building original it must mirror arithmetic-for-arithmetic,
reference src/codec.rs:427-455) across a broad sweep of lengths.
"""

import numpy as np
import pytest

from glc.codec.encoder import (
    bucket_upload,
    frame_plan,
    frame_signal,
    upload_geometry,
)
from glc.config import DEFAULT_CONFIG as CFG


LENGTHS = [1, 2, 3, 511, 512, 513, 1023, 1024, 1025, 2047, 2048, 2049,
           4096, 44100, 88200, 88201, 1_000_000]


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("total", LENGTHS)
def test_frame_plan_matches_frame_signal(total, channels):
    """The arithmetic twin must agree with the array-building original —
    including on ragged inputs, where both must raise or both must accept
    with identical geometry."""
    samples = np.zeros(total, np.float32)
    try:
        padded, F_sig, padding_sig, T_sig = frame_signal(
            samples, channels, CFG
        )
    except ValueError:
        with pytest.raises(ValueError):
            frame_plan(total, channels, CFG)
        return
    T, F, padding = frame_plan(total, channels, CFG)
    assert (T, F, padding) == (T_sig, F_sig, padding_sig)
    assert padded.shape == (channels, CFG.hop_size // 2 + T + padding)


@pytest.mark.parametrize("channels", [1, 2, 3])
@pytest.mark.parametrize("total", LENGTHS)
def test_upload_geometry_invariants(total, channels):
    hop = CFG.hop_size
    lead = hop // 2
    try:
        T, F, padding, plan, need_hops, Tb = upload_geometry(
            total, channels, CFG
        )
    except ValueError:
        # ragged inputs the reference panics on — frame_plan must agree
        with pytest.raises(ValueError):
            frame_plan(total, channels, CFG)
        return

    # the plan tiles [0, F) exactly: contiguous starts, full coverage
    assert plan[0][0] == 0
    for (s0, k0), (s1, _k1) in zip(plan, plan[1:]):
        assert s1 == s0 + k0
    last_start, last_k = plan[-1]
    assert last_start + last_k >= F
    assert all(k <= CFG.encode_chunk_frames for _s, k in plan)

    # every segment program's slice stays inside the device-padded signal
    assert need_hops >= last_start + last_k + 1
    # the padded signal covers lead + T (+ trailing lead)
    assert need_hops * hop >= lead + T + lead - hop + 1

    # the bucketed upload holds the full input and fits the planar buffer
    assert Tb >= T
    assert lead + Tb <= need_hops * hop

    samples = np.zeros(total, np.int16)
    xup = bucket_upload(samples, total, Tb, channels, np.int16)
    assert len(xup) == Tb * channels
    assert len(xup) >= total


def test_bucket_upload_zero_copy_when_aligned():
    """A ladder-aligned input is handed over untouched (no memcpy)."""
    cfg = CFG
    # find a total whose Tb lands exactly on T
    for total in range(2 * 44100, 2 * 44100 + 4096, 2):
        T, F, padding, plan, need_hops, Tb = upload_geometry(total, 2, cfg)
        if Tb * 2 == total:
            samples = np.zeros(total, np.int16)
            assert bucket_upload(samples, total, Tb, 2, np.int16) is samples
            return
    pytest.skip("no aligned length in the probed range")
