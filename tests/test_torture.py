"""Seeded random-configuration torture sweep.

Thirty random (waveform mix, duration, channels, rate) combinations, each
asserting the invariants every container must satisfy regardless of content:
structural self-consistency, byte-stable serialization, exact decoded
length, finite output, and decode chunk-size invariance.  Complements the
targeted suites with breadth — shapes are drawn from the bucketed ladder so
the compile count stays bounded on CPU.
"""

import numpy as np
import pytest

from glc import (
    CodecConfig,
    Decoder,
    Encoder,
    deserialize_encoded,
    serialize_encoded,
)

RATES = [8000, 22050, 44100, 48000]


def random_signal(rng: np.random.Generator, total: int) -> np.ndarray:
    """A random mix of tones, noise bursts, silence, and DC segments."""
    t = np.arange(total, dtype=np.float32)
    out = np.zeros(total, np.float32)
    for _ in range(int(rng.integers(1, 4))):
        f = float(rng.uniform(30, 8000))
        out += float(rng.uniform(0.05, 0.4)) * np.sin(
            2 * np.pi * f * t / 44100.0
        ).astype(np.float32)
    kind = int(rng.integers(0, 4))
    if kind == 0:  # noise burst in the middle
        a, b = sorted(rng.integers(0, total, 2))
        out[a:b] += rng.standard_normal(b - a).astype(np.float32) * 0.3
    elif kind == 1:  # hard clipping
        out = np.clip(out * 3.0, -0.9, 0.9)
    elif kind == 2:  # leading/trailing silence
        out[: total // 4] = 0.0
        out[-total // 4 :] = 0.0
    return out


@pytest.mark.parametrize("case", range(30))
def test_random_config_invariants(case):
    rng = np.random.default_rng(1000 + case)
    channels = int(rng.integers(1, 4))
    rate = int(rng.choice(RATES))
    # durations drawn small (compile-bucket friendly) with occasional longer
    dur = float(rng.choice([0.03, 0.1, 0.25, 0.7, 1.5]))
    total = max(int(rate * dur), 1)
    per = random_signal(rng, total)
    samples = np.repeat(per, channels).astype(np.float32)
    # ragged interleaved input — accepted only when the shorter channels
    # still pad to channel-0's length, i.e. (lead + T) % hop != 1
    # (frame_signal rejects the other case like the reference panics)
    if case % 5 == 0 and channels > 1 and (512 + total) % 1024 != 1:
        samples = samples[:-1]

    enc = Encoder(rate)
    ea = enc.encode(samples, channels)
    fs = ea.frame_set

    # structural invariants
    assert len(fs.pairs) == int(fs.nnz.sum())
    assert len(fs.raw_pcm) == int(fs.raw_mask.sum())
    assert (fs.nnz[fs.raw_mask] == 0).all()
    assert (fs.nnz >= 0).all() and (fs.nnz <= 1024).all()
    assert (fs.pairs["k"] < 1024).all()

    # byte-stable round trip
    data = serialize_encoded(ea)
    ea2 = deserialize_encoded(data)
    assert serialize_encoded(ea2) == data

    # exact length + finite output
    dec = Decoder(channels, rate)
    out = dec.decode(ea2)
    assert len(out) == len(samples)
    assert np.isfinite(out).all()
    assert dec.decoded_length(ea2) == len(out)

    # decode chunk-size invariance (≤1 ulp across chunkings is the
    # documented contract; require exact here since both decoders run the
    # same per-chunk program sizes unless F crosses a bucket)
    small = Decoder(channels, rate,
                    config=CodecConfig(decode_chunk_frames=128))
    out_small = small.decode(ea2)
    np.testing.assert_allclose(out, out_small, atol=3e-6, rtol=3e-5)

    # i16 surface agrees with the f32 surface within 1 LSB — compared
    # against the exporters' own f32 conversion (the documented contract),
    # not an f64 re-derivation that could disagree by an extra LSB
    from glc.io.audio import convert_f32_to_i16

    i16 = dec.decode_i16(ea2)
    ref = convert_f32_to_i16(out)
    assert np.abs(i16.astype(np.int32) - ref.astype(np.int32)).max() <= 1
