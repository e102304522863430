"""On-disk compression ratio tests (mirrors reference tests/test_file_size.rs).

Ratio = original f32 byte size / .glc file size, stereo 10 s signals
(test_file_size.rs:15-38).
"""

import numpy as np
import pytest

from glc import Encoder, save_encoded
from utils import (
    generate_frequency_sweep,
    generate_sawtooth_wave,
    generate_sine_wave,
    generate_square_wave,
    generate_white_noise,
)


def waveform_ratio(tmp_path, samples, name):
    encoded = Encoder(44100).encode(samples, 2)
    p = tmp_path / f"test_{name}.glc"
    save_encoded(encoded, p)
    file_size = p.stat().st_size
    return len(samples) * 4 / file_size, encoded


@pytest.mark.parametrize("gen,name", [
    (lambda: generate_sine_wave(440.0, 44100, 2, 10.0), "sine"),
    (lambda: generate_square_wave(440.0, 44100, 2, 10.0), "square"),
    (lambda: generate_sawtooth_wave(440.0, 44100, 2, 10.0), "sawtooth"),
    (lambda: generate_frequency_sweep(100.0, 10000.0, 44100, 2, 10.0), "sweep"),
])
def test_compression_tonal(tmp_path, gen, name):
    """test_file_size.rs:40-82 — tonal stereo signals compress ≥ 2×."""
    ratio, _ = waveform_ratio(tmp_path, gen(), name)
    assert ratio >= 2.0, f"Compression ratio too low: {ratio:.2f}x"


def test_compression_multiple_frequencies(tmp_path):
    """test_file_size.rs:84-109 — C major chord."""
    freqs = [261.63, 329.63, 392.00]
    parts = [generate_sine_wave(f, 44100, 2, 10.0) for f in freqs]
    mixed = ((parts[0] + parts[1] + parts[2]) / np.float32(3.0)).astype(np.float32)
    ratio, _ = waveform_ratio(tmp_path, mixed, "chord")
    assert ratio >= 2.0, f"Compression ratio too low: {ratio:.2f}x"


def test_compression_white_noise(tmp_path):
    """test_file_size.rs:111-127, corrected.

    White noise must hit the raw-PCM fallback on every frame.  The reference
    test asserts ratio ∈ [1.95, 2.05], but that bound matches an *older* raw
    layout storing HOP_SIZE samples per frame (still claimed by the struct
    comment at codec.rs:67); the current reference code stores FRAME_SIZE
    samples (codec.rs:469,499), which makes the true ratio ~1.0 — i16 at 2×
    overlap costs exactly the f32 input size.  We assert the behavior the
    shipped code actually has: full fallback and no significant expansion.
    """
    samples = generate_white_noise(44100, 2, 10.0, 12345)
    ratio, encoded = waveform_ratio(tmp_path, samples, "white_noise")
    # every frame must use the raw-PCM fallback
    assert bool(encoded.frame_set.raw_mask.all()), "expected full raw-PCM fallback"
    assert 0.95 <= ratio <= 1.05, f"unexpected white-noise ratio: {ratio:.2f}x"
