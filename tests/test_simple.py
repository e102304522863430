"""Basic codec round-trip tests (mirrors reference tests/test_simple.rs)."""

import numpy as np
import pytest

from glc import Decoder, Encoder
from utils import calculate_snr_range, generate_sine_wave


def roundtrip(samples, sample_rate, channels):
    encoder = Encoder(sample_rate)
    encoded = encoder.encode(samples, channels)
    decoder = Decoder(channels, sample_rate)
    return encoded, decoder.decode(encoded)


def test_basic_encode_decode():
    """test_simple.rs:7-43"""
    samples = generate_sine_wave(440.0, 44100, 1, 2.0)
    encoded, decoded = roundtrip(samples, 44100, 1)
    assert len(encoded.frames) > 0

    min_len = min(len(samples), len(decoded))
    assert min_len > 1000
    snr = calculate_snr_range(samples, decoded, 1000, min(min_len, len(samples) - 1000))
    assert snr > -10.0, f"SNR too low: {snr} dB"


def test_length_preservation():
    """test_simple.rs:45-67"""
    samples = generate_sine_wave(440.0, 44100, 1, 2.0)
    _, decoded = roundtrip(samples, 44100, 1)
    length_ratio = len(decoded) / len(samples)
    assert abs(length_ratio - 1.0) < 0.01


def test_speed_ratio():
    """test_simple.rs:69-96"""
    samples = generate_sine_wave(440.0, 44100, 1, 2.0)
    _, decoded = roundtrip(samples, 44100, 1)
    speed_ratio = (len(decoded) / 44100) / (len(samples) / 44100)
    assert abs(speed_ratio - 1.0) < 0.01


@pytest.mark.parametrize("frequency", [100.0, 440.0, 1000.0, 2000.0])
def test_multiple_frequencies(frequency):
    """test_simple.rs:98-122"""
    samples = generate_sine_wave(frequency, 44100, 1, 1.0)
    _, decoded = roundtrip(samples, 44100, 1)
    assert len(decoded) == len(samples)


@pytest.mark.parametrize("duration", [0.5, 1.0, 2.0, 5.0])
def test_various_durations(duration):
    """test_simple.rs:124-149"""
    samples = generate_sine_wave(440.0, 44100, 1, duration)
    _, decoded = roundtrip(samples, 44100, 1)
    assert len(decoded) == len(samples)


def test_tiny_input_single_frame():
    """100 samples → one frame; exact length through the trim."""
    samples = generate_sine_wave(440.0, 44100, 1, 1.0)[:100].copy()
    encoded, decoded = roundtrip(samples, 44100, 1)
    assert len(encoded.frames) == 1
    assert len(decoded) == 100


def test_integer_input_rejected():
    from glc import Encoder
    with pytest.raises(TypeError):
        Encoder(44100).encode(np.zeros(1000, np.int16), 1)


def test_ragged_interleaved_input():
    """The reference deinterleaves by i % ch, accepting ragged interleaved
    counts (codec.rs:427-431); length is preserved through the trim."""
    samples = generate_sine_wave(440.0, 44100, 1, 1.2)[:44101].copy()
    encoded, decoded = roundtrip(samples, 44100, 2)  # odd count, stereo
    assert encoded.header.total_samples == 44101
    assert len(decoded) == 44101
