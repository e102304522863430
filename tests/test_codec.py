"""Per-waveform round-trip + gapless contract (mirrors reference tests/test_codec.rs)."""

import numpy as np

from glc import Decoder, Encoder
from utils import (
    calculate_snr,
    generate_sawtooth_wave,
    generate_sine_wave,
    generate_square_wave,
)


def roundtrip(samples, sample_rate, channels):
    encoded = Encoder(sample_rate).encode(samples, channels)
    return Decoder(channels, sample_rate).decode(encoded)


def test_sine_wave_440hz_mono():
    """test_codec.rs:6-24"""
    samples = generate_sine_wave(440.0, 44100, 1, 2.0)
    decoded = roundtrip(samples, 44100, 1)
    assert len(decoded) == len(samples)
    snr = calculate_snr(samples, decoded)
    assert snr > -10.0, f"SNR too low: {snr} dB"


def test_square_wave_1000hz_mono():
    """test_codec.rs:26-44"""
    samples = generate_square_wave(1000.0, 44100, 1, 2.0)
    decoded = roundtrip(samples, 44100, 1)
    assert len(decoded) == len(samples)
    snr = calculate_snr(samples, decoded)
    assert snr > -15.0, f"SNR too low: {snr} dB"


def test_sawtooth_wave_440hz_mono():
    """test_codec.rs:46-64"""
    samples = generate_sawtooth_wave(440.0, 44100, 1, 2.0)
    decoded = roundtrip(samples, 44100, 1)
    assert len(decoded) == len(samples)
    snr = calculate_snr(samples, decoded)
    assert snr > -10.0, f"SNR too low: {snr} dB"


def test_sample_rate_variations():
    """test_codec.rs:66-89"""
    for rate in (44100, 48000):
        samples = generate_sine_wave(440.0, rate, 1, 1.0)
        decoded = roundtrip(samples, rate, 1)
        assert len(decoded) == len(samples)


def test_stereo_encoding():
    """test_codec.rs:91-109 — note the reference's own Q1 interleaved trim
    makes stereo SNR much worse than mono; the gate is the same −10 dB."""
    samples = generate_sine_wave(440.0, 44100, 2, 2.0)
    decoded = roundtrip(samples, 44100, 2)
    assert len(decoded) == len(samples)
    snr = calculate_snr(samples, decoded)
    assert snr > -10.0, f"Stereo SNR too low: {snr} dB"


def test_short_duration():
    """test_codec.rs:111-123"""
    samples = generate_sine_wave(440.0, 44100, 1, 0.5)
    decoded = roundtrip(samples, 44100, 1)
    assert len(decoded) == len(samples)


def test_long_duration():
    """test_codec.rs:125-137"""
    samples = generate_sine_wave(440.0, 44100, 1, 5.0)
    decoded = roundtrip(samples, 44100, 1)
    assert len(decoded) == len(samples)


def test_gapless_multiple_files():
    """test_codec.rs:139-170 — the gapless contract: per-file round trips
    preserve exact total length across a 3-file album."""
    file1 = generate_sine_wave(440.0, 44100, 1, 2.0)
    file2 = generate_sine_wave(880.0, 44100, 1, 2.0)
    file3 = generate_square_wave(440.0, 44100, 1, 2.0)
    total_original = len(file1) + len(file2) + len(file3)

    total_decoded = 0
    for f in (file1, file2, file3):
        total_decoded += len(roundtrip(f, 44100, 1))
    assert total_decoded == total_original
