"""Coefficient sparsity (mirrors reference tests/test_compression_ratio.rs)."""

from glc import Encoder
from utils import generate_sine_wave


def test_compression_effectiveness():
    """test_compression_ratio.rs:6-36 — a 440 Hz sine must keep < 50% of
    MDCT coefficients."""
    samples = generate_sine_wave(440.0, 44100, 1, 2.0)
    encoded = Encoder(44100).encode(samples, 1)

    fs = encoded.frame_set
    comp_frames = int((~fs.raw_mask).sum())
    total_coeffs = int(fs.nnz.sum())
    total_possible = comp_frames * fs.channels * 1024
    assert total_possible > 0
    sparsity = total_coeffs / total_possible
    assert sparsity < 0.5, f"{sparsity*100:.2f}% coefficients retained"
