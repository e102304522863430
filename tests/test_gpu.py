"""Tests that need an NVIDIA GPU (marker `gpu`; they skip elsewhere).

`python chip_smoke.py` runs them on the card, inside its own process, as
its `gpu_tests` phase.  They pin what only the GPU can show: f32 transform
precision (no TF32), run-to-run determinism of encode and decode, and the
album paths against the serial ones.
"""

import numpy as np
import pytest

from utils import generate_sine_wave, generate_white_noise

from glc import Decoder, Encoder, serialize_encoded
from glc.ops.mdct import (
    get_mdct_tables,
    imdct,
    imdct_window_f64,
    mdct,
    mdct_f64,
    relative_error,
)

pytestmark = pytest.mark.gpu


def _material(seconds: float, seed: int) -> np.ndarray:
    tone = generate_sine_wave(330.0 + 55.0 * seed, 44100, 2, seconds)
    noise = generate_white_noise(44100, 2, seconds, seed)
    x = 0.6 * tone + 0.02 * noise[: len(tone)]
    return np.clip(x * 32767.0, -32768, 32767).astype(np.int16)


def test_transforms_hold_f32_precision(gpu_device):
    """Precision.HIGHEST keeps the products out of TF32: both transforms
    stay within 1e-5 of float64 at the decode-chunk width."""
    tb = get_mdct_tables(1024, 2048)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2816, 2, 2048)).astype(np.float32)
    assert relative_error(mdct(x, tb.cos_table, tb.norm), mdct_f64(x, tb)) \
        <= 1e-5
    c = rng.standard_normal((2816, 2, 1024)).astype(np.float32) * 0.1
    out = imdct(c, tb.cos_table, tb.norm) * tb.window
    assert relative_error(out, imdct_window_f64(c, tb)) <= 1e-5


def test_encode_and_decode_are_deterministic(gpu_device):
    pcm = _material(20.0, 1)
    enc = Encoder(44100)
    a = serialize_encoded(enc.encode_pcm16(pcm, 2))
    b = serialize_encoded(enc.encode_pcm16(pcm, 2))
    assert a == b
    ea = enc.encode_pcm16(pcm, 2)
    dec = Decoder(2, 44100)
    assert np.array_equal(dec.decode_i16(ea), dec.decode_i16(ea))
    assert np.array_equal(dec.decode(ea), dec.decode(ea))


def test_album_paths_match_serial(gpu_device):
    """Short tracks take the batched lax.map programs: the containers equal
    the serial encodes byte for byte, decode_many is within 1 LSB."""
    tracks = [(_material(4.0, s), 2) for s in range(4)]
    enc = Encoder(44100)
    many = enc.encode_many(tracks)
    for (pcm, c), ea in zip(tracks, many):
        assert serialize_encoded(ea) == serialize_encoded(
            enc.encode_pcm16(pcm, c))
    dec = Decoder(2, 44100)
    for (pcm, _c), out, ea in zip(tracks, dec.decode_many(many), many):
        ref = dec.decode_i16(ea)
        assert len(out) == len(ref) == len(pcm)
        assert int(np.abs(out.astype(np.int32) - ref).max()) <= 1
