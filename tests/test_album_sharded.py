"""Album-scale multi-device equivalence: a batch of tracks encoded/decoded
over a virtual 8-device mesh must match the single-device per-file path
exactly.

The analog of the reference's only scale-out surface (the rayon thread-pool
scaling of tests/test_performance.rs:134-156) applied to the GUI's album
workflows (src/ui.rs:291-402): tracks ride the 'data' mesh axis, frames the
'frames' axis, and the decode halo is the 1-hop ppermute.
"""

import numpy as np
import pytest

from utils import generate_sine_wave, generate_white_noise

from glc import Decoder, Encoder, serialize_encoded
from glc.parallel import (
    decode_album_sharded,
    encode_album_sharded,
    make_mesh,
)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8)


@pytest.fixture(scope="module")
def album():
    """Three stereo tracks of different lengths; one noisy (raw-PCM path)."""
    t1 = generate_sine_wave(440.0, 44100, 2, 0.3)
    t2 = generate_sine_wave(660.0, 44100, 2, 0.5)
    t3 = generate_white_noise(44100, 2, 0.2, 99) * np.float32(0.5)
    return [t1, t2, t3]


def test_album_encode_matches_single_device(mesh, album):
    sharded = encode_album_sharded(mesh, album, 2, 44100)
    assert len(sharded) == len(album)
    enc = Encoder(44100)
    for s, ea_sh in zip(album, sharded):
        ea_1 = enc.encode(s, 2)
        # bit-identical containers: same math, different partitioning
        assert serialize_encoded(ea_sh) == serialize_encoded(ea_1)


def test_album_decode_matches_single_device(mesh, album):
    enc = Encoder(44100)
    encoded = [enc.encode(s, 2) for s in album]
    outs = decode_album_sharded(mesh, encoded)
    dec = Decoder(2, 44100)
    for ea, out_sh, src in zip(encoded, outs, album):
        out_1 = dec.decode(ea)
        assert len(out_sh) == len(src)
        # the partitioned program fuses the IMDCT/OLA chain differently from
        # the single-device one → ±1 ulp on a few % of samples; the encode
        # side is bit-identical because quantization absorbs it
        np.testing.assert_allclose(out_sh, out_1, rtol=2e-6, atol=1e-7)


def test_album_roundtrip_gapless_lengths(mesh, album):
    """The gapless contract at album scale: per-track decoded lengths equal
    the originals exactly, so concatenation is sample-exact at boundaries
    (reference tests/test_codec.rs:139-170)."""
    encoded = encode_album_sharded(mesh, album, 2, 44100)
    outs = decode_album_sharded(mesh, encoded)
    total = np.concatenate(outs)
    assert len(total) == sum(len(s) for s in album)


def test_album_mismatched_format_rejected(mesh):
    a = Encoder(44100).encode(generate_sine_wave(440.0, 44100, 1, 0.2), 1)
    b = Encoder(48000).encode(generate_sine_wave(440.0, 48000, 1, 0.2), 1)
    with pytest.raises(ValueError):
        decode_album_sharded(mesh, [a, b])


def test_album_single_track_and_nondivisible_batch(mesh, album):
    """Batch sizes that don't divide the 'data' axis get padded rows; those
    must not leak into results."""
    for tracks in ([album[0]], album[:3]):
        sharded = encode_album_sharded(mesh, tracks, 2, 44100)
        enc = Encoder(44100)
        for s, ea_sh in zip(tracks, sharded):
            assert serialize_encoded(ea_sh) == serialize_encoded(
                enc.encode(s, 2)
            )
