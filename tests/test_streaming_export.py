"""Streaming decode→FLAC export: byte identity with the batch path.

`Decoder.decode_i16_stream` + `encode_flac_i16_streaming` overlap host FLAC
math with device transfers; these tests pin that the streamed results are
EXACTLY the batch results — same trimmed samples, same FLAC bytes — across
chunk boundaries, gapless trims, raw-PCM frames, stereo, and odd lengths.
"""

import numpy as np
import pytest

from utils import generate_sine_wave, generate_white_noise

from glc import CodecConfig, Decoder, Encoder
from glc.flac.encoder import (
    FlacError,
    encode_flac_i16_streaming,
    encode_flac_i16_with_level,
)


@pytest.mark.parametrize(
    "channels,duration",
    [(1, 2.0), (2, 1.0), (1, 0.05)],
)
def test_decode_stream_equals_batch(channels, duration):
    s = generate_sine_wave(440.0, 44100, channels, duration)
    ea = Encoder(44100).encode(s, channels)
    dec = Decoder(channels, 44100)
    batch = dec.decode_i16(ea)
    streamed = np.concatenate(list(dec.decode_i16_stream(ea)))
    np.testing.assert_array_equal(streamed, batch)
    assert dec.decoded_length(ea) == len(batch)


def test_decode_stream_small_chunks_and_raw_frames():
    """Multiple decode chunks + raw-PCM fallback frames cross the stream.

    Needs > 128 frames (the chunk-size floor) to actually span chunks: the
    overlap tail rides the last chunk's download now (append_carry), so a
    single-chunk stream yields exactly one part."""
    tone = generate_sine_wave(440.0, 44100, 1, 1.6)
    noise = generate_white_noise(44100, 1, 1.6, 5)
    s = np.concatenate([tone, noise]).astype(np.float32)
    ea = Encoder(44100).encode(s, 1)
    assert int(ea.frame_set.raw_mask.sum()) > 0
    assert ea.frame_set.num_frames > 128
    dec = Decoder(1, 44100, config=CodecConfig(decode_chunk_frames=128))
    batch = dec.decode_i16(ea)
    parts = list(dec.decode_i16_stream(ea))
    assert len(parts) > 1  # the stream really is chunked
    np.testing.assert_array_equal(np.concatenate(parts), batch)


@pytest.mark.parametrize("level", [0, 3, 5, 8])
def test_streaming_flac_byte_identity(level):
    rng = np.random.default_rng(0)
    i16 = (rng.standard_normal(44100 * 2) * 8000).astype(np.int16)
    ref = encode_flac_i16_with_level(i16, 44100, 2, level)

    # feed in awkward chunk sizes (not block-aligned, not channel-aligned
    # boundaries of the final stream are irrelevant — only concatenation
    # order matters)
    cuts = np.sort(rng.choice(len(i16) - 2, 7, replace=False) + 1)
    chunks = np.split(i16, cuts)
    got = encode_flac_i16_streaming(iter(chunks), 44100, 2, level,
                                    len(i16) // 2)
    assert got == ref


def test_streaming_flac_single_chunk_and_partial_tail():
    """Total not a multiple of the block size → partial last block."""
    rng = np.random.default_rng(1)
    total = 4096 * 2 + 1234
    i16 = (rng.standard_normal(total) * 5000).astype(np.int16)
    ref = encode_flac_i16_with_level(i16, 48000, 1, 5)
    got = encode_flac_i16_streaming(iter([i16]), 48000, 1, 5, total)
    assert got == ref


def test_streaming_flac_length_mismatch_rejected():
    i16 = np.zeros(1000, np.int16)
    with pytest.raises(FlacError):
        encode_flac_i16_streaming(iter([i16]), 44100, 1, 5, 999)


def test_streaming_flac_incremental_matches_whole_pack(monkeypatch):
    """Per-group incremental frame packing (glc_flac_pack_frames as each
    group's stats complete, header + join at end-of-stream) is
    byte-identical to the single final whole-stream pack
    (GLC_FLAC_WHOLE_PACK=1) — frames are byte-aligned and
    self-contained, so WHEN they are packed cannot change the bytes."""
    rng = np.random.default_rng(2)
    i16 = (rng.standard_normal(4096 * 33 + 777) * 6000).astype(np.int16)
    chunks = np.split(i16, [10000, 50000, 90000])
    a = encode_flac_i16_streaming(iter(chunks), 44100, 1, 5, len(i16))
    monkeypatch.setenv("GLC_FLAC_WHOLE_PACK", "1")
    b = encode_flac_i16_streaming(iter(chunks), 44100, 1, 5, len(i16))
    assert a == b


def test_cli_decode_uses_streaming_path(tmp_path, capsys):
    """The CLI flac export (now streamed) produces the same bytes and the
    same printed output shape as before."""
    from glc.cli import main
    from glc.io.wav import write_wav

    s = generate_sine_wave(440.0, 44100, 2, 0.5)
    wav = tmp_path / "t.wav"
    write_wav(wav, s, 44100, 2)
    assert main([str(wav)]) == 0
    glc = wav.with_suffix(".glc")
    assert main(["-d", str(glc)]) == 0
    out = capsys.readouterr().out
    assert "Decoded " in out and "(FLAC, level 5)" in out
    flac = wav.with_suffix(".flac")

    # oracle: batch decode + batch encode
    from glc import load_encoded

    ea = load_encoded(glc)
    dec = Decoder(2, 44100)
    ref = encode_flac_i16_with_level(dec.decode_i16(ea), 44100, 2, 5)
    assert flac.read_bytes() == ref


def test_album_export_streaming_byte_identity(tmp_path):
    from glc import save_encoded
    from glc.album import export_playlist_to_flac

    paths = []
    for i, f in enumerate((440.0, 660.0)):
        s = generate_sine_wave(f, 44100, 1, 0.4)
        p = tmp_path / f"t{i}.glc"
        save_encoded(Encoder(44100).encode(s, 1), p)
        paths.append(p)
    out = tmp_path / "album.flac"
    export_playlist_to_flac(paths, out, 5)

    dec = Decoder(1, 44100)
    from glc import load_encoded

    full = np.concatenate(
        [dec.decode_i16(load_encoded(p)) for p in paths]
    )
    ref = encode_flac_i16_with_level(full, 44100, 1, 5)
    assert out.read_bytes() == ref


def test_stream_chunk_override_byte_identical():
    """The chunk_frames override changes transfer scheduling only: on the
    CPU backend FLAC bytes are identical for any decode chunk size."""
    s = generate_sine_wave(440.0, 44100, 2, 2.2)
    ea = Encoder(44100).encode(s, 2)
    dec = Decoder(2, 44100)
    n_total = dec.decoded_length(ea)
    outs = [
        encode_flac_i16_streaming(
            dec.decode_i16_stream(ea, chunk_frames=kf), 44100, 2, 5,
            n_total // 2,
        )
        for kf in (None, 1024, 256, 128)
    ]
    assert all(o == outs[0] for o in outs[1:])
