"""Locks down the reference's quirky behaviors (SURVEY.md §2.9) and the
clean-path fixes behind reference_compat=False.

These quirks are the behavioral contract for parity with the reference; the
clean mode demonstrates the fixes without changing the wire format.
"""

import numpy as np

from glc import CodecConfig, Decoder, Encoder
from utils import calculate_snr, generate_sine_wave, generate_white_noise

CLEAN = CodecConfig(reference_compat=False)


def test_q1_interleaved_trim_shifts_stereo():
    """Q1 (codec.rs:755-767): the gapless trim drains encoder_delay=512
    *interleaved* samples, so stereo is shifted by 256 per channel and the
    first 256 per-channel lead-in zeros remain.  Length is still exact."""
    samples = generate_sine_wave(440.0, 44100, 2, 1.0)
    encoded = Encoder(44100).encode(samples, 2)
    decoded = Decoder(2, 44100).decode(encoded)
    assert len(decoded) == len(samples)
    # The compat decode is late by 256 per-channel samples (512 interleaved):
    # compensating for the shift aligns it with the original...
    snr_shifted = calculate_snr(samples[: len(samples) - 512], decoded[512:])
    assert snr_shifted > 20.0, f"shift-compensated SNR: {snr_shifted}"
    # ...while the clean mode aligns exactly (high SNR, no shift).
    decoded_clean = Decoder(2, 44100, config=CLEAN).decode(
        Encoder(44100, config=CLEAN).encode(samples, 2)
    )
    assert len(decoded_clean) == len(samples)
    assert calculate_snr(samples, decoded_clean) > 20.0
    # compat stereo SNR is poor (misaligned), clean is good
    assert calculate_snr(samples, decoded) < 10.0


def test_q1_mono_unaffected():
    """For mono, interleaved units == per-channel units; both modes align."""
    samples = generate_sine_wave(440.0, 44100, 1, 1.0)
    compat = Decoder(1, 44100).decode(Encoder(44100).encode(samples, 1))
    clean = Decoder(1, 44100, config=CLEAN).decode(
        Encoder(44100, config=CLEAN).encode(samples, 1)
    )
    assert calculate_snr(samples, compat) > 20.0
    np.testing.assert_allclose(compat, clean, atol=1e-6)


def test_q2_padding_field_written():
    """Q2: GaplessInfo.padding is set (codec.rs:546) though never read."""
    samples = generate_sine_wave(440.0, 44100, 1, 1.0)  # 44100 per channel
    encoded = Encoder(44100).encode(samples, 1)
    T = 44100
    lead = 512
    P = lead + T
    P = P + (1024 - P % 1024) % 1024 + lead
    assert encoded.gapless_info.padding == P - T - lead
    assert encoded.gapless_info.encoder_delay == 512
    assert encoded.gapless_info.original_length == len(samples)


def test_q4_raw_pcm_single_windowed():
    """Q4 (codec.rs:496-502 vs 626-643): raw frames are windowed at encode
    but not re-windowed at decode, so overlap-add sums w[i]+w[i+hop] ∈
    [1, √2] instead of w²-complementary 1.  Mono white noise (all raw
    frames) therefore shows amplitude modulation ≥ ~1.2× mid-seam in compat
    mode; clean mode re-windows and reconstructs ~1:1."""
    samples = generate_white_noise(44100, 1, 1.0, 7)
    compat = Decoder(1, 44100).decode(Encoder(44100).encode(samples, 1))
    clean = Decoder(1, 44100, config=CLEAN).decode(
        Encoder(44100, config=CLEAN).encode(samples, 1)
    )
    # compat: RMS inflated by mean of (sin+cos) envelope ≈ 1.27
    rms_in = float(np.sqrt(np.mean(samples[2048:-2048] ** 2)))
    rms_compat = float(np.sqrt(np.mean(compat[2048:-2048] ** 2)))
    rms_clean = float(np.sqrt(np.mean(clean[2048:-2048] ** 2)))
    assert rms_compat / rms_in > 1.15
    assert abs(rms_clean / rms_in - 1.0) < 0.02
    assert calculate_snr(samples, clean) > 40.0


def test_q13_raw_pcm_channel_scramble():
    """Q13 (codec.rs:471-503 vs 636): raw PCM is stored channel-major but
    read back interleaved, scrambling stereo raw frames.  With distinct L/R
    noise, compat decode mangles the content; clean mode reconstructs it."""
    rng_l = generate_white_noise(44100, 1, 0.5, 1)
    rng_r = generate_white_noise(44100, 1, 0.5, 2)
    samples = np.empty(2 * len(rng_l), np.float32)
    samples[0::2] = rng_l
    samples[1::2] = rng_r

    encoded = Encoder(44100).encode(samples, 2)
    assert bool(encoded.frame_set.raw_mask.all())
    compat = Decoder(2, 44100).decode(encoded)
    assert calculate_snr(samples, compat) < 0.0  # scrambled

    clean_enc = Encoder(44100, config=CLEAN).encode(samples, 2)
    clean = Decoder(2, 44100, config=CLEAN).decode(clean_enc)
    assert calculate_snr(samples, clean) > 40.0


def test_untrimmed_streaming_length():
    """The streaming path never trims (codec.rs:744-768): total streamed
    length is (num_frames+1)·hop·channels interleaved samples."""
    samples = generate_sine_wave(440.0, 44100, 1, 1.0)
    encoded = Encoder(44100).encode(samples, 1)
    dec = Decoder(1, 44100)
    rx = dec.decode_streaming(encoded)
    total = 0
    while True:
        chunk = rx.get()
        total += len(chunk.samples)
        if chunk.is_last:
            break
    F = len(encoded.frames)
    assert total == (F + 1) * 1024


def test_decode_i16_matches_f32_path():
    """decode_i16 applies the exporters' trunc(clip(x·32767)) conversion on
    device.  The f32 hops come from a *differently compiled* XLA program
    than decode()'s, so values may differ by ±1 ulp — which flips the i16
    LSB only where x·32767 sits exactly on an integer boundary.  Contract:
    ≤1 LSB difference, on a vanishing fraction of samples."""
    from glc.io.audio import convert_f32_to_i16

    samples = generate_sine_wave(440.0, 44100, 2, 1.3)
    encoded = Encoder(44100).encode(samples, 2)
    dec = Decoder(2, 44100)
    f32 = dec.decode(encoded)
    i16 = dec.decode_i16(encoded)
    assert i16.dtype == np.int16
    assert len(i16) == len(f32)
    ref = convert_f32_to_i16(f32)
    diff = np.abs(i16.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1
    assert (diff != 0).mean() < 1e-3


def test_round_half_away_matches_rust_semantics():
    """Rust f32::round rounds half away from zero; jnp.round would round
    half to even (SURVEY.md §7 hard part #2)."""
    import jax

    from glc.ops.encode import round_half_away

    cases = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 0.49999997,
                      -0.49999997, 3.0, -3.0, 0.0], np.float32)
    expected = np.array([1.0, 2.0, 3.0, -1.0, -2.0, -3.0, 0.0,
                         -0.0, 3.0, -3.0, 0.0], np.float32)
    got = np.asarray(jax.jit(round_half_away)(cases))
    np.testing.assert_array_equal(got, expected)


def test_out_of_range_coefficient_index_skipped():
    """The reference skips sparse indices ≥ n at decode (codec.rs:661);
    a foreign .glc with k=2000 must decode without error."""
    from glc.container.schema import (
        PAIR_DTYPE, AudioHeader, EncodedAudio, EncodedFrame, GaplessInfo,
    )

    pairs = np.array([(5, 1000), (2000, 5000)], PAIR_DTYPE)  # 2000 ≥ 1024
    frame = EncodedFrame(
        sparse_coeffs_per_channel=[pairs],
        scale_factors=np.array([0.5], np.float32),
    )
    enc = EncodedAudio.from_frames(
        AudioHeader(44100, 1, 1024), [frame], GaplessInfo(512, 0, 1024)
    )
    out = Decoder(1, 44100).decode(enc)
    assert len(out) == 1024
    assert np.isfinite(out).all()


def test_progress_protocol_sequence():
    """The Progress protocol is part of the API surface (SURVEY.md §5):
    Status("Starting streaming decode of N frames") → Decoding(pct) per
    500-frame flush → Complete("Decoded N frames in X.XXs")."""
    import re

    from glc.container.schema import ProgressKind

    samples = generate_sine_wave(440.0, 44100, 1, 12.0)  # 517 frames
    encoded = Encoder(44100).encode(samples, 1)
    F = len(encoded.frames)
    assert F > 500

    msgs = []
    Decoder(1, 44100).decode(encoded, progress_sender=msgs.append)

    assert msgs[0].kind == ProgressKind.STATUS
    assert msgs[0].value == f"Starting streaming decode of {F} frames"
    decoding = [m for m in msgs if m.kind == ProgressKind.DECODING]
    assert len(decoding) == F // 500
    # pct uses the 0-based index of the frame that filled the chunk
    assert abs(decoding[0].value - 499 / F * 100.0) < 1e-6
    assert msgs[-1].kind == ProgressKind.COMPLETE
    assert re.fullmatch(rf"Decoded {F} frames in \d+\.\d\ds", msgs[-1].value)


def test_duplicate_coefficient_index_last_wins():
    """The reference's sequential scatter is last-wins on duplicate indices
    (codec.rs:660-663); the rebuild must decode such foreign containers
    deterministically the same way."""
    from glc.container.schema import (
        PAIR_DTYPE, AudioHeader, EncodedAudio, EncodedFrame, GaplessInfo,
    )

    pairs = np.array([(5, 1000), (5, -2000), (9, 300)], PAIR_DTYPE)
    frame = EncodedFrame(
        sparse_coeffs_per_channel=[pairs],
        scale_factors=np.array([0.5], np.float32),
    )
    enc = EncodedAudio.from_frames(
        AudioHeader(44100, 1, 1024), [frame], GaplessInfo(512, 0, 1024)
    )
    out1 = Decoder(1, 44100).decode(enc)

    # reference semantics: equivalent to keeping only the LAST (5, -2000)
    pairs2 = np.array([(5, -2000), (9, 300)], PAIR_DTYPE)
    frame2 = EncodedFrame(
        sparse_coeffs_per_channel=[pairs2],
        scale_factors=np.array([0.5], np.float32),
    )
    enc2 = EncodedAudio.from_frames(
        AudioHeader(44100, 1, 1024), [frame2], GaplessInfo(512, 0, 1024)
    )
    out2 = Decoder(1, 44100).decode(enc2)
    np.testing.assert_array_equal(out1, out2)
