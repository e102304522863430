"""End-to-end coverage of the encoder's density-tiered transfer programs.

The device encode compacts sparse pairs into a budget TIER (n/8 → n/4 →
n/2 of the coefficient slots; reference density model src/codec.rs:506-521).
Past the 50% byte crossover — where 4-byte packed pairs outweigh the dense
program's 2-byte rows — the segment takes a DIFFERENT compiled program
(`encode_interleaved_dense_device`), whose keep-gate can differ by ±1 ulp
from the compacting program's, so the encoder takes nnz/scales/use_raw from
the dense program too.  The program FAMILY is decided ONLY by the exact
per-segment kept-pair count (encoder._reencode_overflow); the adaptive
density hint sizes the dispatch-time tier (or dispatches a stats-only
budget=0 probe for predicted-dense content) but can never change the
container bytes.  These tests pin that contract.
"""

import numpy as np
import pytest

import glc.codec.encoder as encoder_mod
from glc import Decoder, Encoder, deserialize_encoded, serialize_encoded
from glc.config import CodecConfig


def bandlimited_noise(duration_s: float, channels: int, frac: float = 0.4,
                      sample_rate: int = 44100, seed: int = 7) -> np.ndarray:
    """White noise lowpassed to `frac` of the spectrum: ~frac kept-coefficient
    density.  0.4 sits between the n/8 standard tier and the 50% byte
    crossover; 0.65 sits past the crossover, below the raw-PCM trip point."""
    rng = np.random.default_rng(seed)
    T = int(sample_rate * duration_s)
    chans = []
    for _ in range(channels):
        x = rng.standard_normal(T)
        X = np.fft.rfft(x)
        X[int(len(X) * frac):] = 0
        y = np.fft.irfft(X, T)
        chans.append(y / np.abs(y).max() * 0.5)
    out = np.empty(T * channels, np.float32)
    for c, y in enumerate(chans):
        out[c::channels] = y
    return out


@pytest.fixture()
def count_programs(monkeypatch):
    """Count dense-program and stats-only-probe device dispatches."""
    calls = {"dense": 0, "probe": 0}
    real_dense = encoder_mod.encode_interleaved_dense_device
    real_solo = encoder_mod.encode_interleaved_device

    def counting_dense(*args, **kwargs):
        calls["dense"] += 1
        return real_dense(*args, **kwargs)

    def counting_solo(*args, **kwargs):
        if kwargs.get("budget") == 0:
            calls["probe"] += 1
        return real_solo(*args, **kwargs)

    monkeypatch.setattr(
        encoder_mod, "encode_interleaved_dense_device", counting_dense)
    monkeypatch.setattr(
        encoder_mod, "encode_interleaved_device", counting_solo)
    return calls


def check_container(ea, samples, channels):
    """Self-consistency + bincode round-trip + sane reconstruction."""
    fs = ea.frame_set
    # the pair stream is segmented by nnz, raw rows by raw_mask — any
    # desync between a program's stats and its pairs breaks these
    assert len(fs.pairs) == int(fs.nnz.sum())
    assert len(fs.raw_pcm) == int(fs.raw_mask.sum())
    assert (fs.nnz[fs.raw_mask] == 0).all()
    assert (fs.scales > 0).all()

    data = serialize_encoded(ea)
    ea2 = deserialize_encoded(data)
    assert serialize_encoded(ea2) == data

    # decode: exact length, sane reconstruction (skip edge transients).
    # Quality is judged in clean mode — reference_compat reproduces quirk
    # Q1, whose stereo trim shift makes sample comparison meaningless.
    out = Decoder(channels, 44100).decode(ea2)
    assert len(out) == len(samples)
    clean = CodecConfig(reference_compat=False)
    ea_clean = Encoder(44100, config=clean).encode(samples, channels)
    out_clean = Decoder(channels, 44100, config=clean).decode(ea_clean)
    assert len(out_clean) == len(samples)
    a, b = samples[1000:-1000], out_clean[1000:-1000]
    err = np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(a ** 2))
    assert err < 0.5, f"relative RMS error {err:.3f}"


@pytest.mark.parametrize("channels,duration", [(1, 2.0), (2, 1.0)])
def test_midrange_density_stays_compact(channels, duration, count_programs):
    """~40% density is past the standard n/8 tier but below the byte
    crossover: a bigger compact TIER must serve it — the dense program
    (strictly more transfer bytes here) must never fire."""
    samples = bandlimited_noise(duration, channels, frac=0.4)
    enc = Encoder(44100)
    ea = enc.encode(samples, channels)

    assert count_programs["dense"] == 0

    fs = ea.frame_set
    density = fs.nnz[~fs.raw_mask].mean() / 1024
    assert 0.15 < density < 0.50
    assert not fs.raw_mask.all()
    check_container(ea, samples, channels)


def test_dense_fires_past_byte_crossover(count_programs):
    """~65% density exceeds the 50% byte crossover: the dense int16
    program must carry those segments (packed pairs would transfer more
    bytes), and its stats must stay self-consistent with its pairs."""
    samples = bandlimited_noise(2.0, 1, frac=0.65)
    enc = Encoder(44100)
    ea = enc.encode(samples, 1)

    assert count_programs["dense"] > 0

    fs = ea.frame_set
    density = fs.nnz[~fs.raw_mask].mean() / 1024
    assert 0.50 < density < 0.80
    assert not fs.raw_mask.all()
    check_container(ea, samples, 1)


def test_density_hint_cannot_change_bytes_midrange(count_programs):
    """Same mid-density content encoded cold (standard tier → overflow →
    bigger tier) and warm (hint dispatches the right tier directly) must
    byte-match: every compact tier is an exact packing of identical math."""
    samples = bandlimited_noise(2.0, 1, frac=0.4)
    enc = Encoder(44100)
    d1 = serialize_encoded(enc.encode(samples, 1))
    d2 = serialize_encoded(enc.encode(samples, 1))
    assert count_programs["dense"] == 0
    assert d1 == d2


def test_density_hint_cannot_change_bytes_dense(count_programs):
    """Same past-crossover content encoded cold (tier overflow → dense)
    and warm (hint ≥ 80% of cap → stats-only budget=0 probe → dense) must
    byte-match: the probe measures, the exact count decides."""
    samples = bandlimited_noise(2.0, 1, frac=0.65)
    enc = Encoder(44100)
    d1 = serialize_encoded(enc.encode(samples, 1))
    d2 = serialize_encoded(enc.encode(samples, 1))
    assert count_programs["dense"] >= 2
    assert count_programs["probe"] >= 1  # the warm encode probed first
    assert d1 == d2


def test_tiered_path_matches_standard_tier_when_budget_allows():
    """The same signal encoded through a segment plan whose standard-tier
    budget is not exceeded (shorter file → higher budget-to-content ratio)
    must agree with the bigger-tier container on the frames they share —
    every tier implements one spec (codec.rs:462-541)."""
    # 0.25 s at 40%: F≈10 frames, budget floor 16384 pairs > ~4.3k kept →
    # standard tier; same frames inside the 2 s file go through a bigger
    # tier.  The short signal is a PREFIX of the long one (bandlimiting is
    # length-dependent, so slice rather than regenerate) — frame 0 sees
    # identical samples in both.
    long = bandlimited_noise(2.0, 1)
    short = long[: int(44100 * 0.25)].copy()

    enc = Encoder(44100)
    ea_s = enc.encode(short, 1)
    ea_l = enc.encode(long, 1)
    fs_s, fs_l = ea_s.frame_set, ea_l.frame_set

    # frame 4 lies fully inside the shared prefix (its 2048-sample window
    # ends at sample 4·1024+1536 < 11025): same windowed input, so stats
    # and pairs must agree up to segment-shape einsum ulp tolerance
    f = 4
    n_s, n_l = int(fs_s.nnz[f, 0]), int(fs_l.nnz[f, 0])
    assert n_s > 100  # genuinely dense content in this frame
    assert abs(n_s - n_l) <= 2
    assert fs_s.scales[f, 0] == fs_l.scales[f, 0]
    off_s = int(fs_s.nnz[:f].sum())
    off_l = int(fs_l.nnz[:f].sum())
    m = min(n_s, n_l)
    ps = fs_s.pairs[off_s : off_s + m]
    pl = fs_l.pairs[off_l : off_l + m]
    same = (ps["k"] == pl["k"]) & (ps["q"] == pl["q"])
    assert same.mean() > 0.99
