"""Segment/chunk invariance: results must not depend on how the frame axis
is split into device chunks (the rebuild's analog of the reference's
"never rely on completion order" lesson, SURVEY.md §5 race detection)."""

import numpy as np

from glc import CodecConfig, Decoder, Encoder, serialize_encoded
from utils import generate_frequency_sweep, generate_white_noise


def test_encode_segmentation_invariance():
    """A ~30 s signal spans multiple encode segments at small chunk sizes;
    the container must be byte-identical to the single-segment result."""
    samples = generate_frequency_sweep(100.0, 8000.0, 44100, 1, 30.0)
    big = Encoder(44100, config=CodecConfig(encode_chunk_frames=4096))
    small = Encoder(44100, config=CodecConfig(encode_chunk_frames=512))
    data_big = serialize_encoded(big.encode(samples, 1))
    data_small = serialize_encoded(small.encode(samples, 1))
    assert data_big == data_small


def test_encode_segmentation_invariance_with_raw_frames():
    """Mixed raw/compressed content across segment boundaries."""
    tone = generate_frequency_sweep(200.0, 2000.0, 44100, 1, 10.0)
    noise = generate_white_noise(44100, 1, 10.0, 11)
    samples = np.concatenate([tone, noise, tone]).astype(np.float32)
    big = Encoder(44100, config=CodecConfig(encode_chunk_frames=4096))
    small = Encoder(44100, config=CodecConfig(encode_chunk_frames=512))
    ea_big = big.encode(samples, 1)
    ea_small = small.encode(samples, 1)
    assert int(ea_big.frame_set.raw_mask.sum()) > 0
    assert serialize_encoded(ea_big) == serialize_encoded(ea_small)


def test_decode_chunking_invariance():
    """Decode output must be identical whether the carry crosses one chunk
    boundary or many."""
    samples = generate_frequency_sweep(100.0, 4000.0, 44100, 2, 15.0)
    encoded = Encoder(44100).encode(samples, 2)
    big = Decoder(2, 44100, config=CodecConfig(decode_chunk_frames=4096))
    small = Decoder(2, 44100, config=CodecConfig(decode_chunk_frames=512))
    out_big = big.decode(encoded)
    out_small = small.decode(encoded)
    # different chunk sizes are different XLA programs → ±ulp f32 wiggle
    np.testing.assert_allclose(out_big, out_small, atol=2e-6)
    i_big = big.decode_i16(encoded).astype(np.int32)
    i_small = small.decode_i16(encoded).astype(np.int32)
    diff = np.abs(i_big - i_small)
    assert diff.max() <= 1
    assert (diff != 0).mean() < 1e-3


def test_len_bucket_ladder():
    """The resident-length ladder bounds both the overshoot (≤12.5%) and
    the number of distinct compiled shapes (≤8 per octave) — an exact
    length would recompile the encode programs per long-file length."""
    from glc.codec.encoder import _len_bucket

    for x in (1, 16, 17, 100, 4097, 8193, 65535, 10**6):
        b = _len_bucket(x)
        assert b >= x
        assert b <= max(16, x + (x >> 3))  # ≤ 12.5% overshoot
    # ladder is idempotent (values are fixed points)
    for x in (16, 24, 4096, 4608, 9216):
        assert _len_bucket(x) == x
    # distinct values per octave is bounded
    octave = {_len_bucket(x) for x in range(4097, 8193)}
    assert len(octave) <= 8


def test_encode_many_matches_serial():
    """Pipelined multi-file encode (file i+1 uploaded before file i's
    downloads) must produce bit-identical containers to per-file calls,
    across mixed i16/f32 inputs and lengths."""
    from utils import generate_sine_wave

    enc = Encoder(44100)
    f32_a = generate_sine_wave(440.0, 44100, 2, 0.4)
    f32_b = generate_sine_wave(660.0, 44100, 1, 1.1)
    i16_c = np.clip(
        generate_sine_wave(880.0, 44100, 2, 0.3) * 32767.0, -32768, 32767
    ).astype(np.int16)
    f32_d = generate_sine_wave(220.0, 44100, 1, 0.05)

    many = enc.encode_many(
        [(f32_a, 2), (f32_b, 1), (i16_c, 2), (f32_d, 1)]
    )
    singles = [
        enc.encode(f32_a, 2),
        enc.encode(f32_b, 1),
        enc.encode_pcm16(i16_c, 2),
        enc.encode(f32_d, 1),
    ]
    assert len(many) == 4
    for got, want in zip(many, singles):
        assert serialize_encoded(got) == serialize_encoded(want)


def test_compaction_matches_reference_order():
    """_compact_pairs (sort-free cumsum+scatter) must reproduce the exact
    stream order of a host global compaction — row-major over
    (frame, channel), ascending k — for sparse and dense rows alike."""
    import jax
    from glc.ops.encode import _compact_pairs

    rng = np.random.default_rng(0)
    n = 1024
    K, C = 8, 2
    budget = K * C * n // 8

    def host_ref(q):
        flat = q.reshape(-1, n).astype(np.int64)
        ref = []
        for r in range(flat.shape[0]):
            for k in np.nonzero(flat[r])[0]:
                ref.append((int(k) << 16) | (int(flat[r, k]) & 0xFFFF))
        return np.asarray(ref, np.int32)

    # sparse rows
    q = np.where(rng.random((K, C, n)) < 0.05,
                 rng.integers(-3000, 3000, (K, C, n)), 0).astype(np.int16)
    nnz = (q != 0).sum(-1).astype(np.int32)
    got = np.asarray(jax.jit(
        lambda q, z: _compact_pairs(q, z, n, budget))(q, nnz))
    ref = host_ref(q)
    np.testing.assert_array_equal(got[: len(ref)], ref)

    # one very dense row mixed in — same answer
    q2 = q.copy()
    q2[0, 0, :700] = 7
    nnz2 = (q2 != 0).sum(-1).astype(np.int32)
    got2 = np.asarray(jax.jit(
        lambda q, z: _compact_pairs(q, z, n, budget))(q2, nnz2))
    ref2 = host_ref(q2)
    np.testing.assert_array_equal(got2[: len(ref2)], ref2)


def test_blocked_compaction_matches_element_scatter():
    """_compact_pairs_auto (two-stage blocked compaction) must be
    bit-identical to the legacy element scatter in every regime: the fast
    branch (kept blocks within bb_mult·R), the full-coverage lax.cond
    branch (content denser than the budget), the always-full static case
    (bb_mult ≥ NB), and the static guard fallbacks (bb_mult=0, n not a
    multiple of the block size)."""
    import jax
    from glc.ops.encode import _compact_pairs, _compact_pairs_auto

    rng = np.random.default_rng(3)
    n = 1024
    K, C = 8, 2
    budget = K * C * n // 8

    def both(q, nnz, bb_mult, n=n, budget=budget):
        legacy = np.asarray(jax.jit(
            lambda q, z: _compact_pairs(q, z, n, budget))(q, nnz))
        auto = np.asarray(jax.jit(
            lambda q, z: _compact_pairs_auto(q, z, n, budget, bb_mult)
        )(q, nnz))
        wanted = int(nnz.sum())
        np.testing.assert_array_equal(auto[:wanted], legacy[:wanted])

    # clustered sparse rows → fast branch
    q = np.zeros((K, C, n), np.int16)
    for f in range(K):
        for c in range(C):
            base = rng.integers(0, n - 300)
            idx = base + rng.integers(0, 260, size=40)
            q[f, c, np.unique(idx)] = rng.integers(1, 3000)
    nnz = (q != 0).sum(-1).astype(np.int32)
    both(q, nnz, bb_mult=6)

    # spread rows (every 128-block kept) → overflow → full-coverage branch
    q2 = np.where(rng.random((K, C, n)) < 0.3,
                  rng.integers(-3000, 3000, (K, C, n)), 0).astype(np.int16)
    nnz2 = (q2 != 0).sum(-1).astype(np.int32)
    both(q2, nnz2, bb_mult=1)

    # bb_mult >= NB → static always-full path (no cond)
    both(q2, nnz2, bb_mult=8)

    # static guards → legacy path
    both(q2, nnz2, bb_mult=0)
    n3 = 96  # not a multiple of 128
    q3 = np.where(rng.random((K, C, n3)) < 0.2,
                  rng.integers(-3000, 3000, (K, C, n3)), 0).astype(np.int16)
    nnz3 = (q3 != 0).sum(-1).astype(np.int32)
    both(q3, nnz3, bb_mult=6, n=n3, budget=K * C * n3 // 4)

    # all-zero input → no pairs, no crash
    qz = np.zeros((K, C, n), np.int16)
    both(qz, (qz != 0).sum(-1).astype(np.int32), bb_mult=6)


def test_grouped_sort_compaction_matches_element_scatter():
    """_compact_pairs_sorted (grouped sort + windowed scatter-add, the
    shipped default) must be bit-identical to the legacy element scatter —
    the FULL output array including the zero tail and the overflow-drop
    boundary, not just the valid prefix — across densities, group sizes
    (including clamped and non-dividing ones), and the sentinel-collision
    hazard (q = −1 at the last coefficient of the last row in a group,
    whose packed key is the largest legal value)."""
    import jax
    from glc.ops.encode import _compact_pairs, _compact_pairs_sorted

    rng = np.random.default_rng(5)

    def both(q, nnz, group, n, budget):
        legacy = np.asarray(jax.jit(
            lambda q, z: _compact_pairs(q, z, n, budget))(q, nnz))
        srt = np.asarray(jax.jit(
            lambda q, z: _compact_pairs_sorted(q, z, n, budget, group)
        )(q, nnz))
        np.testing.assert_array_equal(srt, legacy)

    n = 1024
    K, C = 8, 2
    for density, budget_div in [(0.05, 8), (0.3, 8), (0.9, 1), (0.0, 8)]:
        q = np.where(rng.random((K, C, n)) < density,
                     rng.integers(-3000, 3000, (K, C, n)), 0).astype(np.int16)
        # sentinel hazard: force q = -1 (0xFFFF) at col n-1 everywhere
        q[..., n - 1] = -1
        nnz = (q != 0).sum(-1).astype(np.int32)
        # group 32 clamps to the 16-group key-width cap for n=1024;
        # budget_div=8 with density 0.3 exercises the overflow drop
        for group in (1, 2, 4, 16, 32):
            both(q, nnz, group, n, K * C * n // budget_div)

    # R not divisible by the group → G halves until it divides (R=6 rows)
    q = np.where(rng.random((3, 2, n)) < 0.1,
                 rng.integers(-3000, 3000, (3, 2, n)), 0).astype(np.int16)
    both(q, (q != 0).sum(-1).astype(np.int32), 4, n, 6 * n // 4)

    # non-power-of-two n works (no fallback needed below the key cap)
    n3 = 96
    q3 = np.where(rng.random((K, C, n3)) < 0.2,
                  rng.integers(-3000, 3000, (K, C, n3)), 0).astype(np.int16)
    both(q3, (q3 != 0).sum(-1).astype(np.int32), 16, n3, K * C * n3 // 4)

    # n beyond the 30-bit key cap → graceful _compact_pairs fallback
    n4 = 40000
    q4 = np.where(rng.random((1, 2, n4)) < 0.01,
                  rng.integers(-3000, 3000, (1, 2, n4)), 0).astype(np.int16)
    both(q4, (q4 != 0).sum(-1).astype(np.int32), 16, n4, n4 // 2)


def test_sorted2_compaction_matches_element_scatter():
    """_compact_pairs_sorted2 (row sort + P slice + narrow group sort)
    must be bit-identical to the legacy element scatter on BOTH sides of
    its on-device density cond: rows all within the P cap (fast two-stage
    path) and any row above it (full grouped-sort fallback) — full output
    array, sentinel hazard, and the overflow-drop boundary included."""
    import jax
    from glc.ops.encode import _compact_pairs, _compact_pairs_sorted2

    rng = np.random.default_rng(17)
    n, K, C = 1024, 8, 2

    def both(q, nnz, P, budget):
        legacy = np.asarray(jax.jit(
            lambda q, z: _compact_pairs(q, z, n, budget))(q, nnz))
        got = np.asarray(jax.jit(
            lambda q, z: _compact_pairs_sorted2(q, z, n, budget, P)
        )(q, nnz))
        np.testing.assert_array_equal(got, legacy)

    # sparse rows under the cap → fast path (with sentinel hazard at the
    # last column: q = -1 packs to the largest legal key)
    q = np.where(rng.random((K, C, n)) < 0.05,
                 rng.integers(-3000, 3000, (K, C, n)), 0).astype(np.int16)
    q[..., n - 1] = -1
    nnz = (q != 0).sum(-1).astype(np.int32)
    assert nnz.max() <= 384
    both(q, nnz, 384, K * C * n // 8)
    both(q, nnz, 128, K * C * n // 8)    # tighter cap, still covering

    # one row above the cap → on-device fallback to the full grouped sort
    q2 = q.copy()
    q2[3, 1, :600] = 7
    nnz2 = (q2 != 0).sum(-1).astype(np.int32)
    assert nnz2.max() > 384
    both(q2, nnz2, 384, K * C * n // 8)

    # dense everywhere + tiny budget → fallback AND overflow-drop boundary
    q3 = np.where(rng.random((K, C, n)) < 0.7,
                  rng.integers(-3000, 3000, (K, C, n)), 0).astype(np.int16)
    nnz3 = (q3 != 0).sum(-1).astype(np.int32)
    both(q3, nnz3, 384, K * C * n // 16)

    # budget boundary cutting through a fast-path group
    both(q, nnz, 384, int(nnz.sum()) // 2)

    # P >= n → static fallback to the plain grouped sort
    both(q, nnz, 1024, K * C * n // 8)

    # all-zero input → no pairs, no crash
    qz = np.zeros((K, C, n), np.int16)
    both(qz, (qz != 0).sum(-1).astype(np.int32), 384, K * C * n // 8)


def test_compact_mode_dispatch_and_e2e_equivalence():
    """compact_pairs_any routes every mode spec to a bit-identical
    implementation, rejects unknown specs, and the CodecConfig knob
    reaches the full encode pipeline: the same signal encodes to the same
    container bytes under "sort", "sort:4", "blocked", and "legacy"."""
    import jax
    import pytest
    from glc import CodecConfig, Encoder, serialize_encoded
    from glc.ops.encode import _compact_pairs, compact_pairs_any

    rng = np.random.default_rng(11)
    n, K, C = 1024, 4, 2
    budget = K * C * n // 8
    q = np.where(rng.random((K, C, n)) < 0.08,
                 rng.integers(-3000, 3000, (K, C, n)), 0).astype(np.int16)
    nnz = (q != 0).sum(-1).astype(np.int32)
    legacy = np.asarray(jax.jit(
        lambda q, z: _compact_pairs(q, z, n, budget))(q, nnz))
    for mode in ("sort", "sort:4", "sort2", "sort2:64", "blocked",
                 "legacy", "gather", "shift", "shift:16"):
        got = np.asarray(jax.jit(
            lambda q, z, m=mode: compact_pairs_any(q, z, n, budget, m)
        )(q, nnz))
        np.testing.assert_array_equal(got, legacy)
    with pytest.raises(ValueError, match="compact_mode"):
        compact_pairs_any(q, nnz, n, budget, "nope")

    t = np.arange(44100, dtype=np.float32) / 44100
    sig = np.clip((0.4 * np.sin(2 * np.pi * 440 * t)
                   + 0.05 * rng.standard_normal(44100)) * 32767,
                  -32768, 32767).astype(np.int16)
    pcm = np.repeat(sig, 2)  # trivial stereo
    datas = {
        mode: serialize_encoded(
            Encoder(44100, CodecConfig(compact_mode=mode)).encode_pcm16(
                pcm, 2))
        for mode in ("sort", "sort2", "blocked", "legacy", "gather",
                     "shift")
    }
    assert (datas["sort"] == datas["sort2"] == datas["blocked"]
            == datas["legacy"] == datas["gather"] == datas["shift"])


def test_encode_many_batched_group_matches_serial():
    """Same-bucket tracks go through ONE batched device program
    (encode_interleaved_batch_device); containers must be bit-identical to
    per-file encodes — including a white-noise track that exercises the
    raw-PCM fallback inside the batch."""
    from utils import generate_sine_wave, generate_white_noise

    enc = Encoder(44100)
    a = generate_sine_wave(440.0, 44100, 2, 1.0)
    b = generate_sine_wave(523.25, 44100, 2, 1.0)
    c = generate_white_noise(44100, 2, 1.0, seed=7)  # raw fallback frames
    d = np.clip(
        generate_sine_wave(330.0, 44100, 2, 1.0) * 32767.0, -32768, 32767
    ).astype(np.int16)

    # f32 group of three + the i16 goes to its own (pcm16) group
    many = enc.encode_many([(a, 2), (b, 2), (c, 2), (d, 2)])
    singles = [
        enc.encode(a, 2),
        enc.encode(b, 2),
        enc.encode(c, 2),
        enc.encode_pcm16(d, 2),
    ]
    for got, want in zip(many, singles):
        assert serialize_encoded(got) == serialize_encoded(want)
    assert singles[2].frame_set.raw_mask.any()  # noise hit the raw path


def test_piecewise_upload_container_identical(monkeypatch):
    """upload_resident's piecewise path (device concat) must produce the
    same resident signal — containers bit-identical to whole-buffer upload."""
    import glc.codec.encoder as em
    from glc import Encoder, serialize_encoded
    from utils import generate_sine_wave

    s = generate_sine_wave(440.0, 44100, 2, 3.0)
    enc = Encoder(44100)
    ref = serialize_encoded(enc.encode(s, 2))
    # force the split (normal threshold is 32 MB; this signal is ~1 MB)
    monkeypatch.setattr(em, "_UPLOAD_PIECE_BYTES", 1 << 16)
    got = serialize_encoded(enc.encode(s, 2))
    assert got == ref


def test_encode_many_segmented_matches_serial():
    """segmented_batch=True: multi-segment tracks batch at SEGMENT level
    (every same-shape segment of every track in one
    encode_interleaved_units_device dispatch): containers must be
    bit-identical to per-file encodes across heterogeneous lengths
    (different plan shapes, different upload buckets) and a raw-fallback
    white-noise track."""
    from dataclasses import replace

    from utils import generate_sine_wave, generate_white_noise

    import glc.ops.encode as oe
    from glc.config import DEFAULT_CONFIG

    cfg = replace(DEFAULT_CONFIG, encode_chunk_frames=128,
                  segmented_batch=True)
    enc = Encoder(44100, config=cfg)
    a = generate_sine_wave(440.0, 44100, 2, 3.6)      # 2 segments
    b = generate_sine_wave(523.25, 44100, 2, 6.9)     # 3 segments
    c = generate_white_noise(44100, 2, 3.6, seed=7)   # raw frames
    d = np.clip(
        generate_sine_wave(330.0, 44100, 2, 3.6) * 32767.0, -32768, 32767
    ).astype(np.int16)                                # pcm16 cluster, B=1

    calls = {"n": 0}
    real = oe.encode_interleaved_units_device

    def counting(*args, **kwargs):
        calls["n"] += 1
        return real(*args, **kwargs)

    oe.encode_interleaved_units_device = counting
    try:
        many = enc.encode_many([(a, 2), (b, 2), (c, 2), (d, 2)])
    finally:
        oe.encode_interleaved_units_device = real
    assert calls["n"] >= 1  # the f32 cluster used the units program

    enc2 = Encoder(44100, config=cfg)
    singles = [
        enc2.encode(a, 2),
        enc2.encode(b, 2),
        enc2.encode(c, 2),
        enc2.encode_pcm16(d, 2),
    ]
    assert singles[2].frame_set.raw_mask.any()
    for got, want in zip(many, singles):
        assert serialize_encoded(got) == serialize_encoded(want)


def test_encode_many_segmented_mixed_with_singles():
    """Single-segment tracks keep the whole-track batch; multi-segment
    tracks take the full-depth interleaved default; results land in input
    order and match solo encodes bit-for-bit.  Run under BOTH
    segmented_batch settings — the knob must never change the bytes."""
    from dataclasses import replace

    from utils import generate_sine_wave

    from glc.config import DEFAULT_CONFIG

    short = generate_sine_wave(440.0, 44100, 2, 0.8)   # single segment
    long_a = generate_sine_wave(220.0, 44100, 2, 3.6)  # multi-segment
    long_b = generate_sine_wave(277.18, 44100, 2, 3.6)
    items = [(short, 2), (long_a, 2), (short.copy(), 2), (long_b, 2)]
    want = None
    for batch in (False, True):
        cfg = replace(DEFAULT_CONFIG, encode_chunk_frames=128,
                      segmented_batch=batch)
        enc = Encoder(44100, config=cfg)
        many = [serialize_encoded(e) for e in enc.encode_many(items)]
        if want is None:
            enc2 = Encoder(44100, config=cfg)
            want = [serialize_encoded(enc2.encode(s, ch))
                    for s, ch in items]
        assert many == want


def test_bucket_pad_frames_masked_before_compaction():
    """The encode programs zero q/nnz of frames ≥ valid (bucket padding)
    before compacting.  The bucket boundary frame straddles the hard cut
    from real signal to zero-extension, so unmasked it is BROADBAND —
    measured 772 kept pairs on 60 s program material whose real frames max
    out at 353 — which would defeat sort2's `max(nnz) ≤ P` fast path and
    waste compact budget on pairs no caller reads.  Pins: (a) stats rows
    ≥ valid report nnz 0, (b) the valid pairs prefix is bit-identical to
    an exact-size (k_frames == valid) program's, (c) the container bytes
    are unchanged by bucket size."""
    import jax

    from glc.codec.tables import get_device_tables
    from glc.ops.encode import encode_interleaved_device

    rate, C = 44100, 2
    t = np.arange(int(rate * 1.0), dtype=np.float32) / rate
    mono = 0.4 * np.sin(2 * np.pi * 440.0 * t) + 0.2 * np.sin(
        2 * np.pi * 1870.0 * t)
    pcm = np.clip(np.repeat(mono, C) * 32767, -32768, 32767).astype(
        np.int16)

    tb = get_device_tables(1024, 2048, rate)
    tables = (tb.cos_table, tb.window, tb.norm, tb.band_mask,
              tb.band_inv_count, tb.band_pf, tb.band_of, tb.inv_w)
    T = len(pcm) // C
    valid = (T + 1023) // 1024 + 1          # frames incl. lead/tail pads
    k_pad = 64                               # bucketed program size
    assert k_pad > valid
    budget = k_pad * C * 1024 // 8
    kw = dict(channels=C, lead=512, budget=budget, pcm16=True,
              pad_hops=k_pad + 1)

    out_pad = np.asarray(encode_interleaved_device(
        pcm, np.int32(0), np.int32(valid), *tables, k_frames=k_pad, **kw))
    S_pad = k_pad * (2 * C + 1)
    stats = out_pad[:S_pad].reshape(k_pad, 2 * C + 1)
    nnz = stats[:, :C]
    assert nnz[valid:].sum() == 0, "bucket-pad rows leaked pairs"
    assert nnz[:valid].sum() > 0

    out_exact = np.asarray(encode_interleaved_device(
        pcm, np.int32(0), np.int32(valid), *tables,
        k_frames=valid, budget=budget,
        channels=C, lead=512, pcm16=True, pad_hops=valid + 1))
    S_exact = valid * (2 * C + 1)
    wanted = int(nnz[:valid].sum())
    np.testing.assert_array_equal(
        out_pad[S_pad:S_pad + wanted], out_exact[S_exact:S_exact + wanted])
    np.testing.assert_array_equal(
        stats[:valid].reshape(-1), out_exact[:S_exact])

    # container level: a bucket-forcing chunk size changes nothing
    from dataclasses import replace

    from glc.config import DEFAULT_CONFIG

    enc = Encoder(44100)
    want = serialize_encoded(enc.encode_pcm16(pcm, C))
    cfg = replace(DEFAULT_CONFIG, encode_chunk_frames=4096)
    got = serialize_encoded(Encoder(44100, config=cfg).encode_pcm16(pcm, C))
    assert got == want


def test_shift_compaction_matches_element_scatter():
    """_compact_pairs_shift (monotone binary lane routing) must be
    bit-identical to the legacy element scatter with NO density
    restriction — unlike the sort modes it has no fast-path cond and no
    key-width cap, so dense rows, all-kept rows, odd group sizes, huge n,
    the sentinel-free last column, and the overflow-drop boundary all go
    through the same code path."""
    import jax
    from glc.ops.encode import _compact_pairs, _compact_pairs_shift

    rng = np.random.default_rng(23)
    n, K, C = 1024, 8, 2

    def both(q, nnz, G, n_, budget):
        legacy = np.asarray(jax.jit(
            lambda q, z: _compact_pairs(q, z, n_, budget))(q, nnz))
        got = np.asarray(jax.jit(
            lambda q, z: _compact_pairs_shift(q, z, n_, budget, G)
        )(q, nnz))
        np.testing.assert_array_equal(got, legacy)

    # sparse typical + the largest legal word in the last column
    q = np.where(rng.random((K, C, n)) < 0.05,
                 rng.integers(-3000, 3000, (K, C, n)), 0).astype(np.int16)
    q[..., n - 1] = -1
    nnz = (q != 0).sum(-1).astype(np.int32)
    both(q, nnz, 64, n, K * C * n // 8)
    both(q, nnz, 16, n, K * C * n // 8)
    both(q, nnz, 5, n, K * C * n // 8)    # non-divisor group → halved

    # dense rows — the sort2 fallback case is just the normal path here
    q2 = np.where(rng.random((K, C, n)) < 0.7,
                  rng.integers(-3000, 3000, (K, C, n)), 0).astype(np.int16)
    nnz2 = (q2 != 0).sum(-1).astype(np.int32)
    both(q2, nnz2, 64, n, K * C * n // 16)  # overflow-drop boundary
    both(q2, nnz2, 64, n, K * C * n // 8)

    # budget boundary cutting through a group
    both(q, nnz, 64, n, int(nnz.sum()) // 2)

    # every slot kept (max distance = 0 everywhere)
    q3 = rng.integers(1, 3000, (2, 2, n)).astype(np.int16)
    both(q3, (q3 != 0).sum(-1).astype(np.int32), 64, n, 2 * 2 * n)

    # all-zero input
    qz = np.zeros((K, C, n), np.int16)
    both(qz, (qz != 0).sum(-1).astype(np.int32), 64, n, K * C * n // 8)

    # non-power-of-two n and n beyond the sort modes' 30-bit key cap
    n3 = 96
    q4 = np.where(rng.random((K, C, n3)) < 0.2,
                  rng.integers(-3000, 3000, (K, C, n3)), 0).astype(np.int16)
    both(q4, (q4 != 0).sum(-1).astype(np.int32), 16, n3, K * C * n3 // 4)
    n4 = 40000
    q5 = np.where(rng.random((1, 2, n4)) < 0.01,
                  rng.integers(-3000, 3000, (1, 2, n4)), 0).astype(np.int16)
    both(q5, (q5 != 0).sum(-1).astype(np.int32), 2, n4, n4 // 2)


def test_encode_stats_hook_accumulates_and_is_inert():
    """The encoder's stage/transfer attribution hook (bench's protocol-
    ceiling floor model consumes up_n/down_n) must count one resident
    upload and at least one download per planned segment, and never change
    the container bytes."""
    from glc.codec.encoder import upload_geometry

    samples = generate_frequency_sweep(150.0, 4000.0, 44100, 2, 6.0)
    enc = Encoder(44100, config=CodecConfig(encode_chunk_frames=128))
    plain = serialize_encoded(enc.encode(samples, 2))
    stats: dict = {}
    hooked = serialize_encoded(enc.encode(samples, 2, stats=stats))
    assert plain == hooked
    assert set(stats) == {"disp_ms", "wait_ms", "up_n", "down_n"}
    _t, _f, _pad, plan, _nh, _tb = upload_geometry(
        len(samples), 2, enc.config
    )
    assert len(plan) > 1, "geometry must span multiple segments"
    assert stats["up_n"] >= 1
    assert stats["down_n"] >= len(plan)
    assert stats["disp_ms"] > 0 and stats["wait_ms"] >= 0
