"""GLC encoder: host framing → device MDCT/mask/quantize → container assembly.

API mirrors the reference (reference src/codec.rs:396-566):

    enc = Encoder(sample_rate)
    encoded = enc.encode(samples, channels)     # interleaved float32
    encoded = enc.encode_pcm16(i16, channels)   # exact fast path for 16-bit
                                                # sources (i16/2^15 == f32)

The reference parallelizes over frames with rayon (codec.rs:462); here the
frame axis is the batch axis of one jitted device call per segment.

Transfer-minimal design (every host↔device transfer has a fixed cost, so
transfer COUNT matters as well as bytes): the host uploads the signal ONCE per
file and it stays resident in device memory; each segment program slices it with a dynamic start (framing
and the 2× overlap duplication happen on device).  The device compacts the
sparse quantized result into one packed int32 array (~4 bytes per kept
coefficient) plus one packed per-frame stats array — one adaptive download
per segment — and only raw-PCM rows of frames that chose the fallback come
back at full width.  A dense-transfer fallback covers segments whose
kept-coefficient count exceeds the compaction budget.
"""

from __future__ import annotations

import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import CodecConfig, DEFAULT_CONFIG
from ..container.schema import (
    PAIR_DTYPE,
    AudioHeader,
    EncodedAudio,
    FrameSet,
    GaplessInfo,
)
from ..ops.decode import start_host_copy
from ..ops.encode import (
    encode_interleaved_batch_device,
    encode_interleaved_dense_device,
    encode_interleaved_device,
    gather_raw_interleaved_device,
)
from .tables import get_device_tables, len_bucket


def frame_signal(samples: np.ndarray, channels: int, cfg: CodecConfig,
                 dtype=np.float32):
    """Deinterleave + pad, mirroring reference src/codec.rs:427-455.

    Returns (padded [C, P], num_frames, padding, per_channel_len).
    Padding: hop/2 leading zeros, pad to hop multiple, hop/2 trailing zeros.
    """
    hop, frame = cfg.hop_size, cfg.frame_size
    samples = np.asarray(samples, dtype)
    if channels <= 0:
        raise ValueError("channels must be >= 1")
    lead = hop // 2

    def padded_len(t: int) -> int:
        rem = (lead + t) % hop
        return lead + t + ((hop - rem) if rem else 0) + lead

    # The reference deinterleaves by i % ch (codec.rs:427-431), so a ragged
    # interleaved count is accepted: early channels get one extra sample.
    # Frame count comes from channel 0's padded length (codec.rs:449-455);
    # if a shorter channel pads to a smaller length the reference's frame
    # slicing would panic — we reject that input explicitly.
    T = (len(samples) + channels - 1) // channels  # channel-0 length
    P = padded_len(T)
    padded = np.zeros((channels, P), dtype)
    if len(samples) % channels == 0:
        padded[:, lead : lead + T] = samples.reshape(T, channels).T
    else:
        for c in range(channels):
            ch_data = samples[c::channels]
            if padded_len(len(ch_data)) < P:
                raise ValueError(
                    "ragged interleaved input where channel lengths pad to "
                    "different sizes (the reference panics on this input)"
                )
            padded[c, lead : lead + len(ch_data)] = ch_data

    num_frames = 1 if P < frame else (P - frame) // hop + 1
    padding = P - T - lead  # codec.rs:546
    return padded, num_frames, padding, T


_len_bucket = len_bucket


def frame_plan(total_samples: int, channels: int, cfg: CodecConfig):
    """Pure-arithmetic twin of `frame_signal`: (T, F, padding) without
    building any array — the interleaved encode path derives its framing
    geometry from these and leaves the actual deinterleave+pad to the
    device (ops/encode.py:_planarize_device).

    T is the channel-0 length (the reference deinterleaves by i % ch,
    codec.rs:427-431, so ragged inputs give early channels one extra
    sample); F and padding come from channel 0 exactly as in
    codec.rs:449-455 and :546.  Raises for the ragged inputs the
    reference's frame slicing panics on.
    """
    hop, frame = cfg.hop_size, cfg.frame_size
    if channels <= 0:
        raise ValueError("channels must be >= 1")
    lead = hop // 2

    def padded_len(t: int) -> int:
        rem = (lead + t) % hop
        return lead + t + ((hop - rem) if rem else 0) + lead

    T = (total_samples + channels - 1) // channels
    P = padded_len(T)
    if total_samples % channels and padded_len(T - 1) < P:
        raise ValueError(
            "ragged interleaved input where channel lengths pad to "
            "different sizes (the reference panics on this input)"
        )
    F = 1 if P < frame else (P - frame) // hop + 1
    padding = P - T - lead
    return T, F, padding


def upload_geometry(total_samples: int, channels: int, cfg: CodecConfig):
    """The serial encoder's complete transfer geometry for one track:
    (T, F, padding, plan, need_hops, Tb).

    * plan — [(start_hop, k_frames)]: full segments of K = ladder(F) capped
      at encode_chunk_frames, plus one ladder-bucketed tail segment for the
      remainder; short files finish in a single dispatch + one adaptive
      download, and the tail never re-encodes frames.
    * need_hops — the device-side planar length (hops) every segment
      program pads to (static pad_hops).
    * Tb — the bucketed per-channel upload length: the user's interleaved
      buffer is uploaded untouched when its length lands on the 5-bit
      ladder, zero-completed into a Tb·channels copy otherwise (≤6.25%
      overshoot on the upload bytes).

    Shared by `_dispatch_encode`, `encode_many`'s grouping, and bench's
    stage attribution so the measured "upload" can never desynchronize
    from what the encoder actually uploads.  Both bucketed lengths are
    pure functions of the laddered geometry, so the compiled-program set
    stays ≤16/octave.
    """
    hop = cfg.hop_size
    lead = hop // 2
    T, F, padding = frame_plan(total_samples, channels, cfg)
    K = min(max(_len_bucket(F), 16), cfg.encode_chunk_frames)
    plan = [(i * K, K) for i in range(F // K)]  # (start, k_frames)
    rem = F - (F // K) * K  # F >= 1, so rem > 0 whenever plan is empty
    if rem:
        plan.append(((F // K) * K, min(_len_bucket(rem), K)))
    last_start, last_k = plan[-1]
    p_hops = (lead + T + hop - 1) // hop + 1   # hops covering lead+T+lead
    need_hops = max(last_start + last_k + 1, p_hops)
    Tb = max(T, min(_len_bucket(T, 5), need_hops * hop - lead))
    return T, F, padding, plan, need_hops, Tb


def bucket_upload(samples: np.ndarray, total_samples: int, Tb: int,
                  channels: int, dtype) -> np.ndarray:
    """The upload buffer for `encode_interleaved_device`: the caller's
    array untouched when its length is already Tb·channels, else one
    contiguous zero-completed memcpy (a host-side deinterleave would put a
    1-core strided transpose on the critical path instead)."""
    L = Tb * channels
    if L == total_samples:
        return samples
    xup = np.zeros(L, dtype)
    xup[:total_samples] = samples
    return xup


# Very large uploads go to the device in 16 MB pieces joined by one
# on-device concatenate.  The piece size was chosen for an earlier, much
# slower host link; whether pieces help over PCIe is not yet measured.
_UPLOAD_PIECE_BYTES = 16 << 20


@jax.jit
def _concat_pieces(*xs):
    return jnp.concatenate(xs)


def upload_resident(xup: np.ndarray):
    """device_put for resident signals (1-D interleaved or [B, L] batches):
    whole-buffer for normal sizes, piecewise along axis 0 + device concat
    beyond 2×_UPLOAD_PIECE_BYTES."""
    if xup.nbytes <= 2 * _UPLOAD_PIECE_BYTES:
        return jax.device_put(xup)
    row_bytes = xup.nbytes // xup.shape[0]
    step = max(1, _UPLOAD_PIECE_BYTES // row_bytes)
    pieces = [
        jax.device_put(xup[i : i + step])
        for i in range(0, xup.shape[0], step)
    ]
    return _concat_pieces(*pieces)


def upload_piece_count(xup: np.ndarray) -> int:
    """How many transfers `upload_resident(xup)` makes (the encoder stats
    hook counts them)."""
    if xup.nbytes <= 2 * _UPLOAD_PIECE_BYTES:
        return 1
    row_bytes = xup.nbytes // xup.shape[0]
    step = max(1, _UPLOAD_PIECE_BYTES // row_bytes)
    return -(-xup.shape[0] // step)


def zero_extend(padded: np.ndarray, need: int) -> np.ndarray:
    """Zero-extend the signal's sample axis to `need` (no-op when long
    enough).  Shared by the serial encoder's resident-signal extension and
    the sharded album framer so the two paths cannot diverge."""
    if padded.shape[1] >= need:
        return padded
    ext = np.zeros((padded.shape[0], need), padded.dtype)
    ext[:, : padded.shape[1]] = padded
    return ext


def parse_segment_download(first: np.ndarray, out_d, *, k: int, valid: int,
                           C: int, budget: int, cut0: int,
                           stats_hook: Optional[dict] = None):
    """Parse one packed encode-segment download (the [k·(2C+1) + budget]
    layout of encode_interleaved_device): per-frame stats plus the
    adaptively-fetched packed pairs.  Shared by the solo, single-segment
    batch, and segment-batched collect paths so the stream parsing can
    never diverge between them.

    Returns (nnz [k, C] int64, scales view [k, C] f32, use_raw [k] bool,
    wanted, pairs-or-None): `wanted` counts the valid frames' pairs (the
    stream is frame-ordered, so they occupy the first `wanted` packed
    slots regardless of bucket-padding frames after them); pairs is None
    when wanted > budget — the caller must re-run that segment through the
    dense fallback program.
    """
    stats_width = 2 * C + 1
    S = k * stats_width
    stats = first[:S].reshape(k, stats_width)
    nnz = stats[:, :C].astype(np.int64)
    scale = stats[:, C : 2 * C].view(np.float32)
    use_raw = stats[:, 2 * C] != 0
    wanted = int(nnz[:valid].sum())
    if wanted == 0:
        pairs = np.empty(0, PAIR_DTYPE)
    elif wanted <= budget:
        if wanted > cut0:
            cut = min(_len_bucket(wanted, 5), budget)
            t0 = time.perf_counter()
            tail = np.asarray(out_d[S + cut0 : S + cut])
            if stats_hook is not None:  # the short-guess second fetch
                stats_hook["down_n"] = stats_hook.get("down_n", 0) + 1
                stats_hook["wait_ms"] = (stats_hook.get("wait_ms", 0.0)
                                         + (time.perf_counter() - t0) * 1e3)
            packed = np.concatenate([first[S:], tail])[:wanted]
        else:
            packed = first[S : S + wanted]
        pairs = np.empty(wanted, PAIR_DTYPE)
        pairs["k"] = (packed >> 16).astype(np.uint16)
        pairs["q"] = (packed & 0xFFFF).astype(np.uint16).view(np.int16)
    else:
        pairs = None
    return nnz, scale, use_raw, wanted, pairs


# Batch cap where the backend reports no memory limit (the CPU backend).
_FALLBACK_BATCH_BYTES = 2 << 30


def batch_bytes_cap(memory_stats: Optional[dict]) -> int:
    """Device-memory bound for one batched encode dispatch, and for the
    resident signals `encode_many` keeps in flight: one eighth of the
    device's allocatable bytes (`memory_stats()["bytes_limit"]`).  The
    [B, K, C, 2n] f32 block tensor is the largest intermediate, and the
    program's other intermediates and the buffers still in flight take
    several times its size beside it.  Backends that report no limit get
    a fixed 2 GiB."""
    limit = (memory_stats or {}).get("bytes_limit")
    if not limit:
        return _FALLBACK_BATCH_BYTES
    return int(limit) // 8


def _compact_budget_cap(k: int, C: int, n: int) -> int:
    """Largest useful compact budget: past 50% kept density the packed
    int32 pairs (4 B each) outweigh the dense int16 rows (2 B per slot),
    so denser segments transfer FEWER bytes through the dense program."""
    return k * C * n // 2


def _budget_for(wanted: int, k: int, C: int, n: int) -> int:
    """Smallest compact budget tier ≥ `wanted` (n/8 → n/4 → n/2 of the
    coefficient slots).  Fixed tiers bound the compiled-program variants
    per segment shape; the cut0 ladder keeps the actual pairs download
    near 4·wanted bytes regardless of which tier ran."""
    b1 = max(k * C * n // 8, 1 << 14)
    for b in (b1, k * C * n // 4, k * C * n // 2):
        if wanted <= b:
            return b
    raise AssertionError(
        "wanted above the compact cap belongs to the dense program"
    )


def _reencode_overflow(xinter_dev, start, *, valid, k, wanted, tables,
                       params, bb_mult, compact_mode, C, n,
                       stats: Optional[dict] = None):
    """Re-encode one segment whose kept-pair count `wanted` overflowed the
    dispatched compact budget (or was measured by a stats-only budget=0
    dispatch).  Shared by the solo, single-segment-batch, and
    segment-batched collect paths.

    The program FAMILY is decided ONLY by the exact count: the dense int16
    program iff wanted > k·C·n//2 — the byte crossover where 4-byte packed
    pairs outweigh 2-byte dense rows — else the compact program with the
    smallest budget tier that fits.  Compact tiers are exact integer
    packings of identical math (every tier yields the same pairs), while
    compact↔dense moves a ±1-ulp keep gate (see the dense branch below) —
    so hanging the choice on `wanted` alone keeps the container bytes
    independent of the encoder's adaptive prediction state
    (tests/test_dense_fallback.py pins this determinism).

    Returns (nnz [k,C] int64, scales [k,C] f32, use_raw [k] bool, pairs)
    with pairs covering the `valid` frames; callers slice the stats to
    their valid prefix.
    """
    from ..ops.decode import take_prefix_device

    if wanted > _compact_budget_cap(k, C, n):
        # Dense fallback: a DIFFERENT compiled program whose keep-gate can
        # differ by ±1 ulp from the compacting program's — so nnz/scales/
        # use_raw are taken from the dense program too, keeping the
        # container self-consistent (pairs segmented by nnz).
        q_d, nnz_d, scale_d, use_raw_d = encode_interleaved_dense_device(
            xinter_dev, np.int32(start), *tables, k_frames=k, **params
        )
        # download only the valid prefix — bucket padding can be most of
        # the tensor for a tail segment
        t0 = time.perf_counter()
        q_np = np.asarray(take_prefix_device(q_d, valid))[:valid]
        nnz = np.asarray(nnz_d).astype(np.int64)
        scales = np.asarray(scale_d)
        use_raw = np.asarray(use_raw_d)
        if stats is not None:  # dense fallback: 4 materializations
            stats["down_n"] = stats.get("down_n", 0) + 4
            stats["wait_ms"] = (stats.get("wait_ms", 0.0)
                                + (time.perf_counter() - t0) * 1e3)
        fidx, cidx, kpos = np.nonzero(q_np)
        pairs = np.empty(len(kpos), PAIR_DTYPE)
        pairs["k"] = kpos.astype(np.uint16)
        pairs["q"] = q_np[fidx, cidx, kpos]
        return nnz, scales, use_raw, pairs

    budget2 = _budget_for(wanted, k, C, n)
    out2 = encode_interleaved_device(
        xinter_dev, np.int32(start), np.int32(valid), *tables,
        k_frames=k, budget=budget2,
        bb_mult=bb_mult, compact_mode=compact_mode, **params
    )
    S = k * (2 * C + 1)
    cut0 = min(_len_bucket(wanted, 5), budget2)
    t0 = time.perf_counter()
    first = np.asarray(out2[: S + cut0])
    if stats is not None:  # compact-retry fetch
        stats["down_n"] = stats.get("down_n", 0) + 1
        stats["wait_ms"] = (stats.get("wait_ms", 0.0)
                            + (time.perf_counter() - t0) * 1e3)
    nnz, scale, use_raw, _w2, pairs = parse_segment_download(
        first, out2, k=k, valid=valid, C=C, budget=budget2, cut0=cut0,
        stats_hook=stats,
    )
    return nnz, scale.copy(), np.asarray(use_raw), pairs


def _pick_budget(hint, k: int, C: int, n: int) -> int:
    """Dispatch-time compact budget from the measured density hint.

    No hint → the standard n/8 tier.  A hint near the compact cap → 0
    (the stats-only program: the compaction scatter is the larger part of
    the encode program's device cost and its packed download would be
    discarded, so
    a predicted-dense segment measures its exact count cheaply first).
    Otherwise the smallest tier covering the prediction + 25% margin."""
    if hint is None:
        return max(k * C * n // 8, 1 << 14)
    cap = _compact_budget_cap(k, C, n)
    pred = hint * k * C
    if pred >= 0.8 * cap:
        return 0
    return _budget_for(min(int(pred * 1.25), cap), k, C, n)


def _pick_batch_budget(hint, k: int, C: int, n: int) -> int:
    """Dispatch-time SHARED budget for the batch/segment-group programs
    (no stats-only probes there: one program serves every track/unit, so
    a budget=0 dispatch would discard the whole batch's work).  A dense
    prediction dispatches the n/2 CAP tier — tracks whose exact count
    lands ≤ cap are then served from the one batch download, and only
    genuinely past-crossover tracks re-dispatch (dense, per track);
    mapping the sentinel to the floor instead would guarantee a doomed
    dispatch + per-track re-dispatch for every dense-but-compressible
    track.  Floored at the standard tier either way."""
    tier = _pick_budget(hint, k, C, n)
    if tier == 0:
        tier = _compact_budget_cap(k, C, n)
    return max(tier, k * C * n // 8, 1 << 14)


class Encoder:
    """reference src/codec.rs:396-418.

    Stateless in practice (Q8): all state is immutable precomputed tables,
    so `encode` is a pure function of its inputs.
    """

    def __init__(self, sample_rate: int, config: Optional[CodecConfig] = None):
        self.sample_rate = int(sample_rate)
        self.config = config or DEFAULT_CONFIG
        # Warm the table caches (mirrors MdctTables::new + PerceptualWeights::new
        # in Encoder::new, codec.rs:406-418).
        self._tables = get_device_tables(
            self.config.n, self.config.frame_size, self.sample_rate
        )
        # adaptive guess for the single-transfer pair prefix (see collect
        # phase): last segment's kept-pair count, per channel count
        self._pair_guess: dict = {}
        # measured kept-pair density (pairs per frame·channel), per channel
        # count: sizes each segment's compact budget TIER at dispatch time
        # so dense content doesn't pay a doomed standard-budget program +
        # wasted packed download per segment before its fallback.  Purely
        # a prediction — the program family actually used is decided by
        # the exact per-segment count (_reencode_overflow), so this state
        # can never change the container bytes.
        self._density_hint: dict = {}

    def encode(self, samples: np.ndarray, channels: int,
               stats: Optional[dict] = None) -> EncodedAudio:
        """Encode interleaved float32 PCM (codec.rs:421-565).

        `stats`, if given, accumulates the solo path's stage/transfer
        attribution (same contract as `Decoder.decode_i16_stream`):
        disp_ms (dispatch + async-download kickoff), wait_ms (blocked in
        downloads + host sparsify), up_n (upload pieces), down_n
        (download transfers).  Output is identical with or without the
        hook.
        """
        samples = np.asarray(samples)
        if np.issubdtype(samples.dtype, np.integer):
            raise TypeError(
                "encode() expects float PCM in [-1, 1]; for 16-bit integer "
                "sources use encode_pcm16() (exact, half the upload)"
            )
        return self._encode_impl(samples.astype(np.float32, copy=False),
                                 channels, pcm16=False, stats=stats)

    def encode_pcm16(self, samples_i16: np.ndarray, channels: int,
                     stats: Optional[dict] = None) -> EncodedAudio:
        """Exact fast path for 16-bit integer sources.

        Produces the same container as `encode(samples_i16 / 32768.0, ch)` —
        the division happens on device (exact in f32) — while uploading half
        the bytes.  `stats`: see `encode`.
        """
        return self._encode_impl(
            np.asarray(samples_i16, np.int16), channels, pcm16=True,
            stats=stats,
        )

    def _encode_impl(self, samples, channels: int, *, pcm16: bool,
                     stats: Optional[dict] = None) -> EncodedAudio:
        from ..profiling import maybe_trace

        with maybe_trace("encode"):
            return self._dispatch_encode(samples, channels, pcm16=pcm16,
                                         stats=stats)()

    def encode_many(self, items) -> list:
        """Multi-file encode: `items` is a sequence of (samples, channels) —
        int16 arrays take the exact pcm16 fast path, float arrays the f32
        path.  Returns a list of EncodedAudio in input order, bit-identical
        to per-file `encode`/`encode_pcm16` calls.

        Tracks that land in the same (channels, dtype, frame-bucket) group
        are encoded by ONE batched device program
        (`encode_interleaved_batch_device`): one upload, one dispatch, one download for the whole
        group, which amortizes every fixed per-transfer and per-dispatch
        cost of the reference's serial file loop (src/main.rs:545-583) over
        the group.  MULTI-segment tracks (anything
        past encode_chunk_frames ≈ 95 s at 44.1 kHz) pipeline at FULL
        depth instead — every track dispatched before any finishes, so
        uploads, device compute, and downloads of different tracks
        overlap — or, with config.segmented_batch=True, batch every same-shape
        segment across tracks in one dispatch
        (`_encode_segmented_group`, for fast-interconnect deployments).
        Lone single-segment leftovers take the pipelined per-file path.
        """
        from ..profiling import maybe_trace

        with maybe_trace("encode_many"):
            return self._encode_many_impl(items)

    def _encode_many_impl(self, items) -> list:
        cfg = self.config
        cap_bytes = batch_bytes_cap(jax.devices()[0].memory_stats())

        prepped = []
        for samples, channels in items:
            samples = np.asarray(samples)
            pcm16 = samples.dtype == np.int16
            if not pcm16 and np.issubdtype(samples.dtype, np.integer):
                raise TypeError(
                    "encode_many expects float PCM or int16 arrays"
                )
            if not pcm16:
                samples = samples.astype(np.float32, copy=False)
            prepped.append((samples, int(channels), pcm16))

        # Group batchable (single-segment) tracks by program signature,
        # using the same upload_geometry as the serial path so batch
        # membership can never disagree with what a solo encode would do.
        # Multi-segment tracks cluster by (channels, dtype): clusters of ≥2
        # batch at SEGMENT level (_encode_segmented_group);
        # singletons take the pipelined solo path.
        groups: dict = {}
        multis: dict = {}
        solos: list = []
        for i, (samples, C, pcm16) in enumerate(prepped):
            if len(samples) == 0:
                raise ValueError("cannot encode empty input")
            T, F, padding, plan, need_hops, Tb = upload_geometry(
                len(samples), C, cfg
            )
            if len(plan) == 1:
                K = plan[0][1]
                key = (C, pcm16, K, Tb, need_hops)
                groups.setdefault(key, []).append(
                    (i, samples, F, padding)
                )
            else:
                multis.setdefault((C, pcm16), []).append((i, samples))
        for key, recs in list(multis.items()):
            if len(recs) == 1:
                C, pcm16 = key
                solos.append((recs[0][0], recs[0][1], C, pcm16))
                del multis[key]

        results: list = [None] * len(prepped)

        # Pipelined solo path (multi-segment tracks): keep two in flight,
        # which bounds peak memory at two resident signals.
        finishers: list = []
        for i, samples, C, pcm16 in solos:
            finishers.append(
                (i, self._dispatch_encode(samples, C, pcm16=pcm16))
            )
            if len(finishers) > 1:
                j, finish = finishers.pop(0)
                results[j] = finish()

        # Batched groups (splitting any group that would exceed the memory
        # cap).
        for key, recs in groups.items():
            C, pcm16, K, Tb, need_hops = key
            per_track = K * C * cfg.frame_size * 4
            cap = max(1, cap_bytes // per_track)
            for off in range(0, len(recs), cap):
                self._encode_batch_group(
                    recs[off : off + cap], results, C=C, pcm16=pcm16,
                    K=K, Tb=Tb, need_hops=need_hops,
                )

        # Multi-segment clusters.  DEFAULT: full-depth interleaved
        # dispatch — every track's upload+segments dispatched before any
        # track finishes, so each track's downloads drain while later
        # tracks upload.  In-flight resident signals are bytes-bounded.  config.segmented_batch=True instead batches
        # every same-shape segment across tracks in one dispatch
        # (fast-interconnect deployments).  Both are bit-identical to
        # per-file encodes.
        if multis and not cfg.segmented_batch:
            mflat = sorted(
                (i, samples, C, pcm16)
                for (C, pcm16), recs in multis.items()
                for i, samples in recs
            )
            inflight: list = []  # (index, finish, resident bytes)
            live = 0
            for i, samples, C, pcm16 in mflat:
                inflight.append(
                    (i, self._dispatch_encode(samples, C, pcm16=pcm16),
                     samples.nbytes)
                )
                live += samples.nbytes
                while (live > cap_bytes
                       and len(inflight) > 1):
                    j, fin, nb = inflight.pop(0)
                    results[j] = fin()
                    live -= nb
            for j, fin, _nb in inflight:
                results[j] = fin()
        elif multis:
            for (C, pcm16), recs in multis.items():
                itemsize = 2 if pcm16 else 4
                max_len = max(len(s) for _i, s in recs)
                cap = max(
                    2, cap_bytes // (max_len * itemsize)
                )
                for off in range(0, len(recs), cap):
                    part = recs[off : off + cap]
                    if len(part) == 1:
                        i, samples = part[0]
                        results[i] = self._dispatch_encode(
                            samples, C, pcm16=pcm16
                        )()
                    else:
                        self._encode_segmented_group(
                            part, results, C=C, pcm16=pcm16
                        )

        for j, finish in finishers:
            results[j] = finish()
        return results

    def _encode_batch_group(self, recs, results, *, C, pcm16, K,
                            Tb, need_hops) -> None:
        """Encode a group of same-bucket single-segment tracks with one
        batched upload + dispatch + adaptive download.  Fills results[i]
        for each (i, samples, F, padding) record.  Groups of one still go
        through the B=1 batch program: lax.map's body is bit-identical to
        the single-track program (see encode_interleaved_batch_device), so
        group size never changes the bytes."""
        cfg = self.config
        hop, frame_size, n = cfg.hop_size, cfg.frame_size, cfg.n
        lead = hop // 2
        tb = self._tables
        tables = tuple(tb)
        B = len(recs)
        dtype = np.int16 if pcm16 else np.float32

        L = Tb * C
        xb = np.zeros((B, L), dtype)
        for j, (_i, samples, _F, _padding) in enumerate(recs):
            xb[j, : len(samples)] = samples
        xb_dev = upload_resident(xb)

        # Tier the shared budget from the measured density (dense hint →
        # the cap tier; overflows past the byte crossover re-dispatch per
        # track via _reencode_overflow, which the solo program serves
        # bit-identically).
        budget = _pick_batch_budget(self._density_hint.get(C), K, C, n)
        params = dict(
            pcm16=pcm16,
            quality=cfg.quality_factor,
            noise_floor_db=cfg.noise_floor_db,
            compression_threshold=cfg.compression_threshold,
            max_q=cfg.max_q,
            pad_hops=need_hops,
            channels=C,
            lead=lead,
        )
        out_d = encode_interleaved_batch_device(
            xb_dev, np.zeros(B, np.int32),
            np.asarray([r[2] for r in recs], np.int32), *tables,
            k_frames=K, budget=budget,
            bb_mult=cfg.compact_bb_mult,
            compact_mode=cfg.compact_mode, **params
        )

        stats_width = 2 * C + 1
        S = K * stats_width
        guess = self._pair_guess.get((C, K), max(budget // 8, 1 << 14))
        cut0 = min(_len_bucket(guess, 5), budget)
        # per-track async copies of each track's own prefix, so no
        # track's unused budget tail is downloaded
        slices = [start_host_copy(out_d[j, : S + cut0]) for j in range(B)]
        firsts = [np.asarray(sl) for sl in slices]

        max_wanted = 1
        for j, (i, samples, F, padding) in enumerate(recs):
            total_samples = len(samples)
            nnz, scale_v, use_raw_v, wanted, pairs = parse_segment_download(
                firsts[j], out_d[j], k=K, valid=F, C=C, budget=budget,
                cut0=cut0,
            )
            nnz = nnz[:F]
            scales = scale_v[:F].copy()
            use_raw = use_raw_v[:F]
            max_wanted = max(max_wanted, wanted)
            self._density_hint[C] = wanted / (F * C)

            if pairs is None or wanted > _compact_budget_cap(K, C, n):
                # overflow, per track: bigger compact tier or dense — the
                # solo segment program is bit-identical to the batch body
                nnz, scales, use_raw, pairs = _reencode_overflow(
                    xb_dev[j], 0, valid=F, k=K, wanted=wanted,
                    tables=tables, params=params,
                    bb_mult=cfg.compact_bb_mult,
                    compact_mode=cfg.compact_mode, C=C, n=n,
                )
                nnz = nnz[:F]
                scales = scales[:F]
                use_raw = use_raw[:F]

            if use_raw.any():
                ridx = np.flatnonzero(use_raw).astype(np.int32)
                rbudget = min(_len_bucket(len(ridx), 4), K)
                idx_pad = np.zeros(rbudget, np.int32)
                idx_pad[: len(ridx)] = ridx
                rows = np.asarray(
                    gather_raw_interleaved_device(
                        xb_dev[j], idx_pad, tb.window,
                        channels=C, lead=lead, pad_hops=need_hops,
                        pcm16=pcm16)
                )[: len(ridx)]
                raw_all = rows.reshape(-1, C * frame_size)
            else:
                raw_all = np.empty((0, C * frame_size), np.int16)

            fs = FrameSet(nnz, pairs, scales, use_raw, raw_all, frame_size)
            results[i] = EncodedAudio(
                header=AudioHeader(self.sample_rate, C, total_samples),
                frame_set=fs,
                gapless_info=GaplessInfo(
                    encoder_delay=hop // 2,
                    padding=padding,
                    original_length=total_samples,
                ),
            )

        self._pair_guess[(C, K)] = max_wanted + max_wanted // 4 + 1

    def _encode_segmented_group(self, recs, results, *, C, pcm16) -> None:
        """Segment-level batched encode of multi-segment tracks
        (config.segmented_batch=True — see that knob's docstring for when;
        the serial file loop this replaces is reference
        src/main.rs:545-583).

        Each track's interleaved buffer uploads ONCE, ladder-bucketed to
        its OWN length, then stacks into a [B, L_max] resident batch on
        device (stack_padded_device — the padding zeros never cross the
        link).  All (track, segment) units sharing a segment shape k run as
        ONE encode_interleaved_units_device dispatch with per-unit adaptive
        async downloads, so a realistic 3-5 min album costs
        #distinct-shapes dispatches instead of #tracks × #segments.  The
        per-unit body is the solo segment program, so every track's
        container is bit-identical to a per-file `encode`/`encode_pcm16`
        call — the encode_many contract (tests pin this for heterogeneous
        lengths too).
        """
        from ..ops.encode import (
            encode_interleaved_units_device,
            stack_padded_device,
        )

        cfg = self.config
        hop, frame_size, n = cfg.hop_size, cfg.frame_size, cfg.n
        lead = hop // 2
        tb = self._tables
        tables = tuple(tb)
        dtype = np.int16 if pcm16 else np.float32
        B = len(recs)

        geos = []    # (i, samples, F, padding, plan)
        xdevs = []
        need_max = 0
        for i, samples in recs:
            _T, F, padding, plan, need_hops, Tb = upload_geometry(
                len(samples), C, cfg
            )
            geos.append((i, samples, F, padding, plan))
            need_max = max(need_max, need_hops)
            xdevs.append(
                upload_resident(
                    bucket_upload(samples, len(samples), Tb, C, dtype)
                )
            )
        L_max = max(x.shape[0] for x in xdevs)
        xb_dev = stack_padded_device(*xdevs, L=L_max)
        del xdevs

        params = dict(
            pcm16=pcm16,
            quality=cfg.quality_factor,
            noise_floor_db=cfg.noise_floor_db,
            compression_threshold=cfg.compression_threshold,
            max_q=cfg.max_q,
            pad_hops=need_max,
            channels=C,
            lead=lead,
        )

        units_by_k: dict = {}
        for j, (_i, _s, F, _p, plan) in enumerate(geos):
            for start, k in plan:
                units_by_k.setdefault(k, []).append(
                    (j, start, min(k, F - start))
                )

        # dispatch every shape group before collecting anything, so all
        # downloads pipeline on the link
        dispatched = []
        for k, units in units_by_k.items():
            # shared tiered budget (dense hint → cap tier, like the
            # single-segment batch path — only past-crossover units
            # re-dispatch via _reencode_overflow)
            budget = _pick_batch_budget(self._density_hint.get(C), k, C, n)
            guess = self._pair_guess.get((C, k), max(budget // 8, 1 << 14))
            cut0 = min(_len_bucket(guess, 5), budget)
            S = k * (2 * C + 1)
            if len(units) == 1:
                j, start, _valid = units[0]
                out_d = encode_interleaved_device(
                    xb_dev[j], np.int32(start), np.int32(_valid), *tables,
                    k_frames=k, budget=budget,
                    bb_mult=cfg.compact_bb_mult,
                    compact_mode=cfg.compact_mode, **params
                )[None]
            else:
                out_d = encode_interleaved_units_device(
                    xb_dev,
                    np.asarray([u[0] for u in units], np.int32),
                    np.asarray([u[1] for u in units], np.int32),
                    np.asarray([u[2] for u in units], np.int32),
                    *tables, k_frames=k, budget=budget,
                    bb_mult=cfg.compact_bb_mult,
                    compact_mode=cfg.compact_mode, **params
                )
            slices = [
                start_host_copy(out_d[u, : S + cut0])
                for u in range(len(units))
            ]
            dispatched.append((k, budget, units, out_d, slices, cut0))

        # collect per unit into per-track (start → parsed segment) maps
        per_track: list = [dict() for _ in range(B)]
        for k, budget, units, out_d, slices, cut0 in dispatched:
            max_wanted = 1
            for u, (j, start, valid) in enumerate(units):
                first = np.asarray(slices[u])
                nnz, scale, use_raw, wanted, pairs = parse_segment_download(
                    first, out_d[u], k=k, valid=valid, C=C, budget=budget,
                    cut0=cut0,
                )
                max_wanted = max(max_wanted, wanted)
                if pairs is None or wanted > _compact_budget_cap(k, C, n):
                    # overflow (or a count past the byte crossover that a
                    # floored dispatch budget happened to cover): re-run
                    # through the program family the exact count calls for
                    # — same rule as every other site
                    nnz, scale, use_raw, pairs = _reencode_overflow(
                        xb_dev[j], start, valid=valid, k=k, wanted=wanted,
                        tables=tables, params=params,
                        bb_mult=cfg.compact_bb_mult,
                        compact_mode=cfg.compact_mode, C=C, n=n,
                    )
                per_track[j][start] = (
                    nnz[:valid], scale[:valid], use_raw[:valid], pairs
                )
            self._pair_guess[(C, k)] = max_wanted + max_wanted // 4 + 1

        # assemble each track's container (+ one raw gather per track)
        for j, (i, samples, F, padding, plan) in enumerate(geos):
            nnz_all = np.empty((F, C), np.int64)
            scales_all = np.empty((F, C), np.float32)
            raw_mask_all = np.empty(F, bool)
            pair_parts = []
            for start, _k in plan:  # ascending start → stream order
                valid = min(_k, F - start)
                nnz, scale, use_raw, pairs = per_track[j][start]
                nnz_all[start : start + valid] = nnz
                scales_all[start : start + valid] = scale
                raw_mask_all[start : start + valid] = use_raw
                if len(pairs):
                    pair_parts.append(pairs)
            pairs_all = (
                np.concatenate(pair_parts) if pair_parts
                else np.empty(0, PAIR_DTYPE)
            )
            if raw_mask_all.any():
                ridx = np.flatnonzero(raw_mask_all).astype(np.int32)
                rbudget = min(_len_bucket(len(ridx), 4), _len_bucket(F, 4))
                idx_pad = np.zeros(rbudget, np.int32)
                idx_pad[: len(ridx)] = ridx
                rows = np.asarray(
                    gather_raw_interleaved_device(
                        xb_dev[j], idx_pad, tb.window,
                        channels=C, lead=lead, pad_hops=need_max,
                        pcm16=pcm16)
                )[: len(ridx)]
                raw_all = rows.reshape(-1, C * frame_size)
            else:
                raw_all = np.empty((0, C * frame_size), np.int16)

            fs = FrameSet(nnz_all, pairs_all, scales_all, raw_mask_all,
                          raw_all, frame_size)
            results[i] = EncodedAudio(
                header=AudioHeader(self.sample_rate, C, len(samples)),
                frame_set=fs,
                gapless_info=GaplessInfo(
                    encoder_delay=hop // 2,
                    padding=padding,
                    original_length=len(samples),
                ),
            )

    def _dispatch_encode(self, samples, channels: int, *, pcm16: bool,
                         stats: Optional[dict] = None):
        cfg = self.config
        hop, frame_size, n = cfg.hop_size, cfg.frame_size, cfg.n
        C = int(channels)
        total_samples = len(samples)
        if total_samples == 0:
            raise ValueError("cannot encode empty input")

        if stats is not None:
            for key in ("disp_ms", "wait_ms"):
                stats.setdefault(key, 0.0)
            for key in ("up_n", "down_n"):
                stats.setdefault(key, 0)

        def _st_add(key: str, t0: float) -> None:
            if stats is not None:
                stats[key] += (time.perf_counter() - t0) * 1e3

        def _st_n(key: str, k: int = 1) -> None:
            if stats is not None:
                stats[key] += k

        dtype = np.int16 if pcm16 else np.float32
        lead = hop // 2
        tb = self._tables
        params = dict(
            pcm16=pcm16,
            quality=cfg.quality_factor,
            noise_floor_db=cfg.noise_floor_db,
            compression_threshold=cfg.compression_threshold,
            max_q=cfg.max_q,
        )
        # DeviceTables field order matches encode_interleaved_device's params
        tables = tuple(tb)

        # Transfer geometry (see upload_geometry): the signal is uploaded
        # ONCE — the user's interleaved bytes, bucketed — and stays
        # resident on the device; each segment program slices it with a dynamic
        # start; the deinterleave, hop/2 lead, and trailing zeros
        # materialize ON DEVICE (_planarize_device + static pad_hops).
        # Bucket-padding frames beyond F are discarded by the host
        # ([:valid] everywhere); they are nearly free — all-zero blocks
        # encode to nnz=0 — except frame F itself, which can see up to one
        # hop of real end-of-file samples (frame_signal's trailing pad is
        # only hop/2) and may contribute stream-tail pairs that the
        # collect phase simply never reads.
        T, F, padding, plan, need_hops, Tb = upload_geometry(
            total_samples, C, cfg
        )
        xup = bucket_upload(samples, total_samples, Tb, C, dtype)
        t0_up = time.perf_counter()
        xinter_dev = upload_resident(xup)
        _st_n("up_n", upload_piece_count(xup))
        _st_add("disp_ms", t0_up)
        params["pad_hops"] = need_hops
        params["channels"] = C
        params["lead"] = lead

        nnz_all = np.empty((F, C), np.int64)
        scales_all = np.empty((F, C), np.float32)
        raw_mask_all = np.empty(F, bool)
        pair_parts = []
        raw_parts = []
        stats_width = 2 * C + 1

        # Segments are dispatched ahead of collection so compute and
        # downloads pipeline, with a bounded in-flight window so very long
        # files cannot exhaust device memory with live buffers.  The
        # adaptive prefix slice is taken and its host copy STARTED at
        # dispatch time (copy_to_host_async), so segment downloads overlap
        # later segments' compute instead of waiting serially at collect
        # time.
        segs = []  # (start, valid, k, out_d, sliced, cut0, budget)

        def slice_async(out_d, k, budget):
            S = k * stats_width
            # One transfer fetches the stats prefix plus a guessed number of
            # packed pairs; a second fetch happens only when the guess was
            # short (the guess adapts per (channels, chunk) key).  5-bit
            # ladder: the pairs download is link bytes, so its bucket
            # overshoot is capped at 6.25% (pow2 wasted up to 2×).
            guess = self._pair_guess.get((C, k), max(budget // 8, 1 << 14))
            cut0 = min(_len_bucket(guess, 5), budget)
            return start_host_copy(out_d[: S + cut0]), cut0

        def collect(rec):
            start, valid, k, out_d, sliced, cut0, budget = rec
            t0c = time.perf_counter()
            first = np.asarray(sliced)  # counted at slice_async kickoff
            _st_add("wait_ms", t0c)
            # The stream is frame-ordered, so the valid frames' pairs occupy
            # exactly the first `wanted` slots of the packed array — intact
            # as long as wanted ≤ budget, regardless of what bucket-padding
            # frames (which can include real end-of-file samples in frame F)
            # appended after them.  The overflow decision therefore uses
            # `wanted`, not the whole-segment total
            # (parse_segment_download counts nnz[:valid] only).
            nnz, scale, use_raw, wanted, pairs = parse_segment_download(
                first, out_d, k=k, valid=valid, C=C, budget=budget,
                cut0=cut0, stats_hook=stats,
            )
            self._pair_guess[(C, k)] = wanted + wanted // 4 + 1
            self._density_hint[C] = wanted / (valid * C)

            if pairs is None or wanted > _compact_budget_cap(k, C, n):
                # Overflow (or a stats-only budget=0 probe, or a count past
                # the byte crossover that a floored budget happened to
                # cover): re-dispatch the program the exact count calls for
                # — a bigger compact tier, or the dense program past the
                # byte crossover.
                nnz, scale, use_raw, pairs = _reencode_overflow(
                    xinter_dev, start, valid=valid, k=k, wanted=wanted,
                    tables=tables, params=params,
                    bb_mult=cfg.compact_bb_mult,
                    compact_mode=cfg.compact_mode, C=C, n=n, stats=stats,
                )

            nnz_all[start : start + valid] = nnz[:valid]
            scales_all[start : start + valid] = scale[:valid]
            raw_mask_all[start : start + valid] = use_raw[:valid]
            if wanted or len(pairs):
                pair_parts.append(pairs)

            if use_raw[:valid].any():
                # absolute frame indices into the resident signal
                ridx = (start + np.flatnonzero(use_raw[:valid])).astype(
                    np.int32
                )
                # raw rows are the widest download records — 4-bit ladder
                # like every other transfer shape (≤12.5% overshoot)
                rbudget = min(_len_bucket(len(ridx), 4), k)
                idx_pad = np.zeros(rbudget, np.int32)
                idx_pad[: len(ridx)] = ridx
                t0r = time.perf_counter()
                rows = np.asarray(
                    gather_raw_interleaved_device(
                        xinter_dev, idx_pad, tb.window,
                        channels=C, lead=lead, pad_hops=need_hops,
                        pcm16=pcm16)
                )[: len(ridx)]
                _st_add("wait_ms", t0r)
                _st_n("down_n")
                # channel-major flatten — the reference's actual storage
                # layout (codec.rs:471-503, quirk Q13)
                raw_parts.append(rows.reshape(-1, C * frame_size))

        for start, k in plan:
            valid = min(k, F - start)
            budget = _pick_budget(self._density_hint.get(C), k, C, n)
            t0d = time.perf_counter()
            out_d = encode_interleaved_device(
                xinter_dev, np.int32(start), np.int32(valid), *tables,
                k_frames=k, budget=budget,
                bb_mult=cfg.compact_bb_mult,
                compact_mode=cfg.compact_mode, **params
            )
            sliced, cut0 = slice_async(out_d, k, budget)
            _st_add("disp_ms", t0d)
            _st_n("down_n")  # slice_async started one async download
            segs.append((start, valid, k, out_d, sliced, cut0, budget))
            if len(segs) > 4:
                collect(segs.pop(0))

        def finish() -> EncodedAudio:
            """Drain the remaining segment downloads and assemble the
            container.  Deferred so `encode_many` can dispatch the NEXT
            file's upload before this file's downloads start."""
            for rec in segs:
                collect(rec)
            segs.clear()

            pairs_all = (
                np.concatenate(pair_parts) if pair_parts
                else np.empty(0, PAIR_DTYPE)
            )
            raw_all = (
                np.concatenate(raw_parts)
                if raw_parts
                else np.empty((0, C * frame_size), np.int16)
            )

            fs = FrameSet(nnz_all, pairs_all, scales_all, raw_mask_all,
                          raw_all, frame_size)
            return EncodedAudio(
                header=AudioHeader(self.sample_rate, C, total_samples),
                frame_set=fs,
                gapless_info=GaplessInfo(
                    encoder_delay=hop // 2,
                    padding=padding,
                    original_length=total_samples,
                ),
            )

        return finish
