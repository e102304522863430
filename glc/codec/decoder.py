"""GLC decoder: container parse → device IMDCT/window/overlap-add → trim.

API mirrors the reference (reference src/codec.rs:571-768):

    dec = Decoder(channels, sample_rate)
    samples = dec.decode(encoded)                    # trimmed, interleaved
    rx = dec.decode_streaming(encoded, progress_cb)  # queue of AudioChunk

The reference's producer thread + bounded(5) crossbeam channel + 32-frame
rayon batches (codec.rs:595-741) become: a producer thread driving chunked
jitted device calls, a bounded `queue.Queue(5)`, and frame-batched tensor ops.
The sequential overlap buffer is a shifted add (see ops/decode.py); only a
[C, n] carry crosses chunk boundaries.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional

import jax
import numpy as np

from ..config import CodecConfig, DEFAULT_CONFIG
from ..container.schema import AudioChunk, EncodedAudio, FrameSet, Progress
from ..ops.decode import (
    decode_chunk_packed_device,
    prefix_rows,
    start_host_copy,
)
from .tables import chunk_size_for, get_device_tables, len_bucket

ProgressSender = Callable[[Progress], None]

_zero_carry_cache: dict = {}


def _zero_carry_device(C: int, n: int, batch: Optional[int] = None):
    """Device-resident zero [C, n] (or [batch, C, n]) f32 carry, cached per
    shape: every decode starts from silence, and uploading the same 8 KB of
    zeros again would cost a transfer per decode.  jax arrays are immutable, so one cached buffer serves every decode."""
    key = (batch, C, n)
    buf = _zero_carry_cache.get(key)
    if buf is None:
        shape = (C, n) if batch is None else (batch, C, n)
        buf = jax.device_put(np.zeros(shape, np.float32))
        _zero_carry_cache[key] = buf
    return buf


class _Cancelled(Exception):
    """Raised inside the producer thread when the consumer abandoned the
    stream (rx.cancelled set)."""


# Hop downloads leave the device in ≤1024-row pieces (~4 MB stereo), queued
# back-to-back with async copies.  The piece size was chosen for an earlier,
# much slower host link; whether pieces help over PCIe is not yet measured.
_DOWNLOAD_PIECE_ROWS = 1024

# In-flight chunk handles in the multi-track pipelined decode (matches
# decode_i16_stream's own lookahead depth).  Tracks run in strict serial
# CHUNK order, but the window is GLOBAL across track boundaries: track
# N+1's pack/upload/dispatch/compute proceed while track N's last downloads
# drain, so the device never idles at a boundary (the reference decodes
# album tracks with a cold start per file, src/ui.rs:317-359).  The depth
# bounds in-flight device memory; its best value on the GPU is not yet
# measured.
_PIPELINE_DEPTH = 8


def _piece_download(hops_d, rows: int):
    """Slice the leading `rows` of a device hop tensor into ≤1024-row
    pieces with async host copies started; returns the piece list."""
    pieces = []
    for o in range(0, rows, _DOWNLOAD_PIECE_ROWS):
        pieces.append(
            start_host_copy(hops_d[o : min(o + _DOWNLOAD_PIECE_ROWS, rows)])
        )
    return pieces


def _gather_pieces(pieces) -> np.ndarray:
    """Materialize a pieced download as one host array."""
    if len(pieces) == 1:
        return np.asarray(pieces[0])
    return np.concatenate([np.asarray(p) for p in pieces])


def _packed_slices(fs: FrameSet, start: int, count: int, K: int, n: int,
                   reference_compat: bool = True,
                   force_budget: int = 0, force_rbudget: int = 0):
    """Packed upload payload for frames [start, start+count) of a K-frame
    chunk (count ≤ K; the rest is padding).

    Returns (words int32, budget, rbudget) for
    `decode_chunk_packed_device` — ONE buffer per chunk, raw frames
    included, because every transfer has a fixed cost whatever its size,
    so one combined upload beats several small ones.
    See the device docstring for the section layout.  The raw-PCM byte
    layout is read back *interleaved* (sample_idx = i*channels + ch,
    reference src/codec.rs:636) even though the encoder stored it
    channel-major — quirk Q13, reproduced for parity.

    `force_budget`/`force_rbudget` (> 0) override the ladder-derived
    sizes: the segment-batched multi-track path needs every track's chunk
    buffer in a batch to share ONE layout, so it forces the batch maxima.
    Forcing smaller than this chunk's own pair/raw count is an error
    (caught by the existing budget check below).
    """
    C = fs.channels
    frame_size = fs.frame_size
    nnz = fs.nnz[start : start + count]              # [count, C]
    is_raw_v = fs.raw_mask[start : start + count]

    pair_start = int(fs.nnz[:start].sum())
    P = int(nnz.sum())
    pairs = fs.pairs[pair_start : pair_start + P] if P else fs.pairs[:0]
    if P:
        # The reference's sequential scatter is last-wins on duplicate
        # indices (codec.rs:660-663); the device scatter is order-
        # unspecified, so duplicates must be resolved host-side.  And the
        # upload carries nnz as uint16 (the device rebuilds the pair→row
        # mapping from it), so rows with > 65535 pairs must shrink.  Both
        # only happen in malformed streams — well-formed ones are strictly
        # increasing per (frame, channel) with ≤ n pairs, so this O(P)
        # check is all that runs — and both imply duplicates, so one
        # rewrite handles them: physically drop all but the LAST of each
        # duplicate position and recount nnz (equivalent by last-wins;
        # ≤ n+1 distinct positions remain per row, well under 2^16).
        # Dedup key: row stride n+1 gives out-of-range k (clamped to n) a
        # slot of its own per row, so OOB pairs never alias a neighboring
        # row's k=0 (the device drops OOB regardless).
        flat_fc = np.repeat(np.arange(count * C), nnz.reshape(-1))
        p = flat_fc * (n + 1) + np.minimum(pairs["k"].astype(np.int64), n)
        if P > 1 and not (np.diff(p) > 0).all():
            dup = np.zeros(P, bool)
            order = np.argsort(p, kind="stable")
            ps = p[order]
            dup_sorted = np.concatenate([ps[1:] == ps[:-1], [False]])
            dup[order] = dup_sorted  # True for all but the LAST of each run
            keep = ~dup
            pairs = pairs[keep]
            nnz = np.bincount(
                flat_fc[keep], minlength=count * C
            ).reshape(count, C).astype(np.int64)
            P = len(pairs)

    # ladder-bucketed upload shapes, capped at the dense maximum — keeps
    # the set of compiled decode programs small while wasting ≤6.25% of the
    # pairs upload (these are link bytes; pow2 wasted up to 2×)
    budget = force_budget or min(len_bucket(P, 5), K * C * n)
    if P > budget:
        # Post-dedup, each row holds ≤ n+1 distinct slots (n in-range plus
        # one OOB slot), so a malformed stream can exceed the dense budget
        # cap K·C·n by up to one pair per row.  A well-formed stream never
        # gets here; fail loudly instead of a shape-mismatch crash.
        raise ValueError(
            f"malformed stream: {P} coefficient pairs exceed the dense "
            f"budget {budget} for a {K}-frame chunk"
        )

    R = int(is_raw_v.sum())
    # raw rows are the widest upload records (C·frame_size i16 each), so
    # they get the 4-bit ladder too (floor 16, ≤12.5% overshoot)
    rbudget = force_rbudget or (min(len_bucket(R, 4), K) if R else 0)
    if R > rbudget:
        raise ValueError(
            f"{R} raw frames exceed the forced raw budget {rbudget}"
        )
    base = budget + (K * C) // 2 + K * C + K
    raw_sec = rbudget + rbudget * C * frame_size // 2
    words = np.empty(base + raw_sec, np.int32)
    kv = words[:budget].view(np.uint32)
    kv[:] = 0xFFFF0000  # fill: k = 0xFFFF ≥ n → dropped by the device
    if P:
        kidx = pairs["k"].astype(np.uint32)
        kv[:P] = (kidx << 16) | pairs["q"].view(np.uint16).astype(np.uint32)

    nnz_sec = words[budget : budget + (K * C) // 2].view(np.uint16)
    if int(nnz.max(initial=0)) >= (1 << 16):
        # Unreachable after the dedup rewrite above (≤ n+1 pairs per row
        # survive), but the uint16 narrowing below must never wrap silently
        # — and `assert` would vanish under python -O.
        raise ValueError("malformed stream: per-row pair count >= 2^16")
    nnz_sec[: count * C] = nnz.reshape(-1).astype(np.uint16)
    nnz_sec[count * C :] = 0
    o1 = budget + (K * C) // 2
    scale_sec = words[o1 : o1 + K * C].view(np.float32)
    scale_sec[: count * C] = fs.scales[start : start + count].reshape(-1)
    scale_sec[count * C :] = 0.0
    flag_sec = words[o1 + K * C : o1 + K * C + K]
    flag_sec[:count] = is_raw_v
    flag_sec[count:] = 0

    if rbudget == 0:
        return words, budget, 0

    raw_words = words[base:]
    raw_words[:rbudget] = K  # fill indices → dropped
    raw_words[:R] = np.flatnonzero(is_raw_v).astype(np.int32)
    rows_sec = raw_words[rbudget:].view(np.int16).reshape(
        rbudget, C, frame_size
    )
    raw_before = int(np.count_nonzero(fs.raw_mask[:start]))
    rows = fs.raw_pcm[raw_before : raw_before + R]
    if reference_compat:
        # interleaved read-back of channel-major data (Q13)
        rows_sec[:R] = rows.reshape(-1, frame_size, C).transpose(0, 2, 1)
    else:
        # clean mode: read channel-major, as actually stored
        rows_sec[:R] = rows.reshape(-1, C, frame_size)
    rows_sec[R:] = 0
    return words, budget, rbudget


def gapless_trim_bounds(pre_len: int, gapless_info, channels: int,
                        reference_compat: bool):
    """(skip, limit) of the gapless trim of reference src/codec.rs:756-767:
    drain the encoder delay, truncate to the original length — both guarded,
    both in interleaved-sample units (quirk Q1).  Clean mode scales the
    delay by the channel count so the per-channel lead-in is fully removed
    (fixes Q1).

    Single source of truth for every decode surface (`decode`,
    `decode_i16_stream`, and length prediction): a trim change lands once,
    here.  The trimmed stream is `full[skip : skip + limit]`.
    """
    delay = gapless_info.encoder_delay
    if not reference_compat:
        delay *= channels
    skip = delay if pre_len > delay else 0
    limit = min(gapless_info.original_length, pre_len - skip)
    return skip, limit


def gapless_trim(all_samples: np.ndarray, gapless_info, channels: int,
                 reference_compat: bool) -> np.ndarray:
    skip, limit = gapless_trim_bounds(len(all_samples), gapless_info,
                                      channels, reference_compat)
    return all_samples[skip : skip + limit]


class Decoder:
    """reference src/codec.rs:571-592 (stateless in practice, Q8)."""

    def __init__(
        self,
        channels: int,
        sample_rate: int,
        config: Optional[CodecConfig] = None,
    ):
        self.channels = int(channels)
        self.sample_rate = int(sample_rate)
        self.config = config or DEFAULT_CONFIG
        self._tables = get_device_tables(
            self.config.n, self.config.frame_size, self.sample_rate
        )

    # --- streaming decode (codec.rs:595-741) ---

    def decode_streaming(
        self,
        encoded: EncodedAudio,
        progress_sender: Optional[ProgressSender] = None,
    ) -> "queue.Queue[AudioChunk]":
        """Spawn a producer thread; returns a bounded queue of AudioChunk.

        Chunks are frames_per_chunk (=500) frames of interleaved samples; the
        final chunk carries the remainder plus the last overlap tail and has
        ``is_last=True``.  Output is UNtrimmed, exactly like the reference
        streaming path (the gapless trim only happens in `decode`,
        codec.rs:744-768).
        """
        rx: "queue.Queue[AudioChunk]" = queue.Queue(maxsize=5)
        # Consumers that abandon the stream early set this so the producer
        # thread exits instead of blocking forever on the bounded queue
        # (the crossbeam analog: rx dropped → send errors → thread exits).
        rx.cancelled = threading.Event()  # type: ignore[attr-defined]
        t = threading.Thread(
            target=self._produce_safe,
            args=(encoded, rx, progress_sender),
            daemon=True,
        )
        t.start()
        return rx

    def _produce_safe(self, encoded, rx, progress_sender):
        try:
            self._produce(encoded, rx, progress_sender)
        except _Cancelled:
            pass
        except Exception as e:  # surface the failure instead of hanging rx
            if progress_sender is not None:
                try:
                    progress_sender(Progress.error(str(e)))
                except Exception:
                    pass
            try:
                # must not be dropped: without a terminal chunk the consumer
                # blocks forever (reference: crossbeam send blocks too)
                self._put(
                    rx,
                    AudioChunk(samples=np.empty(0, np.float32), is_last=True,
                               error=str(e)),
                )
            except _Cancelled:
                pass

    @staticmethod
    def _put(rx, chunk) -> None:
        """Bounded put that gives up when the consumer cancelled."""
        while True:
            if getattr(rx, "cancelled", None) is not None and rx.cancelled.is_set():
                raise _Cancelled()
            try:
                rx.put(chunk, timeout=0.25)
                return
            except queue.Full:
                continue

    def _produce(self, encoded, rx, progress_sender):
        cfg = self.config
        n, C = cfg.n, encoded.header.channels
        fs = encoded.frame_set
        F = fs.num_frames
        tb = self._tables
        start_time = time.monotonic()

        def send(p: Progress):
            if progress_sender is not None:
                progress_sender(p)

        send(Progress.status(f"Starting streaming decode of {F} frames"))

        flush_frames = cfg.frames_per_chunk
        chunk = chunk_size_for(max(F, 1), cfg.decode_chunk_frames)
        carry = _zero_carry_device(C, n)
        window_raw = not cfg.reference_compat  # fix Q4 in clean mode

        pending = []          # list of [K, n, C] hop arrays (numpy)
        pending_frames = 0
        emitted = 0           # frames emitted so far

        def emit(frames_needed: int, hops_concat) -> None:
            nonlocal emitted
            # [Kf, n, C] arrives interleaved from the device — flat view
            flat = hops_concat.reshape(-1)
            self._put(rx, AudioChunk(samples=flat, is_last=False))
            emitted += frames_needed

        # One-chunk dispatch lookahead: kick off device chunk i+1 before
        # downloading chunk i so compute/upload overlap the download (the
        # double-buffered host feeder of SURVEY.md §2.8).
        inflight = None  # (piece list, valid)
        tail_row = None  # [n, C] — the stream's overlap tail (last chunk)

        def drain(handle, last=False):
            nonlocal pending_frames, tail_row
            pieces, valid = handle
            arr = _gather_pieces(pieces)
            pending.append(arr[:valid])
            pending_frames += valid
            if last:
                # append_carry put the tail at row `valid` — no 2nd transfer
                tail_row = arr[valid]

        def flush_full_chunks():
            # Flush in exact 500-frame chunks, mirroring the per-frame
            # accumulate-and-flush of codec.rs:706-717; progress uses the
            # 0-based index of the frame that filled the chunk
            # (codec.rs:710-714).
            nonlocal pending, pending_frames
            while pending_frames >= flush_frames:
                buf = np.concatenate(pending) if len(pending) > 1 else pending[0]
                out, rest = buf[:flush_frames], buf[flush_frames:]
                pending = [rest] if len(rest) else []
                pending_frames -= flush_frames
                idx = emitted + flush_frames - 1
                send(Progress.decoding(idx / F * 100.0))
                emit(flush_frames, out)

        for start in range(0, F, chunk):
            valid = min(chunk, F - start)
            words, budget, rbudget = _packed_slices(
                fs, start, valid, chunk, n, cfg.reference_compat
            )

            hops, carry = decode_chunk_packed_device(
                jax.device_put(words),
                carry,
                np.int32(valid),
                tb.cos_table, tb.window, tb.norm,
                K=chunk, C=C, n=n,
                budget=budget, rbudget=rbudget,
                max_q=cfg.max_q,
                window_raw=window_raw,
                out_interleave=True,
                append_carry=True,
            )
            # device-side prefix slice: chunk padding never crosses the
            # link; +1 row so the last chunk's download carries the tail;
            # pieced so the download rides burst transfers
            rows = prefix_rows(valid + 1, chunk + 1)
            pieces = _piece_download(hops, rows)
            prev, inflight = inflight, (pieces, valid)
            if prev is not None:
                drain(prev)
                flush_full_chunks()

        if inflight is not None:
            drain(inflight, last=True)
            flush_full_chunks()

        # Final chunk: remaining frames + last overlap tail (codec.rs:722-732)
        if tail_row is None:  # F == 0: no chunks ran, the tail is silence
            tail_row = np.zeros((n, C), np.float32)
        tail = tail_row.reshape(1, -1)  # [1, n*C] interleaved
        if pending_frames:
            buf = np.concatenate(pending) if len(pending) > 1 else pending[0]
            flat = buf.reshape(-1)
            last = np.concatenate([flat, tail.reshape(-1)])
        else:
            last = tail.reshape(-1)
        self._put(rx, AudioChunk(samples=last, is_last=True))

        send(
            Progress.complete(
                f"Decoded {F} frames in {time.monotonic() - start_time:.2f}s"
            )
        )

    # --- fast non-streaming decode to int16 (export path) ---

    def decode_i16_stream(self, encoded: EncodedAudio,
                          chunk_frames: Optional[int] = None,
                          stats: Optional[dict] = None):
        """Generator of gapless-trimmed int16 interleaved chunks, in stream
        order, with the exporters' conversion applied on device
        (trunc(clip(x·32767)), audio.rs:9-16).

        Streaming form of `decode_i16`: consumers (the FLAC exporter) can
        overlap their host work with the device decode's transfers.  The
        trim is applied incrementally — the guarded drain/truncate of
        codec.rs:756-767 needs the pre-trim total, which is exact up front:
        (F+1)·n·C interleaved samples (F hops plus the overlap tail).

        `chunk_frames` overrides the decode chunk size for this stream.
        The shipped exports leave it at config.decode_chunk_frames: on the
        CPU backend the bytes are identical at any chunk size (tests pin
        this), but on the GPU each chunk shape is its own compiled program
        and the int16 output can move by 1 LSB.

        `stats`, if given, accumulates wall-time stage attribution into the
        dict: pack_ms (host _packed_slices), disp_ms (upload staging +
        dispatch + async-download kickoff), wait_ms (blocked in download
        gathers + trim), plus the transfer counts up_n (chunk-words
        uploads) and down_n (download pieces).  It instruments the SHIPPED loop, so bench
        attribution can never desynchronize from what this method does.
        """
        for _pos, flat in self._pipelined_i16_chunks(
            [(0, encoded)], chunk_frames=chunk_frames, stats=stats
        ):
            yield flat

    def _pipelined_i16_chunks(self, recs, chunk_frames: Optional[int] = None,
                              stats: Optional[dict] = None):
        """Core of every int16 decode surface: drive the tracks in `recs`
        (a list of ``(pos, EncodedAudio)``) through per-chunk device
        dispatches with ONE global `_PIPELINE_DEPTH`-deep in-flight window,
        yielding ``(pos, trimmed_flat)`` in stream order.

        `decode_i16_stream` is the single-track case;
        `_decode_streaming_pipelined` (decode_many's multi-chunk path) is
        the playlist case — one implementation, so the pack/dispatch/trim
        logic can never desynchronize between them.  The window being
        global means track N+1's pack/upload/dispatch/compute overlap
        track N's tail downloads (the reference decodes album tracks with
        a cold start per file, src/ui.rs:317-359).  Per-track chunk
        geometry, dispatch order, and trim are exactly the single-track
        ones, so per-track output is BIT-identical either way.
        """
        cfg = self.config
        n = cfg.n
        tb = self._tables
        window_raw = not cfg.reference_compat

        if stats is not None:
            for k in ("pack_ms", "disp_ms", "wait_ms"):
                stats.setdefault(k, 0.0)
            for k in ("up_n", "down_n"):
                stats.setdefault(k, 0)
        _tick = time.perf_counter

        def _add(key: str, t0: float) -> float:
            t1 = _tick()
            if stats is not None:
                stats[key] += (t1 - t0) * 1e3
            return t1

        # per-track trim state: pos -> [skip_left, emitted, limit]
        trim_state: dict = {}

        def trim(pos, flat):
            st = trim_state[pos]
            skip, emitted, limit = st
            if skip:
                cut = min(skip, len(flat))
                flat = flat[cut:]
                st[0] = skip - cut
            if emitted + len(flat) > limit:
                flat = flat[: limit - emitted]
            st[1] = emitted + len(flat)
            return flat

        def collect(handle):
            pos, pieces, valid, last = handle
            # [valid(+1), n, C] i16, already interleaved; row `valid` of the
            # last chunk is the overlap tail, converted on device with the
            # exact hop epilogue (append_carry)
            need = valid + 1 if last else valid
            t0 = _tick()
            out = trim(pos, _gather_pieces(pieces)[:need].reshape(-1))
            _add("wait_ms", t0)
            return pos, out

        handles: list = []
        for pos, encoded in recs:
            C = encoded.header.channels
            fs = encoded.frame_set
            F = fs.num_frames
            chunk = chunk_size_for(max(F, 1),
                                   chunk_frames or cfg.decode_chunk_frames)
            carry = _zero_carry_device(C, n)
            pre_len = (F + 1) * n * C
            skip, limit = gapless_trim_bounds(
                pre_len, encoded.gapless_info, C, cfg.reference_compat
            )
            trim_state[pos] = [skip, 0, limit]
            if F == 0:  # no chunks to run: the stream is the silent tail
                tail = trim(pos, np.zeros(n * C, np.int16))
                if len(tail):
                    yield pos, tail
                continue
            for start in range(0, F, chunk):
                valid = min(chunk, F - start)
                t0 = _tick()
                words, budget, rbudget = _packed_slices(
                    fs, start, valid, chunk, n, cfg.reference_compat
                )
                t0 = _add("pack_ms", t0)
                hops_d, carry = decode_chunk_packed_device(
                    jax.device_put(words),
                    carry, np.int32(valid),
                    tb.cos_table, tb.window, tb.norm,
                    K=chunk, C=C, n=n,
                    budget=budget, rbudget=rbudget,
                    max_q=cfg.max_q, window_raw=window_raw,
                    out_i16=True,
                    out_interleave=True,
                    append_carry=True,
                )
                last = start + chunk >= F
                rows = prefix_rows(valid + 1, chunk + 1)
                pieces = _piece_download(hops_d, rows)
                handles.append((pos, pieces, valid, last))
                if stats is not None:
                    stats["up_n"] += 1
                    stats["down_n"] += len(pieces)
                _add("disp_ms", t0)
                # bound in-flight device memory, keep the pipeline deep
                if len(handles) > _PIPELINE_DEPTH:
                    pos_o, out = collect(handles.pop(0))
                    if len(out):
                        yield pos_o, out

        for handle in handles:
            pos_o, out = collect(handle)
            if len(out):
                yield pos_o, out

    def decoded_length(self, encoded: EncodedAudio) -> int:
        """Exact post-trim interleaved sample count of `decode`/`decode_i16`
        output, without decoding: the pre-trim length is (F+1)·n·C (F hops
        plus the overlap tail, quirk Q12) and the trim bounds are
        deterministic."""
        C = encoded.header.channels
        F = encoded.frame_set.num_frames
        pre_len = (F + 1) * self.config.n * C
        _skip, limit = gapless_trim_bounds(
            pre_len, encoded.gapless_info, C, self.config.reference_compat
        )
        return limit

    def decode_i16(self, encoded: EncodedAudio,
                   stats: Optional[dict] = None) -> np.ndarray:
        """Decode straight to int16 — equal to
        `convert_f32_to_i16(self.decode(encoded))` within 1 LSB (the
        separately compiled program can shift the f32 hops by ±1 ulp), at
        half the download and with a deep dispatch pipeline (the device
        chains the carry without host round-trips).  `stats` forwards to
        `decode_i16_stream`'s stage-attribution hook."""
        from ..profiling import maybe_trace

        with maybe_trace("decode_i16"):
            parts = list(self.decode_i16_stream(encoded, stats=stats))
        if not parts:
            return np.empty(0, np.int16)
        return np.concatenate(parts)

    def decode_many(self, encoded_list, stats: Optional[dict] = None) -> list:
        """Multi-track decode to int16 — the decode-side analog of
        `Encoder.encode_many` (no reference analog; the GUI album export
        decodes files serially, reference src/ui.rs:317-359).

        `stats` forwards to the pipelined chunk scheduler's stage/transfer
        attribution hook (see `decode_i16_stream`); it counts the
        MULTI-chunk tracks' transfers only — single-chunk groups dispatch
        batched programs whose transfer geometry differs per group.

        Tracks whose packed upload lands in the same (chunk, budget,
        rbudget) buckets — the transfer-shape ladder makes same-material
        tracks coincide — are decoded by ONE batched device program: one
        upload, one dispatch, one download for the whole group.  Singleton
        groups dispatch the single-track packed program on the same
        already-built buffer (no re-packing), so every single-chunk track's
        transfers overlap the others'.  MULTI-chunk tracks (anything past
        decode_chunk_frames = 1408 frames ≈ 32.7 s at 44.1 kHz) run the
        cross-track pipelined chunk scheduler
        (`_decode_streaming_pipelined`: one global in-flight window, so
        track boundaries never idle the device) — or, with
        config.segmented_batch=True, batch at SEGMENT level: chunk s of
        every track in one dispatch, per-track overlap carries chained
        exactly as the serial path chains them (`_decode_segmented_group`,
        for fast-interconnect deployments).  Per-track output equals
        `decode_i16` within 1 LSB — bit-identical on the default path (it
        IS decode_i16's core, `_pipelined_i16_chunks`); the batched
        programs are the same traced body under lax.map, where XLA may
        fuse the IMDCT chain differently.
        """
        cfg = self.config
        n = cfg.n
        tb = self._tables
        window_raw = not cfg.reference_compat
        results: list = [None] * len(encoded_list)

        groups: dict = {}
        multis: dict = {}
        fallbacks: list = []
        for i, ea in enumerate(encoded_list):
            C = ea.header.channels
            F = ea.frame_set.num_frames
            chunk = chunk_size_for(max(F, 1), cfg.decode_chunk_frames)
            if F == 0:
                fallbacks.append((i, ea))
                continue
            if F > chunk:
                multis.setdefault((C, chunk), []).append((i, ea, F))
                continue
            words, budget, rbudget = _packed_slices(
                ea.frame_set, 0, F, chunk, n, cfg.reference_compat
            )
            key = (C, chunk, budget, rbudget)
            groups.setdefault(key, []).append((i, ea, F, words))

        from ..ops.decode import decode_chunks_packed_batch_device

        # dispatch every group (batched or singleton) before collecting
        # anything, so all downloads pipeline on the link
        handles = []
        for (C, chunk, budget, rbudget), recs in groups.items():
            kw = dict(
                K=chunk, C=C, n=n, budget=budget, rbudget=rbudget,
                max_q=cfg.max_q, window_raw=window_raw,
                out_i16=True, out_interleave=True, append_carry=True,
            )
            valid_b = np.asarray([F for _i, _ea, F, _w in recs], np.int32)
            if len(recs) == 1:
                hops_d, _carry = decode_chunk_packed_device(
                    jax.device_put(recs[0][3]),
                    _zero_carry_device(C, n), np.int32(int(valid_b[0])),
                    tb.cos_table, tb.window, tb.norm, **kw,
                )
                hops_d = hops_d[None]  # [1, K+1, n, C] — same collect shape
            else:
                hops_d = decode_chunks_packed_batch_device(
                    jax.device_put(np.stack([w for *_x, w in recs])),
                    jax.device_put(valid_b),
                    tb.cos_table, tb.window, tb.norm, **kw,
                )
            # per-track device-side prefixes with per-track async copies:
            # padding beyond EACH track never crosses the link
            for b, (i, ea, F, _w) in enumerate(recs):
                rows = prefix_rows(F + 1, chunk + 1)
                # pieced (≤1024-row) async copies, like decode_i16
                handles.append(
                    (i, ea, F, C, _piece_download(hops_d[b], rows))
                )

        # multi-chunk tracks run while the single-chunk downloads drain
        # (their own dispatches/downloads pipeline inside)
        if multis:
            if cfg.segmented_batch:
                for (C, chunk), recs in multis.items():
                    self._decode_segmented_group(
                        recs, results, C=C, chunk=chunk
                    )
            else:
                flat = sorted(
                    (i, ea) for recs in multis.values()
                    for i, ea, _F in recs
                )
                self._decode_streaming_pipelined(flat, results, stats=stats)

        # empty tracks (F == 0) decode through the stream path
        for i, ea in fallbacks:
            results[i] = self.decode_i16(ea)

        for i, ea, F, C, pieces in handles:
            flat = _gather_pieces(pieces)[: F + 1].reshape(-1)  # hops + tail
            # copy: the trim is a view into the track's download buffer
            results[i] = gapless_trim(
                flat, ea.gapless_info, C, cfg.reference_compat
            ).copy()
        return results

    def _decode_streaming_pipelined(self, recs, results,
                                    stats: Optional[dict] = None) -> None:
        """Multi-chunk tracks, DEFAULT path: serial chunk order across the
        playlist with ONE global in-flight window — the playlist case of
        `_pipelined_i16_chunks` (see its docstring; a per-track window
        would idle the device on every track boundary).  Per-track output is
        BIT-identical to `decode_i16` (same core).
        """
        parts: dict = {i: [] for i, _ in recs}
        for pos, flat in self._pipelined_i16_chunks(recs, stats=stats):
            parts[pos].append(flat)
        for i, _ in recs:
            results[i] = (
                np.concatenate(parts[i]) if parts[i]
                else np.empty(0, np.int16)
            )

    def _decode_segmented_group(self, recs, results, *, C, chunk) -> None:
        """Segment-level batched decode of multi-chunk tracks
        (config.segmented_batch=True — see that knob's docstring for when;
        the serial loop this replaces is the GUI album decode, reference
        src/ui.rs:317-359).

        Chunk s of every track in `recs` runs as ONE batched dispatch
        (decode_chunks_packed_batch_carry_device) with the [B, C, n]
        overlap-carry tensor chained device-side between segments — one
        upload + one dispatch per segment index instead of per (track,
        segment).  Every track's chunk buffer in a segment batch is forced
        to the batch-max (budget, rbudget) layout so the [B, W] stack is
        possible; the overshoot is bounded by the 5-bit ladder spread
        across same-album tracks.  Tracks shorter than the group's longest
        ride the tail segments with valid=0 and no download.  Fills
        results[i] with gapless-trimmed int16 per track (≤1 LSB vs
        decode_i16, the cross-program contract).
        """
        from ..ops.decode import decode_chunks_packed_batch_carry_device

        cfg = self.config
        n = cfg.n
        tb = self._tables
        window_raw = not cfg.reference_compat
        B = len(recs)
        Fs = [F for _i, _ea, F in recs]
        n_chunks = [-(-F // chunk) for F in Fs]
        S = max(n_chunks)
        carries = _zero_carry_device(C, n, batch=B)
        parts: list = [[] for _ in range(B)]
        pending: list = []

        def collect(handles) -> None:
            for b, valid, last, pieces in handles:
                need = valid + 1 if last else valid
                parts[b].append(_gather_pieces(pieces)[:need].reshape(-1))

        for s in range(S):
            start = s * chunk
            valids = [min(max(F - start, 0), chunk) for F in Fs]
            # batch-max upload layout (see docstring)
            fb, frb = 1, 0
            for b, (_i, ea, _F) in enumerate(recs):
                if valids[b] == 0:
                    continue
                fsb = ea.frame_set
                P = int(fsb.nnz[start : start + valids[b]].sum())
                R = int(np.count_nonzero(
                    fsb.raw_mask[start : start + valids[b]]))
                fb = max(fb, min(len_bucket(P, 5), chunk * C * n))
                if R:
                    frb = max(frb, min(len_bucket(R, 4), chunk))
            words_b = np.stack([
                _packed_slices(
                    ea.frame_set, min(start, F), valids[b], chunk, n,
                    cfg.reference_compat,
                    force_budget=fb, force_rbudget=frb,
                )[0]
                for b, (_i, ea, F) in enumerate(recs)
            ])
            hops_b, carries = decode_chunks_packed_batch_carry_device(
                jax.device_put(words_b),
                carries,
                jax.device_put(np.asarray(valids, np.int32)),
                tb.cos_table, tb.window, tb.norm,
                K=chunk, C=C, n=n, budget=fb, rbudget=frb,
                max_q=cfg.max_q, window_raw=window_raw,
                out_i16=True, out_interleave=True, append_carry=True,
            )
            handles = []
            for b in range(B):
                if valids[b] == 0:
                    continue
                last = s == n_chunks[b] - 1
                rows = prefix_rows(valids[b] + (1 if last else 0), chunk + 1)
                # pieced async copies — see the single-chunk path's note
                handles.append(
                    (b, valids[b], last, _piece_download(hops_b[b], rows))
                )
            pending.append(handles)
            # bound live device/host buffers while keeping the pipeline deep
            if len(pending) > 2:
                collect(pending.pop(0))

        for handles in pending:
            collect(handles)

        for b, (i, ea, _F) in enumerate(recs):
            flat = np.concatenate(parts[b])
            results[i] = gapless_trim(
                flat, ea.gapless_info, C, cfg.reference_compat
            ).copy()

    # --- synchronous decode + gapless trim (codec.rs:744-768) ---

    def decode(
        self,
        encoded: EncodedAudio,
        progress_sender: Optional[ProgressSender] = None,
    ) -> np.ndarray:
        from ..profiling import maybe_trace

        with maybe_trace("decode"):
            rx = self.decode_streaming(encoded, progress_sender)
            parts = []
            while True:
                chunk = rx.get()
                if chunk.error is not None:
                    raise RuntimeError(f"decode failed: {chunk.error}")
                parts.append(chunk.samples)
                if chunk.is_last:
                    break
        all_samples = np.concatenate(parts) if parts else np.empty(0, np.float32)
        return gapless_trim(all_samples, encoded.gapless_info,
                            encoded.header.channels,
                            self.config.reference_compat)
