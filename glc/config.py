"""Codec configuration constants.

Mirrors the compile-time constants of the reference implementation
(reference src/codec.rs:15-29).  Frozen dataclass so instances hash and can be
closed over by jitted functions as static configuration.
"""

from dataclasses import dataclass


@dataclass(frozen=True)
class CodecConfig:
    # Transform geometry (codec.rs:15-16)
    frame_size: int = 2048  # 2N — samples per MDCT block
    hop_size: int = 1024    # N — hop, 50% overlap

    # Quantization (codec.rs:17, 24-25)
    quantization_bits: int = 16
    min_quantization_bits: int = 8
    max_quantization_bits: int = 16

    # Streaming (codec.rs:18-19)
    frames_per_chunk: int = 500
    decode_batch: int = 32

    # Lossy parameters (codec.rs:22-23)
    noise_floor_db: float = -48.0
    quality_factor: float = 0.7

    # Per-frame raw-PCM fallback threshold (codec.rs:29)
    compression_threshold: float = 0.85

    # --- Rebuild-specific knobs (not in the reference) ---
    # Reproduce the reference's quirky behaviors exactly (SURVEY.md §2.9):
    #  Q1  gapless trim in interleaved units (codec.rs:755-767)
    #  Q4  raw-PCM frames windowed once at encode, not re-windowed at decode
    #      (codec.rs:496-502 vs 626-643)
    #  Q13 raw-PCM stored channel-major (codec.rs:471-503) but read back
    #      interleaved (codec.rs:636) — scrambles stereo raw frames
    # Setting reference_compat=False fixes all three (clean-path mode).
    reference_compat: bool = True

    # Device batching: frames per jitted chunk (static shape → one compile).
    encode_chunk_frames: int = 4096
    # Decode chunks are deliberately SMALLER than encode's: a chunk is the
    # decode pipeline's overlap unit (chunk i+1's pack/upload/dispatch/
    # compute hide under chunk i's downloads), and a 60 s file in ONE
    # 2816-frame chunk has nothing to overlap.  The size was tuned on an
    # earlier, much slower host link; it is not yet measured on the GPU.
    # Every int16 export (WAV, FLAC, album FLAC) decodes in chunks of this
    # one size: on the GPU a different chunk shape compiles a different
    # program, whose f32 hops can differ by 1 ulp and the int16 by 1 LSB,
    # so one size keeps the FLAC and WAV exports of a file identical.
    decode_chunk_frames: int = 1408

    # Segment-batched album paths for MULTI-segment tracks
    # (encode_interleaved_units_device / decode_chunks_packed_batch_carry_
    # device): every same-shape segment of every track in one lax.map
    # dispatch, carries chained on device.  Off by default: the default
    # paths pipeline each track's segments through one in-flight window
    # instead.  Which one wins on the GPU is not yet measured.  Both paths
    # are correctness-tested; encode is bit-identical either way.
    segmented_batch: bool = False

    # On-device pair-compaction implementation (ops/encode.py
    # compact_pairs_any) — how the encode program packs kept (k, q) pairs
    # into the stream-ordered download buffer.  All modes are bit-identical;
    # they differ only in device cost.  "shift" (the default) is a stable
    # partition, not a sort: each kept element hops left by its
    # precomputed distance in log2(G·n) binary sweeps — O(W·log W) selects
    # vs the sorts' O(W·log² W) compare-exchanges, no density-dependent
    # branch, no key-width cap at any n.  The other modes ("sort2",
    # "sort", "gather", "blocked", "legacy") are kept as alternatives; their
    # relative cost on the GPU is not yet measured.
    compact_mode: str = "shift"

    # Two-stage blocked compaction budget (compact_mode="blocked" only):
    # mean kept 128-wide blocks per (frame, channel) row the fast branch
    # accommodates (ops/encode.py _compact_pairs_auto).  Compacting BLOCKS
    # first makes stage 2 scale with bb_mult/8 of the legacy scatter.
    # Content whose mean kept blocks exceed the budget takes the
    # full-coverage lax.cond branch on device (legacy cost, never
    # incomplete), so a too-small budget costs at most the legacy scatter.
    # Bit-identical at every setting.  0 = legacy element scatter.
    compact_bb_mult: int = 5

    @property
    def n(self) -> int:
        """Number of MDCT coefficients per frame (= hop_size)."""
        return self.hop_size

    @property
    def max_q(self) -> float:
        """Fixed quantization denominator 2^(bits-1) (codec.rs:281,656)."""
        return float(1 << (self.quantization_bits - 1))


DEFAULT_CONFIG = CodecConfig()
