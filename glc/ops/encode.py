"""Device-side encode pipeline: window → MDCT → masking → quantize → stats.

One jitted call processes a fixed-size chunk of frames for all channels at
once: ``blocks [K, C, frame_size] → (q, nnz, scales, raw_pcm, use_raw)``.
This replaces the reference's rayon `par_iter` over frames
(reference src/codec.rs:462-541) with frame-major batched tensor ops: the MDCT
is one matmul over all K·C blocks, the masking thresholds are a band
matmul, and the keep/quantize gate is fused elementwise work.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .mdct import mdct
from .psycho import masking_thresholds

# 10^(NOISE_FLOOR_DB/20) with NOISE_FLOOR_DB=-48 (codec.rs:22,277), f32.
def _noise_floor_linear(noise_floor_db: float) -> np.float32:
    return np.float32(10.0 ** float(np.float32(noise_floor_db) / np.float32(20.0)))


def round_half_away(x: jnp.ndarray) -> jnp.ndarray:
    """Rust f32::round semantics: round half away from zero.

    jnp.round rounds half-to-even, which would disagree with the reference
    on exact .5 ties, and the classic floor(|x|+0.5) trick is wrong for
    values one ulp below .5 (the f32 addition ties upward) — so compute the
    fractional part exactly instead (x−trunc(x) is exact for |x| < 2^23;
    SURVEY.md §7 hard part #2).
    """
    t = jnp.trunc(x)
    frac = x - t
    return t + jnp.where(
        jnp.abs(frac) >= np.float32(0.5), jnp.sign(x), np.float32(0.0)
    )


def encode_math(
    blocks: jnp.ndarray,       # [..., C, frame_size] f32, un-windowed
    cos_table: jnp.ndarray,    # [n, frame_size] f32
    window: jnp.ndarray,       # [frame_size] f32
    norm: jnp.ndarray,         # scalar f32
    band_mask: jnp.ndarray,
    band_inv_count: jnp.ndarray,
    band_pf: jnp.ndarray,
    band_of: jnp.ndarray,
    inv_w: jnp.ndarray,
    *,
    quality: float = 0.7,
    noise_floor_db: float = -48.0,
    compression_threshold: float = 0.85,
    max_q: float = 32768.0,
):
    """Returns (q int16 [...,C,n], nnz int32 [...,C], scales f32 [...,C],
    raw_pcm int16 [...,C,frame_size], use_raw bool [...]).

    Pure local math usable under vmap/shard_map (leading dims are batch).

    Semantics per reference src/codec.rs:462-541:
      * scale = max |coeff| clamped ≥ 1e-10 (codec.rs:488)
      * keep iff |coeff| > noise_floor·scale AND |coeff| > threshold·scale
        (codec.rs:291; the variable-bit path is a vestigial keep-gate only,
        SURVEY.md Q3)
      * q = round(coeff/scale · 2^15) half-away-from-zero, clamped to i16,
        dropped if 0 (codec.rs:299-306)
      * raw fallback PCM = windowed samples ×32767, clamped, truncated toward
        zero (Rust `as i16`, codec.rs:501)
      * use_raw iff estimated compressed size ≥ 0.85 × raw size
        (codec.rs:506-521)
    """
    C, frame_size = blocks.shape[-2:]

    win = blocks * window
    coeffs = mdct(win, cos_table, norm)              # [..., C, n]
    absc = jnp.abs(coeffs)
    scale = jnp.maximum(jnp.max(absc, axis=-1), np.float32(1e-10))  # [..., C]

    thr = masking_thresholds(
        coeffs, scale[..., None], band_mask, band_inv_count, band_pf,
        band_of, inv_w, quality,
    )

    nf_lin = _noise_floor_linear(noise_floor_db) * scale             # [K, C]
    qf = round_half_away((coeffs / scale[..., None]) * np.float32(max_q))
    qf = jnp.clip(qf, np.float32(-32768.0), np.float32(32767.0))
    keep = (
        (absc > nf_lin[..., None])
        & (absc > thr * scale[..., None])
        & (qf != np.float32(0.0))
    )
    q = jnp.where(keep, qf, np.float32(0.0)).astype(jnp.int16)
    nnz = jnp.sum(keep, axis=-1, dtype=jnp.int32)                    # [..., C]

    raw = jnp.trunc(
        jnp.clip(win * np.float32(32767.0), np.float32(-32768.0), np.float32(32767.0))
    ).astype(jnp.int16)

    # Per-frame size model (codec.rs:506-521)
    comp_size = (
        jnp.sum(8 + 4 * nnz, axis=-1) + 8 + 4 * C + 64
    ).astype(jnp.float32)
    raw_size = np.float32(frame_size * C * 2)
    use_raw = comp_size >= raw_size * np.float32(compression_threshold)

    return q, nnz, scale, raw, use_raw


@partial(
    jax.jit,
    static_argnames=("quality", "noise_floor_db", "compression_threshold", "max_q"),
)
def encode_chunk_device(
    blocks: jnp.ndarray,       # [K, C, frame_size] f32, un-windowed
    cos_table: jnp.ndarray,
    window: jnp.ndarray,
    norm: jnp.ndarray,
    band_mask: jnp.ndarray,
    band_inv_count: jnp.ndarray,
    band_pf: jnp.ndarray,
    band_of: jnp.ndarray,
    inv_w: jnp.ndarray,
    *,
    quality: float = 0.7,
    noise_floor_db: float = -48.0,
    compression_threshold: float = 0.85,
    max_q: float = 32768.0,
):
    """Single-device jitted wrapper over `encode_math` (one chunk of frames).

    Replaces the reference's rayon frame loop (codec.rs:462): the frame axis
    is the batch axis of one matmul.
    """
    return encode_math(
        blocks, cos_table, window, norm, band_mask, band_inv_count,
        band_pf, band_of, inv_w,
        quality=quality, noise_floor_db=noise_floor_db,
        compression_threshold=compression_threshold, max_q=max_q,
    )


def _compact_pairs(q: jnp.ndarray, nnz: jnp.ndarray, n: int,
                   budget: int) -> jnp.ndarray:
    """Compact nonzero (k, q) pairs of q [..., C, n] into packed int32
    [budget], stream-ordered (row-major over frame·channel, ascending k).

    Sort-free: every kept element's output slot is computable directly —
    its rank within the row (cumsum of the keep mask along k, which is
    already ascending-k order) plus its row's start (exclusive cumsum of
    per-row counts) — so compaction is two cumsums and one scatter, no
    global sort.  Replaces a jnp.nonzero/top_k ladder (nonzero lowers to a
    global sort over every coefficient slot).

    Elements past the budget scatter out of range and are dropped; the
    caller detects sum(nnz) > budget from the stats rows and reruns via the
    dense fallback.
    """
    rows = q.reshape(-1, n).astype(jnp.int32)          # [R, n]
    col = jax.lax.broadcasted_iota(jnp.int32, rows.shape, 1)
    mask = rows != 0
    p32 = jnp.where(mask, (col << 16) | (rows & 0xFFFF), 0)
    rank = jnp.cumsum(mask, axis=1, dtype=jnp.int32) - 1
    counts = nnz.reshape(-1).astype(jnp.int32)
    row_start = jnp.cumsum(counts) - counts            # exclusive cumsum
    pos = jnp.where(mask, row_start[:, None] + rank, budget)
    return (
        jnp.zeros(budget, jnp.int32)
        .at[pos.reshape(-1)]
        .set(p32.reshape(-1), mode="drop")
    )


def _compact_blocked_core(blocks_r, bkeep, brank, out_start_all, *,
                          n: int, block: int, budget: int, BB: int):
    """Stage 2 of the two-stage blocked compaction for a given block
    budget BB: gather the kept blocks into a [BB, block] dense array
    (slice gather — vector moves, not element scatter), then element-
    scatter only those BB·block candidates into the packed output.
    """
    RB = blocks_r.shape[0]
    NB = n // block
    src = (
        jnp.full(BB, RB, jnp.int32)
        .at[jnp.where(bkeep, brank, BB)]
        .set(jnp.arange(RB, dtype=jnp.int32), mode="drop")
    )
    data2 = jnp.take(blocks_r, src, axis=0, mode="fill", fill_value=0)
    out_start = jnp.take(out_start_all, src, mode="fill", fill_value=budget)
    m2 = data2 != 0
    rank2 = jnp.cumsum(m2, axis=1, dtype=jnp.int32) - 1
    colbase = (src % NB) * block
    colj = jax.lax.broadcasted_iota(jnp.int32, data2.shape, 1)
    col = colbase[:, None] + colj
    p32 = jnp.where(m2, (col << 16) | (data2 & 0xFFFF), 0)
    pos = jnp.where(m2, out_start[:, None] + rank2, budget)
    return (
        jnp.zeros(budget, jnp.int32)
        .at[pos.reshape(-1)]
        .set(p32.reshape(-1), mode="drop")
    )


def _compact_pairs_auto(q: jnp.ndarray, nnz: jnp.ndarray, n: int,
                        budget: int, bb_mult: int = 6,
                        block: int = 128) -> jnp.ndarray:
    """Two-stage blocked compaction, bit-identical to `_compact_pairs`
    with a scatter over about an eighth of the elements.

    Stage 1 compacts 128-wide BLOCKS (a 65k-element id scatter + slice
    gather — vector-aligned moves); stage 2 runs the exact-pair element
    scatter over only the block-compacted candidates (bb_mult·R·block
    updates instead of R·n).  Content whose kept blocks exceed the
    bb_mult·R budget takes a full-coverage branch via `lax.cond` on
    device (same cost as the legacy single-stage scatter, always
    complete), so the host contract — first sum(nnz) packed slots valid —
    is unconditional and no fallback re-dispatch exists.  `lax.cond`
    stays a true conditional under jit and inside `lax.map` (scan)
    bodies; the sharded paths use dense `encode_math` and never reach
    this.  bb_mult=0 selects the legacy element scatter.
    """
    R = int(np.prod(q.shape[:-1]))
    if bb_mult <= 0 or n % block or n // block < 2:
        return _compact_pairs(q, nnz, n, budget)
    NB = n // block
    rows = q.reshape(R, n).astype(jnp.int32)
    blocks_r = rows.reshape(R * NB, block)
    mask1 = blocks_r != 0
    bcnt = jnp.sum(mask1, axis=1, dtype=jnp.int32)       # [R·NB]
    bkeep = bcnt > 0
    brank = jnp.cumsum(bkeep, dtype=jnp.int32) - 1
    counts = nnz.reshape(-1).astype(jnp.int32)
    row_start = jnp.cumsum(counts) - counts
    bcnt_rows = bcnt.reshape(R, NB)
    bpfx = jnp.cumsum(bcnt_rows, axis=1) - bcnt_rows     # exclusive, per row
    out_start_all = (row_start[:, None] + bpfx).reshape(-1)

    core = partial(
        _compact_blocked_core, blocks_r, bkeep, brank, out_start_all,
        n=n, block=block, budget=budget,
    )
    BB_small = min(R * bb_mult, R * NB)
    if BB_small == R * NB:
        return core(BB=BB_small)
    nblocks = brank[-1] + 1  # total kept blocks, from the existing cumsum
    return jax.lax.cond(
        nblocks <= BB_small,
        lambda: core(BB=BB_small),
        lambda: core(BB=R * NB),
    )


def _compact_pairs_sorted(q: jnp.ndarray, nnz: jnp.ndarray, n: int,
                          budget: int, group: int = 16) -> jnp.ndarray:
    """Grouped-sort compaction, bit-identical to `_compact_pairs`.

    Two vector-friendly passes replace the 5-8M-update element scatter:

      1. GROUPED SEGMENTED SORT left-aligns the kept pairs of each GROUP
         of `group` consecutive (frame, channel) rows: non-kept slots
         become INT32_MAX sentinels; kept slots pack
         (local_row << (col_bits+16)) | (col << 16) | (q & 0xFFFF), whose
         ascending int32 order IS row-major ascending-k stream order — so
         one single-operand `lax.sort` over [R/G, G·n] segments performs
         the compaction without per-lane dynamic stores.  Masking the local-row bits off afterwards
         recovers the packed (col << 16) | q wire word.
      2. WINDOWED SCATTER-ADD places each group as ONE contiguous G·n-wide
         update window at its exclusive-cumsum output offset.  XLA lowers
         each window as one serialized vector update regardless of its
         width, so cost scales with WINDOW COUNT — the
         entire point of grouping: R/G windows instead of R·n element
         updates.  Windows overlap the following groups' regions, but
         sorted tails are zeroed and group g's pairs all land before group
         g+1's start, so overlap contributes exact zeros — `add`
         reassembles the stream bit-exactly.  Out-of-budget groups clamp
         into a G·n-wide pad zone the return slices off, reproducing
         `_compact_pairs`'s per-element drop semantics at the boundary.

    G is capped so the packed key stays a positive int32 STRICTLY below
    the sentinel: local_row bits + col bits + 16 ≤ 30 (at 31 the largest
    legal pair — last row, col n−1, q = −1 — collides with INT32_MAX; for
    n = 1024 the cap is G ≤ 16), then halved until it divides R.  Unlike
    the blocked two-stage scatter there is no density-dependent branch:
    sort cost is fixed, so dense content pays exactly what sparse content
    pays (no lax.cond full-coverage ladder).
    """
    R = int(np.prod(q.shape[:-1]))
    col_bits = int(n - 1).bit_length()
    if col_bits + 16 > 30:
        # n too wide for the packed-key order trick (needs col + q + at
        # least 0 group bits in a positive int32) — never true for the
        # 1024-coefficient codec
        return _compact_pairs(q, nnz, n, budget)
    G = min(group, max(1, (1 << (15 - col_bits)) // 2))
    while R % G:
        G //= 2
    shift = col_bits + 16
    sent = jnp.int32(0x7FFFFFFF)
    rows = q.reshape(R, n).astype(jnp.int32)
    col = jax.lax.broadcasted_iota(jnp.int32, rows.shape, 1)
    lrow = (jnp.arange(R, dtype=jnp.int32) % G)[:, None]
    mask = rows != 0
    key = jnp.where(
        mask, (lrow << shift) | (col << 16) | (rows & 0xFFFF), sent)
    srt = jax.lax.sort(key.reshape(R // G, G * n), dimension=1)
    val = jnp.where(srt == sent, 0, srt & ((1 << shift) - 1))
    return _place_group_windows(val, nnz, G, budget)


def _place_group_windows(val: jnp.ndarray, nnz: jnp.ndarray, G: int,
                         budget: int) -> jnp.ndarray:
    """Windowed scatter-add placement shared by the sorted compactions:
    `val` [R/G, W] holds each group's stream-ordered kept words followed by
    zeros; each group lands as ONE W-wide update window at its exclusive-
    cumsum output offset.  Windows overlap the following groups' regions,
    but the zero tails make the overlap contribute exact zeros under `add`.
    Out-of-budget groups clamp into a W-wide pad zone the return slices
    off (per-element drop semantics at the boundary, like `_compact_pairs`).
    """
    W = val.shape[1]
    counts = nnz.reshape(-1).astype(jnp.int32)
    row_start = jnp.cumsum(counts) - counts                  # [R] exclusive
    starts = jnp.minimum(row_start[::G], budget)[:, None]    # [R/G, 1]
    out = jnp.zeros(budget + W, jnp.int32)
    out = jax.lax.scatter_add(
        out, starts, val,
        jax.lax.ScatterDimensionNumbers(
            update_window_dims=(1,), inserted_window_dims=(),
            scatter_dims_to_operand_dims=(0,)),
        indices_are_sorted=True, unique_indices=False,
        mode=jax.lax.GatherScatterMode.FILL_OR_DROP)
    return out[:budget]


def _compact_pairs_sorted2(q: jnp.ndarray, nnz: jnp.ndarray, n: int,
                           budget: int, P: int = 384,
                           group: int = 16) -> jnp.ndarray:
    """Two-stage sorted compaction, bit-identical to `_compact_pairs`:
    shrink the merge problem BETWEEN the two sorts instead of sorting the
    full R·n slots in one G·n-wide pass.

      1. ROW SORT (no row bits): key = (col << 16) | (q & 0xFFFF) for kept
         slots, INT32_MAX sentinel otherwise; sorting each n-wide row
         left-aligns its kept pairs in ascending-col order.  Width-n
         segments cost ~55 of the single sort's ~105 compare-exchange
         stages (the compare-exchange network is the cost).
      2. STATIC SLICE to the first P lanes per row — free — which is
         complete iff every row's nnz ≤ P.
      3. GROUP SORT over [R/G, G·P]: re-key the sliced rows with local-row
         bits ((lrow << shift) | word); the merge now touches P/n of the
         slots at a narrower width (~1.1 ms at P=384 vs 2.7 for the
         full-width group stage).
      4. The shared windowed scatter-add placement (G·P-wide windows).

    Rows denser than P would silently lose pairs, so the whole fast path
    sits behind an on-device `lax.cond(max(nnz) <= P, ...)` whose other
    branch is the full grouped sort — content of any density gets a
    bit-identical stream, dense material just pays the plain sort cost.
    The shipped encode programs zero raw-fallback rows' q/nnz before
    compacting (their pairs are never stored, container schema
    `FrameSet.nnz` docs), so P only has to cover rows that survive the
    raw decision — program material measures max 353 kept vs P = 384.
    """
    R = int(np.prod(q.shape[:-1]))
    col_bits = int(n - 1).bit_length()
    if col_bits + 16 > 30 or P >= n:
        return _compact_pairs_sorted(q, nnz, n, budget, group)
    G = min(group, max(1, (1 << (15 - col_bits)) // 2))
    while R % G:
        G //= 2
    shift = col_bits + 16
    sent = jnp.int32(0x7FFFFFFF)

    def fast():
        rows = q.reshape(R, n).astype(jnp.int32)
        col = jax.lax.broadcasted_iota(jnp.int32, rows.shape, 1)
        mask = rows != 0
        k1 = jnp.where(mask, (col << 16) | (rows & 0xFFFF), sent)
        s1 = jax.lax.sort(k1, dimension=1)[:, :P]        # [R, P]
        lrow = (jnp.arange(R, dtype=jnp.int32) % G)[:, None]
        k2 = jnp.where(s1 == sent, sent, (lrow << shift) | s1)
        srt = jax.lax.sort(k2.reshape(R // G, G * P), dimension=1)
        val = jnp.where(srt == sent, 0, srt & ((1 << shift) - 1))
        return _place_group_windows(val, nnz, G, budget)

    return jax.lax.cond(
        jnp.max(nnz) <= P,
        fast,
        lambda: _compact_pairs_sorted(q, nnz, n, budget, group),
    )


def _compact_pairs_shift(q: jnp.ndarray, nnz: jnp.ndarray, n: int,
                         budget: int, group: int = 64) -> jnp.ndarray:
    """Sort-free compaction via monotone binary lane routing, bit-identical
    to `_compact_pairs`.  Compaction is a STABLE PARTITION, not a sort:
    every kept element's target slot is already known (row-start exclusive
    cumsum + within-row rank), so instead of a compare-exchange network
    (the sort modes' cost) each element just travels LEFT by
    dist = lane − target, decomposed in binary — ceil(log2(G·n)) shift+
    select sweeps over the group-flattened rows:

      step b: an element whose remaining dist has bit b set hops 2^b lanes
      left; out[j] takes in[j+2^b] if that element is hopping, else keeps
      its own element if staying, else clears to a hole.

    No two elements ever collide: targets are strictly increasing in lane
    order, so dist is NON-DECREASING over kept lanes, and after the sweeps
    below bit b every remaining dist is a multiple of 2^b — a stayer at j
    (bit b clear) and a hopper at j+2^b (bit b set) would need
    dist[j+2^b] ∈ [dist[j], dist[j]+2^b) yet both ≡ 0 (mod 2^b), forcing
    dist[j+2^b] = dist[j], contradicting the differing bit.  Total work is
    O(W·log W) cheap vector selects vs the sorts' O(W·log² W) wide
    compare-exchanges, there is no key-packing width cap (works for any
    n), and density does not matter — no lax.cond fallback ladder.

    Group size trades the windowed placement count (R/G windows, ~2 µs
    each) against one extra routing sweep per doubling; the windowed
    scatter-add placement itself is shared with the sort modes
    (_place_group_windows, W-wide windows at the group starts).
    """
    R = int(np.prod(q.shape[:-1]))
    G = min(group, R)
    while R % G:
        G //= 2
    W = G * n
    S = R // G
    rows = q.reshape(R, n).astype(jnp.int32)
    col = jax.lax.broadcasted_iota(jnp.int32, rows.shape, 1)
    mask = rows != 0
    w = jnp.where(mask, (col << 16) | (rows & 0xFFFF), 0)
    rank = jnp.cumsum(mask, axis=1, dtype=jnp.int32) - 1
    counts = nnz.reshape(-1).astype(jnp.int32)
    row_start = jnp.cumsum(counts) - counts            # [R] exclusive
    # stream target LOCAL to the group (the group's absolute start is
    # applied by the placement window)
    local = row_start - jnp.repeat(row_start[::G], G)
    target = local[:, None] + rank                      # [R, n]
    lane = jax.lax.broadcasted_iota(jnp.int32, (S, W), 1)
    w = w.reshape(S, W)
    dist = jnp.where(mask.reshape(S, W), lane - target.reshape(S, W), -1)

    for b in range((W - 1).bit_length()):
        s = 1 << b
        sw = jnp.pad(w[:, s:], ((0, 0), (0, s)))
        sd = jnp.pad(dist[:, s:], ((0, 0), (0, s)), constant_values=-1)
        move_in = (sd >= 0) & ((sd & s) != 0)
        stay = (dist >= 0) & ((dist & s) == 0)
        w = jnp.where(move_in, sw, jnp.where(stay, w, 0))
        dist = jnp.where(move_in, sd - s, jnp.where(stay, dist, -1))

    return _place_group_windows(w, nnz, G, budget)


def _compact_pairs_gather(q: jnp.ndarray, nnz: jnp.ndarray, n: int,
                          budget: int, block: int = 128) -> jnp.ndarray:
    """Gather-based compaction, bit-identical to `_compact_pairs`: instead
    of moving all R·n slots toward their output positions (the grouped
    sort's cost is a bitonic pass over every slot), invert the mapping —
    every OUTPUT slot computes which input pair it holds and gathers it.
    Output-side work scales with `budget` (~112K slots for the 60 s
    encode), not with R·n:

      1. WITHIN-BLOCK SORT left-aligns each 128-wide block's kept pairs:
         key = (j << 16) | (q & 0xFFFF) for kept, INT32_MAX sentinel
         otherwise (j = lane index; ascending key order = ascending-col
         order).  Sorting width-128 segments costs ~log²(128)/log²(G·n)
         ≈ 27% of the grouped sort's compare-exchange stages over the
         same 8.4M elements.
      2. BLOCK SCANS: per-block kept counts → global exclusive cumsum =
         each block's first output position (block-major order IS stream
         order).
      3. OWNER MAP: scatter block ids at their output starts (`max` mode:
         an empty block shares its start with the next non-empty one, and
         the larger id is always the non-empty one), cummax-fill forward
         → block_of[s] for every output slot s.
      4. TWO GATHERS sized by the output: off = s − start[block_of[s]]
         (table gather), then the sorted key at
         block_of[s]·block + off (data gather); unpack to the wire word
         ((global col) << 16) | (q & 0xFFFF); slots ≥ total count are
         zeroed (matching `_compact_pairs`' zero fill), and blocks whose
         start lands ≥ budget are dropped (same boundary semantics).

    Like the grouped sort there is no density-dependent branch; unlike it,
    the placement pass costs O(budget) gathers instead of R/G serialized
    scatter windows.
    """
    R = int(np.prod(q.shape[:-1]))
    if n % block or (block - 1).bit_length() + 16 > 31:
        return _compact_pairs(q, nnz, n, budget)
    NB = n // block
    nb_total = R * NB
    blocks_r = q.reshape(nb_total, block).astype(jnp.int32)
    j = jax.lax.broadcasted_iota(jnp.int32, blocks_r.shape, 1)
    mask = blocks_r != 0
    sent = jnp.int32(0x7FFFFFFF)
    key = jnp.where(mask, (j << 16) | (blocks_r & 0xFFFF), sent)
    srt = jax.lax.sort(key, dimension=1)               # [nb_total, block]
    bcnt = jnp.sum(mask, axis=1, dtype=jnp.int32)      # [nb_total]
    cum = jnp.cumsum(bcnt, dtype=jnp.int32)
    total = cum[-1]
    bstart = cum - bcnt                                # exclusive cumsum
    # owner map over output slots (step 3)
    ids = jnp.arange(nb_total, dtype=jnp.int32)
    marks = (
        jnp.zeros(budget, jnp.int32)
        .at[bstart]
        .max(ids, mode="drop")                         # start ≥ budget drops
    )
    block_of = jax.lax.associative_scan(jnp.maximum, marks)
    # output-sized gathers (step 4)
    s = jnp.arange(budget, dtype=jnp.int32)
    off = s - jnp.take(bstart, block_of)
    k = jnp.take(srt.reshape(-1), block_of * block + off)
    colg = (block_of % NB) * block + (k >> 16)
    word = (colg << 16) | (k & 0xFFFF)
    return jnp.where(s < total, word, 0)


def compact_pairs_any(q: jnp.ndarray, nnz: jnp.ndarray, n: int, budget: int,
                      compact_mode: str = "sort",
                      bb_mult: int = 5) -> jnp.ndarray:
    """Dispatch the configured compaction implementation
    (CodecConfig.compact_mode).  All modes produce bit-identical packed
    output; they differ only in device cost:

      * "shift" / "shift:<G>" — sort-free monotone binary lane routing +
        windowed scatter-add (_compact_pairs_shift; default G 64): every
        kept element hops left by its known distance in log2(G·n) binary
        sweeps — no compare-exchange network, no density fallback, no
        key-width cap;
      * "sort2" / "sort2:<P>" — row sort + P-lane slice + narrow group
        sort + windowed scatter-add, with an on-device full-sort fallback
        when any row's nnz exceeds P (_compact_pairs_sorted2; default
        P 384);
      * "gather" — within-block sort + output-sized gathers
        (_compact_pairs_gather);
      * "sort" / "sort:<group>" — grouped sort + windowed scatter-add
        (_compact_pairs_sorted; default group 16);
      * "blocked" — two-stage blocked scatter (_compact_pairs_auto with
        `bb_mult`, density-dependent via lax.cond);
      * "legacy" — single full element scatter (_compact_pairs).
    """
    if compact_mode == "legacy":
        return _compact_pairs(q, nnz, n, budget)
    if compact_mode == "blocked":
        return _compact_pairs_auto(q, nnz, n, budget, bb_mult)
    if compact_mode == "gather":
        return _compact_pairs_gather(q, nnz, n, budget)
    if compact_mode == "shift" or compact_mode.startswith("shift:"):
        G = int(compact_mode[6:]) if ":" in compact_mode else 64
        return _compact_pairs_shift(q, nnz, n, budget, G)
    if compact_mode == "sort2" or compact_mode.startswith("sort2:"):
        P = int(compact_mode[6:]) if ":" in compact_mode else 384
        return _compact_pairs_sorted2(q, nnz, n, budget, P)
    if compact_mode == "sort" or compact_mode.startswith("sort:"):
        group = int(compact_mode[5:]) if ":" in compact_mode else 16
        return _compact_pairs_sorted(q, nnz, n, budget, group)
    raise ValueError(f"unknown compact_mode {compact_mode!r}")


def frames_from_signal(xpad: jnp.ndarray, n: int) -> jnp.ndarray:
    """Frame a padded signal [C, P] (P a multiple of n) into 50%-overlap
    blocks [F, C, 2n] with F = P//n − 1, entirely on device.

    Pure reshape + slice + concat: the overlap duplication happens in HBM,
    not on the host↔device link (uploading the signal instead of expanded
    blocks halves transfer volume — the dominant cost off-chip).
    """
    C, P = xpad.shape
    r = xpad.reshape(C, P // n, n)
    blocks = jnp.concatenate([r[:, :-1], r[:, 1:]], axis=-1)  # [C, F, 2n]
    return blocks.transpose(1, 0, 2)


def _planarize_device(xinter: jnp.ndarray, channels: int, lead: int,
                      n: int, pad_hops: int) -> jnp.ndarray:
    """Interleaved [L] (bucketed, zero-tailed) → planar [C, pad_hops·n] with
    the lead zeros prepended — frame_signal's deinterleave+pad
    (reference src/codec.rs:427-455) executed on device.

    The host hands over the user's PCM buffer untouched (for a
    ladder-aligned length, literally the same array): no 1-core strided
    transpose on the critical path, no padding bytes on the link.  The
    caller guarantees L % channels == 0 (ragged inputs are zero-completed
    host-side, which reproduces the reference's modulo deinterleave
    exactly) and lead + L/channels ≤ pad_hops·n."""
    L = xinter.shape[0]
    T = L // channels
    x = xinter.reshape(T, channels).T
    return jnp.pad(x, ((0, 0), (lead, pad_hops * n - lead - T)))


def _zero_extend_device(xfull: jnp.ndarray, pad_hops: int, n: int) -> jnp.ndarray:
    """Zero-extend the resident signal's sample axis to pad_hops·n on device.

    The host uploads only (ladder-bucketed) real bytes; the zeros that the
    segment plan needs beyond them are materialized in HBM, where they are
    free — padding the UPLOAD instead would put them on the link, which is
    the binding resource (a pow2 frame bucket used to inflate a 10.6 MB
    upload to 16.8 MB)."""
    if pad_hops * n > xfull.shape[1]:
        xfull = jnp.pad(
            xfull, ((0, 0), (0, pad_hops * n - xfull.shape[1]))
        )
    return xfull


def _encode_signal_body(
    xfull, start, valid, cos_table, window, norm, band_mask,
    band_inv_count, band_pf, band_of, inv_w, *, k_frames, budget,
    pad_hops, pcm16, quality, noise_floor_db, compression_threshold,
    max_q, bb_mult=6, compact_mode="sort",
):
    """Traced body shared by the single-track and batched encode programs.

    `valid` (dynamic int32) is the number of REAL frames in this segment;
    frames ≥ valid exist only because k_frames is ladder-bucketed.  Their
    q/nnz are zeroed before compaction: the bucket boundary frame straddles
    the hard cut from signal to zero-extension, so its spectrum is
    broadband (it can keep twice the pairs of any real frame) — left in, it would defeat any density-bounded
    compaction fast path (sort2's `max(nnz) ≤ P` cond) and waste compact
    budget on pairs no caller reads.  Host-visible output is unchanged:
    pad rows sort after the valid rows' pairs in the packed stream, and
    every caller slices stats/pairs to the valid prefix."""
    n = cos_table.shape[0]
    xfull = _zero_extend_device(xfull, pad_hops, n)
    xpad = jax.lax.dynamic_slice_in_dim(
        xfull, start * n, (k_frames + 1) * n, axis=1
    )
    if pcm16:
        xpad = xpad.astype(jnp.float32) / np.float32(32768.0)
    blocks = frames_from_signal(xpad, n)
    q, nnz, scale, _raw, use_raw = encode_math(
        blocks, cos_table, window, norm, band_mask, band_inv_count,
        band_pf, band_of, inv_w,
        quality=quality, noise_floor_db=noise_floor_db,
        compression_threshold=compression_threshold, max_q=max_q,
    )
    q = jnp.where(use_raw[:, None, None], jnp.int16(0), q)
    nnz = jnp.where(use_raw[:, None], 0, nnz)
    live = jax.lax.broadcasted_iota(jnp.int32, (k_frames, 1), 0) < valid
    q = jnp.where(live[:, :, None], q, jnp.int16(0))
    nnz = jnp.where(live, nnz, 0)

    stats = jnp.concatenate(
        [
            nnz,
            jax.lax.bitcast_convert_type(scale, jnp.int32),
            use_raw.astype(jnp.int32)[:, None],
        ],
        axis=1,
    )
    if budget == 0:
        # Stats-only program: the compaction scatter is the larger part of
        # the encode program's device cost, so when the host PREDICTS the segment is
        # too dense for any compact budget it first dispatches this cheap
        # variant, reads the exact pair count from the stats, and only then
        # picks the right transfer program (encoder._reencode_overflow).
        return stats.reshape(-1)

    packed = compact_pairs_any(q, nnz, n, budget, compact_mode, bb_mult)
    return jnp.concatenate([stats.reshape(-1), packed])


@partial(
    jax.jit,
    static_argnames=(
        "channels", "lead", "k_frames", "budget", "pad_hops", "pcm16",
        "quality", "noise_floor_db", "compression_threshold", "max_q",
        "bb_mult", "compact_mode",
    ),
)
def encode_interleaved_device(
    xinter: jnp.ndarray,       # [L] interleaved PCM, L = Tb·channels,
                               # resident in HBM; f32, or i16 when pcm16=True
    start: jnp.ndarray,        # scalar int32 — segment start, in hops
    valid: jnp.ndarray,        # scalar int32 — real frames in this segment
    cos_table: jnp.ndarray,
    window: jnp.ndarray,
    norm: jnp.ndarray,
    band_mask: jnp.ndarray,
    band_inv_count: jnp.ndarray,
    band_pf: jnp.ndarray,
    band_of: jnp.ndarray,
    inv_w: jnp.ndarray,
    *,
    channels: int,
    lead: int,
    k_frames: int,
    budget: int,
    pad_hops: int,
    pcm16: bool = False,
    quality: float = 0.7,
    noise_floor_db: float = -48.0,
    compression_threshold: float = 0.85,
    max_q: float = 32768.0,
    bb_mult: int = 6,
    compact_mode: str = "sort",
):
    """Transfer-minimal encode over the raw INTERLEAVED buffer: the
    deinterleave + lead/tail padding of frame_signal happen on device
    (_planarize_device; reference src/codec.rs:427-455), so the host
    uploads the user's PCM bytes untouched, ONCE per file — each segment is
    a `dynamic_slice` of the resident signal (one compiled program serves
    every segment).  Every host↔device transfer has a fixed cost, so: one
    upload per file, one adaptive download per segment.  The caller guarantees lead + L/channels ≤
    pad_hops·n and start·n + (k_frames+1)·n ≤ pad_hops·n.

    Returns ONE int32 array [K·(2C+1) + budget] with K = k_frames,
    prefix-sliced by the host to what it actually needs:

      * [0 : K·(2C+1)] — per-frame stats rows: [:, :C] nnz, [:, C:2C]
        bitcast f32 scales, [:, 2C] use_raw flag.
      * [K·(2C+1) :]  — packed pairs: (k << 16) | (q & 0xFFFF), the kept
        (index, value) pairs in frame-major, channel-major, ascending-k
        order (the .glc stream order, codec.rs:462-541); only the first
        sum(nnz) entries are meaningful.

    Frames that chose the raw-PCM fallback contribute no pairs (their nnz
    is reported as 0).  If sum(nnz) > budget the caller must fall back to
    `encode_interleaved_dense_device`.

    pcm16=True takes int16 input and converts with /2^15 on device — exact
    for 16-bit sources (the loaders divide by 2^(bits−1), audio.rs:55,72),
    halving upload volume.
    """
    n = cos_table.shape[0]
    xfull = _planarize_device(xinter, channels, lead, n, pad_hops)
    return _encode_signal_body(
        xfull, start, valid, cos_table, window, norm, band_mask,
        band_inv_count, band_pf, band_of, inv_w,
        k_frames=k_frames, budget=budget, pad_hops=0, pcm16=pcm16,
        quality=quality, noise_floor_db=noise_floor_db,
        compression_threshold=compression_threshold, max_q=max_q,
        bb_mult=bb_mult, compact_mode=compact_mode,
    )


@partial(
    jax.jit,
    static_argnames=(
        "channels", "lead", "k_frames", "budget", "pad_hops", "pcm16",
        "quality", "noise_floor_db", "compression_threshold", "max_q",
        "bb_mult", "compact_mode",
    ),
)
def encode_interleaved_batch_device(
    xbatch: jnp.ndarray,       # [B, L] interleaved tracks, same bucket
    starts: jnp.ndarray,       # [B] int32
    valids: jnp.ndarray,       # [B] int32 — real frames per track
    cos_table: jnp.ndarray,
    window: jnp.ndarray,
    norm: jnp.ndarray,
    band_mask: jnp.ndarray,
    band_inv_count: jnp.ndarray,
    band_pf: jnp.ndarray,
    band_of: jnp.ndarray,
    inv_w: jnp.ndarray,
    *,
    channels: int,
    lead: int,
    k_frames: int,
    budget: int,
    pad_hops: int,
    pcm16: bool = False,
    quality: float = 0.7,
    noise_floor_db: float = -48.0,
    compression_threshold: float = 0.85,
    max_q: float = 32768.0,
    bb_mult: int = 6,
    compact_mode: str = "sort",
):
    """Batched multi-track encode — the album path.  B same-bucket tracks
    cost ONE upload, ONE program dispatch, and ONE [B, K·(2C+1)+budget]
    download instead of B of each (the reference encodes files serially,
    src/main.rs:545-583).

    `lax.map`, not `vmap`: the batch axis must not change the per-track
    math.  A vmapped einsum retiles the MDCT matmul and can shift results
    by ±1 ulp vs the single-track program, which moves quantizer keep-gate
    decisions and breaks the bit-identical-to-`encode` contract; lax.map
    runs the identical per-track computation in a device loop (the album
    tests and chip_smoke.py compare the bytes with serial encodes)."""
    n = cos_table.shape[0]

    def body(t):
        xinter, start, valid = t
        xfull = _planarize_device(xinter, channels, lead, n, pad_hops)
        return _encode_signal_body(
            xfull, start, valid, cos_table, window, norm, band_mask,
            band_inv_count, band_pf, band_of, inv_w,
            k_frames=k_frames, budget=budget, pad_hops=0, pcm16=pcm16,
            quality=quality, noise_floor_db=noise_floor_db,
            compression_threshold=compression_threshold, max_q=max_q,
            bb_mult=bb_mult, compact_mode=compact_mode,
        )

    return jax.lax.map(body, (xbatch, starts, valids))


@partial(jax.jit, static_argnames=("L",))
def stack_padded_device(*xs, L: int):
    """Stack resident 1-D signals of (possibly) different lengths into one
    [B, L] batch, zero-padding each on device.  The per-track uploads stay
    ladder-bucketed to their OWN lengths (no padding bytes ever cross the
    link); the zeros materialize in device memory.  Compiled per tuple of lengths, which the upload ladder keeps
    to a handful per octave."""
    return jnp.stack([jnp.pad(x, (0, L - x.shape[0])) for x in xs])


@partial(
    jax.jit,
    static_argnames=(
        "channels", "lead", "k_frames", "budget", "pad_hops", "pcm16",
        "quality", "noise_floor_db", "compression_threshold", "max_q",
        "bb_mult", "compact_mode",
    ),
)
def encode_interleaved_units_device(
    xbatch: jnp.ndarray,       # [B, L] resident interleaved tracks
    track_idx: jnp.ndarray,    # [U] int32 — which track each unit encodes
    starts: jnp.ndarray,       # [U] int32 — segment start (hops) per unit
    valids: jnp.ndarray,       # [U] int32 — real frames per unit
    cos_table: jnp.ndarray,
    window: jnp.ndarray,
    norm: jnp.ndarray,
    band_mask: jnp.ndarray,
    band_inv_count: jnp.ndarray,
    band_pf: jnp.ndarray,
    band_of: jnp.ndarray,
    inv_w: jnp.ndarray,
    *,
    channels: int,
    lead: int,
    k_frames: int,
    budget: int,
    pad_hops: int,
    pcm16: bool = False,
    quality: float = 0.7,
    noise_floor_db: float = -48.0,
    compression_threshold: float = 0.85,
    max_q: float = 32768.0,
    bb_mult: int = 6,
    compact_mode: str = "sort",
):
    """Segment-level batched encode for MULTI-segment tracks:
    U (track, segment) units — every same-shape segment of every
    track in an album — run in ONE dispatch with one [U, ...] adaptive
    download, while each track's signal stays resident exactly once
    (units index into the [B, L] batch with `jnp.take`, so a 3-segment
    track never duplicates its upload the way stacking per-unit inputs
    would).  Replaces the reference's serial file loop at the scale where
    single-program-per-track batching stops applying
    (reference src/main.rs:545-583; the album join of src/ui.rs:291-402).

    `lax.map` body = the single-track segment program
    (encode_interleaved_device) on the unit's (track, start): identical
    math, so the batch is bit-identical to per-track serial encodes — the
    same contract as encode_interleaved_batch_device, which this
    generalizes (that op is the special case track_idx == arange(B),
    one unit per track)."""
    n = cos_table.shape[0]

    def body(t):
        ti, start, valid = t
        xinter = jnp.take(xbatch, ti, axis=0)
        xfull = _planarize_device(xinter, channels, lead, n, pad_hops)
        return _encode_signal_body(
            xfull, start, valid, cos_table, window, norm, band_mask,
            band_inv_count, band_pf, band_of, inv_w,
            k_frames=k_frames, budget=budget, pad_hops=0, pcm16=pcm16,
            quality=quality, noise_floor_db=noise_floor_db,
            compression_threshold=compression_threshold, max_q=max_q,
            bb_mult=bb_mult, compact_mode=compact_mode,
        )

    return jax.lax.map(body, (track_idx, starts, valids))


@partial(
    jax.jit,
    static_argnames=(
        "channels", "lead", "k_frames", "pad_hops", "pcm16",
        "quality", "noise_floor_db", "compression_threshold", "max_q",
    ),
)
def encode_interleaved_dense_device(
    xinter: jnp.ndarray,
    start: jnp.ndarray,
    cos_table: jnp.ndarray,
    window: jnp.ndarray,
    norm: jnp.ndarray,
    band_mask: jnp.ndarray,
    band_inv_count: jnp.ndarray,
    band_pf: jnp.ndarray,
    band_of: jnp.ndarray,
    inv_w: jnp.ndarray,
    *,
    channels: int,
    lead: int,
    k_frames: int,
    pad_hops: int,
    pcm16: bool = False,
    quality: float = 0.7,
    noise_floor_db: float = -48.0,
    compression_threshold: float = 0.85,
    max_q: float = 32768.0,
):
    """Dense-transfer fallback for segments whose kept-coefficient count
    exceeds the compaction budget (atypically dense but still compressed
    content).  Slices the same resident interleaved signal as
    encode_interleaved_device.  Returns (q, nnz, scale, use_raw)."""
    n = cos_table.shape[0]
    xfull = _planarize_device(xinter, channels, lead, n, pad_hops)
    if pcm16:
        xfull = xfull.astype(jnp.float32) / np.float32(32768.0)
    xpad = jax.lax.dynamic_slice_in_dim(
        xfull, start * n, (k_frames + 1) * n, axis=1
    )
    blocks = frames_from_signal(xpad, n)
    q, nnz, scale, _raw, use_raw = encode_math(
        blocks, cos_table, window, norm, band_mask, band_inv_count,
        band_pf, band_of, inv_w,
        quality=quality, noise_floor_db=noise_floor_db,
        compression_threshold=compression_threshold, max_q=max_q,
    )
    q = jnp.where(use_raw[:, None, None], jnp.int16(0), q)
    nnz = jnp.where(use_raw[:, None], 0, nnz)
    return q, nnz, scale, use_raw


@partial(jax.jit, static_argnames=("channels", "lead", "pad_hops", "pcm16"))
def gather_raw_interleaved_device(
    xinter: jnp.ndarray,  # [L] interleaved (or [B?, L]: 1-D only here)
    idx: jnp.ndarray,     # [R] int32 frame indices (host-padded, in range)
    window: jnp.ndarray,
    *,
    channels: int,
    lead: int,
    pad_hops: int,
    pcm16: bool = False,
):
    """gather_raw_device over the interleaved resident buffer."""
    n = window.shape[0] // 2
    xpad = _planarize_device(xinter, channels, lead, n, pad_hops)
    if pcm16:
        xpad = xpad.astype(jnp.float32) / np.float32(32768.0)
    C, P = xpad.shape
    r = xpad.reshape(C, P // n, n)
    a = jnp.take(r, idx, axis=1, mode="clip")          # [C, R, n]
    b = jnp.take(r, idx + 1, axis=1, mode="clip")
    blocks = jnp.concatenate([a, b], axis=-1).transpose(1, 0, 2)
    win = blocks * window
    return jnp.trunc(
        jnp.clip(win * np.float32(32767.0), np.float32(-32768.0),
                 np.float32(32767.0))
    ).astype(jnp.int16)
