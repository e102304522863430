// glc native runtime: FLAC bitstream packer + independent FLAC decoder.
//
// Split of responsibilities (SURVEY.md §7): the *math* of the FLAC encoder
// (fixed-predictor residuals, Rice parameter estimation — reference
// src/flac.rs:480-552) has a batched JAX twin; this C++ module owns the
// bit-serial work the reference does in Rust: MSB-first bit packing, Rice
// coding (flac.rs:320-424, 554-684), frame headers and CRCs (flac.rs:19-80,
// 747-905).  It also provides a from-scratch RFC 9639 FLAC *decoder* (the
// reference used the external `claxon` crate for decoding, audio.rs:66-83),
// which doubles as the independent conformance oracle for our encoder tests.
//
// Exposed via a C ABI for ctypes.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// CRC tables (FLAC polynomials; reference flac.rs:19-80 builds these per call,
// we build once at static init — quirk Q10 is a pure inefficiency, not
// semantics)
// ---------------------------------------------------------------------------

struct Crc8Table {
  uint8_t t[256];
  Crc8Table() {
    for (int i = 0; i < 256; i++) {
      uint8_t crc = (uint8_t)i;
      for (int b = 0; b < 8; b++)
        crc = (crc & 0x80) ? (uint8_t)((crc << 1) ^ 0x07) : (uint8_t)(crc << 1);
      t[i] = crc;
    }
  }
};
struct Crc16Table {
  uint16_t t[256];
  Crc16Table() {
    for (int i = 0; i < 256; i++) {
      uint16_t crc = (uint16_t)(i << 8);
      for (int b = 0; b < 8; b++)
        crc = (crc & 0x8000) ? (uint16_t)((crc << 1) ^ 0x8005)
                             : (uint16_t)(crc << 1);
      t[i] = crc;
    }
  }
};
const Crc8Table kCrc8;
const Crc16Table kCrc16;

uint8_t crc8(const uint8_t* data, size_t n) {
  uint8_t crc = 0;
  for (size_t i = 0; i < n; i++) crc = kCrc8.t[crc ^ data[i]];
  return crc;
}
uint16_t crc16(const uint8_t* data, size_t n) {
  uint16_t crc = 0;
  for (size_t i = 0; i < n; i++)
    crc = (uint16_t)((crc << 8) ^ kCrc16.t[((crc >> 8) ^ data[i]) & 0xFF]);
  return crc;
}

// ---------------------------------------------------------------------------
// BitWriter — MSB-first accumulator (reference flac.rs:320-424)
// ---------------------------------------------------------------------------

class BitWriter {
 public:
  std::vector<uint8_t> buf;
  uint64_t acc = 0;  // bits pending, left-aligned in the low `nbits` bits
  int nbits = 0;

  void write_bits(uint64_t value, int bits) {
    if (bits == 0) return;
    if (bits > 32) {  // keep acc within 64 bits (nbits ≤ 7 + 32 chunk)
      write_bits(value >> 32, bits - 32);
      write_bits(value & 0xFFFFFFFFULL, 32);
      return;
    }
    value &= (1ULL << bits) - 1;
    // flush in byte units
    nbits += bits;
    acc = (acc << bits) | value;
    while (nbits >= 8) {
      nbits -= 8;
      buf.push_back((uint8_t)(acc >> nbits));
    }
    if (nbits > 0) acc &= (1ULL << nbits) - 1; else acc = 0;
  }

  void write_unary(uint32_t v) {
    while (v >= 32) { write_bits(0, 32); v -= 32; }
    write_bits(1, (int)v + 1);  // v zeros then a one
  }

  void byte_align() {
    if (nbits > 0) write_bits(0, 8 - nbits);
  }

  size_t byte_len() const { return buf.size(); }
};

// UTF-8-style frame number coding (reference flac.rs:426-478)
void write_utf8_number(BitWriter& w, uint64_t v) {
  if (v < 0x80) {
    w.write_bits(v, 8);
  } else if (v < 0x800) {
    w.write_bits(0xC0 | ((v >> 6) & 0x1F), 8);
    w.write_bits(0x80 | (v & 0x3F), 8);
  } else if (v < 0x10000) {
    w.write_bits(0xE0 | ((v >> 12) & 0x0F), 8);
    w.write_bits(0x80 | ((v >> 6) & 0x3F), 8);
    w.write_bits(0x80 | (v & 0x3F), 8);
  } else if (v < 0x200000) {
    w.write_bits(0xF0 | ((v >> 18) & 0x07), 8);
    w.write_bits(0x80 | ((v >> 12) & 0x3F), 8);
    w.write_bits(0x80 | ((v >> 6) & 0x3F), 8);
    w.write_bits(0x80 | (v & 0x3F), 8);
  } else if (v < 0x4000000) {
    w.write_bits(0xF8 | ((v >> 24) & 0x03), 8);
    w.write_bits(0x80 | ((v >> 18) & 0x3F), 8);
    w.write_bits(0x80 | ((v >> 12) & 0x3F), 8);
    w.write_bits(0x80 | ((v >> 6) & 0x3F), 8);
    w.write_bits(0x80 | (v & 0x3F), 8);
  } else if (v < 0x80000000ULL) {
    w.write_bits(0xFC | ((v >> 30) & 0x01), 8);
    w.write_bits(0x80 | ((v >> 24) & 0x3F), 8);
    w.write_bits(0x80 | ((v >> 18) & 0x3F), 8);
    w.write_bits(0x80 | ((v >> 12) & 0x3F), 8);
    w.write_bits(0x80 | ((v >> 6) & 0x3F), 8);
    w.write_bits(0x80 | (v & 0x3F), 8);
  } else {
    w.write_bits(0xFE, 8);
    w.write_bits(0x80 | ((v >> 30) & 0x3F), 8);
    w.write_bits(0x80 | ((v >> 24) & 0x3F), 8);
    w.write_bits(0x80 | ((v >> 18) & 0x3F), 8);
    w.write_bits(0x80 | ((v >> 12) & 0x3F), 8);
    w.write_bits(0x80 | ((v >> 6) & 0x3F), 8);
    w.write_bits(0x80 | (v & 0x3F), 8);
  }
}

int block_size_bits(int bs) {  // reference flac.rs:772-799
  switch (bs) {
    case 192: return 0b0001;
    case 576: return 0b0010;
    case 1152: return 0b0011;
    case 2304: return 0b0100;
    case 4608: return 0b0101;
    case 256: return 0b1000;
    case 512: return 0b1001;
    case 1024: return 0b1010;
    case 2048: return 0b1011;
    case 4096: return 0b1100;
    case 8192: return 0b1101;
    case 16384: return 0b1110;
    case 32768: return 0b1111;
    default: return bs < 256 ? 0b0110 : 0b0111;
  }
}

int sample_rate_bits(uint32_t sr) {  // reference flac.rs:803-818
  switch (sr) {
    case 88200: return 0b0001;
    case 176400: return 0b0010;
    case 192000: return 0b0011;
    case 8000: return 0b0100;
    case 16000: return 0b0101;
    case 22050: return 0b0110;
    case 24000: return 0b0111;
    case 32000: return 0b1000;
    case 44100: return 0b1001;
    case 48000: return 0b1010;
    case 96000: return 0b1011;
    default: return 0b0000;
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// Encoder-side helpers shared with Python (pure functions of level/blocksize;
// reference flac.rs:587-607, 690-700)
// ---------------------------------------------------------------------------

extern "C" int32_t glc_flac_predictor_order(int32_t block_size, int32_t level) {
  int order;
  if (level == 0) order = 0;
  else if (level == 1) order = block_size >= 1 ? 1 : 0;
  else if (level == 2) order = block_size >= 2 ? 2 : 0;
  else if (level <= 4) order = block_size >= 3 ? 3 : 0;
  else order = block_size >= 4 ? 4 : 0;
  return order;
}

extern "C" int32_t glc_flac_partition_order(int32_t block_size,
                                            int32_t predictor_order,
                                            int32_t level) {
  int tz = 0;
  int bs = block_size;
  while (bs > 0 && (bs & 1) == 0) { tz++; bs >>= 1; }
  if (block_size == 0) tz = 0;
  int cap = tz < 8 ? tz : 8;
  int po;
  if (level == 0) po = 0;
  else if (level <= 2) po = cap < 2 ? cap : 2;
  else if (level <= 5) po = cap < 4 ? cap : 4;
  else po = cap < 6 ? cap : 6;
  while (po > 0) {
    int ps = block_size >> po;
    if (ps > predictor_order && ps >= 4) break;
    po--;
  }
  return po;
}

// ---------------------------------------------------------------------------
// Fixed-predictor residuals + Rice partition sums, one pass per row.
//
// Native twin of glc/flac/ops.py::flac_block_stats_host (itself the host
// twin of the device kernel; reference flac.rs:480-552): the numpy version
// materializes a temporary per diff order (~600 MB of memory traffic for a
// 60 s stereo stream at order 4).  This computes the order-k residual as the
// direct binomial kernel and the per-partition |residual| half-sums in ONE
// scan (~85 MB of traffic), so the FLAC export's host math stops competing
// with its own transfers.  Results are bit-identical to the numpy twin
// (exact int32 arithmetic; tests/test_flac.py pins equivalence).
// ---------------------------------------------------------------------------

extern "C" int32_t glc_flac_block_stats(
    const int32_t* x,    // [B, bs] row-major samples
    int64_t B, int32_t bs, int32_t order, int32_t po,
    int32_t* res_out,    // [B, bs] residuals (warm-up slots zeroed)
    int32_t* lo_out,     // [B, 1<<po] per-partition sum(|res| & 0xFFFF)
    int32_t* hi_out) {   // [B, 1<<po] per-partition sum(|res| >> 16)
  if (B < 0 || bs <= 0 || order < 0 || order > 4 || po < 0 || po > 8)
    return 1;
  const int32_t P = 1 << po;
  const int32_t dps = bs >> po;
  if (dps << po != bs || order > bs) return 1;
  for (int64_t r = 0; r < B; r++) {
    const int32_t* xr = x + r * bs;
    int32_t* rr = res_out + r * bs;
    for (int32_t i = 0; i < order; i++) rr[i] = 0;
    switch (order) {
      case 0:
        for (int32_t i = 0; i < bs; i++) rr[i] = xr[i];
        break;
      case 1:
        for (int32_t i = 1; i < bs; i++) rr[i] = xr[i] - xr[i - 1];
        break;
      case 2:
        for (int32_t i = 2; i < bs; i++)
          rr[i] = xr[i] - 2 * xr[i - 1] + xr[i - 2];
        break;
      case 3:
        for (int32_t i = 3; i < bs; i++)
          rr[i] = xr[i] - 3 * xr[i - 1] + 3 * xr[i - 2] - xr[i - 3];
        break;
      default:
        for (int32_t i = 4; i < bs; i++)
          rr[i] = xr[i] - 4 * xr[i - 1] + 6 * xr[i - 2] - 4 * xr[i - 3] +
                  xr[i - 4];
    }
    int32_t* lo = lo_out + r * P;
    int32_t* hi = hi_out + r * P;
    for (int32_t p = 0; p < P; p++) {
      int32_t slo = 0, shi = 0;
      const int32_t* rp = rr + (int64_t)p * dps;
      for (int32_t i = 0; i < dps; i++) {
        int32_t a = rp[i] < 0 ? -rp[i] : rp[i];
        slo += a & 0xFFFF;
        shi += a >> 16;
      }
      lo[p] = slo;
      hi[p] = shi;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Full-stream packer.
//
// Layout contract with the Python caller (per frame f with block size bs[f]):
//   residuals:   frame-major then channel-major, bs[f] int32 per channel
//                (entries [0, order) are ignored warm-up slots)
//   rice_params: frame-major then channel-major, (1 << partition_order[f])
//                int8 per channel
// Orders must equal glc_flac_predictor_order / glc_flac_partition_order.
// ---------------------------------------------------------------------------

namespace {

// Pack one FLAC frame into its own writer.  Frames are byte-aligned and
// independent (CRCs cover only the frame's own bytes), so they parallelize
// across threads — the native-runtime counterpart of the reference's rayon
// frame loop.
void pack_one_frame(BitWriter& w, const int16_t* samples, int64_t sample_off,
                    int32_t channels, uint32_t sample_rate, int32_t level,
                    int64_t f, int bs, const int32_t* res_base,
                    const int8_t* rp_base) {
  const int bps = 16;
  size_t frame_start = w.byte_len();

  w.write_bits(0x3FFE, 14);
  w.write_bits(0, 1);
  w.write_bits(0, 1);
  int bsb = block_size_bits(bs);
  w.write_bits((uint64_t)bsb, 4);
  w.write_bits((uint64_t)sample_rate_bits(sample_rate), 4);
  uint32_t chan_bits = channels == 1 ? 0b0000
                       : channels == 2 ? 0b0001
                                       : (uint32_t)(channels - 1);
  w.write_bits(chan_bits, 4);
  w.write_bits(0b100, 3);
  w.write_bits(0, 1);
  write_utf8_number(w, (uint64_t)f);
  if (bsb == 0b0110) w.write_bits((uint64_t)(bs - 1), 8);
  else if (bsb == 0b0111) w.write_bits((uint64_t)(bs - 1), 16);
  w.write_bits(crc8(w.buf.data() + frame_start, w.byte_len() - frame_start),
               8);

  int order = glc_flac_predictor_order(bs, level);
  int po = glc_flac_partition_order(bs, order, level);
  int num_partitions = 1 << po;

  for (int c = 0; c < channels; c++) {
    w.write_bits(0, 1);
    if (order == 0) w.write_bits(0b000001, 6);
    else w.write_bits(0b001000 | (uint32_t)order, 6);
    w.write_bits(0, 1);

    if (order == 0) {
      for (int i = 0; i < bs; i++)
        w.write_bits(
            (uint64_t)(uint16_t)samples[sample_off + (int64_t)i * channels + c],
            bps);
    } else {
      for (int i = 0; i < order; i++)
        w.write_bits(
            (uint64_t)(uint16_t)samples[sample_off + (int64_t)i * channels + c],
            bps);
      const int32_t* res = res_base + (int64_t)c * bs + order;
      const int8_t* rp = rp_base + (int64_t)c * num_partitions;
      w.write_bits(0, 2);
      w.write_bits((uint64_t)po, 4);
      int dps = bs >> po;
      int64_t idx = 0;
      for (int p = 0; p < num_partitions; p++) {
        int ps = p == 0 ? dps - order : dps;
        // RFC 9639 requires a Rice parameter for EVERY partition, including
        // an empty first partition (block_size == predictor order).  The
        // reference skips it (flac.rs:632-638), emitting invalid FLAC its
        // own claxon oracle rejects — fixed here (QUIRKS.md Q15).
        // Defense-in-depth: k is caller-supplied through the C ABI.  Out of
        // 0..14 it would be UB shifts below (k>31, k<0) or the 0b1111
        // escape code (15..31) that decoders reject; clamp into the valid
        // range — any k in 0..14 yields correct (if suboptimal) FLAC.  The
        // project's own estimator already clamps (glc/flac/ops.py).
        int k = rp[p];
        if (k < 0 || k > 14) k = 14;
        w.write_bits((uint64_t)k, 4);
        if (ps == 0) continue;
        uint32_t mask = k > 0 ? ((1u << k) - 1) : 0;
        for (int i = 0; i < ps; i++) {
          int32_t s = res[idx++];
          uint32_t folded = s >= 0 ? ((uint32_t)s << 1)
                                   : ((((uint32_t)(-(s + 1))) << 1) | 1);
          uint32_t msb = folded >> k;
          int len = (int)msb + 1 + k;
          if (len <= 32) {
            w.write_bits((1ull << k) | (folded & mask), len);
          } else {
            w.write_unary(msb);
            if (k > 0) w.write_bits(folded & mask, k);
          }
        }
      }
    }
  }

  w.byte_align();
  uint16_t c16 = crc16(w.buf.data() + frame_start, w.byte_len() - frame_start);
  w.write_bits(c16, 16);
}

}  // namespace

namespace {

// Pack frames [first_frame, first_frame + num_frames) ONLY — no stream
// header.  FLAC frames are byte-aligned and self-contained (CRCs cover
// only the frame's own bytes; the frame number rides in the header via
// UTF-8 coding), so a streaming caller can pack each group of blocks as
// its stats complete — overlapping the pack with later transfers — and
// assemble header + chunks at end-of-stream, byte-identical to the
// whole-stream packer below.
int64_t flac_pack_frames_impl(
    const int16_t* samples, int64_t n_total, int32_t channels,
    uint32_t sample_rate, int32_t level,
    const int32_t* block_sizes, int32_t num_frames, int64_t first_frame,
    const int32_t* residuals, const int8_t* rice_params,
    uint8_t** out, int64_t* out_len,
    const uint8_t* prefix = nullptr, int64_t prefix_len = 0) {
  if (channels < 1 || channels > 8 || level < 0 || level > 8) return -1;
  if (first_frame < 0) return -5;
  // validate frame geometry before any buffer math (OOB reads otherwise)
  {
    int64_t covered = 0;
    for (int f = 0; f < num_frames; f++) {
      int bs = block_sizes[f];
      if (bs < 1 || bs > 65535) return -3;
      covered += (int64_t)bs * channels;
    }
    if (covered > n_total) return -4;
  }

  // Precompute per-frame offsets (deterministic from block sizes/level)
  std::vector<int64_t> s_off(num_frames), r_off(num_frames), p_off(num_frames);
  {
    int64_t so = 0, ro = 0, po_off = 0;
    for (int f = 0; f < num_frames; f++) {
      int bs = block_sizes[f];
      s_off[f] = so;
      r_off[f] = ro;
      p_off[f] = po_off;
      int order = glc_flac_predictor_order(bs, level);
      int po = glc_flac_partition_order(bs, order, level);
      so += (int64_t)bs * channels;
      ro += (int64_t)bs * channels;
      po_off += (int64_t)(1 << po) * channels;
    }
  }

  // Frames are byte-aligned and self-contained → pack them in parallel
  // (the reference's rayon frame parallelism, flac.rs has none but
  // codec.rs:462 sets the pattern), then concatenate in order.
  std::vector<BitWriter> frames((size_t)num_frames);
  unsigned hw = std::thread::hardware_concurrency();
  int T = (int)(hw ? (hw < 16 ? hw : 16) : 1);
  if (num_frames < 2 * T) T = 1;

  auto work = [&](int t) {
    for (int f = t; f < num_frames; f += T)
      pack_one_frame(frames[(size_t)f], samples, s_off[f], channels,
                     sample_rate, level, first_frame + f, block_sizes[f],
                     residuals + r_off[f], rice_params + p_off[f]);
  };
  if (T == 1) {
    work(0);
  } else {
    std::vector<std::thread> threads;
    threads.reserve((size_t)T);
    for (int t = 0; t < T; t++) threads.emplace_back(work, t);
    for (auto& th : threads) th.join();
  }

  int64_t total = prefix_len;
  for (auto& fw : frames) total += (int64_t)fw.buf.size();
  uint8_t* p = (uint8_t*)std::malloc((size_t)(total ? total : 1));
  if (!p) return -2;
  uint8_t* dst = p;
  if (prefix_len) {
    std::memcpy(dst, prefix, (size_t)prefix_len);
    dst += prefix_len;
  }
  for (auto& fw : frames) {
    std::memcpy(dst, fw.buf.data(), fw.buf.size());
    dst += fw.buf.size();
  }
  *out = p;
  *out_len = total;
  return 0;
}

int64_t flac_pack_impl(
    const int16_t* samples, int64_t n_total, int32_t channels,
    uint32_t sample_rate, int32_t level, const uint8_t* md5,
    const int32_t* block_sizes, int32_t num_frames,
    const int32_t* residuals, const int8_t* rice_params,
    uint8_t** out, int64_t* out_len) {
  if (channels < 1 || channels > 8 || level < 0 || level > 8) return -1;
  const int bps = 16;

  BitWriter w;
  w.write_bits(0x664C6143ULL, 32);  // "fLaC"

  // STREAMINFO (reference flac.rs:907-944): min/max block size are the
  // nominal block size, frame sizes unknown (0)
  int nominal_bs = num_frames > 0 ? block_sizes[0] : 0;
  w.write_bits(1, 1);                 // last metadata block
  w.write_bits(0, 7);                 // type streaminfo
  w.write_bits(34, 24);               // length
  w.write_bits((uint64_t)nominal_bs, 16);
  w.write_bits((uint64_t)nominal_bs, 16);
  w.write_bits(0, 24);
  w.write_bits(0, 24);
  w.write_bits(sample_rate, 20);
  w.write_bits((uint64_t)(channels - 1), 3);
  w.write_bits((uint64_t)(bps - 1), 5);
  w.write_bits((uint64_t)(n_total / channels), 36);
  for (int i = 0; i < 16; i++) w.write_bits(md5[i], 8);
  (void)bps;

  // header rides as a prefix into the frame packer's single allocation —
  // no second full-stream malloc+memcpy
  return flac_pack_frames_impl(samples, n_total, channels, sample_rate,
                               level, block_sizes, num_frames, 0,
                               residuals, rice_params, out, out_len,
                               w.buf.data(), (int64_t)w.buf.size());
}

}  // namespace

extern "C" int64_t glc_flac_pack(
    const int16_t* samples, int64_t n_total, int32_t channels,
    uint32_t sample_rate, int32_t level, const uint8_t* md5,
    const int32_t* block_sizes, int32_t num_frames,
    const int32_t* residuals, const int8_t* rice_params,
    uint8_t** out, int64_t* out_len) {
  try {
    return flac_pack_impl(samples, n_total, channels, sample_rate, level,
                          md5, block_sizes, num_frames, residuals,
                          rice_params, out, out_len);
  } catch (...) {
    return -99;
  }
}

extern "C" int64_t glc_flac_pack_frames(
    const int16_t* samples, int64_t n_total, int32_t channels,
    uint32_t sample_rate, int32_t level,
    const int32_t* block_sizes, int32_t num_frames, int64_t first_frame,
    const int32_t* residuals, const int8_t* rice_params,
    uint8_t** out, int64_t* out_len) {
  try {
    return flac_pack_frames_impl(samples, n_total, channels, sample_rate,
                                 level, block_sizes, num_frames, first_frame,
                                 residuals, rice_params, out, out_len);
  } catch (...) {
    return -99;
  }
}

extern "C" void glc_free(uint8_t* p) { std::free(p); }

// ---------------------------------------------------------------------------
// FLAC decoder (RFC 9639 subset sufficient for real-world files: constant /
// verbatim / fixed / LPC subframes, both Rice methods + escapes, wasted bits,
// all stereo decorrelation modes, 4-32 bit depths).
// ---------------------------------------------------------------------------

namespace {

class BitReader {
 public:
  const uint8_t* data;
  int64_t len;     // bytes
  int64_t pos = 0; // byte position
  int bit = 0;     // bits consumed of current byte (0..7)
  bool error = false;

  BitReader(const uint8_t* d, int64_t n) : data(d), len(n) {}

  bool eof() const { return pos >= len; }

  uint64_t read_bits(int n) {
    uint64_t v = 0;
    while (n > 0) {
      if (pos >= len) { error = true; return 0; }
      int avail = 8 - bit;
      int take = n < avail ? n : avail;
      uint8_t cur = data[pos];
      int shift = avail - take;
      v = (v << take) | (uint64_t)((cur >> shift) & ((1u << take) - 1));
      bit += take;
      if (bit == 8) { bit = 0; pos++; }
      n -= take;
    }
    return v;
  }

  int64_t read_signed(int n) {
    uint64_t v = read_bits(n);
    if (n < 64 && (v & (1ULL << (n - 1)))) v |= ~((1ULL << n) - 1);
    return (int64_t)v;
  }

  uint32_t read_unary() {
    uint32_t n = 0;
    for (;;) {
      if (pos >= len) { error = true; return 0; }
      uint8_t cur = (uint8_t)(data[pos] << bit);
      if (cur == 0) {
        n += 8 - bit;
        bit = 0;
        pos++;
        continue;
      }
      // count leading zeros of remaining bits in this byte
      int lz = 0;
      while (!(cur & 0x80)) { cur <<= 1; lz++; }
      n += lz;
      bit += lz + 1;
      if (bit >= 8) { bit -= 8; pos++; }
      return n;
    }
  }

  void align() {
    if (bit) { bit = 0; pos++; }
  }
};

int64_t read_utf8(BitReader& br) {
  uint32_t b0 = (uint32_t)br.read_bits(8);
  if (br.error) return -1;
  int extra;
  uint64_t v;
  if ((b0 & 0x80) == 0) { return (int64_t)b0; }
  else if ((b0 & 0xE0) == 0xC0) { extra = 1; v = b0 & 0x1F; }
  else if ((b0 & 0xF0) == 0xE0) { extra = 2; v = b0 & 0x0F; }
  else if ((b0 & 0xF8) == 0xF0) { extra = 3; v = b0 & 0x07; }
  else if ((b0 & 0xFC) == 0xF8) { extra = 4; v = b0 & 0x03; }
  else if ((b0 & 0xFE) == 0xFC) { extra = 5; v = b0 & 0x01; }
  else if (b0 == 0xFE) { extra = 6; v = 0; }
  else return -1;
  for (int i = 0; i < extra; i++) {
    uint32_t b = (uint32_t)br.read_bits(8);
    if ((b & 0xC0) != 0x80) return -1;
    v = (v << 6) | (b & 0x3F);
  }
  return (int64_t)v;
}

// residual decode into out[order..bs)
bool decode_residual(BitReader& br, int bs, int order, int64_t* out) {
  uint32_t method = (uint32_t)br.read_bits(2);
  if (method > 1) return false;
  int plen = method == 0 ? 4 : 5;
  uint32_t escape = method == 0 ? 0xF : 0x1F;
  uint32_t po = (uint32_t)br.read_bits(4);
  int parts = 1 << po;
  if ((bs >> po) << po != bs) return false;
  int idx = order;
  for (int p = 0; p < parts; p++) {
    int ps = (bs >> po) - (p == 0 ? order : 0);
    if (ps < 0) return false;
    uint32_t k = (uint32_t)br.read_bits(plen);
    if (k == escape) {
      uint32_t raw = (uint32_t)br.read_bits(5);
      for (int i = 0; i < ps; i++)
        out[idx++] = raw ? br.read_signed((int)raw) : 0;
    } else {
      for (int i = 0; i < ps; i++) {
        uint32_t msb = br.read_unary();
        uint64_t lsb = k ? br.read_bits((int)k) : 0;
        uint64_t folded = ((uint64_t)msb << k) | lsb;
        out[idx++] = (int64_t)(folded >> 1) ^ -(int64_t)(folded & 1);
        if (br.error) return false;
      }
    }
  }
  return !br.error;
}

bool decode_subframe(BitReader& br, int bs, int bps, int64_t* out) {
  if (br.read_bits(1) != 0) return false;  // padding bit
  uint32_t type = (uint32_t)br.read_bits(6);
  uint32_t wasted = 0;
  if (br.read_bits(1)) wasted = br.read_unary() + 1;
  int ebps = bps - (int)wasted;
  if (ebps <= 0 || br.error) return false;

  if (type == 0) {  // constant
    int64_t v = br.read_signed(ebps);
    for (int i = 0; i < bs; i++) out[i] = v;
  } else if (type == 1) {  // verbatim
    for (int i = 0; i < bs; i++) out[i] = br.read_signed(ebps);
  } else if ((type & 0x38) == 0x08 && (type & 0x07) <= 4) {  // fixed
    int order = (int)(type & 0x07);
    if (order > bs) return false;
    for (int i = 0; i < order; i++) out[i] = br.read_signed(ebps);
    if (!decode_residual(br, bs, order, out)) return false;
    // Hostile streams can drive the predictor recurrences past int64 range
    // (confirmed UBSan reproducer); all arithmetic here runs in uint64 —
    // defined wraparound — so garbage-in stays garbage-out without UB.
    // Well-formed streams never approach the limits, so results are
    // unchanged for real audio.
    for (int i = order; i < bs; i++) {
      uint64_t pred;
      const uint64_t a = (uint64_t)out[i - 1];
      switch (order) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = 2 * a - (uint64_t)out[i - 2]; break;
        case 3: pred = 3 * a - 3 * (uint64_t)out[i - 2]
                       + (uint64_t)out[i - 3]; break;
        default:
          pred = 4 * a - 6 * (uint64_t)out[i - 2]
                 + 4 * (uint64_t)out[i - 3] - (uint64_t)out[i - 4];
      }
      out[i] = (int64_t)((uint64_t)out[i] + pred);
    }
  } else if (type & 0x20) {  // LPC
    int order = (int)(type & 0x1F) + 1;
    if (order > bs) return false;
    for (int i = 0; i < order; i++) out[i] = br.read_signed(ebps);
    uint32_t prec = (uint32_t)br.read_bits(4) + 1;
    if (prec == 16) return false;  // 1111 invalid
    int shift = (int)br.read_signed(5);
    if (shift < 0) return false;
    int64_t coef[32];
    for (int i = 0; i < order; i++) coef[i] = br.read_signed((int)prec);
    if (!decode_residual(br, bs, order, out)) return false;
    for (int i = order; i < bs; i++) {
      uint64_t acc = 0;  // uint64: wrap instead of signed-overflow UB
      for (int j = 0; j < order; j++)
        acc += (uint64_t)coef[j] * (uint64_t)out[i - 1 - j];
      out[i] = (int64_t)((uint64_t)out[i] +
                         (uint64_t)((int64_t)acc >> shift));
    }
  } else {
    return false;
  }

  if (wasted)
    for (int i = 0; i < bs; i++)
      out[i] = (int64_t)((uint64_t)out[i] << wasted);
  return !br.error;
}

}  // namespace

// ---------------------------------------------------------------------------
// .glc container (bincode v1) serializer / parser.
//
// Byte-compatible with Rust bincode::serialize of the reference's serde
// structs (reference src/codec.rs:31-69, 774-786): little-endian fixed-width
// ints, u64 Vec lengths, Option as a 1-byte tag.  Columnar in/out matching
// glc.container.schema.FrameSet.
// ---------------------------------------------------------------------------

namespace {
inline void put_u64(uint8_t*& p, uint64_t v) {
  std::memcpy(p, &v, 8);
  p += 8;
}
inline void put_u32(uint8_t*& p, uint32_t v) {
  std::memcpy(p, &v, 4);
  p += 4;
}
inline void put_u16(uint8_t*& p, uint16_t v) {
  std::memcpy(p, &v, 2);
  p += 2;
}
}  // namespace

extern "C" int64_t glc_container_serialize(
    uint32_t sample_rate, uint16_t channels, uint64_t total_samples,
    uint32_t encoder_delay, uint32_t padding, uint64_t original_length,
    int64_t num_frames,
    const int64_t* nnz,      // [F, C]
    const uint8_t* pairs,    // [K] 4-byte (u16 k, i16 q) records, stream order
    int64_t pairs_len,       // K — bounds the pairs buffer
    const float* scales,     // [F, C]
    const uint8_t* raw_mask, // [F]
    const int16_t* raw_pcm,  // [R, L] rows for raw frames in order
    int64_t raw_len,         // L = frame_size * channels
    uint8_t** out, int64_t* out_len) {
  const int64_t C = channels;
  if (raw_len < 0) return -3;
  // size pass — overflow-guarded: nnz entries come through the C ABI, and
  // wrapped sums would defeat the pairs_len check below and undersize the
  // allocation (heap-corrupting memcpys in the fill pass)
  int64_t total = 14 + 8 + 16;
  int64_t pair_total = 0;
  // raw frame record bytes: 8+8+1+8 fixed + 2·raw_len PCM (mul guarded —
  // raw_len is validated >= 0 but not bounded, so 2·raw_len can overflow)
  int64_t raw_bytes, raw_rec;
  if (__builtin_mul_overflow(raw_len, (int64_t)2, &raw_bytes) ||
      __builtin_add_overflow(raw_bytes, (int64_t)(8 + 8 + 1 + 8), &raw_rec))
    return -3;
  for (int64_t f = 0; f < num_frames; f++) {
    if (raw_mask[f]) {
      if (__builtin_add_overflow(total, raw_rec, &total))
        return -3;
    } else {
      int64_t fp = 0;
      for (int64_t c = 0; c < C; c++) {
        int64_t cnt = nnz[f * C + c];
        if (cnt < 0 || cnt > pairs_len) return -3;
        if (__builtin_add_overflow(fp, cnt, &fp)) return -3;
      }
      int64_t bytes;
      if (__builtin_mul_overflow(fp, (int64_t)4, &bytes)) return -3;
      if (__builtin_add_overflow(total, 8 + 8 * C + 8 + 4 * C + 1, &total) ||
          __builtin_add_overflow(total, bytes, &total))
        return -3;
      if (__builtin_add_overflow(pair_total, fp, &pair_total)) return -3;
    }
  }
  // nnz must be consistent with the pairs buffer (the numpy fallback raises
  // for this; the native path must not read out of bounds)
  if (pair_total > pairs_len) return -4;
  uint8_t* buf = (uint8_t*)std::malloc((size_t)total);
  if (!buf) return -1;
  uint8_t* p = buf;

  put_u32(p, sample_rate);
  put_u16(p, channels);
  put_u64(p, total_samples);
  put_u64(p, (uint64_t)num_frames);

  const uint8_t* pp = pairs;
  const int16_t* rp = raw_pcm;
  for (int64_t f = 0; f < num_frames; f++) {
    if (raw_mask[f]) {
      put_u64(p, 0);
      put_u64(p, 0);
      *p++ = 1;
      put_u64(p, (uint64_t)raw_len);
      std::memcpy(p, rp, (size_t)(2 * raw_len));
      p += 2 * raw_len;
      rp += raw_len;
    } else {
      put_u64(p, (uint64_t)C);
      for (int64_t c = 0; c < C; c++) {
        int64_t cnt = nnz[f * C + c];
        put_u64(p, (uint64_t)cnt);
        std::memcpy(p, pp, (size_t)(4 * cnt));
        p += 4 * cnt;
        pp += 4 * cnt;
      }
      put_u64(p, (uint64_t)C);
      std::memcpy(p, scales + f * C, (size_t)(4 * C));
      p += 4 * C;
      *p++ = 0;
    }
  }
  put_u32(p, encoder_delay);
  put_u32(p, padding);
  put_u64(p, original_length);

  if (p - buf != total) {
    std::free(buf);
    return -2;
  }
  *out = buf;
  *out_len = total;
  return 0;
}

// Parse pass 1: validate + count.  Fills counts so the caller can allocate
// exactly-sized numpy buffers, then calls glc_container_fill.
extern "C" int32_t glc_container_scan(
    const uint8_t* data, int64_t len,
    uint32_t* sample_rate, uint16_t* channels, uint64_t* total_samples,
    uint32_t* encoder_delay, uint32_t* padding, uint64_t* original_length,
    int64_t* num_frames, int64_t* pair_count, int64_t* raw_count,
    int64_t* raw_len) {
  if (len < 14 + 8 + 16) return -1;
  const uint8_t* p = data;
  std::memcpy(sample_rate, p, 4); p += 4;
  std::memcpy(channels, p, 2); p += 2;
  std::memcpy(total_samples, p, 8); p += 8;
  uint64_t F;
  std::memcpy(&F, p, 8); p += 8;
  if ((int64_t)F > len) return -2;
  const int64_t C = *channels;
  const uint8_t* end = data + len - 16;

  int64_t pairs = 0, raws = 0, rlen = -1;
  for (uint64_t f = 0; f < F; f++) {
    if (p + 8 > end) return -3;
    uint64_t outer;
    std::memcpy(&outer, p, 8); p += 8;
    if (outer == (uint64_t)C && C > 0) {
      for (int64_t c = 0; c < C; c++) {
        if (p + 8 > end) return -3;
        uint64_t cnt;
        std::memcpy(&cnt, p, 8); p += 8;
        // division form: immune to signed-multiply overflow on huge counts
        if (cnt > (uint64_t)(end - p) / 4) return -3;
        p += 4 * cnt;
        pairs += (int64_t)cnt;
      }
      if (p + 8 > end) return -3;
      uint64_t sl;
      std::memcpy(&sl, p, 8); p += 8;
      if (sl != (uint64_t)C) return -4;
      if (p + 4 * C + 1 > end) return -3;
      p += 4 * C;
      if (*p++ != 0) return -5;
    } else if (outer == 0) {
      if (p + 9 > end) return -3;
      uint64_t sl;
      std::memcpy(&sl, p, 8); p += 8;
      if (sl != 0) return -6;
      if (*p++ != 1) return -7;
      // the raw-PCM length needs its own bound: without it p can pass
      // `end` here and the (end - p) below underflows to ~2^64, letting a
      // crafted L walk p anywhere (confirmed SIGSEGV reproducer)
      if (p + 8 > end) return -3;
      uint64_t L;
      std::memcpy(&L, p, 8); p += 8;
      if (L > (uint64_t)(end - p) / 2) return -3;
      if (rlen < 0) rlen = (int64_t)L;
      else if (rlen != (int64_t)L) return -8;
      p += 2 * L;
      raws++;
    } else {
      return -9;
    }
  }
  // gapless_info follows the frames immediately; bincode v1's legacy
  // deserialize allows trailing bytes after it (codec.rs:781-786), so we do
  // too — only require that 16 bytes exist at p.
  if (p > end) return -10;
  std::memcpy(encoder_delay, p, 4);
  std::memcpy(padding, p + 4, 4);
  std::memcpy(original_length, p + 8, 8);
  *num_frames = (int64_t)F;
  *pair_count = pairs;
  *raw_count = raws;
  *raw_len = rlen;
  return 0;
}

// Parse pass 2: fill caller-allocated columnar buffers.  Self-bounding: it
// re-validates every read against `len` and every write against the passed
// capacities, so it is memory-safe even if the buffer changed between scan
// and fill (the scan/fill ABI carries no shared-state invariant — a caller
// passing a mutated or different buffer gets an error code, not a SIGSEGV).
extern "C" int32_t glc_container_fill(
    const uint8_t* data, int64_t len, int64_t num_frames, int32_t channels,
    int64_t* nnz, uint8_t* pairs, int64_t pair_capacity,  // pair records
    float* scales, uint8_t* raw_mask,
    int16_t* raw_pcm, int64_t raw_capacity,               // raw rows
    int64_t raw_len) {                                    // samples per row
  const int64_t C = channels;
  if (num_frames < 0 || C <= 0 || pair_capacity < 0 || raw_capacity < 0 ||
      raw_len < 0 || len < 22 + 16)
    return -2;
  const uint8_t* p = data + 22;
  const uint8_t* end = data + len - 16;
  uint8_t* pp = pairs;
  uint8_t* const pp_end = pairs + 4 * pair_capacity;
  int16_t* rp = raw_pcm;
  int64_t raws = 0;
  for (int64_t f = 0; f < num_frames; f++) {
    if (p + 8 > end) return -3;
    uint64_t outer;
    std::memcpy(&outer, p, 8); p += 8;
    if (outer == (uint64_t)C) {
      raw_mask[f] = 0;
      for (int64_t c = 0; c < C; c++) {
        if (p + 8 > end) return -3;
        uint64_t cnt;
        std::memcpy(&cnt, p, 8); p += 8;
        if (cnt > (uint64_t)(end - p) / 4) return -3;
        if (4 * (int64_t)cnt > pp_end - pp) return -4;
        nnz[f * C + c] = (int64_t)cnt;
        std::memcpy(pp, p, (size_t)(4 * cnt));
        pp += 4 * cnt;
        p += 4 * cnt;
      }
      if (p + 8 + 4 * C + 1 > end) return -3;
      uint64_t sl;
      std::memcpy(&sl, p, 8); p += 8;
      if (sl != (uint64_t)C) return -5;
      std::memcpy(scales + f * C, p, (size_t)(4 * C));
      p += 4 * C;
      if (*p++ != 0) return -5;
    } else if (outer == 0) {
      raw_mask[f] = 1;
      for (int64_t c = 0; c < C; c++) nnz[f * C + c] = 0;
      for (int64_t c = 0; c < C; c++) scales[f * C + c] = 0.0f;
      if (p + 8 + 1 + 8 > end) return -3;
      uint64_t sl;
      std::memcpy(&sl, p, 8); p += 8;
      if (sl != 0 || *p++ != 1) return -5;
      uint64_t L;
      std::memcpy(&L, p, 8); p += 8;
      if (L > (uint64_t)(end - p) / 2) return -3;
      if (L != (uint64_t)raw_len || raws >= raw_capacity) return -4;
      std::memcpy(rp, p, (size_t)(2 * L));
      rp += L;
      raws++;
      p += 2 * L;
    } else {
      return -5;
    }
  }
  return p <= end ? 0 : -1;
}

namespace {

int32_t flac_decode_impl(const uint8_t* data, int64_t len,
                         int32_t** out_samples, int64_t* out_count,
                         uint32_t* out_rate, uint32_t* out_channels,
                         uint32_t* out_bps) {
  if (len < 8 || std::memcmp(data, "fLaC", 4) != 0) return -1;
  int64_t pos = 4;
  uint32_t si_rate = 0, si_channels = 0, si_bps = 0;
  uint64_t si_total = 0;
  bool have_si = false;

  // metadata blocks
  for (;;) {
    if (pos + 4 > len) return -2;
    uint8_t hdr = data[pos];
    uint32_t btype = hdr & 0x7F;
    uint32_t blen = ((uint32_t)data[pos + 1] << 16) |
                    ((uint32_t)data[pos + 2] << 8) | data[pos + 3];
    pos += 4;
    if (pos + blen > len) return -2;
    if (btype == 0 && blen >= 34) {
      BitReader br(data + pos, blen);
      br.read_bits(16); br.read_bits(16);        // min/max block size
      br.read_bits(24); br.read_bits(24);        // min/max frame size
      si_rate = (uint32_t)br.read_bits(20);
      si_channels = (uint32_t)br.read_bits(3) + 1;
      si_bps = (uint32_t)br.read_bits(5) + 1;
      si_total = br.read_bits(36);
      have_si = true;
    }
    pos += blen;
    if (hdr & 0x80) break;  // last block
  }
  if (!have_si || si_rate == 0) return -3;

  std::vector<int32_t> out;
  // Pre-size from STREAMINFO, but bound by what the input could possibly
  // encode (a 16-bit sample costs ≥1 bit even fully Rice-degenerate): a
  // crafted header claiming 2^36 samples must not drive a huge reserve.
  {
    uint64_t claimed = si_total * si_channels;
    uint64_t plausible = (uint64_t)len * 16 + 4096;
    if (claimed > 0 && claimed <= plausible) out.reserve((size_t)claimed);
  }

  std::vector<int64_t> ch_buf;

  BitReader br(data + pos, len - pos);
  while (!br.eof()) {
    // frames are byte-aligned; stop cleanly at EOF
    if (br.bit != 0) br.align();
    if (br.pos >= br.len) break;
    size_t frame_start = (size_t)br.pos;
    uint32_t sync = (uint32_t)br.read_bits(14);
    if (br.error) break;
    if (sync != 0x3FFE) return -4;
    br.read_bits(1);                       // reserved
    br.read_bits(1);                       // blocking strategy
    uint32_t bsc = (uint32_t)br.read_bits(4);
    uint32_t src = (uint32_t)br.read_bits(4);
    uint32_t ca = (uint32_t)br.read_bits(4);
    uint32_t ssc = (uint32_t)br.read_bits(3);
    br.read_bits(1);                       // reserved
    if (read_utf8(br) < 0) return -5;

    int bs;
    switch (bsc) {
      case 0: return -6;
      case 1: bs = 192; break;
      case 2: case 3: case 4: case 5: bs = 576 << (bsc - 2); break;
      case 6: bs = (int)br.read_bits(8) + 1; break;
      case 7: bs = (int)br.read_bits(16) + 1; break;
      default: bs = 256 << (bsc - 8); break;
    }
    uint32_t rate = si_rate;
    if (src == 12) rate = (uint32_t)br.read_bits(8) * 1000;
    else if (src == 13) rate = (uint32_t)br.read_bits(16);
    else if (src == 14) rate = (uint32_t)br.read_bits(16) * 10;
    else if (src == 15) return -7;
    (void)rate;

    int bps;
    switch (ssc) {
      case 0: bps = (int)si_bps; break;
      case 1: bps = 8; break;
      case 2: bps = 12; break;
      case 4: bps = 16; break;
      case 5: bps = 20; break;
      case 6: bps = 24; break;
      case 7: bps = 32; break;
      default: return -8;
    }

    int channels;
    enum { INDEP, LS, RS, MS } mode = INDEP;
    if (ca < 8) { channels = (int)ca + 1; }
    else if (ca == 8) { channels = 2; mode = LS; }
    else if (ca == 9) { channels = 2; mode = RS; }
    else if (ca == 10) { channels = 2; mode = MS; }
    else return -9;
    if ((uint32_t)channels != si_channels) return -10;

    // header CRC-8 check
    {
      size_t hdr_len = (size_t)br.pos - frame_start;
      uint8_t expect = crc8(br.data + frame_start, hdr_len);
      uint8_t got = (uint8_t)br.read_bits(8);
      if (expect != got) return -11;
    }

    ch_buf.resize((size_t)channels * bs);
    for (int c = 0; c < channels; c++) {
      int sub_bps = bps;
      if ((mode == LS && c == 1) || (mode == RS && c == 0) ||
          (mode == MS && c == 1))
        sub_bps += 1;
      if (!decode_subframe(br, bs, sub_bps, ch_buf.data() + (size_t)c * bs))
        return -12;
    }
    br.align();
    // frame CRC-16 (covers everything from sync through subframes+padding)
    {
      size_t body_len = (size_t)br.pos - frame_start;
      uint16_t expect = crc16(br.data + frame_start, body_len);
      uint16_t got = (uint16_t)br.read_bits(16);
      if (br.error) return -13;
      if (expect != got) return -14;
    }

    // stereo decorrelation
    int64_t* L = ch_buf.data();
    int64_t* R = ch_buf.data() + bs;
    if (mode == LS) {
      for (int i = 0; i < bs; i++) R[i] = L[i] - R[i];
    } else if (mode == RS) {
      for (int i = 0; i < bs; i++) L[i] = R[i] + L[i];
    } else if (mode == MS) {
      for (int i = 0; i < bs; i++) {
        // uint64 arithmetic: hostile subframe values can overflow the
        // shift/add here (see the predictor note in decode_subframe)
        int64_t mid = (int64_t)(((uint64_t)L[i] << 1) | ((uint64_t)R[i] & 1));
        int64_t side = R[i];
        L[i] = (int64_t)((uint64_t)mid + (uint64_t)side) >> 1;
        R[i] = (int64_t)((uint64_t)mid - (uint64_t)side) >> 1;
      }
    }

    // Decompression-bomb guard: constant subframes make frames ~40000×
    // cheaper than the samples they expand to, so bound total output by
    // what STREAMINFO declares (or a generous absolute cap when it
    // declares nothing — legitimate silent tracks compress enormously, so
    // an input-proportional bound would reject them).
    {
      uint64_t new_total = (uint64_t)out.size() + (uint64_t)bs * channels;
      uint64_t cap = si_total > 0 ? si_total * (uint64_t)si_channels
                                  : ((uint64_t)1 << 30);
      if (new_total > cap) return -16;
    }

    size_t base = out.size();
    out.resize(base + (size_t)bs * channels);
    for (int i = 0; i < bs; i++)
      for (int c = 0; c < channels; c++)
        out[base + (size_t)i * channels + c] =
            (int32_t)ch_buf[(size_t)c * bs + i];
  }

  // NOTE: this final copy doubles peak memory for the decoded stream; the
  // vector keeps all the earlier error paths leak-free, and decode inputs
  // are bounded by the bomb guard above, so the trade is accepted.
  int32_t* p = (int32_t*)std::malloc(out.empty() ? 1 : out.size() * sizeof(int32_t));
  if (!p) return -15;
  if (!out.empty()) std::memcpy(p, out.data(), out.size() * sizeof(int32_t));
  *out_samples = p;
  *out_count = (int64_t)out.size();
  *out_rate = si_rate;
  *out_channels = si_channels;
  *out_bps = si_bps;
  return 0;
}

}  // namespace

// Decode a whole FLAC stream.  Returns 0 on success; fills malloc'd
// interleaved int32 samples (caller frees with glc_free on the cast
// pointer).  Exceptions (e.g. bad_alloc on hostile headers) must not cross
// the C ABI — they become error codes.
extern "C" int32_t glc_flac_decode(const uint8_t* data, int64_t len,
                                   int32_t** out_samples, int64_t* out_count,
                                   uint32_t* out_rate, uint32_t* out_channels,
                                   uint32_t* out_bps) {
  try {
    return flac_decode_impl(data, len, out_samples, out_count, out_rate,
                            out_channels, out_bps);
  } catch (...) {
    return -99;
  }
}
