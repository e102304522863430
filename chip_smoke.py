"""Smoke run of the codec's main path on an NVIDIA GPU.

Usage:
    python chip_smoke.py [--seed N]        one GPU: every phase below
    python chip_smoke.py --four-cards      four GPUs: the mesh check only

It drives the program the way a user does, in this one process, which holds
the card.  The audio is program-like material made from --seed.  Phases:

  transforms      MDCT and IMDCT+window on the card against float64 NumPy
                  at 4096 frames × 2 channels (relative error ≤ 1e-5).
  cli             a 180 s 44.1 kHz 16-bit stereo WAV through
                  `glc song.wav`, `glc -d --flac-level 5` and `glc -d --wav`
                  (glc.cli.main, in process): exact decoded length, the FLAC
                  equal to the WAV's PCM with a matching STREAMINFO MD5,
                  SNR against the source.
  album           Encoder.encode_many / Decoder.decode_many on 4 × 120 s
                  and 4 × 15 s tracks: containers byte-identical to serial
                  encode_pcm16, exact decoded lengths, decode within 1 LSB of
                  serial decode_i16.
  cpu_reference   a 60 s signal encoded and decoded on the CPU backend in a
                  child process with JAX_PLATFORMS=cpu (it never opens the
                  card): the CPU container decoded on the card within 1 LSB,
                  the card's encode against the CPU's (quantized values, raw
                  decisions, SNR within 0.1 dB).
  determinism     the same container decoded twice, and the same PCM
                  encoded twice, on the card: identical bytes.
  memory          compiled.memory_analysis() of the largest encode and
                  decode programs, and the device's peak bytes in use.
  gpu_tests       the tests marked `gpu` (tests/test_gpu.py), run in this
                  process through pytest.

Each phase prints its first-call (compile included) and second-call wall
times.  Any failed check raises, so the script exits non-zero without the
last line.  The last line is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a GPU it exits with code 2 before any work.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
RATE = 44100


def program_material(seconds: float, seed: int) -> np.ndarray:
    """Interleaved int16 stereo: a chord, a sweep whose clock wraps every
    60 s, and a noise bed, all drawn from `seed`."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(RATE * seconds), dtype=np.float32) / RATE
    ts = np.mod(t, np.float32(60.0))
    f1, f2 = rng.uniform(200.0, 300.0), rng.uniform(300.0, 400.0)
    left = (
        0.30 * np.sin(2 * np.pi * f1 * t)
        + 0.20 * np.sin(2 * np.pi * f2 * t)
        + 0.15 * np.sin(2 * np.pi * (440.0 + 100.0 * ts) * ts)
    )
    noise = rng.standard_normal(len(t)).astype(np.float32) * 0.01
    out = np.empty(2 * len(t), np.float32)
    out[0::2] = left + noise
    out[1::2] = left * 0.9 + noise
    return np.clip(out * 32767.0, -32768, 32767).astype(np.int16)


def snr_db(src: np.ndarray, out: np.ndarray, lag: int = 0) -> float:
    """SNR of `out` against `src`; `lag` interleaved samples of `out` lead
    the source (see STEREO_LAG)."""
    a = src[: len(src) - lag].astype(np.float64)
    e = a - out[lag:].astype(np.float64)
    return float(10.0 * np.log10(np.sum(a * a) / max(np.sum(e * e), 1e-20)))


# The reference's gapless trim drains the encoder delay (512) in interleaved
# units (quirk Q1, reproduced by the default reference_compat mode), so a
# stereo decode keeps 256 frames of lead-in: it lags the source by
# 512 interleaved samples.  SNRs below are taken at that lag.
STEREO_LAG = 512


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def run_twice(name: str, fn):
    """Run a phase twice; print both wall times; return the second result."""
    t0 = time.perf_counter()
    fn()
    t1 = time.perf_counter()
    out = fn()
    t2 = time.perf_counter()
    print(f"phase {name}: first call {t1 - t0:.3f} s (compile included), "
          f"second call {t2 - t1:.3f} s")
    sys.stdout.flush()
    return out


# --- phases -----------------------------------------------------------------


def phase_transforms() -> None:
    import jax

    from glc.ops.mdct import (
        get_mdct_tables, imdct, imdct_window_f64, mdct, mdct_f64,
        relative_error,
    )

    tb = get_mdct_tables(1024, 2048)
    rng = np.random.default_rng(4096)
    x = rng.standard_normal((4096, 2, 2048)).astype(np.float32)
    c = rng.standard_normal((4096, 2, 1024)).astype(np.float32) * 0.1
    fwd = jax.jit(lambda x: mdct(x, tb.cos_table, tb.norm))
    inv = jax.jit(lambda c: imdct(c, tb.cos_table, tb.norm) * tb.window)

    def run():
        return (np.asarray(fwd(x)), np.asarray(inv(c)))

    y, z = run_twice("transforms", run)
    e_fwd = relative_error(y, mdct_f64(x, tb))
    e_inv = relative_error(z, imdct_window_f64(c, tb))
    print(f"transforms: MDCT rel err {e_fwd:.3e}, IMDCT+window rel err "
          f"{e_inv:.3e} at 4096x2 rows (tolerance 1e-05; TF32 would give "
          f"~1e-3)")
    check(e_fwd <= 1e-5 and e_inv <= 1e-5, "transform precision over 1e-5")


def phase_cli(seed: int, work: Path) -> None:
    from glc.cli import main as glc_main
    from glc.container.bincode import load_encoded
    from glc.flac.decoder import decode_flac
    from glc.io.wav import read_wav_pcm16, write_wav_i16

    src = program_material(180.0, seed)
    wav = work / "song.wav"
    write_wav_i16(wav, src, RATE, 2)

    def run():
        rc = glc_main([str(wav)])
        check(rc == 0, f"glc song.wav exited {rc}")
        out_glc = work / "out.glc"
        out_glc.write_bytes((work / "song.glc").read_bytes())
        rc = glc_main(["-d", str(out_glc), "--flac-level", "5"])
        check(rc == 0, f"glc -d --flac-level 5 exited {rc}")
        rc = glc_main(["-d", str(out_glc), "--wav"])
        check(rc == 0, f"glc -d --wav exited {rc}")
        return out_glc

    out_glc = run_twice("cli", run)
    ea = load_encoded(out_glc)
    F = ea.frame_set.num_frames
    pcm, rate, ch = read_wav_pcm16(work / "out.wav")
    flac_bytes = (work / "out.flac").read_bytes()
    fl, f_rate, f_ch, f_bps = decode_flac(flac_bytes)
    md5 = flac_bytes[26:42]  # STREAMINFO: fLaC + block header + 18 bytes
    print(f"cli: {len(src) // 2} samples/channel -> {F} frames, "
          f"{out_glc.stat().st_size} bytes .glc; decoded {len(pcm)} samples "
          f"(source {len(src)}); SNR {snr_db(src, pcm, STEREO_LAG):.2f} dB "
          f"at the quirk-Q1 lag ({snr_db(src, pcm):.2f} dB unaligned); FLAC "
          f"{len(flac_bytes)} bytes")
    check((rate, ch) == (RATE, 2), "WAV header")
    check(len(pcm) == len(src), "decoded length != source length")
    check((f_rate, f_ch, f_bps) == (RATE, 2, 16), "FLAC stream info")
    check(np.array_equal(fl, pcm.astype(np.int32)),
          "FLAC samples differ from the WAV's PCM")
    check(md5 == hashlib.md5(pcm.astype("<i2").tobytes()).digest(),
          "FLAC STREAMINFO MD5 mismatch")
    print("cli: FLAC equals the WAV PCM exactly; STREAMINFO MD5 matches")


def phase_album(seed: int, seconds: float, label: str) -> None:
    from glc import Decoder, Encoder, serialize_encoded

    tracks = [(program_material(seconds, seed + 1 + i), 2) for i in range(4)]
    enc = Encoder(RATE)
    dec = Decoder(2, RATE)

    def run():
        many = enc.encode_many(tracks)
        return many, dec.decode_many(many)

    many, outs = run_twice(label, run)
    same = [serialize_encoded(ea) == serialize_encoded(enc.encode_pcm16(p, c))
            for (p, c), ea in zip(tracks, many)]
    lsb = 0
    for (p, _c), out, ea in zip(tracks, outs, many):
        check(len(out) == len(p), f"{label}: decoded length != track length")
        ref = dec.decode_i16(ea)
        lsb = max(lsb, int(np.abs(out.astype(np.int32) - ref).max()))
    print(f"{label}: 4 x {seconds:.0f} s; encode_many byte-identical to "
          f"serial encode_pcm16 for {sum(same)}/4 tracks; decoded lengths "
          f"exact; decode_many vs serial decode_i16 max {lsb} LSB "
          f"(tolerance 1)")
    check(all(same), f"{label}: encode_many differs from serial encodes")
    check(lsb <= 1, f"{label}: decode_many off by more than 1 LSB")


def cpu_reference_child(out_dir: Path, seed: int) -> None:
    """Body of the CPU child (JAX_PLATFORMS=cpu): encode and decode the
    60 s reference signal on the CPU backend; write both to out_dir."""
    import jax

    check(jax.devices()[0].platform == "cpu", "the reference child is CPU")
    from glc import Decoder, Encoder, serialize_encoded

    pcm = program_material(60.0, seed)
    ea = Encoder(RATE).encode_pcm16(pcm, 2)
    out = Decoder(2, RATE).decode_i16(ea)
    np.savez(out_dir / "cpu.npz", container=np.frombuffer(
        serialize_encoded(ea), np.uint8), decoded=out)


def phase_cpu_reference(seed: int, work: Path) -> None:
    from glc import Decoder, Encoder, deserialize_encoded

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--cpu-reference",
         str(work), "--seed", str(seed)],
        env=env, capture_output=True, text=True, timeout=900,
    )
    print(f"phase cpu_reference: CPU child {time.perf_counter() - t0:.3f} s "
          f"(rc {p.returncode})")
    check(p.returncode == 0, f"CPU reference child failed: {p.stderr[-2000:]}")
    ref = np.load(work / "cpu.npz")
    ea_cpu = deserialize_encoded(ref["container"].tobytes())
    dec_cpu = ref["decoded"]

    pcm = program_material(60.0, seed)
    enc = Encoder(RATE)
    dec = Decoder(2, RATE)
    out = run_twice("cpu_reference_gpu_side",
                    lambda: (dec.decode_i16(ea_cpu), enc.encode_pcm16(pcm, 2)))
    on_card, ea_gpu = out

    # (b) one container, two backends
    diff = np.abs(on_card.astype(np.int32) - dec_cpu.astype(np.int32))
    check(len(on_card) == len(dec_cpu), "(b) decoded lengths differ")
    print(f"(b) CPU container decoded on card vs CPU: max {int(diff.max())} "
          f"LSB (tolerance 1), {float(np.mean(diff != 0)):.3e} of samples "
          f"differ")
    check(int(diff.max()) <= 1, "(b) card decode off by more than 1 LSB")

    # (c) one signal, two encoders
    qg, qc = ea_gpu.frame_set.dense_q(), ea_cpu.frame_set.dense_q()
    check(qg.shape == qc.shape, "(c) frame counts differ")
    kept = (qg != 0) | (qc != 0)
    both = (qg != 0) & (qc != 0)
    dq = np.abs(qg - qc)
    raw_g, raw_c = ea_gpu.frame_set.raw_mask, ea_cpu.frame_set.raw_mask
    snr_g = snr_db(pcm, dec.decode_i16(ea_gpu), STEREO_LAG)
    snr_c = snr_db(pcm, dec_cpu, STEREO_LAG)
    print(f"(c) card vs CPU encode: {float(np.mean(qg != qc)):.3e} of all "
          f"coefficient slots and {float(np.mean(qg[kept] != qc[kept])):.3e} "
          f"of kept coefficients differ; keep-gate flips "
          f"{int(np.sum(kept & ~both))} of {int(kept.sum())}; max |dq| "
          f"where both keep {int(dq[both].max(initial=0))} (tolerance 1); "
          f"raw-PCM decisions differ in {int(np.sum(raw_g != raw_c))} of "
          f"{len(raw_g)} frames; decoded SNR card {snr_g:.3f} dB, CPU "
          f"{snr_c:.3f} dB (tolerance 0.1 dB)")
    check(int(dq[both].max(initial=0)) <= 1, "(c) |dq| over 1")
    check(abs(snr_g - snr_c) <= 0.1, "(c) SNR differs by more than 0.1 dB")


def phase_determinism(seed: int) -> None:
    from glc import Decoder, Encoder, serialize_encoded

    pcm = program_material(60.0, seed)
    enc = Encoder(RATE)
    dec = Decoder(2, RATE)

    def run():
        a = serialize_encoded(enc.encode_pcm16(pcm, 2))
        b = serialize_encoded(enc.encode_pcm16(pcm, 2))
        ea = enc.encode_pcm16(pcm, 2)
        return a, b, dec.decode_i16(ea), dec.decode_i16(ea)

    a, b, d1, d2 = run_twice("determinism", run)
    check(a == b, "(d) encoding the same PCM twice differs")
    check(np.array_equal(d1, d2), "(d) decoding the same container twice "
                                  "differs")
    print("(d) same PCM encoded twice: identical containers; same container "
          "decoded twice: identical samples")


def phase_memory(seed: int) -> None:
    import jax

    from glc import Encoder
    from glc.codec.decoder import _packed_slices, _zero_carry_device
    from glc.codec.encoder import _pick_budget, bucket_upload, upload_geometry
    from glc.codec.tables import chunk_size_for, get_device_tables
    from glc.ops.decode import decode_chunk_packed_device
    from glc.ops.encode import encode_interleaved_device

    enc = Encoder(RATE)
    cfg = enc.config
    n = cfg.n
    tb = get_device_tables(n, cfg.frame_size, RATE)
    pcm = program_material(180.0, seed)
    _T, F, _pad, plan, need_hops, Tb = upload_geometry(len(pcm), 2, cfg)
    k = max(kk for _s, kk in plan)
    xup = bucket_upload(pcm, len(pcm), Tb, 2, np.int16)
    enc_prog = encode_interleaved_device.lower(
        jax.device_put(xup), np.int32(0), np.int32(k), *tuple(tb),
        k_frames=k, budget=_pick_budget(None, k, 2, n),
        bb_mult=cfg.compact_bb_mult, compact_mode=cfg.compact_mode,
        pcm16=True, quality=cfg.quality_factor,
        noise_floor_db=cfg.noise_floor_db,
        compression_threshold=cfg.compression_threshold, max_q=cfg.max_q,
        pad_hops=need_hops, channels=2, lead=cfg.hop_size // 2,
    ).compile()

    fs = enc.encode_pcm16(pcm, 2).frame_set
    K = chunk_size_for(fs.num_frames, cfg.decode_chunk_frames)
    words, budget, rbudget = _packed_slices(fs, 0, min(K, fs.num_frames),
                                            K, n)
    dec_prog = decode_chunk_packed_device.lower(
        jax.device_put(words), _zero_carry_device(2, n), np.int32(K),
        tb.cos_table, tb.window, tb.norm, K=K, C=2, n=n, budget=budget,
        rbudget=rbudget, max_q=cfg.max_q, window_raw=False, out_i16=True,
        out_interleave=True, append_carry=True,
    ).compile()

    def describe(prog) -> str:
        ma = prog.memory_analysis()
        keys = ("argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "generated_code_size_in_bytes")
        return ", ".join(f"{k_[:-9]} {getattr(ma, k_, 'n/a')}" for k_ in keys)

    print(f"memory: encode program ({k} frames x 2 ch): {describe(enc_prog)}")
    print(f"memory: decode program ({K} frames x 2 ch): {describe(dec_prog)}")
    stats = jax.devices()[0].memory_stats() or {}
    print(f"memory: device peak_bytes_in_use {stats.get('peak_bytes_in_use')}"
          f" of bytes_limit {stats.get('bytes_limit')}")


def phase_gpu_tests() -> None:
    import pytest

    class Count:
        passed = 0
        failed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                Count.passed += 1
            elif report.failed:
                Count.failed += 1

    os.environ["GLC_TESTS_ON_GPU"] = "1"
    t0 = time.perf_counter()
    rc = pytest.main(
        [str(ROOT / "tests" / "test_gpu.py"), "-m", "gpu", "-q",
         "-p", "no:cacheprovider", "--rootdir", str(ROOT)],
        plugins=[Count()],
    )
    print(f"phase gpu_tests: {Count.passed} passed, {Count.failed} failed, "
          f"pytest rc {int(rc)}, {time.perf_counter() - t0:.3f} s")
    check(int(rc) == 0 and Count.passed > 0 and Count.failed == 0,
          "gpu-marked tests failed or did not run")


def phase_four_cards(seed: int) -> None:
    from glc.parallel import check_mesh

    tracks = [program_material(120.0, seed + 1 + i).astype(np.float32)
              / np.float32(32768.0) for i in range(4)]
    # The sharded and the serial IMDCT are matmuls of other shapes, which
    # cuBLAS sums in another order: hold the f32 decode to the transform's
    # own bound against float64 (phase transforms), 1e-5 of full scale —
    # a third of an int16 LSB.
    atol = 1e-5
    res = run_twice("four_cards",
                    lambda: check_mesh(4, tracks, decode_atol=atol))
    diff = res["decode_max_abs_diff"]
    print(f"four_cards: mesh {res['mesh']}, 4 x 120 s; sharded encode "
          f"bit-identical to serial Encoder; sharded decode max |diff| "
          f"{diff:.3e} ({diff * 32767:.4f} int16 LSB) vs serial Decoder "
          f"(tolerance rtol 2e-6 + atol {atol:g}); round-trip mse "
          f"{res['roundtrip_mse']:.6f}")


# --- driver -----------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the mesh check on four GPUs")
    ap.add_argument("--cpu-reference", type=Path, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.cpu_reference is not None:
        cpu_reference_child(args.cpu_reference, args.seed)
        return 0

    import jax

    devs = jax.devices()
    need = 4 if args.four_cards else 1
    if devs[0].platform != "gpu" or len(devs) < need:
        print(f"chip_smoke.py needs {need} NVIDIA GPU(s); JAX found "
              f"{len(devs)} {devs[0].platform!r} device(s)", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip())
    print(f"device_kind: {devs[0].device_kind} (x{len(devs)})")

    from glc.native import get_native

    check(get_native() is not None, "the native library did not load")
    print("native library: loaded")
    sys.stdout.flush()

    if args.four_cards:
        phase_four_cards(args.seed)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            work = Path(tmp)
            phase_transforms()
            phase_cli(args.seed, work)
            phase_album(args.seed, 120.0, "album_4x120s")
            phase_album(args.seed, 15.0, "album_4x15s")
            phase_cpu_reference(args.seed, work)
            phase_determinism(args.seed)
            phase_memory(args.seed)
        phase_gpu_tests()

    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
