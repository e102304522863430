"""bench.py last-line contract.

A capture that keeps only the tail of bench output parses the LAST
{"metric": ...} JSON line.  bench.py's contract (its module docstring) is
therefore: the final printed line is the flagship encode metric with a
compact `summary` field carrying every other metric, and it must stay
< 1500 chars so metric additions can never push the flagship number out of
the tail.  Every result line names the device it ran on.

These tests pin that with representative — deliberately padded — data.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import bench  # noqa: E402


_DEVICE = {
    "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
               "count": 1},
    "card": "NVIDIA H100 80GB HBM3, 700.00 W",
}


def _representative_summary():
    """Every summary key bench can emit, with worst-case-width values."""
    return {
        "decode": {"x": 8888.8, "med": 8888.8, "st": [888, 888, 888]},
        "flac": {"x": 8888.8, "med": 8888.8},
        "album_enc": {"x": 8888.8, "med": 8888.8, "vs_serial": 88.88},
        "album_dec": {"x": 8888.8, "med": 8888.8, "vs_serial": 88.88},
        "quality": {"compat_snr": -88.8, "clean_snr": 88.8,
                    "compat_maxerr_pct": 888.8, "clean_maxerr_pct": 88.8},
        "long600": {"x": 8888.8, "med": 8888.8,
                    "runs": [8888.8, 8888.8, 8888.8]},
        "album120_enc": {"x": 8888.8, "med": 8888.8, "vs_serial": 88.88},
        "album120_dec": {"x": 8888.8, "med": 8888.8, "vs_serial": 88.88},
    }


def _representative_flagship():
    line = {
        "metric": "encode_realtime_factor_44k_stereo",
        "value": 8888.8,
        "unit": "x_realtime",
        "median_value": 8888.8,
        "runs": 11,
    }
    line.update(_DEVICE)
    return line


def test_final_line_under_tail_budget():
    s = bench._build_final_line(_representative_flagship(),
                                _representative_summary())
    assert len(s) < 1500, f"final line {len(s)} chars >= 1500 budget"


def test_final_line_is_flagship_metric():
    s = bench._build_final_line(_representative_flagship(),
                                _representative_summary())
    d = json.loads(s)
    # the driver's `parsed` takes metric/value/unit/vs_baseline from the
    # last JSON line — these must be the flagship encode-e2e fields
    assert d["metric"] == "encode_realtime_factor_44k_stereo"
    assert d["unit"] == "x_realtime"
    assert d["device"]["platform"] == "gpu"
    assert d["card"] == _DEVICE["card"]
    assert set(d["summary"]) == set(_representative_summary())


def test_final_line_single_line():
    s = bench._build_final_line(_representative_flagship(),
                                _representative_summary())
    assert "\n" not in s


def test_oversize_summary_sheds_runs_not_flagship():
    """If the summary ever bloats past the budget, the guard drops verbose
    sub-keys (runs lists) instead of growing the line."""
    summary = _representative_summary()
    summary["long600"]["runs"] = [8888.8] * 200  # pathological
    s = bench._build_final_line(_representative_flagship(), summary)
    d = json.loads(s)
    assert len(s) < 1500
    assert d["metric"] == "encode_realtime_factor_44k_stereo"
    assert "runs" not in d["summary"]["long600"]


def test_pathological_summary_never_breaks_flagship():
    """The guard ladder's last rungs: wide non-runs payloads force whole
    summary entries (then the summary itself) to be shed — the flagship
    metric dict must survive intact at ANY summary size."""
    summary = _representative_summary()
    for i in range(60):  # many future metrics, each with wide payloads
        summary[f"future_metric_{i}"] = {"x": 8888.8, "med": 8888.8,
                                         "note": "y" * 40}
    s = bench._build_final_line(_representative_flagship(), summary)
    d = json.loads(s)
    assert len(s) < 1500
    assert d["metric"] == "encode_realtime_factor_44k_stereo"
    assert d["device"] == _DEVICE["device"]


def test_emit_records_summary_keys(monkeypatch, capsys):
    """emit prints one JSON line with the device fields and records its
    compact summary entry."""
    monkeypatch.setattr(bench, "DEVICE", dict(_DEVICE))
    bench.SUMMARY.clear()
    line = bench.emit("decode_realtime_factor_44k_stereo", 60.0, 0.3, 0.32,
                      key="decode", runs=11)
    assert line["value"] == 200.0
    assert json.loads(capsys.readouterr().out.strip()) == line
    assert line["device"] == _DEVICE["device"]
    assert line["card"] == _DEVICE["card"]
    assert bench.SUMMARY["decode"] == {"x": 200.0, "med": 187.5}
    bench.SUMMARY.clear()
