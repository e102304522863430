"""Drive the tkinter view for real poll() cycles under a display.

The view's listbox-sync and progress pack/forget logic
(glc/ui.py poll(), mirroring reference src/ui.rs:472-505) had never
executed in any test.  These tests run it when a display is available:
$DISPLAY if set, else an Xvfb we launch ourselves.  When neither exists
(this environment ships no Xvfb — probe documented in the skip reason),
they skip; the controller behind the view stays fully covered headlessly
in test_controller.py.
"""

import os
import shutil
import subprocess
import time
from pathlib import Path

import pytest


def _display():
    """Return (display, proc-or-None) for a usable X display, else None."""
    if os.environ.get("DISPLAY"):
        return os.environ["DISPLAY"], None
    xvfb = shutil.which("Xvfb")
    if not xvfb:
        return None
    disp = ":93"
    proc = subprocess.Popen(
        [xvfb, disp, "-screen", "0", "640x480x24"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    time.sleep(0.5)
    if proc.poll() is not None:
        return None
    return disp, proc


@pytest.fixture(scope="module")
def gui():
    probe = _display()
    if probe is None:
        pytest.skip(
            "no X display: $DISPLAY unset and Xvfb not present on PATH "
            "(probed at test time; install Xvfb to exercise the view)"
        )
    disp, proc = probe
    old = os.environ.get("DISPLAY")
    os.environ["DISPLAY"] = disp
    try:
        from glc.controller import CodecController
        from glc.ui import build_gui

        ctl = CodecController()
        try:
            root, poll = build_gui(ctl)
        except Exception as e:  # display exists but Tk can't open it
            pytest.skip(f"Tk could not open display {disp}: {e}")
        yield ctl, root, poll
        root.destroy()
    finally:
        if old is None:
            os.environ.pop("DISPLAY", None)
        else:
            os.environ["DISPLAY"] = old
        if proc is not None:
            proc.terminate()
            proc.wait(timeout=5)


def test_poll_syncs_status_and_listbox(gui):
    ctl, root, poll = gui
    ctl.set_status("Hello", "detail text")
    ctl.encoded_files.append(Path("/tmp/x.glc"))
    poll()
    root.update()
    # the status labels and encoded-files listbox reflect controller state
    boxes = [w for w in root.winfo_children()[0].winfo_children()
             if w.winfo_class() == "Listbox"]
    assert any(b.get(0, "end") == ("x.glc",) for b in boxes)


def test_poll_packs_and_forgets_progress(gui):
    ctl, root, poll = gui
    bars = [w for w in root.winfo_children()[0].winfo_children()
            if w.winfo_class() == "TProgressbar"]
    assert bars
    with ctl._lock:
        ctl._encode_progress = 42.0
    poll()
    root.update()
    assert any(b.winfo_ismapped() for b in bars)
    with ctl._lock:
        ctl._encode_progress = None
    poll()
    root.update()
    assert not any(b.winfo_ismapped() for b in bars)
