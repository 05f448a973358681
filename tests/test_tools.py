"""The benchmark CLIs run their paths end to end on the CPU mesh at tiny
sizes (their times here measure XLA's CPU backend and are not checked)."""

import sys

import pytest

from clenabled_tpu.runtime import config


def _run_tool(module, argv, monkeypatch, capsys):
    # keep this worker's compile-cache setting untouched
    monkeypatch.setattr(config, "init_compile_cache", lambda: "")
    monkeypatch.setattr(sys, "argv", [module.__name__] + argv)
    module.main()
    return capsys.readouterr().out


@pytest.mark.parametrize("mode", ["flagship", "xengine", "ospfb", "xcorr"])
def test_scaling_tool_modes(mode, monkeypatch, capsys):
    from clenabled_tpu.tools import test_scaling

    argv = ["--cpu", "--devices", "1", "2", "--iterations", "1",
            "--samples-per-chip", "1024", "--integration", "16",
            "--channels", "4", "--stations-per-chip", "2",
            "--signal-length", "512", "--max-shift", "16",
            "--windows-per-chip", "2"]
    if mode != "flagship":
        argv.append(f"--{mode}")
    out = _run_tool(test_scaling, argv, monkeypatch, capsys)
    assert "1 device(s)" in out and "2 device(s)" in out
    assert "efficiency" in out


@pytest.mark.parametrize("leg", ["int8", "packed4"])
def test_ingest_tool_narrow_legs(leg, monkeypatch, capsys):
    """The int8 leg (raw IChar ingest into the planar flagship) and the
    packed-4-bit leg (sync → ingest → on-device unpack → int8 flagship)."""
    from clenabled_tpu.tools import test_ingest

    argv = ["--cpu", "--steps", "8", "--samples-per-step", "12"]
    argv += ["--dtype", "int8"] if leg == "int8" else ["--packed4",
                                                       "--no-disk"]
    out = _run_tool(test_ingest, argv, monkeypatch, capsys)
    assert f"[{leg}]" in out
    assert "end-to-end" in out
