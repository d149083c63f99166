"""Native libraries are keyed on the source, the flags and the host CPU."""

import pytest

import pybnesian_tpu._native as native

SRC = 'extern "C" int answer() { return 42; }\n'


def _build(tmp_path):
    src = tmp_path / "probe.cpp"
    src.write_text(SRC)
    lib = native.build_and_load(str(src))
    return src, tmp_path / "libprobe.so", lib


def test_current_stamp_skips_the_build(tmp_path, monkeypatch):
    _, so, lib = _build(tmp_path)
    assert lib.answer() == 42
    before = so.stat().st_mtime_ns
    calls = []
    monkeypatch.setattr(native.subprocess, "run",
                        lambda *a, **k: calls.append(a))
    native.build_and_load(str(tmp_path / "probe.cpp"))
    assert calls == [] and so.stat().st_mtime_ns == before


def test_foreign_host_stamp_rebuilds(tmp_path, monkeypatch):
    src, so, _ = _build(tmp_path)
    stamp = (tmp_path / "libprobe.so.sha").read_text()
    monkeypatch.setattr(native, "host_id", lambda: "x86_64-otherhost")
    assert native._stamp(str(src), native._LIB_FLAGS) != stamp
    built = []
    real_run = native.subprocess.run

    def run(cmd, **kw):
        built.append(cmd)
        return real_run(cmd, **kw)

    monkeypatch.setattr(native.subprocess, "run", run)
    lib = native.build_and_load(str(src))
    assert len(built) == 1 and lib.answer() == 42
    assert (tmp_path / "libprobe.so.sha").read_text() != stamp


def test_build_failure_raises(tmp_path):
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="broken.cpp"):
        native.build_and_load(str(src))


def test_host_id_names_the_machine():
    import platform

    assert native.host_id().startswith(platform.machine() + "-")
