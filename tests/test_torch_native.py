"""The port's native build cache (``polympc_torch.native``): the library's
file name is keyed by the source, the exact command line, the compiler's
version text and the host's ``-march=native`` expansion, so another flag,
compiler or machine gives another file (it rebuilds), and nothing changed
reuses the built library.
"""
import pytest

torch = pytest.importorskip("torch")

from polympc_torch import native  # noqa: E402


def test_build_key_covers_every_input():
    base = (b"int f();", ["g++", "-O3", "-march=native", "src.cpp"],
            "g++ 12.2.0", "-march= cooperlake")
    key = native.build_key(*base)
    assert len(key) == 16 and key == native.build_key(*base)
    for i, other in enumerate((b"int g();",
                               ["g++", "-O2", "-march=native", "src.cpp"],
                               "g++ 13.1.0", "-march= sapphirerapids")):
        changed = list(base)
        changed[i] = other
        assert native.build_key(*changed) != key, i


def test_library_path_follows_flags_compiler_and_host(monkeypatch):
    path = native.library_path("qpmad")
    assert path.parent == native.BUILD_DIR and path.name.startswith("_qpmad_")
    assert native.library_path("qpmad") == path
    monkeypatch.setattr(native, "FLAGS", native.FLAGS + ("-ffast-math",))
    assert native.library_path("qpmad") != path
    monkeypatch.undo()
    monkeypatch.setattr(native, "compiler_id", lambda c: "g++ (other) 99")
    assert native.library_path("qpmad") != path
    monkeypatch.undo()
    monkeypatch.setattr(native, "host_arch", lambda c: "-march= other")
    assert native.library_path("qpmad") != path
    monkeypatch.undo()
    assert native.library_path("qpmad") == path


def test_host_arch_falls_back_to_cpuinfo(monkeypatch):
    native.host_arch.cache_clear()
    monkeypatch.setattr(native, "_run", lambda cmd: "")
    try:
        text = native.host_arch("no-such-compiler")
        assert text == native.host_arch("no-such-compiler")
    finally:
        native.host_arch.cache_clear()


def test_unchanged_build_reuses_the_library(monkeypatch):
    lib = native.load_native("qpmad")
    so = native.library_path("qpmad")
    assert so.exists()
    stamp = so.stat().st_mtime_ns
    calls = []
    real_run = native.subprocess.run

    def spy(cmd, *a, **kw):
        calls.append(cmd)
        return real_run(cmd, *a, **kw)
    monkeypatch.setattr(native.subprocess, "run", spy)
    monkeypatch.setattr(native, "_LIBS", {})
    again = native.load_native("qpmad")
    assert so.stat().st_mtime_ns == stamp
    assert not any("-shared" in c for c in calls)
    assert again._name == lib._name
