"""Native-core build/load helper shared by every compiled component
(graph closure, discrete scoring, benchmark baselines).

A library is rebuilt unless the stamp stored next to it matches the
source's content, the compiler command and the host CPU (machine type plus
a hash of its feature flags). Git checkouts do not preserve mtimes, and
``-march=native`` code built on one host can fault on another, so neither
an mtime nor a source hash alone may decide that a library is current.
Build failures raise: there is no quiet fallback to another tier.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess

__all__ = ["build_and_load", "build_ext_and_import", "host_id"]

_LIB_FLAGS = ["-O3", "-march=native", "-pthread", "-shared", "-fPIC"]
_EXT_FLAGS = ["-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC"]


def host_id() -> str:
    """Identity of the CPU that ``-march=native`` compiles for: the machine
    type and a hash of the kernel-reported feature flags."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    flags = line.split(":", 1)[1].strip()
                    break
    except OSError:
        flags = platform.processor()
    digest = hashlib.sha256(flags.encode()).hexdigest()[:16]
    return f"{platform.machine()}-{digest}"


def _stamp(src_path: str, cmd: list[str]) -> str:
    h = hashlib.sha256()
    with open(src_path, "rb") as f:
        h.update(f.read())
    h.update("\0".join(cmd).encode())
    h.update(host_id().encode())
    return h.hexdigest()


def _build_if_stale(src_path: str, out_path: str, cmd: list[str]) -> None:
    """Compile ``src_path`` into ``out_path`` with ``cmd`` unless the stamp
    matches. The library is written under a temporary name and renamed, so
    concurrent processes never load a half-written file."""
    stamp_path = out_path + ".sha"
    digest = _stamp(src_path, cmd)
    current = None
    if os.path.exists(stamp_path):
        with open(stamp_path) as f:
            current = f.read().strip()
    if os.path.exists(out_path) and current == digest:
        return
    tmp = f"{out_path}.{os.getpid()}.tmp"
    proc = subprocess.run(
        ["g++", *cmd, src_path, "-o", tmp], capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"building {os.path.basename(src_path)} failed:\n{proc.stderr}"
        )
    os.replace(tmp, out_path)
    with open(stamp_path + f".{os.getpid()}.tmp", "w") as f:
        f.write(digest)
    os.replace(stamp_path + f".{os.getpid()}.tmp", stamp_path)


def build_and_load(src_path: str, lib_path: str | None = None):
    """Compile ``src_path`` to a shared library (g++ -O3 -march=native)
    unless its stamp is current, then ``ctypes.CDLL`` it. Raises on
    toolchain failure."""
    if lib_path is None:
        base, _ = os.path.splitext(src_path)
        name = os.path.basename(base)
        lib_path = os.path.join(os.path.dirname(src_path), f"lib{name}.so")
    _build_if_stale(src_path, lib_path, _LIB_FLAGS)
    return ctypes.CDLL(lib_path)


def build_ext_and_import(src_path: str, modname: str):
    """Compile ``src_path`` as a CPython EXTENSION module (PyInit_<modname>)
    and import it. Unlike :func:`build_and_load`, calls into the result pay
    normal extension-call overhead (~0.2 µs) instead of ctypes marshalling —
    this is what makes the serial-workload tiers viable (config-1 budget is
    tens of µs per whole pipeline). Same staleness rule as
    :func:`build_and_load`; raises on toolchain failure (for example when
    ``Python.h`` is missing)."""
    import importlib.util
    import sysconfig

    so_path = os.path.join(os.path.dirname(src_path), f"{modname}.so")
    inc = sysconfig.get_paths()["include"]
    _build_if_stale(src_path, so_path, [*_EXT_FLAGS, f"-I{inc}"])
    spec = importlib.util.spec_from_file_location(modname, so_path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
