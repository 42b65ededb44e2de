"""Shared on-demand builder for the C++ host components.

Each `*/native/__init__.py` compiles its .cpp on first use.  The
libraries are built with `-march=native`, so one is valid only on a host
with the same CPU features: its file name carries a key hashed from the
source bytes, the compiler command and the host CPU (machine type plus
the /proc/cpuinfo feature flags).  A library built on another machine or
from an older source therefore never matches and is never loaded.  The
library goes beside its source when that directory is writable, else
into a per-user cache.  Callers catch exceptions and fall back to their
NumPy/device paths when no toolchain is available.
"""

from __future__ import annotations

import hashlib
import os
import platform
import subprocess

_CXX = ("g++", "-O3", "-march=native", "-std=c++17", "-fPIC", "-shared")


def host_cpu() -> str:
    """Machine type and CPU feature flags of this host."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    flags = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return f"{platform.machine()}:{flags}"


def artifact_key(src: str, libs: tuple = ()) -> str:
    """Hash of (source bytes, compiler command, host CPU)."""
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join((*_CXX, "-lpthread", *libs)).encode())
    h.update(host_cpu().encode())
    return h.hexdigest()[:16]


def ensure_built(src: str, so_name: str, libs: tuple = ()) -> str:
    """Path of the shared object for `src` on this host, compiling it
    first when no library with the current key exists.  `libs` adds
    linker flags (e.g. ("-lz",)).  Raises if compilation fails."""
    d = os.path.dirname(os.path.abspath(src))
    if not os.access(d, os.W_OK):
        d = os.path.join(
            os.environ.get("XDG_CACHE_HOME")
            or os.path.join(os.path.expanduser("~"), ".cache"),
            "pseudoaligner_tpu",
        )
        os.makedirs(d, exist_ok=True)
    stem = so_name[:-3] if so_name.endswith(".so") else so_name
    so = os.path.join(d, f"{stem}-{artifact_key(src, libs)}.so")
    if os.path.exists(so):
        return so
    tmp = f"{so}.tmp{os.getpid()}"
    subprocess.run([*_CXX, src, "-o", tmp, "-lpthread", *libs],
                   check=True, capture_output=True)
    os.replace(tmp, so)
    return so
