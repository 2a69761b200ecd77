"""Native (C++) host components of the port and their build.

Counterpart: ``lighthouse_tpu/native/__init__.py`` (:31-64). ``load(name)``
compiles ``src/<name>.cpp`` with g++ on first use and returns the ctypes
CDLL. The library goes to ``build/lib<name>-<key>.so`` (``build/`` is not
committed), keyed by a hash of the source and of the host CPU's feature
flags, so that a changed source is rebuilt and a library built on another
host is never loaded; a process that finds its library built loads it.
Processes that build at once take a file lock in ``build/``: the first
builds, the others then load its library. As in the JAX loader,
``-march=native`` code generation is tried first and portable code if
that compile fails, and a library that will not load is rebuilt portable:
these change compiler flags, not the route. A build that fails with both
raises.
"""

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src")
_BUILD = os.path.join(_HERE, "build")
_BASE = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC"]
_lock = threading.Lock()
_cache = {}


def _cpu_flags() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return os.uname().machine.encode()


def library_path(name: str) -> str:
    """Where `name`'s library is (or will be) built on this host."""
    with open(os.path.join(_SRC, f"{name}.cpp"), "rb") as f:
        key = hashlib.sha256(f.read() + b"\0" + " ".join(_BASE).encode() + b"\0"
                             + _cpu_flags()).hexdigest()[:16]
    return os.path.join(_BUILD, f"lib{name}-{key}.so")


def _compile(src: str, out: str, native: bool) -> None:
    tmp = f"{out}.tmp.{os.getpid()}"
    try:
        if native:
            try:
                # -march=native unlocks SHA-NI/AVX paths where guarded by
                # #ifdef in the sources; portable codegen if it fails.
                subprocess.run(_BASE + ["-march=native", "-o", tmp, src],
                               check=True, capture_output=True)
            except subprocess.CalledProcessError:
                native = False
        if not native:
            subprocess.run(_BASE + ["-o", tmp, src], check=True, capture_output=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load(name: str) -> ctypes.CDLL:
    with _lock:
        if name in _cache:
            return _cache[name]
        src = os.path.join(_SRC, f"{name}.cpp")
        out = library_path(name)
        os.makedirs(_BUILD, exist_ok=True)
        with open(os.path.join(_BUILD, f"{name}.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not os.path.exists(out):
                _compile(src, out, native=True)
            try:
                lib = ctypes.CDLL(out)
            except OSError:
                # A library that will not load here: rebuild portable.
                _compile(src, out, native=False)
                lib = ctypes.CDLL(out)
        _cache[name] = lib
        return lib
