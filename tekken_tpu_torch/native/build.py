"""Build the native engine's shared library with g++.

    python -m tekken_tpu_torch.native.build

compiles ``native/engine.cpp`` with the JAX package's flags

    g++ -O3 -march=native -shared -fPIC -std=c++17 -o LIB engine.cpp -lpthread

into ``tekken_tpu_torch/_build/libtekken_native-<hash>.so``, where the hash
covers the flags and the source, so an edited source is rebuilt and a
stale library is never loaded.  Nothing is built when the package is
imported: the first ``NativeEncoder`` builds it.  Several processes may
build at once; each writes a name of its own and moves it into place.
A failed build raises with g++'s output.
"""

from __future__ import annotations

import hashlib
import os
import subprocess

from .._build import BUILD_DIR

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "engine.cpp")
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")


def lib_path() -> str:
    digest = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    with open(SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libtekken_native-{digest.hexdigest()[:12]}.so")


def build() -> str:
    """The library's path, compiled first if it is not there."""
    out = lib_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", *CXX_FLAGS, "-o", tmp, SRC, "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native engine: cannot run g++ ({e})") from e
    if proc.returncode != 0:
        raise RuntimeError(f"native engine: g++ failed ({proc.returncode}):\n"
                           f"{proc.stderr}{proc.stdout}")
    os.replace(tmp, out)
    return out


if __name__ == "__main__":
    print("built", build())
