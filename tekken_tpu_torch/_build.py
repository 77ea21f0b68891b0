"""Build and load the CUDA kernels of the port (nvcc + ctypes).

Each ``csrc/*.cu`` file compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the flags, the source and every
``csrc`` header it includes (``#include "..."``, followed recursively), so
an edited source or header is rebuilt and a stale library is never
loaded.  Nothing is built
when the package is imported: the first wrapper call on a CUDA tensor
builds what it needs, and ``build()`` builds every kernel at once, one
nvcc process per source, all started together.

``LAUNCHES`` counts kernel launches by name (a kernel's library may have
several C entry points; a launch of any of them counts toward its name);
it is the launch section of the port's counters, ``utils.timing.COUNTERS``.
``launch`` adds one where a C entry point launched its kernel and nowhere
else (not where an empty
input left nothing to launch), so a caller can zero the counts, run the
encode path and read which kernels it went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

from .utils.timing import COUNTERS

_PKG = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint

# kernel name -> (source, {C entry point: argtypes}, error-string function);
# ``launch`` takes the first entry point unless it is named
KERNELS = {
    "stage1_compact": (
        "stage1_compact.cu",
        {"tk_stage1_compact": [_P, _P, _P, _I, _I, _I, _I, _I, _U, _U, _P,
                               _P, _P]},
        "tk_stage1_error"),
    "merge_rows": (
        "merge_rows.cu",
        {"tk_merge_rows": [_P, _P, _P, _P, _U, _U, _U, _I, _I, _I, _P, _P,
                           _P],
         "tk_merge_buckets": [_I, _P, _P, _P, _P, _I, _P, _I, _P, _P, _U,
                              _U, _U, _P, _P]},
        "tk_merge_error"),
    "stage1_fused": (
        "stage1_fused.cu",
        {"tk_stage1_fused": [_P, _P, _I, _I, _I, _U, _U, _P, _P]},
        "tk_stage1_fused_error"),
    "decode_store": (
        "decode_store.cu",
        {"tk_decode_store": [_P, _I, _I, _P, _I, _P, _I, _P, _I, _P, _P, _I,
                             _U, _P]},
        "tk_decode_error"),
}

_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

LAUNCHES = COUNTERS.launches
LAUNCHES.update({name: 0 for name in KERNELS})
# what a C entry point returns when its input is empty and it launched
# nothing (CUDA error codes are >= 0)
NO_LAUNCH = -1

# name -> nvcc's report (seconds, ptxas register/shared-memory/spill
# lines)
BUILD_LOG: dict[str, dict] = {}

_libs: dict[str, tuple] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand:
            path = os.path.join(cand, "bin", "nvcc")
            if os.path.exists(path):
                return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return path


def _sources(src: str) -> list[str]:
    """``src`` and the csrc files it includes, recursively, in the order
    first met."""
    seen: list[str] = []
    todo = [src]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        with open(os.path.join(SRC_DIR, path), "rb") as f:
            todo += [m.decode() for m in _INCLUDE.findall(f.read())]
    return seen


def _lib_path(name: str) -> str:
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in _sources(KERNELS[name][0]):
        with open(os.path.join(SRC_DIR, path), "rb") as f:
            digest.update(path.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(names=None) -> dict[str, dict]:
    """Compile the named kernels (all by default) that are not built yet,
    one nvcc per source, all in parallel.  Returns BUILD_LOG for them."""
    names = list(KERNELS) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            BUILD_LOG.setdefault(name, {"seconds": 0.0, "cached": True,
                                        "ptxas": ""})
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(SRC_DIR, KERNELS[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        ptxas = "\n".join(ln for ln in log.splitlines()
                          if "registers" in ln or "Compiling" in ln
                          or "spill" in ln)
        BUILD_LOG[name] = {"seconds": secs, "cached": False, "ptxas": ptxas}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {n: BUILD_LOG[n] for n in names}


def entry(name: str, fn_name: str | None = None):
    """(C entry point, error-string function) of a kernel, building and
    loading its library on first use; the first entry point unless
    ``fn_name`` names another."""
    with _lock:
        got = _libs.get(name)
        if got is None:
            build([name])
            _, entries, err_name = KERNELS[name]
            lib = ctypes.CDLL(_lib_path(name))
            fns = {}
            for fname, argtypes in entries.items():
                fn = getattr(lib, fname)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[fname] = fn
            err = getattr(lib, err_name)
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            got = _libs[name] = (lib, fns, err)
    fns = got[1]
    return fns[fn_name or next(iter(fns))], got[2]


def launch(name: str, *args, fn_name: str | None = None) -> bool:
    """Call a kernel's C entry point (``fn_name``, or its first); raise on
    a launch error.  Returns True and counts the launch under ``name``, or
    False where the entry point had no work to launch (it returns
    NO_LAUNCH for an empty input)."""
    fn, err = entry(name, fn_name)
    rc = fn(*args)
    if rc == NO_LAUNCH:
        return False
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{err(rc).decode()} ({rc})")
    LAUNCHES[name] += 1
    return True
