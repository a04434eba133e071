"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``apex_tpu_torch/csrc/<name>.cu`` compiles on its own with ``nvcc``
for Hopper (``sm_90a``) into a shared library with a plain C interface,
``build/apex_tpu_torch/<name>.<hash>.so`` under the repository root. The
hash covers the source and the flags, so an edited source rebuilds and an
unchanged one loads what is there. :func:`build` starts one ``nvcc`` per
stale source, all at once, and waits for all of them. No source includes
PyTorch's headers: that keeps a build at seconds, not minutes.

The libraries link the CUDA runtime statically; each entry point takes
the device index and PyTorch's current stream, launches, and returns
``cudaGetLastError()``, which the wrapper turns into a raise.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

SOURCES = ("prefill_attention", "decode_attention")
CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "apex_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes shared by every entry point
DTYPE_CODES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}

_lock = threading.Lock()
_libs = {}        # name -> ctypes.CDLL, loaded at most once per process
build_log = {}    # name -> nvcc's output (ptxas register/spill report)


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "apex_tpu_torch build only where the CUDA "
                           "toolkit is installed")
    return path


def lib_path(name):
    """The content-addressed library path of one source."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}.{digest}.so"


def build(names=SOURCES):
    """Compile every stale library among ``names`` in parallel (one
    ``nvcc`` each); returns the wall seconds spent. Raises with the
    compiler's output when a build fails."""
    t0 = time.perf_counter()
    stale = [n for n in names if not lib_path(n).exists()]
    if not stale:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in stale:
        out = lib_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n"
                          f"{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name, signatures):
    """The loaded library of one source, building it first if needed.
    ``signatures`` maps each entry point to its ``(argtypes, restype)``,
    set once when the library loads."""
    with _lock:
        if name not in _libs:
            build((name,))
            lib = ctypes.CDLL(str(lib_path(name)))
            for fn_name, (argtypes, restype) in signatures.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = restype
            _libs[name] = lib
        return _libs[name]


def check(lib, prefix, rc):
    """Raise when an entry point returned a CUDA error code."""
    if rc:
        fn = getattr(lib, f"{prefix}_error_string")
        raise RuntimeError(f"{prefix}: CUDA error {rc}: "
                           f"{fn(rc).decode(errors='replace')}")
