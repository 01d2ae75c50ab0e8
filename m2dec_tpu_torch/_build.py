"""Build and load the hand-written CUDA kernels.

The kernels are compiled with nvcc at first use into a shared library
with a plain C interface (``build/torch_kernels/``, keyed by a hash of
the source and flags) and loaded with ctypes. No PyTorch headers are
involved, so a build takes seconds. Every failure raises: a missing
source, a missing nvcc, a compiler error or a library that does not load.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

_HERE = pathlib.Path(__file__).resolve().parent

SOURCE = _HERE / "csrc" / "h264_wavefront.cu"
BUILD_DIR = _HERE.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VP = ctypes.c_void_p
_INT = ctypes.c_int

#: C entry points: (pointers, ints) before the trailing stream. Pointers
#: and the stream are c_void_p, so ctypes never truncates them to 32 bits.
_SIGNATURES = {"h264_intra_luma": (11, 3), "h264_intra_chroma": (6, 2),
               "h264_deblock_luma": (7, 2), "h264_deblock_chroma": (8, 2)}

_LOCK = threading.Lock()
_LIBS: dict = {}

#: nvcc's report of the last build in this process (-Xptxas -v: each
#: kernel's registers, shared memory and spills)
LAST_BUILD = {"log": ""}


def nvcc_path() -> str:
    """The nvcc executable; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _compile(src: pathlib.Path, out: pathlib.Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}) building {src}:\n"
            f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    LAST_BUILD["log"] = res.stdout + res.stderr


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the wavefront kernel library, once per
    process for a given source and build directory."""
    key = (str(SOURCE), str(BUILD_DIR))
    with _LOCK:
        lib = _LIBS.get(key)
        if lib is not None:
            return lib
        src = pathlib.Path(SOURCE)
        if not src.is_file():
            raise FileNotFoundError(f"kernel source missing: {src}")
        tag = hashlib.sha256(src.read_bytes()
                             + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        out = pathlib.Path(BUILD_DIR) / f"libh264_wavefront_{tag}.so"
        if not out.is_file():
            _compile(src, out)
        lib = ctypes.CDLL(str(out))
        for name, (n_ptr, n_int) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = [_VP] * n_ptr + [_INT] * n_int + [_VP]
            fn.restype = ctypes.c_int
        _LIBS[key] = lib
        return lib
