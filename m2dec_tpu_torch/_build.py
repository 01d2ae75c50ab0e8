"""Build and load the hand-written CUDA kernels.

Each source ``csrc/<name>.cu`` is compiled with nvcc at first use into
its own shared library with a plain C interface (``build/torch_kernels/``,
keyed by a hash of the source and flags) and loaded with ctypes. No
PyTorch headers are involved, so a build takes seconds. Every failure
raises: a missing source, a missing nvcc, a compiler error or a library
that does not load.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

from .runtime import trace

_HERE = pathlib.Path(__file__).resolve().parent

CSRC = _HERE / "csrc"
BUILD_DIR = _HERE.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VP = ctypes.c_void_p
_INT = ctypes.c_int

#: library -> its C entry points -> argtypes. Pointers and the trailing
#: stream are c_void_p, so ctypes never truncates them to 32 bits.
LIBRARIES = {
    "h264_wavefront": {
        "h264_intra_luma": [_VP] * 12 + [_INT] * 4 + [_VP],
        "h264_intra_chroma": [_VP] * 7 + [_INT] * 3 + [_VP],
        "h264_deblock_luma": [_VP] * 8 + [_INT] * 3 + [_VP],
        "h264_deblock_chroma": [_VP] * 9 + [_INT] * 3 + [_VP],
    },
    "mpeg2_idct": {
        "mpeg2_idct8x8": [_VP, _VP, ctypes.c_longlong, _VP],
    },
    "h265_tile": {
        "h265_tile_wavefront": [_VP] * 8 + [_INT] * 4 + [_VP],
        "h265_tile_grid": [_INT, _INT, _INT, _VP],
    },
}

#: builds of a source with extra nvcc flags, under their own library
#: name, loaded only by the tools that ask for them (never on the main
#: path): library -> (source name, extra flags, C entry points)
VARIANTS = {
    "h265_tile_probe": ("h265_tile", ("-DH265_TILE_PROBE",), {
        "h265_tile_wavefront_probe": [_VP] * 9 + [_INT] * 4 + [_VP],
    }),
}

_LOCK = threading.Lock()
_LIBS: dict = {}

#: nvcc's report of each library's last build in this process
#: (-Xptxas -v: each kernel's registers, shared memory and spills)
LAST_BUILD: dict = {}


def nvcc_path() -> str:
    """The nvcc executable; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + VARIANTS[name][1] if name in VARIANTS else NVCC_FLAGS


def _target(name: str) -> tuple[pathlib.Path, pathlib.Path]:
    """(source, library path) of library ``name``."""
    stem = VARIANTS[name][0] if name in VARIANTS else name
    src = pathlib.Path(CSRC) / f"{stem}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"kernel source missing: {src}")
    tag = hashlib.sha256(src.read_bytes()
                         + " ".join(_flags(name)).encode()).hexdigest()[:16]
    return src, pathlib.Path(BUILD_DIR) / f"lib{name}_{tag}.so"


def _compile(name: str, src: pathlib.Path, out: pathlib.Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}."
                        f"{threading.get_ident()}.tmp")
    cmd = [nvcc_path(), *_flags(name), "-o", str(tmp), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}) building {src}:\n"
            f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    LAST_BUILD[name] = res.stdout + res.stderr


def _build(name: str) -> pathlib.Path:
    src, out = _target(name)
    if not out.is_file():
        _compile(name, src, out)
    return out


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load kernel library ``name``, once per
    process for a given source directory and build directory."""
    key = (name, str(CSRC), str(BUILD_DIR))
    with _LOCK:
        lib = _LIBS.get(key)
        if lib is not None:
            return lib
        with trace.span("setup.build"):
            lib = ctypes.CDLL(str(_build(name)))
        entries = (VARIANTS[name][2] if name in VARIANTS
                   else LIBRARIES[name])
        for fn_name, argtypes in entries.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[key] = lib
        return lib


def build_all() -> None:
    """Compile every library at once (one nvcc per source, started
    together), then load each; raises on the first failure."""
    with ThreadPoolExecutor(len(LIBRARIES)) as ex:
        for f in [ex.submit(_build, n) for n in LIBRARIES]:
            f.result()
    for name in LIBRARIES:
        load_library(name)
