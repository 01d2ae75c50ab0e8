"""Native (C++) host code of the port: the H.264 slice decoder and wire
packer (``h264parse.cpp``), the MPEG-1/2 picture decoder
(``m2vparse.cpp``) and the H.265 slice decoder (``h265parse.cpp``), with
their generated tables (``*.inc``) beside them, and the H.265 intra-op
level scheduler (``oplevel.cpp``).

Each library is compiled with g++ at first use into
``build/torch_native/<key>/``, where the key hashes the sources, the
flags and the host CPU (the flags hold ``-march=native``, so a library
built on one host may not run on another). Concurrent first loads from
several processes are safe: the build holds an ``fcntl`` lock and
writes under a temporary name that ``os.replace`` publishes whole, so
no process ever loads a half-written file. A failed build raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import platform
import subprocess
import threading

from m2dec_tpu_torch.runtime import trace

_HERE = pathlib.Path(__file__).resolve().parent
BUILD_ROOT = _HERE.parent.parent / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

#: library name -> (source, the table files it includes)
SOURCES = {"h264parse": ("h264parse.cpp", "h264_tables.inc"),
           "m2vparse": ("m2vparse.cpp", "mpeg2_tables.inc"),
           "h265parse": ("h265parse.cpp", "h265_tables.inc"),
           "oplevel": ("oplevel.cpp",)}

_LOCK = threading.Lock()
_LIBS: dict = {}


def _cpu_tag() -> str:
    """The host CPU's identity: machine, model name and flags."""
    tag = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                if ln.startswith(("model name", "flags")):
                    tag += ln
                    if ln.startswith("flags"):
                        break
    except OSError:
        pass
    return tag


def library_path(name: str) -> pathlib.Path:
    """Where library ``name`` is (or will be) built."""
    h = hashlib.sha256()
    for f in SOURCES[name]:
        h.update((_HERE / f).read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_cpu_tag().encode())
    return pathlib.Path(BUILD_ROOT) / h.hexdigest()[:16] / f"lib{name}.so"


def build(name: str) -> pathlib.Path:
    """Compile library ``name`` unless it is built; returns its path.
    Safe across processes; raises on a compiler error."""
    out = library_path(name)
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.is_file():  # built by another process while we waited
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = ["g++", *CXX_FLAGS, "-o", str(tmp),
               str(_HERE / SOURCES[name][0])]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed ({res.returncode}) building "
                               f"{name}:\n{res.stderr}")
        os.replace(tmp, out)
    return out


def _load(name, declare):
    key = (name, str(BUILD_ROOT))
    with _LOCK:
        lib = _LIBS.get(key)
        if lib is None:
            with trace.span("setup.build"):
                lib = ctypes.CDLL(str(build(name)))
            declare(lib)
            _LIBS[key] = lib
        return lib


# --------------------------------------------------------------- MPEG-2 --

class M2vPicParams(ctypes.Structure):
    _fields_ = [
        ("mb_w", ctypes.c_int32),
        ("mb_h", ctypes.c_int32),
        ("is_mpeg2", ctypes.c_int32),
        ("coding_type", ctypes.c_int32),
        ("r_size", ctypes.c_int32 * 4),
        ("intra_dc_precision", ctypes.c_int32),
        ("frame_pred_frame_dct", ctypes.c_int32),
        ("concealment_motion_vectors", ctypes.c_int32),
        ("q_scale_type", ctypes.c_int32),
        ("intra_vlc_format", ctypes.c_int32),
        ("alternate_scan", ctypes.c_int32),
        ("picture_structure", ctypes.c_int32),
        ("qmat_intra", ctypes.c_int32 * 64),
        ("qmat_nonintra", ctypes.c_int32 * 64),
    ]


def _declare_m2v(lib):
    fn = lib.m2v_decode_picture
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ctypes.POINTER(M2vPicParams),
    ] + [ctypes.c_void_p] * 13


def load_m2v():
    """The MPEG-1/2 Phase-A library (built at first use)."""
    return _load("m2vparse", _declare_m2v)


# ---------------------------------------------------------------- H.264 --

class H264SliceParams(ctypes.Structure):
    _fields_ = [
        ("slice_type", ctypes.c_int32),
        ("is_cabac", ctypes.c_int32),
        ("cabac_init_idc", ctypes.c_int32),
        ("qp", ctypes.c_int32),
        ("first_mb", ctypes.c_int32),
        ("num_ref_idx", ctypes.c_int32 * 2),
        ("constrained_intra", ctypes.c_int32),
        ("t8x8_mode", ctypes.c_int32),
        ("chroma_qp_index", ctypes.c_int32 * 2),
        ("direct_spatial", ctypes.c_int32),
        ("weighted_mode", ctypes.c_int32),
        ("deb_idc_plus1", ctypes.c_int32),
        ("alpha_ofs", ctypes.c_int32),
        ("beta_ofs", ctypes.c_int32),
        ("poc", ctypes.c_int32),
        ("is_field", ctypes.c_int32),
        ("bit_offset", ctypes.c_int64),
    ]


def _declare_h264(lib):
    vp = ctypes.c_void_p
    pvp = ctypes.POINTER(ctypes.c_void_p)
    lib.h264p_new.restype = vp
    lib.h264p_new.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.h264p_free.argtypes = [vp]
    lib.h264p_begin_picture.argtypes = [vp, pvp, ctypes.c_int]
    lib.h264pack_new.restype = vp
    lib.h264pack_new.argtypes = []
    lib.h264pack_free.argtypes = [vp]
    lib.h264pack_measure.argtypes = [
        vp, pvp, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64)]
    lib.h264pack_fill.argtypes = [
        vp, pvp, ctypes.c_int, ctypes.c_int, pvp,
        ctypes.POINTER(ctypes.c_int64), vp, vp, vp]
    lib.h264p_set_refs.argtypes = [vp] * 11
    lib.h264p_finalize_deblock.argtypes = [vp, ctypes.c_int, vp, vp, vp]
    lib.h264p_slice.restype = ctypes.c_int
    lib.h264p_slice.argtypes = [
        vp, ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(H264SliceParams), ctypes.POINTER(ctypes.c_int32)]


def load_h264():
    """The H.264 Phase-A library (built at first use)."""
    return _load("h264parse", _declare_h264)


# ---------------------------------------------------------------- H.265 --

class H265SliceParams(ctypes.Structure):
    """Mirror of h265parse.cpp's H265SliceParams (field order must
    match)."""

    _fields_ = [
        ("slice_type", ctypes.c_int32),
        ("slice_qpy", ctypes.c_int32),
        ("cabac_init_flag", ctypes.c_int32),
        ("sao_luma", ctypes.c_int32),
        ("sao_chroma", ctypes.c_int32),
        ("slice_addr", ctypes.c_int32),
        ("max_merge", ctypes.c_int32),
        ("mvd_l1_zero", ctypes.c_int32),
        ("temporal_mvp", ctypes.c_int32),
        ("colocated_from_l0", ctypes.c_int32),
        ("collocated_ref_idx", ctypes.c_int32),
        ("num_ref_idx_minus1", ctypes.c_int32 * 2),
        ("deblock_disabled", ctypes.c_int32),
        ("beta_offset_div2", ctypes.c_int32),
        ("tc_offset_div2", ctypes.c_int32),
        ("qpc_delta", ctypes.c_int32 * 2),
        ("sign_data_hiding", ctypes.c_int32),
        ("transform_skip", ctypes.c_int32),
        ("cu_qp_delta", ctypes.c_int32),
        ("max_hier_intra", ctypes.c_int32),
        ("max_hier_inter", ctypes.c_int32),
        ("amp", ctypes.c_int32),
        ("log2_parallel_merge", ctypes.c_int32),
        ("min_cb_log2", ctypes.c_int32),
        ("max_tb_log2", ctypes.c_int32),
        ("min_tb_log2", ctypes.c_int32),
        ("bit_offset", ctypes.c_int64),
        ("ref_poc", ctypes.c_int32 * 32),
        ("ref_fidx", ctypes.c_int32 * 32),
        ("col_page", ctypes.c_int32),
        ("lowdelay", ctypes.c_int32),
        ("colmv", ctypes.c_int32 * 64),
        ("tmv", ctypes.c_int32 * 64),
        ("fidx_curr", ctypes.c_int32 * 32),
        ("fidx_col", ctypes.c_int32 * 32),
        ("cb_qp_offset", ctypes.c_int32),
        ("cr_qp_offset", ctypes.c_int32),
    ]


def _declare_h265(lib):
    vp = ctypes.c_void_p
    lib.h265p_new.restype = vp
    lib.h265p_new.argtypes = [ctypes.c_int] * 5
    lib.h265p_free.argtypes = [vp]
    lib.h265p_begin_picture.argtypes = [
        vp, ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int]
    lib.h265p_slice.restype = ctypes.c_int
    lib.h265p_slice.argtypes = [vp, ctypes.c_char_p, ctypes.c_longlong,
                                ctypes.POINTER(H265SliceParams)]
    lib.h265p_finish.argtypes = [vp] * 4


def load_h265():
    """The H.265 Phase-A library (built at first use)."""
    return _load("h265parse", _declare_h265)


def _declare_oplevel(lib):
    fn = lib.h265_schedule_levels
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                   ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                   ctypes.c_int32, ctypes.c_void_p]


def load_oplevel():
    """The H.265 intra-op level scheduler (built at first use)."""
    return _load("oplevel", _declare_oplevel)
