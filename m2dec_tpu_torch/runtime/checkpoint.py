"""Decode-state checkpoint/resume of the port's decoders.

A copy of ``m2dec_tpu/runtime/checkpoint.py`` for ``m2dec_tpu_torch``:
at any picture boundary the full decoder state -- active SPS/PPS, POC
counters, DPB, frame pool pixels, reference lists and colocated-MV
pages, LRU/output state -- is serialized to one opaque blob. A fresh
process restores the blob and continues decoding from the recorded
stream offset with bit-exact output.

Usage:
    blob, pos = save(dec)            # at a picture boundary
    dec2 = load(blob)
    dec2.set_data(data[pos:])        # same elementary stream, resumed
    dec2.decode_picture() ...        # identical frames from here on

Checkpoint payloads are produced and consumed by this package only --
they are pickles of internal decoder state, not an interchange format.
The header carries this package's magic, a format version and a schema
digest (hash of the source of the decoder's defining module, here the
port's own): a blob of the JAX package, or one written before an
internal refactor, refuses to load instead of resuming with stale
state. The magic is checked first, so a foreign blob never makes this
package import the other one.
"""

from __future__ import annotations

import hashlib
import inspect
import io
import pickle
import struct

#: differs from the JAX package's b"m2dtpu-ckpt2": each package refuses
#: the other's blobs before it reads any further
MAGIC = b"m2dtorch-ckpt2"
#: bump on deliberate layout changes of the blob itself.  v3 adds the
#: writer's decoder module name to the header so the expected schema
#: digest is computable (and compared) BEFORE unpickling — a stale blob
#: fails with the intended clean ValueError instead of dying inside the
#: new module's __setstate__ paths.
FORMAT_VERSION = 3


def _module_digest(mod) -> bytes:
    try:
        src = inspect.getsource(mod)
    except (OSError, TypeError):
        src = getattr(mod, "__name__", repr(mod))
    return hashlib.sha256(src.encode()).digest()[:16]


def _schema_digest(cls) -> bytes:
    """Digest of the decoder state schema: the source of the module
    defining the decoder class. Any edit there (field renames included)
    invalidates outstanding blobs — deliberately conservative; decode
    state is cheap to rebuild from the stream."""
    mod = inspect.getmodule(cls)
    if mod is None:
        return hashlib.sha256(cls.__qualname__.encode()).digest()[:16]
    return _module_digest(mod)


def save(dec) -> tuple[bytes, int]:
    """Serialize decoder state; returns (blob, stream_pos) where
    stream_pos is the byte offset of the first undecoded start code in
    the buffer last passed to set_data (vtable stream_pos parity,
    m2d.h:69)."""
    buf = io.BytesIO()
    buf.write(MAGIC)
    buf.write(struct.pack("<H", FORMAT_VERSION))
    buf.write(_schema_digest(type(dec)))
    mod_name = type(dec).__module__.encode()
    buf.write(struct.pack("<H", len(mod_name)))
    buf.write(mod_name)
    pickle.dump(dec, buf, protocol=pickle.HIGHEST_PROTOCOL)
    return buf.getvalue(), dec.stream_pos()


def load(blob: bytes):
    """Restore a decoder checkpointed by save(). The caller re-attaches
    the remaining stream with set_data(data[stream_pos:]).

    Raises ValueError on a foreign blob, a format-version mismatch, or
    a schema mismatch (blob written by a different revision of the
    decoder module).  The schema check runs BEFORE unpickling whenever
    the writer's module is importable, so stale blobs cannot reach the
    new module's deserialization paths."""
    if blob[: len(MAGIC)] != MAGIC:
        raise ValueError("not a m2dec_tpu_torch checkpoint (bad magic)")
    off = len(MAGIC)
    (ver,) = struct.unpack_from("<H", blob, off)
    off += 2
    if ver != FORMAT_VERSION:
        raise ValueError(
            f"checkpoint format v{ver} != supported v{FORMAT_VERSION}")
    digest = blob[off : off + 16]
    off += 16
    (nlen,) = struct.unpack_from("<H", blob, off)
    off += 2
    mod_name = blob[off : off + nlen].decode()
    off += nlen

    def _refuse(modname):
        raise ValueError(
            "checkpoint schema mismatch: blob was written by a "
            f"different revision of {modname}; re-decode "
            "from the stream instead of resuming")

    pre_checked = False
    try:
        import importlib

        mod = importlib.import_module(mod_name)
    except Exception:
        mod = None
    if mod is not None:
        if digest != _module_digest(mod):
            _refuse(mod_name)
        pre_checked = True
    obj = pickle.loads(blob[off:])
    if not pre_checked and digest != _schema_digest(type(obj)):
        _refuse(type(obj).__module__)
    return obj
