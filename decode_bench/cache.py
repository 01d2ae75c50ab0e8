"""The benchmark's cache of streams and reference digests: one fixed
directory inside the checkout, keyed by a hash of the benchmark's own
files that make or judge them (the generators, the reference, the
digest) and of the configuration."""

from __future__ import annotations

import hashlib
import json
import os
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / ".cache"

#: the files whose contents decide what a cached stream or digest holds
_KEYED = ("gen", "ref", "streams.py", "reference.py", "digest.py")


def _keyed_files():
    for name in _KEYED:
        p = HERE / name
        yield from (sorted(p.rglob("*.py")) if p.is_dir() else [p])


def key(config: dict) -> str:
    h = hashlib.sha256(json.dumps(config, sort_keys=True).encode())
    for p in _keyed_files():
        h.update(str(p.relative_to(HERE)).encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def path(config: dict, name: str) -> pathlib.Path:
    d = CACHE / f"{config['name']}-{key(config)}"
    d.mkdir(parents=True, exist_ok=True)
    return d / name


def write_bytes(p: pathlib.Path, data: bytes) -> None:
    """Write whole or not at all: a reader never sees half a file."""
    tmp = p.with_name(f"{p.name}.tmp{os.getpid()}")
    tmp.write_bytes(data)
    os.replace(tmp, p)
