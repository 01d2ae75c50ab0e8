"""The cell's input streams, made from the seed by the frozen
generators in ``decode_bench/gen``.

A configuration names its generator, the generator's arguments, the
picture size and the GOP pattern. A stream is one GOP (IDR first).
Distinct GOP g of seed n draws each picture from its own generator,
seeded by (n, g, picture), so the pictures of a GOP are made in
parallel on the host's cores and joined behind the SPS and PPS. Streams
are cached by seed under ``decode_bench/.cache``.
"""

from __future__ import annotations

import importlib
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
import os
import random

from decode_bench import cache


def _generator(config: dict, seed: int, gop: int):
    gen = config["generator"]
    mod = importlib.import_module(f"decode_bench.gen.{gen['module']}")
    g = getattr(mod, gen["class"])(config["width"], config["height"],
                                   seed=f"{seed}:{gop}", **gen["args"])
    g.picture_rng = lambda i: random.Random(f"{seed}:{gop}:{i}")
    return g


def picture_bytes(config: dict, seed: int, gop: int, i: int) -> bytes:
    """The NAL bytes of coding-order picture i of distinct GOP gop."""
    return _generator(config, seed, gop).generate(config["gop"], only=i)


def gop_bytes_serial(config: dict, seed: int, gop: int) -> bytes:
    """The whole stream made in one pass (the tests hold the parallel
    assembly to it)."""
    return _generator(config, seed, gop).generate(config["gop"])


def _task(args):
    return picture_bytes(*args)


def make(config: dict, seed: int, n_gops: int) -> list:
    """The bytes of distinct GOPs 0..n_gops-1 of this seed, from the
    cache or made in parallel (and then cached)."""
    paths = [cache.path(config, f"s{seed}_g{g}.bin") for g in range(n_gops)]
    missing = [g for g, p in enumerate(paths) if not p.is_file()]
    if missing:
        n_pic = len(config["gop"])
        tasks = [(config, seed, g, i) for g in missing for i in range(n_pic)]
        workers = max(1, min(len(tasks), os.cpu_count() or 1))
        with ProcessPoolExecutor(
                workers, mp_context=multiprocessing.get_context("spawn")) as ex:
            pics = list(ex.map(_task, tasks))
        for k, g in enumerate(missing):
            body = b"".join(pics[k * n_pic:(k + 1) * n_pic])
            head = _generator(config, seed, g).header_bytes()
            cache.write_bytes(paths[g], head + body)
    return [p.read_bytes() for p in paths]
