"""Small cells for the benchmark's CPU tests: the real configurations
and traffic at test sizes, run with the program on the CPU."""

from __future__ import annotations

import json

from decode_bench import cache, harness

SIZES = ((48, 32), (64, 48), (176, 144))


def config(name: str, width: int, height: int, gop=None) -> dict:
    with open(cache.HERE / "configs" / f"{name}.json") as f:
        c = json.load(f)
    c.update(name=f"{name}-{width}x{height}", width=width, height=height)
    if gop is not None:
        c["gop"] = gop
    return c


def cell(config_name: str, streams: int, width=48, height=32,
         gop=None) -> harness.Cell:
    with open(cache.ROOT / "BENCHMARK.json") as f:
        manifest = json.load(f)
    traffic = {"streams": streams, "distinct_gops": 2, "loop": "closed",
               "ahead": 1}
    return harness.Cell(f"{config_name}.test", 1,
                        config(config_name, width, height, gop), traffic,
                        manifest["end_to_end"], manifest["per_layer"])
