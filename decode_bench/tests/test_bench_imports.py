"""What a run loads: nothing of JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and a
reference that loads nothing of the port; and a run without a CUDA
device exits non-zero with no result."""

import json
import os
import subprocess
import sys

from decode_bench import cache, harness

BANNED = {"jax", "jaxlib", "flax", "m2dec_tpu"}


def _modules(code: str) -> set:
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", f"import sys\nsys.path.insert(0, "
         f"{str(cache.ROOT)!r})\n{code}\nimport json\nprint(json.dumps("
         f"sorted({{m.split('.')[0] for m in sys.modules}})))"],
        cwd=cache.ROOT, env=env, capture_output=True, text=True,
        timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    mods = _modules(
        "import time, torch\n"
        "from decode_bench import harness\n"
        "from decode_bench.tests._small import cell\n"
        "for name in ('h264-main-1080p', 'h265-main-1080p'):\n"
        "    r = harness.run_cell(cell(name, 1), 21, 0.05, False,\n"
        "                         torch.device('cpu'), time.perf_counter())\n"
        "    assert r['correct'], r\n"
        "assert not harness.banned_modules()\n")
    assert "m2dec_tpu_torch" in mods
    assert not mods & BANNED


def test_reference_loads_nothing_of_the_port():
    mods = _modules(
        "from decode_bench import reference, streams\n"
        "from decode_bench.tests._small import config\n"
        "for name in ('h264-main-1080p', 'h265-main-1080p'):\n"
        "    cfg = config(name, 48, 32)\n"
        "    (data,) = streams.make(cfg, 22, 1)\n"
        "    reference.gop_digests(cfg['codec'], data)\n")
    assert "decode_bench" in mods
    assert not mods & (BANNED | {"m2dec_tpu_torch", "torch"})


def test_banned_names_are_whole():
    sys.modules.setdefault("m2dec_tpu_torch", sys)
    assert "m2dec_tpu" not in harness.banned_modules()


def test_no_device_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "decode_bench/run.py", "--workload",
         "h264-main-1080p.s8", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=cache.ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
