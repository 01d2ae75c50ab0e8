#!/usr/bin/env python3
"""Split the device time of the H.265 tile kernel (csrc/h265_tile.cu) on
the card.

Builds the kernel twice: as the main path builds it (library
``h265_tile``) and with ``-DH265_TILE_PROBE`` (library
``h265_tile_probe``), where lane 0 of each of a CTA's two warps adds
clock64() spans per (plane, band) into an int64 buffer [3 * rows, 16]:
warp 0 (the ops) waiting for its inputs, reading neighbour lines,
predicting and storing, and at barriers; warp 1 (the data) issuing the
prefetch copies, waiting for them, listing the next CTU's ops, polling
the band above, waiting on it, reading the line above, writing a CTU
back, and the fence and flag that publish it; then the band's ops, its
cycles, its nanoseconds and its start (%globaltimer). A wait at a
barrier between the two warps ends at the other warp's arrival, stamped
before it arrives: a clock read placed right after the ``bar.sync`` runs
before the barrier releases the warp. Both run on the tile kernel's
inputs of pictures 0 (I) and 1 (P) of bench.py's 1080p
H.265 stream (chip_smoke.py's stream, made and cached as chip_smoke
makes it), captured from one run of the port's Phase B on the card. It
prints, per picture: the kernel's time (CUDA events, median of 20) with
and without the probe, the longest chain of luma and chroma ops
(``wavefront_kernels.op_chain``), and for luma and chroma the mean band's
split per warp in ms and in us per chain op, with the first and the
last band's; then the cost of one op on its chain by size and mode, on
synthetic one-band pictures (no wait on another band), and of a CTU
step with no op. The probe build must give the main build's bytes. The
nvcc report (-Xptxas -v) and the machine code size (cuobjdump) of both
builds are printed too. The result also goes to
build/probe_h265_tile_split.json.

    python3 tools/probe_h265_tile_split.py   # one GPU
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO)]

#: the probe's columns: warp 0's spans (the ops), warp 1's (the data),
#: then the band's ops, cycles (warp 0's), nanoseconds and start
SPANS = (("wait for inputs", "neighbour lines", "predict + store",
          "barriers"),
         ("copies issued", "copies waited", "ops listed", "poll above",
          "wait above", "line above", "write-back", "fence + flag"))
N_SPANS = len(SPANS[0]) + len(SPANS[1])
OPS, CYCLES, NS, START = range(N_SPANS, N_SPANS + 4)
N_COLS = N_SPANS + 4


def h265_stream():
    """bench.py's 1080p H.265 stream, made by chip_smoke's recipe in a
    child process (tests/streamgen imports the JAX package's host
    modules; this process does not) and cached where chip_smoke caches
    it."""
    import chip_smoke as CS

    out = CS.CACHE / CS.H265_STREAM
    if not out.is_file():
        module, expr = CS.STREAMS[CS.H265_STREAM]
        out.parent.mkdir(parents=True, exist_ok=True)
        code = (f"import sys\nsys.path[:0] = [{str(REPO)!r}, "
                f"{str(REPO / 'tests')!r}]\n"
                f"from streamgen.{module} import *\n"
                f"open({str(out)!r}, 'wb').write({expr})\n")
        subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)
    return out.read_bytes()


def sass_size(name):
    """The kernel's machine code size, from cuobjdump -sass of library
    ``name`` (instructions and bytes), or why it is not known."""
    import shutil

    from m2dec_tpu_torch import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        out = subprocess.run([tool, "-sass", str(_build._target(name)[1])],
                             capture_output=True, text=True,
                             timeout=120).stdout
    except OSError as e:
        return f"no SASS size ({e})"
    n = sum(1 for ln in out.splitlines()
            if ln.strip().startswith("/*") and "*/" in ln
            and ln.strip()[2:6].strip("0123456789abcdef") == "")
    return f"{n} SASS instructions ({16 * n} bytes)"


def capture_inputs(data, dev, n):
    """The tile kernel's inputs of the stream's first ``n`` pictures,
    from one run of H265SeqPhaseB on ``dev`` after the native Phase A."""
    import torch

    from m2dec_tpu_torch.codecs.h265 import reconstruct as R
    from m2dec_tpu_torch.codecs.h265 import wavefront_kernels as TK
    from m2dec_tpu_torch.codecs.h265.headers import H265Decoder

    dec = H265Decoder(device=dev)
    dec.set_data(data)
    dec.begin_decode(backend="native", defer_recon=True)
    while dec.decode_picture() == 1:
        pass
    plans = dec.plans
    captured = []
    real = TK.tile_wavefront

    def capturing(*args):
        if len(captured) < n:
            captured.append(tuple(a.clone() if torch.is_tensor(a) else a
                                  for a in args))
        return real(*args)

    TK.tile_wavefront = capturing
    try:
        R.H265SeqPhaseB(plans[0].H, plans[0].W, len(dec.pool),
                        device=dev).run_async(plans)
        torch.cuda.synchronize()
    finally:
        TK.tile_wavefront = real
    return captured


def op_costs(launch, dev, reps=10):
    """The kernel's cost per op on its own chain: synthetic 1920 x 16
    pictures (CTB 16: one band per plane, so the luma chain is every op
    of the band, with no wait on another band), each with one kind of op
    in every slot that fits it, valid counts within what the schedule
    has built; and the cost of a CTU step with no op. Returns [(size,
    mode name, ms, chain ops, us per op)] and the empty run's ms."""
    import numpy as np
    import torch

    from m2dec_tpu_torch.codecs.h265 import reconstruct as R
    from m2dec_tpu_torch.codecs.h265 import wavefront_kernels as TK

    H, W, cl2 = 16, 1920, 4
    C, cols = 1 << cl2, W >> cl2
    rng = np.random.default_rng(0)
    Hc, Wc = H >> 1, W >> 1

    def rand(shape, lo, hi):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(
            np.int32)).to(dev)

    y, ry = rand((H + 33, W + 33), 0, 256), rand((H + 33, W + 33), -20, 20)
    c = rand((2 * R._CR0(Hc), Wc + 17), 0, 256)
    rc = rand((2 * R._CR0(Hc), Wc + 17), -20, 20)
    zc = torch.zeros((cols, 4), dtype=torch.int32, device=dev)
    slots = R._zslot_table(cl2)

    def words(sl2, mode):
        size = 1 << sl2
        z = np.zeros((cols, len(slots)), np.int32)
        for j, (oy, ox, smax) in enumerate(slots):
            if oy % size or ox % size or smax < size:
                continue
            vx = min(2 * size, 2 * C - ox) if oy == 0 else size
            vy = min(2 * size, C - oy)
            z[:, j] = (1 | (sl2 - 2) << R._ZF_SL2 | mode << R._ZF_MODE
                       | vx << R._ZF_VX | vy << R._ZF_VY)
        return torch.from_numpy(z).to(dev)

    def timed(zl):
        times = []
        for _ in range(reps + 2):
            a = (y.clone(), c.clone(), ry, rc, zl, zc, H, W, cl2, False)
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            launch(a)
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times[2:])

    rows = []
    for sl2 in (2, 3, 4):
        for mode, name in ((1, "DC"), (0, "planar"), (26, "vertical"),
                           (18, "angular 18"), (5, "angular 5")):
            zl = words(sl2, mode)
            ms = timed(zl)
            chain = TK.op_chain(zl, cols, 1)
            rows.append((1 << sl2, name, ms, chain, 1e3 * ms / chain))
    return rows, timed(torch.zeros((cols, len(slots)), dtype=torch.int32,
                                   device=dev))


def main(argv=None):
    import numpy as np

    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]
                            ).parse_args(argv)

    import torch

    from m2dec_tpu_torch import _build
    from m2dec_tpu_torch.codecs.h265 import wavefront_kernels as TK

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the probe runs on the card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    lib = _build.load_library("h265_tile")
    plib = _build.load_library("h265_tile_probe")
    print(f"card: {smi}")
    for name in ("h265_tile", "h265_tile_probe"):
        rep = " | ".join(ln.strip() for ln in
                         _build.LAST_BUILD.get(name, "(cached)").splitlines()
                         if "registers" in ln or "spill" in ln)
        print(f"nvcc -Xptxas -v, {name}: {rep}; {sass_size(name)}")
    captured = capture_inputs(h265_stream(), dev, 2)
    H0, W0, cl0 = captured[0][6:9]
    grid = ctypes.c_int(0)
    smem = lib.h265_tile_grid(H0, W0, cl0, ctypes.addressof(grid))
    print(f"grid at {H0} rows, CTB {1 << cl0}: {grid.value} CTAs, "
          f"{smem} bytes of dynamic shared memory each")
    ang = TK._tile_table(dev)

    def launch(a, probe=None):
        y, c, ry, rc, zl, zc, H, W, cl2, strong = a
        progress = TK._band_progress(dev, H >> cl2)
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [t.data_ptr() for t in (y, c, ry, rc, zl, zc)]
        if probe is None:
            err = lib.h265_tile_wavefront(*ptrs, ang.data_ptr(),
                                          progress.data_ptr(), H, W, cl2,
                                          int(bool(strong)), stream)
        else:
            err = plib.h265_tile_wavefront_probe(
                *ptrs, ang.data_ptr(), progress.data_ptr(),
                probe.data_ptr(), H, W, cl2, int(bool(strong)), stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    def fresh(a):
        return (a[0].clone(), a[1].clone(), *a[2:])

    def event_ms(probe, a, reps=20):
        times = []
        for _ in range(reps + 2):
            inputs = fresh(a)
            buf = (None if not probe else torch.zeros(
                (3 * (a[6] >> a[8]), N_COLS), dtype=torch.int64,
                device=dev))
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            launch(inputs, buf)
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times[2:])

    result = {"card": smi, "pictures": []}
    for k, a in enumerate(captured):
        y, c, ry, rc, zl, zc, H, W, cl2, strong = a
        cols, rows = W >> cl2, H >> cl2
        plain = fresh(a)
        launch(plain)
        probed = fresh(a)
        buf = torch.zeros((3 * rows, N_COLS), dtype=torch.int64, device=dev)
        launch(probed, buf)
        torch.cuda.synchronize()
        if not (torch.equal(plain[0], probed[0])
                and torch.equal(plain[1], probed[1])):
            raise RuntimeError(f"picture {k}: the probe build's bytes differ "
                               f"from the main build's")
        ms = [event_ms(False, a), event_ms(True, a), event_ms(True, a),
              event_ms(False, a)]
        kernel_ms = statistics.mean((ms[0], ms[3]))
        probe_ms = statistics.mean((ms[1], ms[2]))
        p = buf.cpu().numpy()
        hz = p[:, CYCLES].sum() / max(p[:, NS].sum(), 1) * 1e9  # per s
        span_ms = ((p[:, START] + p[:, NS]).max() - p[:, START].min()) / 1e6
        chains = {"luma": TK.op_chain(zl, cols, rows),
                  "chroma": TK.op_chain(zc, cols, rows)}
        pic = {"picture": k, "kernel_ms": kernel_ms, "probe_ms": probe_ms,
               "times_ms": ms, "clock_hz": float(hz),
               "probe_span_ms": float(span_ms), "chain_ops": chains,
               "planes": {}}
        print(f"picture {k}: kernel {kernel_ms:.4f} ms, with the probe "
              f"{probe_ms:.4f} ms (CUDA events, median of 20, in turns "
              f"{[round(t, 4) for t in ms]}); probe's launch span "
              f"{span_ms:.4f} ms at {hz / 1e9:.3f} GHz; longest chain "
              f"{chains['luma']} luma and {chains['chroma']} chroma ops; "
              f"{1e3 * kernel_ms / chains['luma']:.3f} us per luma chain op")
        for plane, sel in (("luma", slice(0, None, 3)),
                           ("chroma", [i for i in range(3 * rows)
                                       if i % 3])):
            q = p[sel]
            band_ms = q[:, CYCLES].mean() / hz * 1e3
            chain = chains[plane]
            split = {}
            for w, names in enumerate(SPANS):
                c0 = 0 if w == 0 else len(SPANS[0])
                part = {n: float(q[:, c0 + i].mean() / hz * 1e3)
                        for i, n in enumerate(names)}
                part["other" if w == 0 else "idle"] = (
                    band_ms - sum(part.values()))
                split[f"warp {w}"] = part
            start = (q[:, START] - p[:, START].min()) / 1e6
            dur = q[:, NS] / 1e6
            spread = {"start_ms": [float(np.min(start)),
                                   float(np.median(start)),
                                   float(np.max(start))],
                      "band_ms": [float(np.min(dur)), float(np.median(dur)),
                                  float(np.max(dur))]}
            pic["planes"][plane] = {
                "bands": len(q), "ops": int(q[:, OPS].sum()),
                "band_ms": float(band_ms), "split_ms": split,
                "spread": spread,
                "us_per_chain_op": {w: {n: 1e3 * v / chain
                                        for n, v in part.items()}
                                    for w, part in split.items()}}
            print(f"  {plane}: {len(q)} bands, {int(q[:, OPS].sum())} ops, "
                  f"the mean band {band_ms:.4f} ms; bands start "
                  f"{'/'.join(f'{v:.4f}' for v in spread['start_ms'])} ms "
                  f"after the first and last "
                  f"{'/'.join(f'{v:.4f}' for v in spread['band_ms'])} ms "
                  f"(min/median/max, %globaltimer)")
            for w, part in split.items():
                print(f"    {w}: " + "; ".join(
                    f"{n} {v:.4f} ms ({1e3 * v / chain:.3f} us/chain op)"
                    for n, v in part.items()))
            # the first and the last band, whose end is the kernel's
            ends = {}
            for name, row in (("first", q[0]), ("last", q[-1])):
                ends[name] = {"ops": int(row[OPS]),
                              "band_ms": float(row[CYCLES] / hz * 1e3),
                              "spans_ms": [float(v / hz * 1e3)
                                           for v in row[:N_SPANS]]}
                print(f"    {name} band: {int(row[OPS])} ops, "
                      f"{row[CYCLES] / hz * 1e3:.4f} ms; " + "; ".join(
                          f"{n} {v / hz * 1e3:.4f}" for n, v in
                          zip(SPANS[0] + SPANS[1], row[:N_SPANS])))
            pic["planes"][plane]["ends"] = ends
        result["pictures"].append(pic)
    rows, empty_ms = op_costs(launch, dev)
    result["op_costs"] = {"ops": rows, "empty_ms": empty_ms}
    print(f"per op on one band's chain (1920 x 16, CTB 16, one kind of op "
          f"in every slot; CUDA events, median of 10): " + "; ".join(
              f"{sz}x{sz} {name} {us:.3f} us ({chain} ops, {ms:.4f} ms)"
              for sz, name, ms, chain, us in rows)
          + f"; no op: {empty_ms:.4f} ms for {1920 >> 4} CTU steps "
          f"({1e3 * empty_ms / (1920 >> 4):.3f} us each)")
    out = REPO / "build" / "probe_h265_tile_split.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
