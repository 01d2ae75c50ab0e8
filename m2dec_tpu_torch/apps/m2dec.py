"""MPEG-1/2 decoder CLI (reference src/app/m2dec.cpp parity), with Phase
B on the card.

Usage: python -m m2dec_tpu_torch.apps.m2dec [-o out | -O out] [-n N]
                                            [--fast] [--device DEV]
                                            <in.m2v|in.vob>
  -o  raw NV12 output      -O  per-frame MD5 lines (test.sh format)
  -n  decode at most N frames
  --fast    DC-only 1/8-scale preview decode (the reference's
            --enable-fastdec compile mode as a runtime switch)
  --device  where Phase B runs: the CUDA device by default, ``cpu`` on
            request
Program streams (.vob/.mpg/.ps) are demuxed (containers/ps.py).
"""

from __future__ import annotations

import argparse
import pathlib
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="m2dec")
    ap.add_argument("-o", dest="raw_out")
    ap.add_argument("-O", dest="md5_out")
    ap.add_argument("-n", dest="frames", type=int, default=0)
    ap.add_argument("--fast", action="store_true",
                    help="DC-only 1/8-scale preview decode")
    ap.add_argument("--device", default=None,
                    help="where Phase B runs (default: the CUDA device)")
    ap.add_argument("infile")
    args = ap.parse_args(argv)

    from ..codecs.mpeg2.decoder import Mpeg2Decoder
    from ..runtime.output import cropped_nv12_bytes, frame_md5_line

    data = pathlib.Path(args.infile).read_bytes()
    if args.infile.lower().endswith((".vob", ".mpg", ".ps")):
        from ..containers.ps import PsDemuxer

        data = PsDemuxer(data).video_stream()
    dec = Mpeg2Decoder(device=args.device, fast=args.fast)
    dec.set_data(data)
    raw = open(args.raw_out, "wb") if args.raw_out else None
    md5 = open(args.md5_out, "wb") if args.md5_out else None
    n = 0
    for frame in dec.decode_all():
        if raw:
            raw.write(cropped_nv12_bytes(frame))
        if md5:
            md5.write(frame_md5_line(frame))
        n += 1
        if args.frames and n >= args.frames:
            break
    for f in (raw, md5):
        if f:
            f.close()
    print(f"{n} frames", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
