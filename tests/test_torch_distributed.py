"""The port's multi-device decode over two processes: two gloo ranks run
the cross-GOP DPB exchange step and the MB-row band step
(tests/distributed/torch_worker.py, which imports no jax). Each process
has its own 60 s timeout; the parent kills both on a failure."""

import pathlib
import socket
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent))

from streamgen.h264_enc import H264InterGen  # noqa: E402


def test_two_process_exchange_and_bands(tmp_path):
    stream = tmp_path / "bands.264"
    stream.write_bytes(H264InterGen(48, 64, seed=3, intra_prob=0.35,
                                    num_ref_frames=2,
                                    disable_deblock=False).generate("IP"))
    worker = pathlib.Path(__file__).parent / "distributed" / "torch_worker.py"
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(i), port, str(stream)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=60)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-2000:]}"
        assert f"proc {i} OK" in out
