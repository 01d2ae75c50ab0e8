"""The port's entry points on the CPU (``--device cpu``), in-process:
the h264dec / m2dec / thrplay tools, the threaded Pipeline, the PS
demuxer, the terminal displays and decode-state checkpoints, against
the JAX package's paths that compile no JAX graph -- its CLI's flag-less
H.264 and H.265 paths (the serial host decoders), its
``Mpeg2Decoder(backend="numpy")`` and its host-only runtime modules.
Output bytes, MD5 lines, checksum files and stderr lines are compared
exactly."""

import io
import pathlib
import sys

import pytest

import torch_helpers  # noqa: F401  (one torch thread per worker)

sys.path.insert(0, str(pathlib.Path(__file__).parent))

from streamgen.h264_enc import H264BGen  # noqa: E402
from streamgen.h265_enc import H265StreamGen  # noqa: E402
from streamgen.mpeg2_enc import Mpeg2StreamGen  # noqa: E402
from streamgen.ps_mux import mux_ps, mux_ps_aligned  # noqa: E402

from m2dec_tpu.apps import h264dec as jax_h264dec  # noqa: E402
from m2dec_tpu.codecs.h264.decoder import H264Decoder as JaxH264  # noqa: E402
from m2dec_tpu.codecs.mpeg2.decoder import Mpeg2Decoder as JaxMpeg2  # noqa: E402
from m2dec_tpu.runtime import checkpoint as jax_checkpoint  # noqa: E402
from m2dec_tpu.runtime import display as jax_display  # noqa: E402
from m2dec_tpu.runtime.golden import host_cks_file as jax_cks_file  # noqa: E402
from m2dec_tpu.runtime.output import cropped_nv12_bytes as jax_bytes  # noqa: E402
from m2dec_tpu.runtime.output import frame_md5_line as jax_md5  # noqa: E402
from m2dec_tpu_torch.apps import h264dec, m2dec, thrplay  # noqa: E402
from m2dec_tpu_torch.codecs.h264.decoder import H264Decoder  # noqa: E402
from m2dec_tpu_torch.codecs.mpeg2.decoder import Mpeg2Decoder  # noqa: E402
from m2dec_tpu_torch.containers.ps import PsDemuxer  # noqa: E402
from m2dec_tpu_torch.errors import StreamFeatureExcluded  # noqa: E402
from m2dec_tpu_torch.runtime import checkpoint, display  # noqa: E402
from m2dec_tpu_torch.runtime.golden import host_cks_file  # noqa: E402
from m2dec_tpu_torch.runtime.output import cropped_nv12_bytes  # noqa: E402
from m2dec_tpu_torch.runtime import pipeline as pipeline_mod  # noqa: E402
from m2dec_tpu_torch.runtime.pipeline import Pipeline  # noqa: E402

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_apps")
    (d / "b.264").write_bytes(
        H264BGen(80, 48, seed=5, num_ref_frames=2).generate("IPBPBP"))
    es = Mpeg2StreamGen(80, 48, seed=11).generate("IPPBP")
    (d / "mp.m2v").write_bytes(es)
    (d / "mp_es.264").write_bytes(es)  # wrong extension; -m forces MPEG-2
    (d / "mp.mpg").write_bytes(mux_ps_aligned(es))
    (d / "mp.vob").write_bytes(mux_ps(es, packet_size=97))
    (d / "s.265").write_bytes(H265StreamGen(
        64, 48, seed=82, qp=32, cbf_prob=0.4, tmvp=1, deblock=1, sao=1,
        max_level=1).generate("IPBP"))
    return d


def _mpeg2_frames(data, **kw):
    dec = JaxMpeg2(backend="numpy", **kw)
    dec.set_data(data)
    return dec.decode_all()


def _run(cli, monkeypatch, capsys, cwd, args):
    monkeypatch.chdir(cwd)
    code = cli.main(args)
    return code, capsys.readouterr().err


#: port flags -> (input, the JAX CLI's flag-less flags, or None for the
#: JAX numpy MPEG-2 decoder through the same writer)
H264DEC_CASES = {
    "md5": (["-O"], "b.264", ["-O"]),
    "raw": (["-o"], "b.264", ["-o"]),
    "turbo": (["--turbo", "-O"], "b.264", ["-O"]),
    "torch": (["--torch", "-O"], "b.264", ["-O"]),
    "torch_emptify": (["--torch", "-e", "-o"], "b.264", ["-e", "-o"]),
    "skip": (["-f", "2", "-O"], "b.264", ["-f", "2", "-O"]),
    "limit": (["--turbo", "-n", "3", "-O"], "b.264", ["-n", "3", "-O"]),
    "h265": (["-O"], "s.265", ["-O"]),
    "h265_torch": (["--torch", "-o"], "s.265", ["-o"]),
    "mpeg2_forced": (["-m", "-O"], "mp_es.264", None),
    "mpeg2_detected": (["-o"], "mp.m2v", None),
    "ps": (["-s", "-O"], "mp.mpg", None),
    "vob": (["-O"], "mp.vob", None),
}


@pytest.mark.parametrize("case", sorted(H264DEC_CASES))
def test_h264dec_vs_jax(case, streams, monkeypatch, capsys):
    flags, name, jax_flags = H264DEC_CASES[case]
    out = streams / (name.rsplit(".", 1)[0] + ".out")
    out.unlink(missing_ok=True)
    code, err = _run(h264dec, monkeypatch, capsys, streams,
                     flags + CPU + [name])
    assert code == 0
    ours = out.read_bytes()
    out.unlink()
    if jax_flags is None:
        fmt = jax_md5 if "-O" in flags else jax_bytes
        golden = b"".join(fmt(f) for f in _mpeg2_frames(
            (streams / "mp.m2v").read_bytes()))
        assert err == "80 x 48 x 3\n"
    else:
        jcode, jerr = _run(jax_h264dec, monkeypatch, capsys, streams,
                           jax_flags + [name])
        golden = out.read_bytes()
        out.unlink()
        assert (code, err) == (jcode, jerr)
    assert ours and ours == golden
    if case == "skip":
        assert "Skip 0 frames(" in err


def test_h264dec_checksum_mode(streams, monkeypatch, capsys):
    """-C writes one checksum line per frame; it equals host_cks_file
    over the flag-less JAX CLI's raw output (and the JAX package's)."""
    out = streams / "b.out"
    out.unlink(missing_ok=True)
    _run(jax_h264dec, monkeypatch, capsys, streams, ["-o", "b.264"])
    raw = out.read_bytes()
    out.unlink()
    code, _ = _run(h264dec, monkeypatch, capsys, streams,
                   ["-C"] + CPU + ["b.264"])
    assert code == 0
    text = out.read_text()
    out.unlink()
    assert len(text.splitlines()) == 6
    assert text == host_cks_file(raw, 80, 48) == jax_cks_file(raw, 80, 48)


@pytest.mark.parametrize("argv", [
    [], ["-d", "40", "b.264"], ["--bogus", "b.264"], ["missing.264"],
    ["-C", "mp.m2v"], ["-b", "-d", "3"]])
def test_h264dec_usage_errors(argv, streams, monkeypatch, capsys):
    got = _run(h264dec, monkeypatch, capsys, streams, CPU + argv)
    want = _run(jax_h264dec, monkeypatch, capsys, streams, argv)
    assert got == want
    assert got[0] == 1 and got[1].startswith("Usage:")


@pytest.mark.parametrize("fast", [False, True])
def test_m2dec_ps_input(fast, streams, monkeypatch, capsys):
    """m2dec on a program stream (demuxed by the extension), full and
    --fast, against the JAX numpy decoder's frames."""
    args = (["--fast"] if fast else []) + ["-o", "x.raw", "-O", "x.md5"]
    code, err = _run(m2dec, monkeypatch, capsys, streams,
                     args + CPU + ["mp.mpg"])
    assert (code, err) == (0, "5 frames\n")
    want = _mpeg2_frames((streams / "mp.m2v").read_bytes(), fast=fast)
    assert (streams / "x.raw").read_bytes() == b"".join(
        jax_bytes(f) for f in want)
    assert (streams / "x.md5").read_bytes() == b"".join(
        jax_md5(f) for f in want)


def _playlist(flags, streams, monkeypatch, capsys):
    """thrplay -m ``flags`` on [H.264, PS-wrapped MPEG-2, H.265]: checks
    each input's <stem>.out against the JAX serial decoders' MD5 lines
    and the frame count line; returns each Pipeline's (codec, replays)."""
    for stem in ("b", "mp", "s"):
        (streams / f"{stem}.out").unlink(missing_ok=True)
    replays = []
    run = Pipeline.run

    def counted(self, sink):
        n = run(self, sink)
        replays.append((self.codec, self.metrics.count("replays")))
        return n

    monkeypatch.setattr(pipeline_mod.Pipeline, "run", counted)
    code, err = _run(thrplay, monkeypatch, capsys, streams,
                     flags + ["-m"] + CPU + ["b.264", "mp.mpg", "s.265"])
    got = {s: (streams / f"{s}.out").read_bytes() for s in ("b", "mp", "s")}
    assert code == 0
    want = {"mp": b"".join(jax_md5(f) for f in _mpeg2_frames(
        (streams / "mp.m2v").read_bytes()))}
    for stem, name in (("b", "b.264"), ("s", "s.265")):
        _run(jax_h264dec, monkeypatch, capsys, streams, ["-O", name])
        want[stem] = (streams / f"{stem}.out").read_bytes()
    assert got == want
    n = sum(v.count(b"\r\n") for v in got.values())
    assert err == f"{n} frames\n"
    return replays


def test_thrplay_turbo_playlist(streams, monkeypatch, capsys):
    """thrplay --turbo -m: every input decoded by its Turbo driver, with
    no serial replay; -h and -s are usage errors, as in the reference."""
    replays = _playlist(["--turbo"], streams, monkeypatch, capsys)
    assert replays == [("h264", 0), ("mpeg2", 0), ("h265", 0)]
    for argv in (["-s", "b.264"], ["-h", "b.264"], [], ["-f", "2", "b.264"]):
        assert _run(thrplay, monkeypatch, capsys, streams, argv)[0] == 1


def test_thrplay_serial_playlist(streams, monkeypatch, capsys):
    """thrplay -m without --turbo: the Pipeline's serial decoders with
    their Phase B on the given device (H.264 native + torch Phase B,
    H.265 backend="torch", MPEG-2), equal to the JAX serial decoders."""
    replays = _playlist([], streams, monkeypatch, capsys)
    assert replays == [("h264", 0), ("mpeg2", 0), ("h265", 0)]


@pytest.mark.parametrize("mux", [mux_ps_aligned, mux_ps])
def test_ps_demuxer_vs_jax(mux, streams):
    from m2dec_tpu.containers.ps import PsDemuxer as JaxPsDemuxer

    es = (streams / "mp.m2v").read_bytes()
    ps = mux(es)
    got = list(PsDemuxer(ps).video_packets())
    assert got == list(JaxPsDemuxer(ps).video_packets())
    assert PsDemuxer(ps).video_stream() == es


@pytest.mark.parametrize("two_phase", [False, True])
def test_pipeline_metrics(two_phase, streams):
    """Counters of the port's Pipeline, serial and two-phase, on an
    MPEG-2 stream and on the same stream cut mid-picture (the stream of
    the JAX package's tests/test_pipeline.py::test_metrics_counters)."""
    es = Mpeg2StreamGen(64, 48, seed=3).generate("IPP")
    want = [jax_bytes(f) for f in _mpeg2_frames(es)]
    p = Pipeline(es, two_phase=two_phase, device="cpu")
    got = []
    assert p.run(lambda f: got.append(cropped_nv12_bytes(f))) == len(want)
    assert got == want
    snap = p.metrics.snapshot()
    assert snap["bytes_in"] == len(es)
    assert snap["frames_decoded"] == snap["frames_output"] == len(want)
    assert snap.get("decode_errors", 0) == 0
    assert snap["frames_output_per_s"] > 0
    assert all(len(r.split(",")) == 3
               for r in p.timeline_csv().strip().splitlines())
    p2 = Pipeline(es[: len(es) - 40], two_phase=two_phase, device="cpu")
    p2.run(lambda f: None)
    assert p2.metrics.count("decode_errors") >= 1


class _RefusingTurbo:
    """A Turbo driver stand-in that emits the serial decoder's first
    ``n`` frames, then raises ``exc``."""

    n, exc = 2, StreamFeatureExcluded

    def __init__(self, data, device=None):
        dec = Mpeg2Decoder(device=device)
        dec.set_data(data)
        self.head = dec.decode_all()[: self.n]

    def frames(self):
        yield from self.head
        raise self.exc("refused")


@pytest.mark.parametrize("exc", [StreamFeatureExcluded, NotImplementedError,
                                 RuntimeError])
def test_pipeline_replay_only_on_refusal(exc, streams, monkeypatch):
    """A Turbo driver's StreamFeatureExcluded (a stream feature it
    excludes) replays the stream serially without repeating the frames
    already out and counts one replay; any other error -- a plain
    NotImplementedError too, as torch raises for an op with no CUDA
    kernel -- ends the run with that error."""
    from m2dec_tpu_torch.runtime import turbo

    monkeypatch.setattr(_RefusingTurbo, "exc", exc)
    monkeypatch.setattr(turbo, "TurboMpeg2Decoder", _RefusingTurbo)
    es = (streams / "mp.m2v").read_bytes()
    p = Pipeline(es, two_phase=True, device="cpu")
    got = []
    if exc is not StreamFeatureExcluded:
        with pytest.raises(exc, match="refused"):
            p.run(lambda f: got.append(f))
        assert p.metrics.count("replays") == 0
        return
    p.run(lambda f: got.append(cropped_nv12_bytes(f)))
    assert got == [jax_bytes(f) for f in _mpeg2_frames(es)]
    assert p.metrics.count("frames_decoded") == len(got)
    assert p.metrics.count("replays") == 1


def test_h265_mid_row_slices_excluded():
    """The H.265 Turbo driver's Phase B refuses a picture whose slice
    segments start mid-row with StreamFeatureExcluded (the Pipeline's
    replay signal); a row-aligned multi-slice picture is accepted."""
    from types import SimpleNamespace

    from m2dec_tpu_torch.codecs.h265.reconstruct import _slices_of

    with pytest.raises(StreamFeatureExcluded, match="mid-row"):
        _slices_of(SimpleNamespace(multi_slice=True, slice_aligned=False,
                                   slice_rows=[0, 1], rows=3))
    assert _slices_of(SimpleNamespace(
        multi_slice=True, slice_aligned=True, slice_rows=[0, 2],
        rows=3)) == ((0, 2), (2, 3))


def test_pipeline_detects_h264_and_h265(streams):
    for name in ("b.264", "s.265"):
        p = Pipeline((streams / name).read_bytes(), device="cpu")
        assert p.codec == {"264": "h264", "265": "h265"}[name[-3:]]
    assert Pipeline._detect(
        (streams / "mp.mpg").read_bytes()) == "ps"


def test_displays_vs_jax(streams):
    frames = _mpeg2_frames((streams / "mp.m2v").read_bytes())
    for cls, size in (("AnsiDisplay", (20, 10)), ("AsciiDisplay", (40, 12))):
        ours, ref = io.StringIO(), io.StringIO()
        d = getattr(display, cls)(out=ours, max_size=size)
        r = getattr(jax_display, cls)(out=ref, max_size=size)
        for f in frames[:2]:  # the second repaints in place
            d.show(f)
            r.show(f)
        assert ours.getvalue() == ref.getvalue() and ours.getvalue()
    assert display.make_display("none") is None


def _drain(dec, out, is_end=False):
    ready, frm = dec.peek_decoded_frame(is_end)
    while ready:
        dec.get_decoded_frame(is_end)
        out.append(cropped_nv12_bytes(frm))
        ready, frm = dec.peek_decoded_frame(is_end)


def _resumed(make, step, data, k):
    """Decode k pictures, checkpoint, resume in a new decoder from the
    blob; returns every frame's bytes."""
    dec = make()
    dec.set_data(data)
    out = []
    for _ in range(k):
        _drain(dec, out)
        assert getattr(dec, step)() == 1
    blob, pos = checkpoint.save(dec)
    assert 0 < pos < len(data)
    dec = checkpoint.load(blob)
    dec.set_data(data[pos:])
    while True:
        _drain(dec, out)
        if getattr(dec, step)() < 0:
            _drain(dec, out, True)
            return out


@pytest.mark.parametrize("codec,k", [("h264", 2), ("h264", 3),
                                     ("mpeg2", 2), ("mpeg2", 4)])
def test_checkpoint_resume_mid_gop(codec, k, streams):
    if codec == "h264":
        data = (streams / "b.264").read_bytes()
        make, step = H264Decoder, "decode_picture"
        ref = JaxH264()
    else:
        data = (streams / "mp.m2v").read_bytes()
        make, step = (lambda: Mpeg2Decoder(device="cpu")), "decode_data"
        ref = JaxMpeg2(backend="numpy")
    ref.set_data(data)
    want = [jax_bytes(f) for f in ref.decode_all()]
    assert _resumed(make, step, data, k) == want


def test_checkpoint_blobs_not_interchangeable(streams):
    """A port blob is refused by the JAX package's load, and a JAX blob
    by the port's, before either unpickles."""
    data = (streams / "b.264").read_bytes()
    ours, theirs = H264Decoder(), JaxH264()
    for d in (ours, theirs):
        d.set_data(data)
        assert d.decode_picture() == 1
    blob, _ = checkpoint.save(ours)
    jblob, _ = jax_checkpoint.save(theirs)
    assert type(checkpoint.load(blob)) is H264Decoder
    with pytest.raises(ValueError, match="bad magic"):
        jax_checkpoint.load(blob)
    with pytest.raises(ValueError, match="bad magic"):
        checkpoint.load(jblob)
    v = bytearray(blob)
    v[len(checkpoint.MAGIC)] ^= 1
    with pytest.raises(ValueError, match="format"):
        checkpoint.load(bytes(v))


def test_h264_phase_b_torch_vs_np(streams):
    """H264Decoder(native=True, phase_b="torch") on the CPU gives the
    JAX serial decoder's frames; any other Phase B name raises."""
    data = (streams / "b.264").read_bytes()
    ref = JaxH264()
    ref.set_data(data)
    want = [jax_bytes(f) for f in ref.decode_all()]
    dec = H264Decoder(native=True, phase_b="torch", device="cpu")
    dec.set_data(data)
    assert [cropped_nv12_bytes(f) for f in dec.decode_all()] == want
    for phase_b in ("jax", "np"):
        with pytest.raises(ValueError):
            H264Decoder(native=True, phase_b=phase_b)
