"""``tools/bench_decode_torch.py``, the port's decode-rate tool, on a tiny
corpus (two videos of 8 frames at 32x48, one pool worker): its line has the
JAX tool's keys plus the host, the usable cores and the codec it wrote, every
rate is positive, the native rate is a number only where the library is
built, the OpenCV rate is OpenCV's even where the native backend is opted
in, and the corpus decodes to JAX's ``tools/bench_decode.py`` corpus frame
for frame. What needs OpenCV skips without it; the rest does not."""

import importlib.util
import json
import os
import socket
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
TINY = ["--height", "32", "--width", "48", "--frames", "8", "--videos", "2"]
JAX_KEYS = {"geometry", "host_cores", "pool_workers", "native_pool_frames_per_s",
            "opencv_frames_per_s"}


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def tool():
    return _load("bench_decode_torch")


@pytest.fixture
def needs_cv2():
    pytest.importorskip("cv2", reason="writing the corpus needs OpenCV")


def _line(tool, capsys, argv=TINY) -> dict:
    assert tool.main(argv) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    return json.loads(out[0])


def test_line_has_the_jax_keys_host_and_codec(tool, needs_cv2, capsys):
    from vimoclip_tpu_torch.data import native

    line = _line(tool, capsys)
    assert set(line) == JAX_KEYS | {"codec", "host", "cpu_model", "usable_cores"}
    assert line["geometry"] == "2x8f @ 32x48 mp4v"
    assert line["codec"] == "mp4v (MPEG-4 Part 2)"
    assert line["host"] == socket.gethostname() and line["cpu_model"]
    assert line["host_cores"] == os.cpu_count()
    assert line["usable_cores"] == len(os.sched_getaffinity(0))
    assert line["pool_workers"] == 1
    assert line["opencv_frames_per_s"] > 0
    rate = line["native_pool_frames_per_s"]
    if native.available():
        assert isinstance(rate, float) and rate > 0
    else:
        assert rate == "unavailable: native data plane not built"


def test_native_rate_is_the_reason_when_the_library_is_missing(tool, needs_cv2, capsys,
                                                                monkeypatch):
    from vimoclip_tpu_torch.data import native

    monkeypatch.setattr(native, "_load", lambda: None)
    line = _line(tool, capsys, TINY + ["--videos", "1"])
    assert line["native_pool_frames_per_s"] == "unavailable: native data plane not built"
    assert line["opencv_frames_per_s"] > 0


def test_opencv_rate_stays_on_opencv_when_native_is_opted_in(tool, needs_cv2, tmp_path,
                                                              monkeypatch):
    """``VIMO_NATIVE_DECODE=1`` would route ``read_video`` to the native
    decoder: the OpenCV rate holds it off, and gives the variable back."""
    from vimoclip_tpu_torch.data import native

    paths = tool.make_corpus(str(tmp_path), 1, 8, 32, 48)
    monkeypatch.setenv("VIMO_NATIVE_DECODE", "1")
    monkeypatch.setattr(native, "available", lambda: True)
    monkeypatch.setattr(native, "read_video", lambda *a, **k: pytest.fail("native decoder"))
    assert tool.bench_opencv(paths) > 0
    assert os.environ["VIMO_NATIVE_DECODE"] == "1"


def test_codec_label_is_the_files_fourcc(tool, needs_cv2, tmp_path):
    """The corpus is MPEG-4 Part 2 (``write_video``'s fourcc mp4v), not
    H.264: the sample entry of the file says so, and OpenCV decodes it with
    FFmpeg's MPEG-4 decoder (FMP4)."""
    import cv2

    (path,) = tool.make_corpus(str(tmp_path), 1, 8, 32, 48)
    data = Path(path).read_bytes()
    at = data.index(b"stsd")  # the tiny file's payload holds no such bytes
    assert data[at + 16:at + 20] == b"mp4v"
    assert tool.fourcc(path) == "mp4v"
    assert tool.codec_label(path) == "mp4v (MPEG-4 Part 2)"
    cap = cv2.VideoCapture(path)
    code = int(cap.get(cv2.CAP_PROP_FOURCC))
    cap.release()
    assert code.to_bytes(4, "little") == b"FMP4"


def _box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + kind + payload


def test_fourcc_reads_the_sample_entry_not_the_payload(tool, tmp_path):
    """The fourcc comes from moov/trak/mdia/minf/stbl/stsd, wherever moov
    sits, and not from bytes of the media data that spell ``stsd``."""
    entry = _box(b"avc1", bytes(78))
    stsd = _box(b"stsd", bytes(4) + struct.pack(">I", 1) + entry)
    moov = _box(b"moov", _box(b"mvhd", bytes(100)) + _box(b"trak", _box(b"tkhd", bytes(84))
                + _box(b"mdia", _box(b"minf", _box(b"stbl", stsd)))))
    decoy = _box(b"mdat", b"\x00" * 5 + b"stsd" + bytes(12) + b"mp4v" + bytes(40))
    path = tmp_path / "v.mp4"
    path.write_bytes(_box(b"ftyp", b"isom" + bytes(4)) + decoy + moov)
    assert tool.fourcc(str(path)) == "avc1"
    assert tool.codec_label(str(path)) == "avc1 (H.264)"
    path.write_bytes(_box(b"ftyp", b"isom" + bytes(4)) + decoy)
    with pytest.raises(ValueError, match="no mp4 sample description"):
        tool.fourcc(str(path))


def test_corpus_decodes_to_the_jax_tools_corpus(tool, needs_cv2, tmp_path, monkeypatch):
    """The port's ``make_corpus`` decoded by the port's ``read_video`` equals
    JAX's ``make_corpus`` decoded by JAX's ``read_video``, frame for frame."""
    from vimoclip_tpu.data.video_reader import read_video as jax_read

    from vimoclip_tpu_torch.data.video_reader import read_video

    monkeypatch.delenv("VIMO_NATIVE_DECODE", raising=False)
    jax_tool = _load("bench_decode")
    for d in ("port", "jax"):
        (tmp_path / d).mkdir()
    ours = tool.make_corpus(str(tmp_path / "port"), 2, 8, 32, 48)
    theirs = jax_tool.make_corpus(str(tmp_path / "jax"), 2, 8, 32, 48)
    for a, b in zip(ours, theirs):
        got, want = read_video(a), jax_read(b)
        assert got.shape == (8, 32, 48, 3)
        np.testing.assert_array_equal(got, want)


def test_without_opencv_it_says_why_and_prints_no_line():
    code = ("import runpy, sys\n"
            "sys.modules['cv2'] = None\n"
            f"sys.argv = ['bench_decode_torch.py'] + {TINY!r}\n"
            f"runpy.run_path({str(ROOT / 'tools' / 'bench_decode_torch.py')!r}, "
            "run_name='__main__')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 1
    assert res.stdout == ""
    assert "cannot write the corpus without OpenCV" in res.stderr


def test_host_info_names_the_host_and_its_usable_cores(tool):
    info = tool.host_info()
    assert info["host"] == socket.gethostname()
    assert info["host_cores"] == os.cpu_count()
    assert 1 <= info["usable_cores"] == len(os.sched_getaffinity(0)) <= os.cpu_count()
    assert info["cpu_model"] and info["cpu_model"] != "unknown"


@pytest.mark.parametrize("name, want", [
    ("Intel(R) Xeon(R) Platinum 8480+", "Intel(R) Xeon(R) Platinum 8480+"),
    ("unknown", "GenuineIntel family 6 model 143 stepping 8")])
def test_cpu_model_falls_back_to_the_cpu_ids(tool, tmp_path, monkeypatch, name, want):
    """A kernel that hides the model name (it reads "unknown") still gives
    the first CPU's vendor, family, model and stepping."""
    info = tmp_path / "cpuinfo"
    info.write_text(f"processor\t: 0\nvendor_id\t: GenuineIntel\ncpu family\t: 6\n"
                    f"model\t\t: 143\nmodel name\t: {name}\nstepping\t: 8\n\n"
                    "processor\t: 1\nmodel name\t: other\n")
    monkeypatch.setattr(tool, "open", lambda path, *a, **k: open(info, *a, **k), raising=False)
    assert tool.cpu_model() == want
