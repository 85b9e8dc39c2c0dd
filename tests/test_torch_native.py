"""The port's ctypes wrapper of the C++ libav data plane
(``vimoclip_tpu_torch/data/native.py``) against the JAX package's wrapper of
the same ``native/libvimo_dataplane.so``, and the native backends of the
port's ``data/video_reader.py`` and ``ClipExtractor``. The tests that need
the library skip until ``make native`` has built it, as
``tests/test_native_dataplane.py`` does; one test always runs."""

import numpy as np
import pytest
import torch

from vimoclip_tpu.data import native as jax_native
from vimoclip_tpu.data.video_reader import write_video
from vimoclip_tpu_torch.data import native, video_reader
from vimoclip_tpu_torch.extraction import ClipExtractor
from vimoclip_tpu_torch.models import init_parameters_
from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig, ClipVisionEncoder

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def built():
    if not native.available():
        pytest.skip("native data plane not built (make native)")


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    d = tmp_path_factory.mktemp("native")
    rng = np.random.default_rng(0)
    paths = []
    for i, (t, h, w) in enumerate(((20, 36, 64), (13, 32, 48), (7, 36, 64))):
        path = str(d / f"v{i}.mp4")
        write_video(path, rng.integers(0, 256, (t, h, w, 3), dtype=np.uint8))
        paths.append(path)
    return paths


def _opencv(path):
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(f, cv2.COLOR_BGR2RGB))
    cap.release()
    return np.stack(frames)


def test_without_the_library_reads_with_opencv(videos, monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib_path", lambda: str(tmp_path / "missing.so"))
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setenv("VIMO_NATIVE_DECODE", "1")
    assert not native.available()
    assert video_reader._native_backend() is None
    np.testing.assert_array_equal(video_reader.read_video(videos[0]), _opencv(videos[0]))
    np.testing.assert_array_equal(video_reader.read_video_window(videos[0], 3, 4),
                                  _opencv(videos[0])[3:7])
    with pytest.raises(RuntimeError, match="not built"):
        native.DecodePool()


def test_library_path_is_the_jax_packages():
    assert native._lib_path() == jax_native._lib_path()


@pytest.mark.parametrize("max_frames", [None, 5])
def test_whole_video_matches_jax_wrapper(built, videos, max_frames):
    for path in videos:
        got = native.read_video(path, max_frames=max_frames)
        np.testing.assert_array_equal(got, jax_native.read_video(path, max_frames=max_frames))
        np.testing.assert_array_equal(got, _opencv(path)[:max_frames])


def test_windows_match_jax_wrapper(built, videos):
    for start, n in ((0, 4), (7, 5), (18, 5), (19, 1)):
        got = native.read_video_window(videos[0], start, n)
        np.testing.assert_array_equal(got, jax_native.read_video_window(videos[0], start, n))
    assert got.shape[0] == 1  # clamped at the end
    d = native._Decoder(videos[1])
    try:
        assert (d.width, d.height) == (48, 32) and d.frame_count() == 13
        a, b = d.read_window(0, 4), d.read_window(4, 4)  # on, without a seek
    finally:
        d.close()
    np.testing.assert_array_equal(np.concatenate([a, b]), _opencv(videos[1])[:8])
    with pytest.raises(IOError):
        native.read_video("/nonexistent.mp4")


def _pool_blocks(module, videos, chunk):
    with module.DecodePool(workers=2, chunk_frames=chunk, max_ready=2) as pool:
        for i, path in enumerate(videos + ["/nonexistent.mp4"]):
            pool.submit(f"v{i}", path)
        pool.seal()
        out: dict = {}
        for vid, frames, final, error in pool:
            out.setdefault(vid, []).append((frames, final, error))
    return out


def test_decode_pool_matches_jax_wrapper(built, videos):
    got, ref = _pool_blocks(native, videos, 8), _pool_blocks(jax_native, videos, 8)
    assert got.keys() == ref.keys()
    for vid in got:
        assert [(f.shape, fin, err) for f, fin, err in got[vid]] == \
               [(f.shape, fin, err) for f, fin, err in ref[vid]]
        for (a, _, _), (b, _, _) in zip(got[vid], ref[vid]):
            np.testing.assert_array_equal(a, b)
    for i, path in enumerate(videos):
        blocks = got[f"v{i}"]
        assert [fin for _, fin, _ in blocks] == [False] * (len(blocks) - 1) + [True]
        np.testing.assert_array_equal(np.concatenate([f for f, _, _ in blocks]),
                                      _opencv(path))
    assert got[f"v{len(videos)}"][-1][1:] == (True, "could not open video")


def test_read_video_takes_the_native_backend_when_opted_in(built, videos, monkeypatch):
    calls = []
    real = native.read_video
    monkeypatch.setattr(native, "read_video", lambda *a, **k: calls.append(a) or real(*a, **k))
    monkeypatch.setenv("VIMO_NATIVE_DECODE", "0")
    first = video_reader.read_video(videos[1])
    monkeypatch.setenv("VIMO_NATIVE_DECODE", "1")
    np.testing.assert_array_equal(video_reader.read_video(videos[1]), first)
    assert calls == [(videos[1],)]


def test_extractor_native_pool_equals_thread_backend(built, videos, monkeypatch):
    cfg = ClipVisionConfig(image_size=32, patch_size=8, hidden_size=32, num_layers=1,
                           num_heads=2, intermediate_size=64, projection_dim=16)
    enc = init_parameters_(ClipVisionEncoder(cfg), torch.Generator().manual_seed(0))
    jobs = [(f"v{i}", p) for i, p in enumerate(videos)] + [("bad", "/nonexistent.mp4")]
    out = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("VIMO_NATIVE_DECODE", flag)
        extractor = ClipExtractor(enc.state_dict(), cfg, batch_size=8,
                                  half_precision=False, decode_workers=2, device="cpu")
        started = []
        real_pump = extractor._pump_native
        extractor._pump_native = lambda *a: started.append(1) or real_pump(*a)
        done = {}
        errors = extractor.extract(jobs, lambda vid, emb: done.__setitem__(vid, emb))
        out[flag] = done, errors
        assert started == ([1] if flag == "1" else [])
    (emb0, err0), (emb1, err1) = out["0"], out["1"]
    assert {k for k, v in emb0.items() if v is not None} == {"v0", "v1", "v2"}
    assert emb0.keys() == emb1.keys()
    assert set(err0) == set(err1) == {"bad"}
    for vid in ("v0", "v1", "v2"):
        assert emb0[vid].shape == (len(video_reader.read_video(videos[int(vid[1])])), 16)
        np.testing.assert_array_equal(emb0[vid], emb1[vid])
