"""The port's motion generation against the JAX package's on the CPU:
frame-diff videos (the difference through ``frame_diff`` on a device, and
OpenCV on the host) and Farneback flow videos decode bit for bit equal; the
ptlflow adapter gives the same flow on an offline stand-in for RAFT
(ptlflow and its weights are not installed); ``process_video_list``, and the
``generate_motion`` and ``extract_frames`` CLIs."""

import os

import numpy as np
import pytest
import torch

import vimoclip_tpu.motion as jm
import vimoclip_tpu_torch.motion as tm
from vimoclip_tpu.cli.extract_frames import main as jax_extract_frames
from vimoclip_tpu.cli.generate_motion import main as jax_generate_motion
from vimoclip_tpu.data.video_reader import read_video, write_video
from vimoclip_tpu_torch.cli import extract_frames, generate_motion

torch.set_num_threads(1)


class TinyFlowNet(torch.nn.Module):
    """ptlflow-interface model with an analytic output: flow_x = 8 * mean of
    the second image, flow_y = -8 * mean of the first."""

    def forward(self, inputs):
        images = inputs["images"]  # (1, 2, 3, H, W)
        assert images.shape[3] % 8 == 0 and images.shape[4] % 8 == 0
        assert float(images.max()) <= 1.0 + 1e-6
        fx = images[:, 1].mean(dim=1, keepdim=True) * 8.0
        fy = images[:, 0].mean(dim=1, keepdim=True) * -8.0
        return {"flows": torch.stack([fx, fy], dim=2)}


class RedOnly(torch.nn.Module):
    """Channel-asymmetric: sees only RGB channel 0."""

    def forward(self, inputs):
        f = inputs["images"][:, :, 0].mean(dim=1, keepdim=True)
        return {"flows": torch.stack([f, 2 * f], dim=2)}


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    """A 140-frame video (two 129-frame device round trips), a short one in a
    subdirectory, and an unreadable file."""
    root = tmp_path_factory.mktemp("rgb")
    rng = np.random.default_rng(0)
    write_video(str(root / "long.mp4"), rng.integers(0, 256, (140, 32, 48, 3), dtype=np.uint8))
    (root / "sub").mkdir()
    write_video(str(root / "sub" / "short.mp4"),
                rng.integers(0, 256, (5, 36, 64, 3), dtype=np.uint8))
    (root / "bad.mp4").write_bytes(b"not a video")
    return root


@pytest.mark.parametrize("ours, theirs", [("cpu", True), (None, False)],
                         ids=["device", "host"])
@pytest.mark.parametrize("name", ["long.mp4", "sub/short.mp4"])
def test_frame_diff_video_matches_jax(videos, tmp_path, ours, theirs, name):
    src = str(videos / name)
    a, b = str(tmp_path / "ours.mp4"), str(tmp_path / "jax.mp4")
    n = tm.generate_frame_diff_video(src, a, device=ours)
    assert n == jm.generate_frame_diff_video(src, b, on_device=theirs)
    assert n == read_video(src).shape[0] - 1
    got, want = read_video(a), read_video(b)
    assert got.shape == want.shape and got.shape[0] == n
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("device", ["cpu", None], ids=["device", "host"])
def test_frame_diff_unreadable_input_raises(videos, tmp_path, device):
    for mod, kw in ((tm, {"device": device}), (jm, {"on_device": device is not None})):
        with pytest.raises(IOError, match="could not open"):
            mod.generate_frame_diff_video(str(videos / "bad.mp4"), str(tmp_path / "x.mp4"),
                                          **kw)


def test_farneback_flow_video_matches_jax(videos, tmp_path):
    src = str(videos / "sub" / "short.mp4")
    a, b = str(tmp_path / "ours.mp4"), str(tmp_path / "jax.mp4")
    assert tm.generate_optical_flow_video(src, a) == jm.generate_optical_flow_video(src, b) == 4
    np.testing.assert_array_equal(read_video(a), read_video(b))
    rng = np.random.default_rng(3)
    prev, cur = (rng.integers(0, 256, (24, 40), dtype=np.uint8) for _ in range(2))
    flow = tm.farneback_flow(prev, cur)
    np.testing.assert_array_equal(flow, jm.farneback_flow(prev, cur))
    np.testing.assert_array_equal(tm.flow_to_hsv_bgr(flow), jm.flow_to_hsv_bgr(flow))


@pytest.mark.parametrize("model", [TinyFlowNet, RedOnly])
@pytest.mark.parametrize("hw", [(30, 41), (16, 16)], ids=["padded", "aligned"])
def test_ptlflow_adapter_matches_jax(model, hw):
    ours, theirs = tm.PtlflowAdapter(model(), device="cpu"), jm.PtlflowAdapter(model())
    assert ours.wants_color and ours.device == torch.device("cpu")
    rng = np.random.default_rng(0)
    prev, cur = (rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for _ in range(2))
    flow = ours(prev, cur)
    assert flow.shape == (*hw, 2) and flow.dtype == np.float32
    np.testing.assert_array_equal(flow, theirs(prev, cur))
    if model is TinyFlowNet:
        np.testing.assert_allclose(flow[..., 0], cur.mean(axis=2) / 255.0 * 8.0, atol=1e-5)


def test_ptlflow_adapter_rgb_order_matters():
    bgr = np.zeros((16, 16, 3), np.uint8)
    bgr[..., 2] = 255  # red is BGR channel 2, RGB channel 0
    np.testing.assert_allclose(tm.PtlflowAdapter(RedOnly(), device="cpu")(bgr, bgr)[..., 0],
                               1.0, atol=1e-6)
    bgr = bgr[..., ::-1].copy()  # now blue
    np.testing.assert_allclose(tm.PtlflowAdapter(RedOnly(), device="cpu")(bgr, bgr), 0.0)


def test_load_flow_backend_factory(tmp_path):
    assert tm.load_flow_backend("farneback") is tm.farneback_flow
    with pytest.raises(ValueError):
        tm.load_flow_backend("nope")
    with pytest.raises(ImportError):  # no ptlflow and no weights
        tm.load_flow_backend("raft", device="cpu")
    weights = str(tmp_path / "tiny_raft.pt")
    torch.save(TinyFlowNet(), weights)
    fn = tm.load_flow_backend("raft", weights=weights, device="cpu")
    assert isinstance(fn, tm.PtlflowAdapter)
    bad = str(tmp_path / "sd.pt")
    torch.save({"some": torch.zeros(2)}, bad)
    with pytest.raises(TypeError, match="torch module"):
        tm.load_flow_backend("raft", weights=bad, device="cpu")


def test_raft_flow_video_matches_jax(videos, tmp_path):
    src = str(videos / "sub" / "short.mp4")
    a, b = str(tmp_path / "ours.mp4"), str(tmp_path / "jax.mp4")
    n = tm.generate_optical_flow_video(src, a, flow_fn=tm.PtlflowAdapter(TinyFlowNet(),
                                                                         device="cpu"))
    assert n == jm.generate_optical_flow_video(src, b, jm.PtlflowAdapter(TinyFlowNet())) == 4
    np.testing.assert_array_equal(read_video(a), read_video(b))


@pytest.mark.parametrize("kind", ["frame_diff", "flow"])
def test_process_video_list_matches_jax(videos, tmp_path, kind):
    lst = tmp_path / "list.txt"
    lst.write_text("sub/short.mp4\n\nbad.mp4\nmissing.mp4\n")
    out, jout = tmp_path / "ours", tmp_path / "jax"
    errors = tm.process_video_list(str(lst), str(videos), str(out), kind=kind, device="cpu")
    assert errors.keys() == jm.process_video_list(str(lst), str(videos), str(jout),
                                                  kind=kind).keys()
    assert set(errors) == {"bad.mp4", "missing.mp4"}
    np.testing.assert_array_equal(read_video(str(out / "sub" / "short.mp4")),
                                  read_video(str(jout / "sub" / "short.mp4")))
    # skip_existing: a present output is not regenerated
    stamp = os.path.getmtime(out / "sub" / "short.mp4")
    (out / "bad.mp4").write_bytes(b"")
    assert tm.process_video_list(str(lst), str(videos), str(out), kind=kind,
                                 device="cpu") == {"missing.mp4": errors["missing.mp4"]}
    assert os.path.getmtime(out / "sub" / "short.mp4") == stamp
    assert set(tm.process_video_list(str(lst), str(videos), str(out), kind=kind,
                                     skip_existing=False, device="cpu")) == set(errors)


@pytest.mark.parametrize("extra", [[], ["--kind", "flow"],
                                   ["--kind", "flow", "--flow-backend", "raft"]],
                         ids=["frame-diff", "farneback", "raft"])
def test_generate_motion_cli_matches_jax(videos, tmp_path, extra, capsys):
    lst = tmp_path / "list.txt"
    lst.write_text("sub/short.mp4\nbad.mp4\n")
    if "raft" in extra:
        torch.save(TinyFlowNet(), tmp_path / "tiny_raft.pt")
        extra = extra + ["--flow-weights", str(tmp_path / "tiny_raft.pt")]
    common = ["--list-file", str(lst), "--input-dir", str(videos)]
    generate_motion.main(common + ["--output-dir", str(tmp_path / "ours"),
                                   "--device", "cpu"] + extra)
    ours = capsys.readouterr().out
    jax_generate_motion(common + ["--output-dir", str(tmp_path / "jax")] + extra)
    assert ours == capsys.readouterr().out == "1 videos failed\n"
    got = read_video(str(tmp_path / "ours" / "sub" / "short.mp4"))
    assert got.shape[0] == 4
    np.testing.assert_array_equal(got, read_video(str(tmp_path / "jax" / "sub" / "short.mp4")))


def test_extract_frames_cli_matches_jax(videos, tmp_path, capsys):
    rgb = str(videos / "sub" / "short.mp4")
    diff = str(tmp_path / "diff.mp4")
    tm.generate_frame_diff_video(rgb, diff, device=None)
    args = ["--rgb", rgb, "--frame-diff", diff, "--num-frames", "3"]
    extract_frames.main(args + ["--out-dir", str(tmp_path / "ours")])
    jax_extract_frames(args + ["--out-dir", str(tmp_path / "jax")])
    names = sorted(os.listdir(tmp_path / "ours"))
    assert names == sorted(os.listdir(tmp_path / "jax")) and len(names) == 6
    for name in names:
        assert (tmp_path / "ours" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert extract_frames.save_aligned_frames({"rgb": rgb}, str(tmp_path / "one"), 2) == [
        str(tmp_path / "one" / "rgb_00_frame0000.jpg"),
        str(tmp_path / "one" / "rgb_01_frame0004.jpg")]
    assert "saved 6 frames" in capsys.readouterr().out
