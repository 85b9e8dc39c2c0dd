"""The port's serving daemon (``vimoclip_tpu_torch/cli/serve.py``) on the CPU:
the behaviours ``tests/test_serve.py`` pins for the JAX daemon, with the
same stub and recording predictors, and the port's daemon and
``predict_batch`` against the JAX package's on the same seeded inputs."""

import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from vimoclip_tpu.cli import serve as jax_serve
from vimoclip_tpu.config import TFAMModelConfig as JTFAMConfig
from vimoclip_tpu.data.video_reader import write_video
from vimoclip_tpu.models import TFAM as JTFAM
from vimoclip_tpu.models.clip_convert import clip_vision_params_from_openai
from vimoclip_tpu.models.clip_vit import ClipVisionConfig as JVision
from vimoclip_tpu.models.clip_vit import ClipVisionEncoder as JEncoder
from vimoclip_tpu.models.torch_compat import tfam_params_from_torch
from vimoclip_tpu.serving import ViMoCLIPPredictor as JPredictor
from vimoclip_tpu_torch.cli import serve
from vimoclip_tpu_torch.cli.serve import (
    _SHUTDOWN,
    DynamicBatcher,
    Overloaded,
    RequestTimeout,
    _PendingVideo,
    handle_request,
    make_http_server,
    prediction_record,
    serve_http,
    serve_stdin,
)
from vimoclip_tpu_torch.config import TFAMModelConfig
from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig
from vimoclip_tpu_torch.models.convert import clip_vision_state_from_jax, tfam_state_from_jax
from vimoclip_tpu_torch.serving import ViMoCLIPPredictor

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VGEOM = dict(image_size=32, patch_size=8, hidden_size=32, num_layers=1,
             num_heads=2, intermediate_size=64, projection_dim=16)
TGEOM = dict(d_model=16, nhead=2, num_layers=1, dim_feedforward=32,
             dropout=0.0, mlp_dropout=0.0, attention_impl="xla")
C = 7
NAMES = {0: "eat", 1: "swim"}


@pytest.fixture(scope="module")
def weights():
    enc = JEncoder(JVision(**VGEOM))
    tp = enc.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"]
    sp = enc.init(jax.random.key(1), jnp.zeros((1, 32, 32, 3)))["params"]
    fp = JTFAM(config=JTFAMConfig(**TGEOM), num_classes=C).init(
        jax.random.key(2), jnp.zeros((1, 4, 16)), jnp.zeros((1, 3, 16)),
        jnp.ones((1, 4), bool), jnp.ones((1, 3), bool))["params"]
    return tp, sp, fp


@pytest.fixture(scope="module")
def jax_predictor(weights):
    tp, sp, fp = weights
    return JPredictor(
        teacher_params=tp, teacher_config=JVision(**VGEOM), student_params=sp,
        student_config=JVision(**VGEOM), tfam_params=fp,
        tfam_config=JTFAMConfig(**TGEOM), num_classes=C, class_names=NAMES,
        frame_batch=8, length_bucket=8, half_precision=False)


@pytest.fixture(scope="module")
def predictor(weights):
    tp, sp, fp = weights
    cfg = ClipVisionConfig(**VGEOM)
    return ViMoCLIPPredictor(
        teacher_state=clip_vision_state_from_jax(tp, cfg, prefix=""), teacher_config=cfg,
        student_state=clip_vision_state_from_jax(sp, cfg, prefix=""), student_config=cfg,
        tfam_state=tfam_state_from_jax(fp, 1), tfam_config=TFAMModelConfig(**TGEOM),
        num_classes=C, class_names=NAMES, frame_batch=8, length_bucket=8,
        half_precision=False, device="cpu")


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_daemon")
    rng = np.random.default_rng(0)
    paths = []
    for i, t in enumerate((11, 9)):
        p = str(d / f"clip{i}.mp4")
        write_video(p, rng.integers(0, 256, (t, 36, 48, 3), dtype=np.uint8))
        paths.append(p)
    return paths


def _motion(path, seed, t=10):
    write_video(path, np.random.default_rng(seed).integers(0, 256, (t, 36, 48, 3),
                                                            dtype=np.uint8))
    return path


def _serve_forever(server):
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return thread


def _post(url, payload, timeout=120):
    body = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.load(r), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e), dict(e.headers)


# --------------------------------------------------------------------------
# against the JAX package
# --------------------------------------------------------------------------


def test_predict_batch_matches_jax(predictor, jax_predictor, videos):
    ref = jax_predictor.predict_batch(videos, top_k=4, max_frames=10)
    got = predictor.predict_batch(videos, top_k=4, max_frames=10)
    for g, r, v in zip(got, ref, videos):
        assert g.video_id == r.video_id == v
        np.testing.assert_allclose(g.probabilities, r.probabilities, atol=1e-4, rtol=0)
        assert [c for c, _, _ in g.top_classes] == [c for c, _, _ in r.top_classes]
    # pooled == each clip alone
    for g, v in zip(got, videos):
        solo = predictor.predict_batch([v], top_k=4, max_frames=10)[0]
        np.testing.assert_allclose(g.probabilities, solo.probabilities, atol=1e-6, rtol=0)


def test_stdin_daemon_matches_jax_daemon(predictor, jax_predictor, videos, tmp_path):
    motion = _motion(str(tmp_path / "motion.mp4"), 1)
    reqs = [
        {"video": videos[0], "top_k": 3},
        {"videos": videos, "top_k": 2},
        {"video": "/nonexistent.mp4"},
        {"video": videos[1], "motion_video": motion, "top_k": 4},
        {"videos": videos, "motion_videos": {videos[1]: motion}, "max_frames": 8},
        {"video": videos[1]},
    ]
    text = "\n".join(json.dumps(r) for r in reqs)
    outs = []
    for module, pred in ((jax_serve, jax_predictor), (serve, predictor)):
        out = io.StringIO()
        assert module.serve_stdin(pred, io.StringIO(text), out) == len(reqs)
        outs.append([json.loads(line) for line in out.getvalue().splitlines()])
    ref, got = outs
    assert got == ref
    assert "error" in got[2]
    # the records' probabilities come from raw ones within 1e-4 of JAX's
    for kw in ({}, {"motion_video_path": motion}):
        a = jax_predictor.predict(videos[1], **kw).probabilities
        b = predictor.predict(videos[1], **kw).probabilities
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=0)


def _reference_files(weights, tmp_path):
    """The three stages' weights as reference-format ``.pth`` files and a
    stage-2 YAML; returns the model flags and the JAX predictor built from
    the same files (``**approx`` on both towers' configs)."""
    tp, sp, fp = weights
    cfg = ClipVisionConfig(**VGEOM)
    teacher = {f"visual.{k}": torch.from_numpy(np.array(v))
               for k, v in clip_vision_state_from_jax(tp, cfg, prefix="").items()}
    student = {f"module.visual_encoder.{k}": torch.from_numpy(np.array(v))
               for k, v in clip_vision_state_from_jax(sp, cfg, prefix="").items()}
    tfam = {k: torch.from_numpy(np.array(v)) for k, v in tfam_state_from_jax(fp, 1).items()}
    paths = {n: str(tmp_path / f"{n}.pth") for n in ("teacher", "student", "tfam")}
    torch.save(teacher, paths["teacher"])
    torch.save(student, paths["student"])
    torch.save({"state_dict": tfam}, paths["tfam"])
    classes = tmp_path / "classes.csv"
    classes.write_text("id,name\n0,eat\n1,swim\n")
    config = tmp_path / "cfg.yaml"
    config.write_text(yaml.safe_dump({
        "data": {"num_classes": C, "length_bucket": 8, "class_names_dir": str(classes)},
        "model": TGEOM}))
    flags = ["--teacher-weights", paths["teacher"],
             "--student-torch-checkpoint", paths["student"],
             "--tfam-torch-checkpoint", paths["tfam"], "--tfam-config", str(config),
             "--device", "cpu", "--float32", "--frame-batch", "8"]

    def jax_predictor(**approx):
        # checkpoints carry no head count: the loaders infer max(1, hidden // 64)
        jvision = JVision(**(VGEOM | {"num_heads": 1}), **approx)
        return JPredictor(
            teacher_params=clip_vision_params_from_openai(
                {k: v.numpy() for k, v in teacher.items()}, jvision),
            teacher_config=jvision,
            student_params=clip_vision_params_from_openai(
                {k.replace("module.visual_encoder.", "visual."): v.numpy()
                 for k, v in student.items()}, jvision),
            student_config=jvision,
            tfam_params=tfam_params_from_torch({k: v.numpy() for k, v in tfam.items()},
                                               num_layers=1, d_model=16),
            tfam_config=JTFAMConfig(**TGEOM), num_classes=C, class_names=NAMES,
            frame_batch=8, length_bucket=8, half_precision=False)

    return flags, jax_predictor


def test_serve_main_stdin_on_reference_checkpoints(weights, videos, tmp_path,
                                                   monkeypatch, capsys):
    """``main`` builds the predictor from reference-format files and answers
    stdin lines as the JAX daemon answers them."""
    flags, jax_predictor = _reference_files(weights, tmp_path)
    lines = [{"video": videos[0], "top_k": 3}, {"videos": videos}]
    text = "\n".join(map(json.dumps, lines))
    monkeypatch.setattr(sys, "stdin", io.StringIO(text))
    serve.main(flags)
    got = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    out = io.StringIO()
    jax_serve.serve_stdin(jax_predictor(), io.StringIO(text), out)
    assert got == [json.loads(line) for line in out.getvalue().splitlines()]
    assert len(got[0]["predictions"]) == 3


@pytest.mark.parametrize("threshold", ["0.5", "1.0"], ids=["passes", "refuses"])
def test_serve_verify_fidelity_with_probe_video(weights, videos, tmp_path, monkeypatch,
                                                capsys, threshold):
    """--verify-fidelity with --probe-video: above the threshold the daemon
    runs int8 in both towers and no ToMe, and answers within 1e-6 of JAX's
    int8 predictor, a hundredth of what int8 moves the answer (JAX int8
    against JAX exact); its JSON is that answer rounded to 4 decimals.
    Below the threshold the daemon refuses to start and answers nothing."""
    from vimoclip_tpu_torch.cli import predict as predict_cli
    from vimoclip_tpu_torch.fidelity import FidelityError

    flags, jax_predictor = _reference_files(weights, tmp_path)
    flags += ["--quantize", "int8", "--verify-fidelity", "4", "--probe-video", videos[0],
              "--fidelity-threshold", threshold]
    text = json.dumps({"videos": videos, "top_k": C})
    monkeypatch.setattr(sys, "stdin", io.StringIO(text))
    if threshold == "1.0":
        with pytest.raises(FidelityError, match="below --fidelity-threshold 1.0"):
            serve.main(flags)
        assert capsys.readouterr().out == ""
        return
    built = []
    build = predict_cli.build_predictor
    monkeypatch.setattr(predict_cli, "build_predictor",
                        lambda *a, **k: built.append(build(*a, **k)) or built[-1])
    serve.main(flags)
    got = json.loads(capsys.readouterr().out)["results"]
    (pred,) = built
    for tower in (pred.teacher, pred.student):
        assert (tower.config.matmul_quant, tower.config.token_merge_r) == ("int8", 0)
    full = pred.predict_batch(videos, top_k=C)
    ref = jax_predictor(matmul_quant="int8").predict_batch(videos, top_k=C)
    exact = jax_predictor().predict_batch(videos, top_k=C)
    assert max(np.abs(r.probabilities - e.probabilities).max()
               for r, e in zip(ref, exact)) >= 100 * 1e-6  # int8's effect
    for record, f, r in zip(got, full, ref):
        np.testing.assert_allclose(f.probabilities, r.probabilities, atol=1e-6, rtol=0)
        probs = {p["class_id"]: p["probability"] for p in record["predictions"]}
        assert record["video"] == r.video_id and sorted(probs) == list(range(C))
        for c, p in probs.items():  # JSON rounds to 4 decimals
            assert abs(p - float(f.probabilities[c])) <= 5e-5 + 1e-7


# --------------------------------------------------------------------------
# the behaviours of tests/test_serve.py, on the port's daemon
# --------------------------------------------------------------------------


def test_stdin_loop_single_and_batch(predictor, videos):
    reqs = [
        {"video": videos[0], "top_k": 3},
        {"videos": videos, "top_k": 2},
        {"video": "/nonexistent.mp4"},  # must not end the loop
        {"video": videos[1]},
    ]
    out = io.StringIO()
    n = serve_stdin(predictor, io.StringIO("\n".join(json.dumps(r) for r in reqs)), out)
    assert n == 4
    lines = [json.loads(line) for line in out.getvalue().splitlines()]
    assert lines[0] == prediction_record(videos[0], predictor.predict(videos[0], top_k=3))
    assert [r["video"] for r in lines[1]["results"]] == videos
    assert all(len(r["predictions"]) == 2 for r in lines[1]["results"])
    assert "error" in lines[2]
    assert len(lines[3]["predictions"]) == 5  # default top_k


def test_batch_route_matches_library_predict_batch(predictor, videos):
    resp = handle_request(predictor, {"videos": videos, "top_k": 4})
    direct = predictor.predict_batch(videos, top_k=4)
    assert resp["results"] == [prediction_record(v, p) for v, p in zip(videos, direct)]


def test_http_server(predictor, videos):
    server = make_http_server(predictor, port=0)
    thread = _serve_forever(server)
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert r.status == 200 and json.load(r) == {"status": "ok"}
        code, resp, _ = _post(f"{base}/predict", {"videos": videos, "top_k": 3})
        assert code == 200
        direct = predictor.predict_batch(videos, top_k=3)
        assert resp["results"] == [prediction_record(v, p) for v, p in zip(videos, direct)]
        code, resp, _ = _post(f"{base}/predict", {"video": "/missing.mp4"})
        assert code == 400 and "error" in resp
        code, _, _ = _post(f"{base}/nowhere", {})
        assert code == 404
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def test_motion_video_request(predictor, videos, tmp_path):
    motion = _motion(str(tmp_path / "motion.mp4"), 1)
    resp = handle_request(predictor, {"video": videos[0], "motion_video": motion, "top_k": 3})
    direct = predictor.predict(videos[0], motion_video_path=motion, top_k=3)
    assert resp == prediction_record(videos[0], direct)


def test_batch_route_partial_motion_dict_falls_back_to_dir(predictor, videos, tmp_path):
    mdir = tmp_path / "motions"
    mdir.mkdir()
    explicit = _motion(str(tmp_path / "explicit.mp4"), 2)
    stem1 = os.path.splitext(os.path.basename(videos[1]))[0]
    dir_match = _motion(str(mdir / f"{stem1}.mp4"), 3, t=8)
    resp = handle_request(
        predictor, {"videos": videos, "motion_videos": {videos[0]: explicit}, "top_k": 3},
        motion_videos_dir=str(mdir))
    direct = [predictor.predict(videos[0], motion_video_path=explicit, top_k=3),
              predictor.predict(videos[1], motion_video_path=dir_match, top_k=3)]
    assert resp["results"] == [prediction_record(v, p) for v, p in zip(videos, direct)]


class _RecordingPredictor:
    """Pass-through proxy that counts predictor calls (coalescing proof)."""

    def __init__(self, inner):
        self.inner = inner
        self.batch_calls: list[list[str]] = []
        self.serial_calls: list[str] = []

    def predict_batch(self, videos, top_k=5, max_frames=None):
        self.batch_calls.append(list(videos))
        return self.inner.predict_batch(videos, top_k=top_k, max_frames=max_frames)

    def predict(self, video, motion_video_path=None, top_k=5, max_frames=None):
        self.serial_calls.append(video)
        return self.inner.predict(video, motion_video_path=motion_video_path,
                                  top_k=top_k, max_frames=max_frames)


def _submit_concurrently(batcher, requests):
    """``predict_many`` for each request on its own thread (the HTTP
    handler-thread shape); results or errors in request order."""
    out = [None] * len(requests)
    barrier = threading.Barrier(len(requests))

    def run(i, req):
        barrier.wait()
        try:
            out[i] = ("ok", batcher.predict_many(*req))
        except Exception as e:  # noqa: BLE001 — asserted by callers
            out[i] = ("err", e)

    threads = [threading.Thread(target=run, args=(i, r)) for i, r in enumerate(requests)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert all(o is not None for o in out), "a submitter thread hung"
    return out


def test_dynamic_batcher_coalesces_concurrent_requests(predictor, videos):
    rec = _RecordingPredictor(predictor)
    batcher = DynamicBatcher(rec, max_batch=2, max_wait_ms=5000)
    try:
        out = _submit_concurrently(batcher, [([videos[0]], [None], 3, None),
                                             ([videos[1]], [None], 2, None)])
    finally:
        batcher.shutdown()
    assert [s for s, _ in out] == ["ok", "ok"]
    assert len(rec.batch_calls) == 1 and rec.serial_calls == []
    assert sorted(rec.batch_calls[0]) == sorted(videos)
    stats = batcher.stats()
    assert stats["requests"] == 2 and stats["predictor_calls"] == 1
    assert stats["max_coalesced"] == 2 and stats["pooled_videos"] == 2
    for (_, preds), video, k in zip(out, videos, (3, 2)):
        solo = predictor.predict(video, top_k=k)
        assert prediction_record(video, preds[0]) == prediction_record(video, solo)
        assert len(preds[0].top_classes) == k


def test_dynamic_batcher_isolates_bad_video(predictor, videos):
    rec = _RecordingPredictor(predictor)
    batcher = DynamicBatcher(rec, max_batch=2, max_wait_ms=5000)
    try:
        out = _submit_concurrently(batcher, [([videos[0]], [None], 3, None),
                                             (["/nonexistent.mp4"], [None], 3, None)])
    finally:
        batcher.shutdown()
    assert {s for s, _ in out} == {"ok", "err"}
    good = next(v for s, v in out if s == "ok")
    assert prediction_record(videos[0], good[0]) == prediction_record(
        videos[0], predictor.predict(videos[0], top_k=3))
    # the pooled attempt failed and fell back to per-video serial calls
    assert len(rec.batch_calls) == 1 and len(rec.serial_calls) == 2


def test_dynamic_batcher_motion_videos_run_serially(predictor, videos, tmp_path):
    motion = _motion(str(tmp_path / "m.mp4"), 3)
    rec = _RecordingPredictor(predictor)
    batcher = DynamicBatcher(rec, max_batch=2, max_wait_ms=5000)
    try:
        out = _submit_concurrently(batcher, [([videos[0]], [motion], 3, None),
                                             ([videos[1]], [None], 3, None)])
    finally:
        batcher.shutdown()
    assert [s for s, _ in out] == ["ok", "ok"]
    # the motion video went serial; its neighbour, a group of one, too
    assert sorted(rec.serial_calls) == sorted(videos)
    assert rec.batch_calls == []
    direct = predictor.predict(videos[0], motion_video_path=motion, top_k=3)
    got = next(v for _, v in out if v[0].video_id == videos[0])
    assert prediction_record(videos[0], got[0]) == prediction_record(videos[0], direct)


def test_dynamic_batcher_pools_only_equal_max_frames(predictor, videos):
    rec = _RecordingPredictor(predictor)
    batcher = DynamicBatcher(rec, max_batch=3, max_wait_ms=5000)
    try:
        out = _submit_concurrently(batcher, [(videos, [None, None], 3, 6),
                                             ([videos[0]], [None], 3, None)])
    finally:
        batcher.shutdown()
    assert [s for s, _ in out] == ["ok", "ok"]
    assert rec.batch_calls == [list(videos)] and rec.serial_calls == [videos[0]]
    for video, pred in zip(videos, out[0][1]):
        solo = predictor.predict(video, top_k=3, max_frames=6)
        assert prediction_record(video, pred) == prediction_record(video, solo)


class _StubPred:
    """Records predict() kwargs; returns a minimal prediction object."""

    class _P:
        top_classes = [(0, "eat", 0.9)]

    def __init__(self):
        self.calls = []

    def predict(self, video, motion_video_path=None, top_k=5, max_frames=None):
        self.calls.append({"video": video, "max_frames": max_frames, "top_k": top_k})
        return self._P()


def test_daemon_max_frames_default_and_override():
    stub = _StubPred()
    handle_request(stub, {"video": "a.mp4"}, default_max_frames=7)
    handle_request(stub, {"video": "b.mp4", "max_frames": None}, default_max_frames=7)
    handle_request(stub, {"video": "c.mp4", "max_frames": 3}, default_max_frames=7)
    assert [c["max_frames"] for c in stub.calls] == [7, None, 3]


def test_http_status_codes_distinguish_client_and_server_faults():
    class _Boom:
        def predict(self, *a, **k):
            raise RuntimeError("device fell over")

    server = make_http_server(_Boom(), port=0)
    thread = _serve_forever(server)
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/predict"
        assert _post(url, b"not json at all")[0] == 400
        assert _post(url, b"{}")[0] == 400  # neither "video" nor "videos"
        assert _post(url, {"video": "x.mp4"})[0] == 500
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def test_batcher_rejects_requests_after_shutdown(predictor):
    batcher = DynamicBatcher(predictor, max_batch=2, max_wait_ms=1)
    batcher.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        batcher.predict_many(["x.mp4"], [None], 3, None)


def test_dynamic_batcher_zero_wait_pools_within_request(predictor, videos):
    """With no wait a multi-video request is still one queue entry, so it
    runs as one pooled call, even past max_batch."""
    rec = _RecordingPredictor(predictor)
    batcher = DynamicBatcher(rec, max_batch=1, max_wait_ms=0)
    try:
        out = batcher.predict_many(list(videos), [None] * len(videos), 3, None)
    finally:
        batcher.shutdown()
    assert rec.batch_calls == [list(videos)] and rec.serial_calls == []
    for video, pred in zip(videos, out):
        solo = predictor.predict(video, top_k=3)
        assert prediction_record(video, pred) == prediction_record(video, solo)


def test_http_server_dynamic_batching_and_stats(predictor, videos):
    rec = _RecordingPredictor(predictor)
    batcher = DynamicBatcher(rec, max_batch=2, max_wait_ms=5000)
    server = make_http_server(rec, port=0, batcher=batcher)
    thread = _serve_forever(server)
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        results = [None, None]

        def post(i, video, k):
            results[i] = _post(f"{base}/predict", {"video": video, "top_k": k})[1]

        threads = [threading.Thread(target=post, args=(i, v, k))
                   for i, (v, k) in enumerate(zip(videos, (3, 2)))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for res, video, k in zip(results, videos, (3, 2)):
            assert res == prediction_record(video, predictor.predict(video, top_k=k))
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
            stats = json.load(r)
        assert stats["requests"] == 2
        assert stats["predictor_calls"] == 1 and stats["max_coalesced"] == 2
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        batcher.shutdown()

    server = make_http_server(predictor, port=0)
    thread = _serve_forever(server)
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.server_address[1]}/stats", timeout=30) as r:
            assert json.load(r) == {"dynamic_batching": False}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


_MODEL_ARGS = ["--teacher-weights", "w.pt", "--student-torch-checkpoint", "s.pth",
               "--tfam-config", "c.yaml", "--tfam-torch-checkpoint", "t.pth"]


@pytest.mark.parametrize("flags", [["--warmup"], ["--verify-fidelity", "4"]],
                         ids=["warmup", "fidelity"])
def test_serve_usage_errors(flags, capsys):
    """--warmup and --verify-fidelity each need --probe-video (a daemon has no
    request video at startup). Both exit before any weights load."""
    with pytest.raises(SystemExit) as e:
        serve.main(_MODEL_ARGS + flags)
    assert e.value.code == 2
    assert f"{flags[0]} needs --probe-video" in capsys.readouterr().err


def test_serve_help_lists_daemon_flags(capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    for flag in ("--port", "--host", "--warmup", "--probe-video", "--max-batch",
                 "--batch-wait-ms", "--max-pending", "--request-timeout-s",
                 "--teacher-weights", "--device"):
        assert flag in out


class _BlockingPred:
    """predict() blocks on ``release`` after signalling ``started``."""

    class _P:
        top_classes = [(0, "eat", 0.9)]

    def __init__(self):
        self.started = threading.Event()
        self.release = threading.Event()
        self.calls: list[str] = []

    def predict(self, video, motion_video_path=None, top_k=5, max_frames=None):
        self.calls.append(video)
        self.started.set()
        if not self.release.wait(timeout=60):
            raise RuntimeError("test forgot to release")
        return self._P()


def _wait_pending(batcher, n, limit=5.0):
    t0 = time.monotonic()
    while batcher._pending < n and time.monotonic() - t0 < limit:
        time.sleep(0.01)
    return batcher._pending


def test_batcher_backpressure_sheds_load():
    stub = _BlockingPred()
    batcher = DynamicBatcher(stub, max_batch=1, max_wait_ms=0, max_pending=2)
    ta = threading.Thread(target=lambda: batcher.predict_many(["a.mp4"], [None], 3, None),
                          daemon=True)
    tb = threading.Thread(target=lambda: batcher.predict_many(["b.mp4"], [None], 3, None),
                          daemon=True)
    try:
        ta.start()
        assert stub.started.wait(timeout=30)  # the worker is blocked inside a
        tb.start()
        assert _wait_pending(batcher, 2) == 2
        with pytest.raises(Overloaded, match="backlog full"):
            batcher.predict_many(["c.mp4"], [None], 3, None)
        assert batcher.stats()["shed"] == 1
    finally:
        stub.release.set()
        ta.join(timeout=30)
        tb.join(timeout=30)
        batcher.shutdown()
    assert not ta.is_alive() and not tb.is_alive()
    assert batcher._pending == 0


def test_batcher_request_timeout():
    stub = _BlockingPred()
    batcher = DynamicBatcher(stub, max_batch=1, max_wait_ms=0, request_timeout_s=0.2)
    try:
        with pytest.raises(RequestTimeout, match="deadline"):
            batcher.predict_many(["a.mp4"], [None], 3, None)
        assert batcher.stats()["timeouts"] == 1
    finally:
        stub.release.set()
        batcher.shutdown()


def test_batcher_shutdown_drains_queued_then_fails_stragglers():
    stub = _BlockingPred()
    batcher = DynamicBatcher(stub, max_batch=1, max_wait_ms=0)
    results = {}

    def submit(name):
        try:
            results[name] = ("ok", batcher.predict_many([f"{name}.mp4"], [None], 3, None))
        except Exception as e:  # noqa: BLE001 — asserted below
            results[name] = ("err", e)

    ta = threading.Thread(target=submit, args=("a",), daemon=True)
    ta.start()
    assert stub.started.wait(timeout=30)  # the worker is blocked inside a
    tb = threading.Thread(target=submit, args=("b",), daemon=True)
    tb.start()
    assert _wait_pending(batcher, 2) == 2  # b queued behind a
    # an entry that passed the _closed check lands behind the sentinel
    batcher._q.put(_SHUTDOWN)
    straggler = _PendingVideo("c.mp4", None, 3, None)
    with batcher._pending_lock:
        batcher._pending += 1
    batcher._q.put([straggler])
    stub.release.set()
    ta.join(timeout=30)
    tb.join(timeout=30)
    batcher._worker.join(timeout=30)
    assert not batcher._worker.is_alive()
    assert results["a"][0] == "ok" and results["b"][0] == "ok"
    assert straggler.done.is_set() and "shut down" in str(straggler.error)
    assert batcher._pending == 0


def test_pooled_short_prediction_list_falls_back_serially():
    class _ShortBatchPred(_StubPred):
        def predict_batch(self, videos, top_k=5, max_frames=None):
            return [self._P()] * (len(videos) - 1)

    stub = _ShortBatchPred()
    batcher = DynamicBatcher(stub, max_batch=4, max_wait_ms=0)
    try:
        out = batcher.predict_many(["a.mp4", "b.mp4"], [None, None], 3, None)
    finally:
        batcher.shutdown()
    assert len(out) == 2
    assert [c["video"] for c in stub.calls] == ["a.mp4", "b.mp4"]


def test_explicit_null_motion_forces_frame_diff(tmp_path):
    class _BatchStub(_StubPred):
        def __init__(self):
            super().__init__()
            self.batch_calls = []
            self.motion_paths = []

        def predict(self, video, motion_video_path=None, top_k=5, max_frames=None):
            self.motion_paths.append(motion_video_path)
            return super().predict(video, top_k=top_k, max_frames=max_frames)

        def predict_batch(self, videos, top_k=5, max_frames=None):
            self.batch_calls.append(list(videos))
            return [self._P() for _ in videos]

    mdir = tmp_path / "motions"
    mdir.mkdir()
    (mdir / "clip.mp4").touch()
    stub = _BatchStub()
    video = str(tmp_path / "clip.mp4")
    handle_request(stub, {"videos": [video], "motion_videos": {video: None}},
                   motion_videos_dir=str(mdir))
    assert stub.batch_calls == [[video]] and stub.calls == []
    handle_request(stub, {"video": video, "motion_video": None}, motion_videos_dir=str(mdir))
    handle_request(stub, {"video": video}, motion_videos_dir=str(mdir))
    assert stub.motion_paths == [None, str(mdir / "clip.mp4")]


def test_http_503_and_504_statuses():
    stub = _BlockingPred()
    batcher = DynamicBatcher(stub, max_batch=1, max_wait_ms=0, max_pending=1,
                             request_timeout_s=0.3)
    server = make_http_server(stub, port=0, batcher=batcher)
    thread = _serve_forever(server)
    url = f"http://127.0.0.1:{server.server_address[1]}/predict"
    first = {}
    try:
        t1 = threading.Thread(target=lambda: first.update(r=_post(url, {"video": "a.mp4"})),
                              daemon=True)
        t1.start()
        assert stub.started.wait(timeout=30)
        code, _, headers = _post(url, {"video": "b.mp4"})
        assert code == 503 and int(headers.get("Retry-After", 0)) >= 1
        t1.join(timeout=30)
        assert first["r"][0] == 504  # a waited past its 0.3 s deadline
        code, _, _ = _post(url, {"video": "c.mp4"})
        assert code in (503, 504)  # 503 while a's video still counts pending
    finally:
        stub.release.set()
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        batcher.shutdown()


def test_sigterm_graceful_drain():
    """SIGTERM with a request in flight: the accept loop stops, the response
    completes with 200, serve_http returns, and the socket is closed."""
    stub = _BlockingPred()
    batcher = DynamicBatcher(stub, max_batch=1, max_wait_ms=0)
    server = make_http_server(stub, port=0, batcher=batcher)
    port = server.server_address[1]
    status = {}
    tc = threading.Thread(target=lambda: status.update(
        code=_post(f"http://127.0.0.1:{port}/predict", {"video": "a.mp4"}, 60)[0]),
        daemon=True)
    tc.start()

    def signaller():
        assert stub.started.wait(timeout=30)  # the request is in flight
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.3)
        stub.release.set()

    ts = threading.Thread(target=signaller, daemon=True)
    ts.start()
    old_term, old_int = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)
    try:
        serve_http(server, batcher)  # returns only after the drain
    finally:
        signal.signal(signal.SIGTERM, old_term)
        signal.signal(signal.SIGINT, old_int)
    tc.join(timeout=30)
    ts.join(timeout=30)
    assert status.get("code") == 200, status
    with pytest.raises(OSError):  # URLError and ConnectionRefusedError are OSErrors
        urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=5)


_HARDKILL_WORKER = '''
import sys, threading
sys.path.insert(0, {root!r})
from vimoclip_tpu_torch.cli.serve import make_http_server, serve_http


class _Wedged:
    """A predictor that never returns."""

    def predict(self, video, motion_video_path=None, top_k=5, max_frames=None):
        print("INFLIGHT", flush=True)
        threading.Event().wait()


server = make_http_server(_Wedged(), port=0)
print(f"PORT {{server.server_address[1]}}", flush=True)
serve_http(server)
print("DRAINED", flush=True)
'''


def test_second_sigterm_hard_kills_wedged_drain(tmp_path):
    """The first SIGTERM drains; a second one kills the process even when
    the drain is wedged on a predictor that never returns."""
    worker = tmp_path / "serve_worker.py"
    worker.write_text(_HARDKILL_WORKER.format(root=ROOT))
    proc = subprocess.Popen([sys.executable, str(worker)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        port = None
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("PORT "):
                port = int(line.split()[1])
                break
        assert port, "".join(lines)

        def client():
            try:
                _post(f"http://127.0.0.1:{port}/predict", {"video": "a.mp4"}, 60)
            except Exception:  # noqa: BLE001 — the worker dies mid-response
                pass

        threading.Thread(target=client, daemon=True).start()
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("INFLIGHT"):
                break
        proc.send_signal(signal.SIGTERM)  # the drain starts and wedges
        time.sleep(0.5)
        proc.send_signal(signal.SIGTERM)  # the hard kill
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    out = "".join(lines) + (proc.stdout.read() or "")
    proc.stdout.close()
    assert rc == -signal.SIGTERM, f"rc={rc}\n{out}"
    assert "DRAINED" not in out
