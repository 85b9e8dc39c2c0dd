"""The port's Table-2 tools on the CPU, held to the JAX package's: the
corpus frames (``tools/run_table2_sweep_torch.py::corpus_frames``) against
JAX's ``build_corpus`` bit for bit; the files route's HDF5 files, built
with JAX's tiny-teacher weights, against JAX's files; the memory route fed
the files route's decoded videos against the files route; one sweep config
for one epoch; the full-width tool's preemption and exit codes
(``tools/run_table2_fullgeom_torch.py``) and one epoch of ``run_mode`` at
d 512; the committed artifacts' integrity."""

import functools
import importlib.util
import json
import os
from pathlib import Path

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vimoclip_tpu.data.video_reader as jax_video_reader
import vimoclip_tpu.extraction as jax_extraction
from vimoclip_tpu.models.clip_vit import ClipVisionConfig as JaxVisionConfig
from vimoclip_tpu.models.clip_vit import ClipVisionEncoder as JaxVisionEncoder
from vimoclip_tpu_torch.data.video_reader import read_video
from vimoclip_tpu_torch.models.convert import clip_vision_state_from_jax

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# float32 on both stacks, the same mp4 bytes decoded by one OpenCV: sums in
# other orders only (measured ~5e-7)
CORPUS_REL = 1e-5
# RGB in bf16 on both stacks (the tools' default, as JAX's corpus ran): each
# rounds its own intermediates to bf16 (8-bit mantissa); at most 5.8e-3
# relative L2 per video (tests/table2_spread.py --parts corpus)
CORPUS_REL_BF16 = 1.5e-2


def _tool(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


sweep = _tool("run_table2_sweep_torch")
fullgeom = _tool("run_table2_fullgeom_torch")
jax_sweep = _tool("run_table2_sweep")


class _Stop(Exception):
    pass


@pytest.mark.parametrize("order_only", [False, True], ids=["flicker", "order"])
def test_corpus_frames_equal_jax(order_only, tmp_path, monkeypatch):
    """One video per class and one held out: the frames JAX's
    ``build_corpus`` hands ``write_video``, bit for bit, with its names and
    labels (``train.txt``, ``val.txt``)."""
    written = {}

    def capture(path, frames, *a, **kw):
        written[os.path.basename(path)] = np.array(frames)

    def stop(*a, **kw):
        raise _Stop

    monkeypatch.setattr(jax_video_reader, "write_video", capture)
    monkeypatch.setattr(jax_extraction, "create_hdf5_dataset", stop)
    with pytest.raises(_Stop):
        jax_sweep.build_corpus(str(tmp_path), seed=3, videos_per_class=1,
                               val_videos_per_class=1, order_only=order_only)
    train = (tmp_path / "train.txt").read_text().split("\n")
    frames, names, labels = sweep.corpus_frames(3, 1, 1, order_only)
    assert names == list(written)
    for video, name in zip(frames, names):
        assert video.dtype == np.uint8
        np.testing.assert_array_equal(video, written[name], err_msg=name)
    assert train == [f"{n} {k}" for n, k in zip(names[:6], labels[:6])]
    assert labels == [i % 6 for i in range(12)]


def _jax_teacher():
    vcfg = JaxVisionConfig(image_size=32, patch_size=8, hidden_size=32, num_layers=1,
                           num_heads=2, intermediate_size=64, projection_dim=24)
    params = JaxVisionEncoder(vcfg).init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"]
    cfg, _ = sweep.tiny_teacher(24)
    return clip_vision_state_from_jax(params, cfg, prefix="")


def _read_h5(path) -> dict:
    with h5py.File(path, "r") as f:
        return {k: (g["embeddings"][:], g["labels"][:] if "labels" in g else None)
                for k, g in f.items() if isinstance(g, h5py.Group)}


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """JAX's corpus and the port's files route, both with RGB extracted in
    float32 and with JAX's teacher weights, from one seed: one
    video per class for training and one held out, order-only."""
    tmp = tmp_path_factory.mktemp("table2")
    kw = dict(seed=0, videos_per_class=1, val_videos_per_class=1, order_only=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_extraction, "create_hdf5_dataset",
                   functools.partial(jax_extraction.create_hdf5_dataset, half_precision=False))
        theirs = jax_sweep.build_corpus(str(tmp / "jax"), **kw)
    ours = sweep.build_corpus(str(tmp / "torch"), device="cpu", teacher_state=_jax_teacher(),
                              rgb_half_precision=False, **kw)
    return tmp, theirs, ours


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_files_route_matches_jax(corpora):
    """rgb.h5, rgb_val.h5 and motion.h5 video by video within 1e-5 relative
    L2, with the same groups, frame counts and labels."""
    _, theirs, ours = corpora
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in theirs]
    for jp, tp in zip(theirs, ours):
        if not jp.endswith(".h5"):
            assert Path(jp).read_text() == Path(tp).read_text()
            continue
        want, got = _read_h5(jp), _read_h5(tp)
        assert sorted(got) == sorted(want), jp
        for key, (emb, labels) in want.items():
            assert got[key][0].shape == emb.shape, key
            assert _rel(got[key][0], emb) <= CORPUS_REL, (jp, key, _rel(got[key][0], emb))
            if labels is not None:
                np.testing.assert_array_equal(got[key][1], labels)


def test_files_route_in_bf16_matches_jax_corpus(tmp_path):
    """At the tools' default, RGB extracted in bf16 as JAX's corpus ran it,
    the files route with JAX's teacher weights gives JAX's rgb.h5 within
    bf16's rounding and its motion.h5 (float32 on both) within 1e-5."""
    kw = dict(seed=0, videos_per_class=1, order_only=False)
    theirs = jax_sweep.build_corpus(str(tmp_path / "jax"), **kw)
    ours = sweep.build_corpus(str(tmp_path / "torch"), device="cpu",
                              teacher_state=_jax_teacher(), **kw)
    for jp, tp, tol in zip(theirs[:2], ours[:2], (CORPUS_REL_BF16, CORPUS_REL)):
        want, got = _read_h5(jp), _read_h5(tp)
        assert sorted(got) == sorted(want), jp
        for key, (emb, _) in want.items():
            assert got[key][0].shape == emb.shape, key
            assert _rel(got[key][0], emb) <= tol, (jp, key, _rel(got[key][0], emb))


def test_memory_route_equals_files_route_on_decoded_frames(corpora):
    """The memory route's embedding stage fed the files route's decoded
    videos and frame-diff videos gives the files route's embeddings; its
    item lists come in ``PairedEmbeddingDataset``'s order with its labels."""
    from vimoclip_tpu_torch.data.embedding_dataset import PairedEmbeddingDataset

    tmp, _, (rgb_h5, motion_h5, _, val_h5) = corpora
    work = tmp / "torch"
    _, names, labels = sweep.corpus_frames(0, 1, 1, True)
    rgb_frames = [read_video(str(work / "videos" / n)) for n in names]
    diff_frames = [read_video(str(work / "diffs" / n)) for n in names]
    cfg, state = sweep.tiny_teacher(24, state=_jax_teacher())
    rgb, motion = sweep.embed_clips(rgb_frames, diff_frames, cfg, state, "cpu",
                                    rgb_half_precision=False)
    items = sweep.as_items(names[:6], labels[:6], rgb[:6], motion[:6])
    files = PairedEmbeddingDataset(rgb_h5, motion_h5)
    assert [it["video_id"] for it in items] == files.keys
    for i, it in enumerate(items):
        want = files[i]
        for key in ("embeddings", "motion_embeddings"):
            assert it[key].shape == want[key].shape
            assert _rel(it[key], want[key]) <= CORPUS_REL, (it["video_id"], key)
        np.testing.assert_array_equal(it["labels"], want["labels"])
    val = PairedEmbeddingDataset(val_h5, motion_h5)
    held = sweep.as_items(names[6:], labels[6:], rgb[6:], motion[6:])
    assert [it["video_id"] for it in held] == val.keys
    # the route's own frame differences are what the diff videos hold, up
    # to the codec: measured a mean of at most 1.06 grey levels per video
    for direct, decoded in zip(sweep.motion_frames_of(rgb_frames, "cpu"), diff_frames):
        assert direct.shape == decoded.shape and direct.dtype == np.uint8
        assert np.abs(direct.astype(int) - decoded).mean() <= 2.0


def test_corpus_items_splits_train_and_val():
    train, val = sweep.corpus_items(0, videos_per_class=1, val_videos_per_class=1,
                                    order_only=True, device="cpu")
    assert [it["video_id"] for it in train] == sorted(f"v{i}.mp4" for i in range(6))
    assert [it["video_id"] for it in val] == sorted(f"v{i}.mp4" for i in range(6, 12))
    for it in train + val:
        t = it["embeddings"].shape[0]
        assert t in (8, 10, 12) and it["embeddings"].shape == (t, 24)
        assert it["motion_embeddings"].shape == (t - 1, 24)
        assert np.isfinite(it["embeddings"]).all() and it["labels"].sum() == 1
    same, again = sweep.corpus_items(0, videos_per_class=1, device="cpu")
    assert same is again  # the toy sweep validates on its training split


def test_one_sweep_config_for_one_epoch(tmp_path, monkeypatch):
    """``main`` on a one-config grid for one epoch: the config trains and
    evaluates, JAX's best val mAP sits beside it, and the run exits 0."""
    import vimoclip_tpu_torch.cli.run_experiments as rx

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(rx, "REFERENCE_GRID", [{}])
    monkeypatch.setattr(sweep, "TINY_BASE_OVERRIDES", {
        "training": dict(sweep.TINY_BASE_OVERRIDES["training"], epochs=1),
        "model": sweep.TINY_BASE_OVERRIDES["model"]})
    out = tmp_path / "SWEEP_TORCH.json"
    assert sweep.main(["--out", str(out), "--work-dir", str(tmp_path / "w"),
                       "--device", "cpu"]) == 0
    art = json.loads(out.read_text())
    assert art["configs_total"] == art["configs_ok"] == 1
    assert art["device"] == "cpu" and art["geometry"]["training"]["device"] == "cpu"
    assert "rgb in bf16" in art["corpus"]
    (res,) = art["results"]
    assert res["config"] == "config_default.yaml" and res["status"] == "ok"
    assert 0.0 <= res["best_val_mAP"] <= 1.0 and 0.0 <= res["eval_mAP"] <= 1.0
    assert res["jax_best_val_mAP"] == pytest.approx(0.784863843986102)
    assert art["mode_ordering"]["jax"] == ["cross", "concat_t", "rgb", "flow"]
    assert "torch" not in art["mode_ordering"]  # three modes did not run


def test_fullgeom_tool_preemption_and_exit_codes(tmp_path, monkeypatch):
    """As JAX's tool: a preempted arm stops the sweep, writes a partial
    artifact and exits 1; a clean --modes subset exits 0 with ordering_ok
    null; an evaluated ordering failure exits 1."""
    monkeypatch.setattr(fullgeom, "corpus", lambda route, work, seed, device: ([], []))
    ran = []

    def fake(status_of):
        def run_mode(mode, items, run_dir, device, epochs=30, **kw):
            assert kw == {"attention_impl": "auto", "resume": False}
            ran.append(mode)
            res = {"mode": mode, "best_val_mAP": status_of.get(mode, 0.9), "wall_s": 1.0,
                   "train_steps": 10, "device": device}
            if res["best_val_mAP"] is None:
                res["status"] = "preempted"
            return res
        return run_mode

    out = tmp_path / "art.json"
    argv = ["--work-dir", str(tmp_path / "w"), "--out", str(out), "--device", "cpu"]
    monkeypatch.setattr(fullgeom, "run_mode", fake({"concat_t": None}))
    assert fullgeom.main(argv) == 1
    assert ran == ["cross", "concat_t"]  # rgb and flow never started
    art = json.loads(out.read_text())  # strict JSON: no -Infinity
    assert art["preempted"] is True and art["ordering_ok"] is None
    assert art["device"] == "cpu" and art["corpus"]["route"] == "memory"

    ran.clear()
    monkeypatch.setattr(fullgeom, "run_mode", fake({}))
    assert fullgeom.main(argv + ["--modes", "cross,rgb"]) == 0
    art = json.loads(out.read_text())
    assert art["ordering_ok"] is None and art["preempted"] is False

    ran.clear()
    monkeypatch.setattr(fullgeom, "run_mode", fake({"cross": 1.0, "concat_t": 0.9,
                                                    "rgb": 0.55, "flow": 0.45}))
    assert fullgeom.main(argv) == 1  # rgb below flow + 0.15
    art = json.loads(out.read_text())
    assert ran == list(fullgeom.MODES) and art["ordering_ok"] is False


def test_sweep_tool_needs_a_card_unless_given_cpu(tmp_path):
    """Without ``--device cpu`` the sweep asks for the card and, with none
    present, raises before it builds anything."""
    work = tmp_path / "w"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep.main(["--out", str(tmp_path / "a.json"), "--work-dir", str(work)])
    assert not work.exists() and not (tmp_path / "a.json").exists()


def test_fullgeom_tool_work_dir_resume_and_attention_impl(tmp_path, monkeypatch):
    """Each run gets a fresh work dir unless one is named; ``--resume`` and
    ``--attention-impl`` reach every arm's trainer and the artifact;
    ``--resume`` without ``--work-dir`` is refused."""
    works, kws = [], []
    monkeypatch.setattr(fullgeom, "corpus",
                        lambda route, work, seed, device: works.append(work) or ([], []))

    def run_mode(mode, items, run_dir, device, epochs=30, **kw):
        kws.append(kw)
        return {"mode": mode, "best_val_mAP": 0.9, "wall_s": 1.0, "train_steps": 1,
                "device": device}

    monkeypatch.setattr(fullgeom, "run_mode", run_mode)
    out = tmp_path / "art.json"
    base = ["--out", str(out), "--device", "cpu", "--modes", "cross"]
    assert fullgeom.main(base) == 0 and fullgeom.main(base) == 0
    assert works[0] != works[1] and all(os.path.isdir(w) for w in works)
    assert kws == [{"attention_impl": "auto", "resume": False}] * 2
    assert json.loads(out.read_text())["attention_impl"] == "auto"

    named = str(tmp_path / "named")
    assert fullgeom.main(base + ["--work-dir", named, "--resume",
                                 "--attention-impl", "flash"]) == 0
    assert works[2] == named and kws[2] == {"attention_impl": "flash", "resume": True}
    art = json.loads(out.read_text())
    assert art["attention_impl"] == "flash" and art["corpus"]["rgb_extraction"] == "bf16"
    with pytest.raises(SystemExit):
        fullgeom.main(base + ["--resume"])
    assert len(works) == 3


def test_fullgeom_files_corpus_is_built_once(tmp_path, monkeypatch):
    """``--corpus files`` builds the files route on the CPU into the work
    dir and reads it as ``PairedEmbeddingDataset``s; a second run reuses it."""
    monkeypatch.setattr(fullgeom, "CORPUS", dict(fullgeom.CORPUS, videos_per_class=1,
                                                 val_videos_per_class=1, projection_dim=24))
    train, val = fullgeom.corpus("files", str(tmp_path), 0, "cpu")
    assert (len(train), len(val)) == (6, 6) and train[0]["embeddings"].shape[1] == 24
    stamp = (tmp_path / "rgb.h5").stat().st_mtime_ns
    again, _ = fullgeom.corpus("files", str(tmp_path), 0, "cpu")
    assert (tmp_path / "rgb.h5").stat().st_mtime_ns == stamp and len(again) == 6


def test_fullgeom_ordering_rule_is_jax_rule():
    ok = {"cross": 1.0, "concat_t": 1.0, "rgb": 0.5386, "flow": 0.3586}
    assert fullgeom.ordering_ok(ok)
    assert not fullgeom.ordering_ok(ok | {"cross": 0.58})  # cross < rgb + 0.05
    assert not fullgeom.ordering_ok(ok | {"flow": 0.40})  # rgb < flow + 0.15
    assert not fullgeom.ordering_ok(ok | {"concat_t": 0.5})  # concat_t < rgb
    assert fullgeom.ordering_ok({k: v for k, v in ok.items() if k != "concat_t"})


def test_run_mode_at_full_width_for_one_epoch(tmp_path):
    """``run_mode`` at d 512 / 8 heads / 4 layers / ff 2048 on the CPU: one
    epoch over 12 training clips (one step of 8) and 12 held-out ones."""
    items = sweep.corpus_items(0, projection_dim=512, videos_per_class=2,
                               val_videos_per_class=2, order_only=True, device="cpu")
    res = fullgeom.run_mode("cross", items, str(tmp_path), "cpu", epochs=1)
    assert res["train_steps"] == 1 and "status" not in res
    assert 0.0 <= res["best_val_mAP"] <= 1.0
    (h,) = res["history"]
    assert np.isfinite(h["train_loss"]) and h["train_loss"] > 0


def _artifact(name):
    path = ROOT / name
    if not path.exists():
        pytest.fail(f"{name} is not committed")
    return json.loads(path.read_text())


def test_sweep_torch_artifact():
    """SWEEP_TORCH.json: 21 of 21 configs ok on the CPU, JAX's best val mAP
    beside each, and both stacks' mode orderings taken from the results."""
    art = _artifact("SWEEP_TORCH.json")
    assert art["configs_total"] == art["configs_ok"] == 21 and art["device"] == "cpu"
    jax_art = json.loads((ROOT / "SWEEP.json").read_text())
    jax_best = {r["config"]: r["best_val_mAP"] for r in jax_art["results"]}
    ours = {}
    for r in art["results"]:
        assert r["status"] == "ok" and 0.0 <= r["best_val_mAP"] <= 1.0
        assert r["jax_best_val_mAP"] == jax_best[r["config"]]
        ours[r["config"]] = r["best_val_mAP"]
    assert len(ours) == 21
    assert art["mode_ordering"]["torch"] == sweep.mode_ordering(ours)
    assert art["mode_ordering"]["jax"] == sweep.mode_ordering(jax_best)


def test_fullgeom_torch_artifact():
    """SWEEP_FULLGEOM_TORCH.json: one card's run of all four modes for 30
    epochs at the flagship geometry, ordering_ok by JAX's rule on its own
    mAPs."""
    art = _artifact("SWEEP_FULLGEOM_TORCH.json")
    assert art["geometry"] == fullgeom.GEOMETRY and art["recipe"] == fullgeom.RECIPE
    assert art["preempted"] is False and "H100" in art["device"] and " W" in art["device"]
    assert art["corpus"]["route"] in ("memory", "files")
    assert art["corpus"]["rgb_extraction"] == "bf16" and art["attention_impl"] == "auto"
    by = {r["mode"]: r["best_val_mAP"] for r in art["results"]}
    assert list(by) == list(fullgeom.MODES) and by == art["best_val_mAP"]
    for r in art["results"]:
        assert r["train_steps"] == 30 * 36 and r["wall_s"] > 0 and len(r["history"]) == 30
    assert art["ordering_ok"] is fullgeom.ordering_ok(by)


def test_tiny_teacher_draws_the_jax_towers_scales():
    """Without a state the tiny teacher is drawn from the seed at the scales
    of JAX's initialisers (JAX's own tower as the yardstick): products at
    variance 1 / fan-in, embeddings at 0.02, LayerNorms 1 and 0."""
    cfg, state = sweep.tiny_teacher(24, seed=5)
    _, again = sweep.tiny_teacher(24, seed=5)
    assert all(torch.equal(state[k], again[k]) for k in state)
    theirs = _jax_teacher()
    for key, ours in state.items():
        ref = torch.tensor(np.array(theirs[key]))
        assert ours.shape == ref.shape, key
        if ref.std() == 0:
            assert torch.equal(ours, ref.to(ours.dtype)), key
        else:
            assert abs(ours.std().item() / ref.std().item() - 1) < 0.3, key
