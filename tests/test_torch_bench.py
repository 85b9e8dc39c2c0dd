"""``bench_torch.py``, the port's one-line benchmark, on the CPU: its copies
of ``bench.py``'s recipes, constants, frame synthesis, FLOP count and
rounding equal ``bench.py``'s; its TFAM and student train-step losses (and
the TFAM step's gradients) equal the JAX package's compositions in
``bench.py`` on weights carried through ``models/convert.py``; every
section runs at small widths on ``device="cpu"`` and the line has
``bench.py``'s keys; without a card the script exits non-zero with a
message; the card-test section reads pytest's summary and fails loudly."""

import ast
import importlib.util
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vimoclip_tpu import losses as jax_losses
from vimoclip_tpu.config import TFAMModelConfig as JTFAMConfig
from vimoclip_tpu.models.clip_vit import ClipVisionConfig as JVisionConfig
from vimoclip_tpu.models.student import StudentModel as JStudent
from vimoclip_tpu.models.tfam import TFAM as JTFAM
from vimoclip_tpu_torch.config import TFAMModelConfig
from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig
from vimoclip_tpu_torch.models.convert import (
    student_state_from_jax,
    tfam_state_from_jax,
    to_tensors,
)
from vimoclip_tpu_torch.models.student import StudentModel
from vimoclip_tpu_torch.models.tfam import TFAM

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"{name}_under_test", ROOT / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


bench = _load("bench")
bench_torch = _load("bench_torch")


# ---------------------------------------------------------------------------
# the copies of bench.py's pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["EXTRACTION_RECIPE", "TFAM_RECIPE", "STUDENT_RECIPE",
                                  "VIT_B16_GFLOP_PER_FRAME"])
def test_recipes_and_constants_equal_bench_py(name):
    assert getattr(bench_torch, name) == getattr(bench, name)


def test_no_tpu_figure_in_the_port():
    """``bench.py``'s measured TPU ceiling has no counterpart: the port
    measures its own."""
    assert not hasattr(bench_torch, "MEASURED_CEILING_TFLOPS")
    assert "193" not in (ROOT / "bench_torch.py").read_text()


@pytest.mark.parametrize("args", [(512, 512, 2048, 4, True), (50, 768, 3072, 12, False),
                                  (197, 768, 3072, 12, False), (16, 32, 64, 2, True),
                                  (1, 8, 8, 1, False)])
def test_transformer_flops_equal_bench_py(args):
    assert bench_torch._transformer_flops(*args) == bench._transformer_flops(*args)


def test_vit_b16_flops_per_frame_is_the_formula_rounded():
    assert bench_torch._transformer_flops(197, 768, 3072, 12, False) / 1e9 == pytest.approx(
        bench_torch.VIT_B16_GFLOP_PER_FRAME, rel=0.01)


def test_round_equals_bench_py():
    tree = {"a": 1.23456, "b": {"c": float("nan"), "d": float("inf"), "e": 7},
            "f": "text", "g": None, "h": [1.23456], "i": -2.0005}
    assert bench_torch._round(tree) == bench._round(tree)
    assert bench_torch._round(tree, 1) == bench._round(tree, 1)


@pytest.mark.parametrize("n, h, w, seed", [(3, 360, 640, 0), (2, 48, 64, 3), (4, 50, 70, 11)])
def test_make_frames_equal_bench_py_bit_for_bit(n, h, w, seed):
    pytest.importorskip("cv2", reason="bench.py's frames are OpenCV resizes")
    got = bench_torch._make_frames(n, h, w, seed=seed)
    want = bench._make_frames(n, h, w, seed=seed)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape == (n, h, w, 3)
    np.testing.assert_array_equal(got, want)


def _bench_main_keys() -> tuple[set, set]:
    """The top-level keys and the ``detail`` keys of ``bench.py``'s line,
    read from its ``main``."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    result = next(n.value for n in ast.walk(main) if isinstance(n, ast.Assign)
                  and any(getattr(t, "id", None) == "result" for t in n.targets))
    detail = next(n.args[0] for n in ast.walk(result) if isinstance(n, ast.Call)
                  and getattr(n.func, "id", None) == "_round")
    return ({k.value for k in result.keys}, {k.value for k in detail.keys})


# ---------------------------------------------------------------------------
# the train steps' compositions against JAX's
# ---------------------------------------------------------------------------

B, T, D, HEADS, LAYERS, C = 2, 16, 32, 2, 2, 5


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("masked", [False, True], ids=["full", "padded"])
def test_tfam_step_loss_and_gradients_match_jax(masked):
    """Eval mode, float32: ``bench_torch.tfam_loss`` and its gradients on
    weights converted from JAX's params, against ``bench.py``'s
    ``losses.bce_with_logits(TFAM.apply(...))``."""
    rng = np.random.default_rng(0)
    rgb = rng.normal(size=(B, T, D)).astype(np.float32)
    motion = rng.normal(size=(B, T - 1, D)).astype(np.float32)
    mr, mf = np.ones((B, T), bool), np.ones((B, T - 1), bool)
    if masked:
        mr[1, 11:], mf[1, 10:] = False, False
    labels = (rng.random((B, C)) < 0.3).astype(np.float32)

    jmodel = JTFAM(config=JTFAMConfig(d_model=D, nhead=HEADS, num_layers=LAYERS,
                                      dim_feedforward=2 * D, attention_impl="auto"),
                   num_classes=C)
    params = jmodel.init(jax.random.key(0), rgb, motion, mr, mf)["params"]

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, rgb, motion, mr, mf, deterministic=True)
        return jax_losses.bce_with_logits(logits, labels)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    jgrads = tfam_state_from_jax(jax.tree.map(np.asarray, jgrads), LAYERS)

    model = TFAM(TFAMModelConfig(d_model=D, nhead=HEADS, num_layers=LAYERS,
                                 dim_feedforward=2 * D, attention_impl="auto"),
                 num_classes=C)
    model.load_state_dict(to_tensors(tfam_state_from_jax(
        jax.tree.map(np.asarray, params), LAYERS)), strict=True)
    model.eval()
    t = torch.from_numpy
    loss = bench_torch.tfam_loss(model, t(rgb), t(motion), t(mr), t(mf), t(labels))
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    compared = 0
    for name, p in model.named_parameters():
        want = jgrads[name]
        if p.grad is None:  # a module the fusion mode never runs
            assert not np.any(want), name
            continue
        assert _rel_l2(p.grad.numpy(), want) <= 1e-4, name
        compared += 1
    assert compared == len([k for k in jgrads if np.any(jgrads[k])])


STUDENT_GEOM = dict(image_size=32, patch_size=8, hidden_size=64, num_layers=2,
                    num_heads=2, intermediate_size=128, projection_dim=32)


def test_student_step_loss_matches_jax():
    """``bench_torch.student_loss`` (cosine distillation + BCE with
    positive weight 9) on a 2-layer, width-64 ViT at 3 frames of 32x48,
    against ``bench.py``'s composition of JAX's losses."""
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (2, 3, 32, 48, 3), dtype=np.uint8)
    teacher = rng.normal(size=(2, 3, STUDENT_GEOM["projection_dim"])).astype(np.float32)
    labels = (rng.random((2, C)) < 0.3).astype(np.float32)
    jmodel = JStudent(vision_config=JVisionConfig(**STUDENT_GEOM), num_classes=C)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0), frames)["params"])
    # a trained fc2 is not zero: give it values so the branch is exercised
    params["residual_mlp"]["fc2"] = {
        k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        for k, v in params["residual_mlp"]["fc2"].items()}

    @jax.jit
    def loss_fn(p, fr):
        _, distill, logits = jmodel.apply({"params": p}, fr)
        return (jax_losses.distillation_loss(distill, teacher, "cosine")
                + jax_losses.classification_loss(logits, labels, 9.0))

    jloss = loss_fn(params, jnp.asarray(frames))

    cfg = ClipVisionConfig(**STUDENT_GEOM)
    model = StudentModel(cfg, num_classes=C)
    model.load_state_dict(to_tensors(student_state_from_jax(params, cfg)), strict=True)
    with torch.no_grad():
        loss = bench_torch.student_loss(model.eval(), torch.from_numpy(frames),
                                        torch.from_numpy(teacher), torch.from_numpy(labels))
    assert abs(float(loss) - float(jloss)) <= 1e-4


# ---------------------------------------------------------------------------
# the sections and the line, at small widths on the CPU
# ---------------------------------------------------------------------------

TINY_VIT = dict(image_size=32, patch_size=8, hidden_size=32, num_layers=2, num_heads=2,
                intermediate_size=64, projection_dim=16)
SMALL = dict(
    ceiling=dict(n=64),
    extraction=dict(recipe=dict(batch=4, iters=2), vision_config=ClipVisionConfig(**TINY_VIT),
                    frame_hw=(48, 64)),
    tfam=dict(recipe=dict(b=2, t=16, d=32, layers=2, ff=64, classes=C, iters=2)),
    student=dict(recipe=dict(b=2, t=3, h=48, w=64, classes=C, iters=2),
                 vision_config=ClipVisionConfig(**TINY_VIT)),
    serving=dict(teacher_config=ClipVisionConfig(**TINY_VIT),
                 student_config=ClipVisionConfig(**TINY_VIT),
                 tfam_config=TFAMModelConfig(d_model=16, nhead=2, num_layers=2,
                                             dim_feedforward=32),
                 classes=C, frame_hw=(48, 64)),
)


@pytest.fixture(scope="module")
def cpu_run():
    pytest.importorskip("cv2", reason="the sections' frames are OpenCV resizes")
    return bench_torch.run("cpu", **SMALL)


def test_line_has_bench_py_keys(cpu_run):
    line, _ = cpu_run
    top, detail = _bench_main_keys()
    assert set(line) == top
    assert "tpu_test" in detail
    assert detail - {"tpu_test"} | {"cuda_test"} <= set(line["detail"])
    assert line["metric"] == "clip_vit_b16_extraction_throughput"
    assert line["unit"] == "frames/s/card"
    assert line["detail"]["device"] == "cpu"


def test_only_the_card_tests_fail_on_the_cpu(cpu_run):
    line, failures = cpu_run
    assert failures == ["cuda_test: skipped: device 'cpu' is not a card"]
    assert line["detail"]["cuda_test"]["status"] == "skipped"


def test_extraction_section_on_the_cpu(cpu_run):
    line, _ = cpu_run
    d = line["detail"]
    assert line["value"] > 0 and line["vs_baseline"] > 0
    assert d["baseline_ref_style_fps_same_host"] > 0 and d["extraction_turbo_fps"] > 0
    assert d["batch"] == 4 and d["iters_per_call"] == 2
    assert d["measured_ceiling_tflops"] > 0 and d["extraction_mfu_vs_measured_ceiling"] > 0
    assert d["extraction_turbo_config"] == "token_merge_r=16 + int8"
    # no device metric from a CPU run
    assert d["extraction_profiled"] == {"profiled_wall_ms": None, "device_busy_ms": None,
                                        "device_idle_share": None}


@pytest.mark.parametrize("section, rate", [("tfam_train_step", "clips_per_sec"),
                                           ("student_train_step", "segments_per_sec")])
def test_train_sections_on_the_cpu(cpu_run, section, rate):
    s = cpu_run[0]["detail"][section]
    assert "error" not in s, s
    assert s[rate] > 0 and s["ms_per_step"] > 0 and s["tflops_per_sec"] >= 0
    assert s["launches_per_step"] == {}  # CPU tensors take the plain versions
    assert s["device_busy_ms"] is None
    if section == "tfam_train_step":
        assert s["attention_impl"] == "auto -> eager (no kernel launched)"


def test_serving_section_on_the_cpu(cpu_run):
    s = cpu_run[0]["detail"]["serving"]
    assert "error" not in s, s
    assert s["video_latency_s_450f_wall"] > 0 and s["pooled_videos_per_s"] > 0
    assert s["serial_videos_per_s"] > 0
    assert s["batch_lengths"] == [160, 144, 176, 152, 168, 136]
    assert 0 <= s["pooled_vs_serial_max_prob_delta"] <= bench_torch.SERVING_DELTA_MAX
    assert s["k1_launches_per_request"] == 0
    assert cpu_run[0]["detail"]["kernel_launches"] == {}


def _stub_sections(monkeypatch, delta=0.0, tests=None):
    monkeypatch.setattr(bench_torch, "measure_ceiling", lambda dev, **kw: 100.0)
    monkeypatch.setattr(bench_torch, "bench_extraction", lambda dev, **kw: {
        "fps": 10.0, "ref_fps": 2.0, "batch": 4, "iters": 2})
    monkeypatch.setattr(bench_torch, "bench_tfam_train", lambda dev, **kw: {"ms_per_step": 1.0})

    def student(dev, **kw):
        raise MemoryError("out of memory")

    monkeypatch.setattr(bench_torch, "bench_student_train", student)
    monkeypatch.setattr(bench_torch, "bench_serving", lambda dev, **kw: {
        "pooled_vs_serial_max_prob_delta": delta})
    monkeypatch.setattr(bench_torch, "bench_cuda_test", lambda dev, **kw: tests or {
        "status": "passed", "passed": 400})


def test_a_failed_section_is_in_the_line_and_fails_the_run(monkeypatch):
    _stub_sections(monkeypatch)
    line, failures = bench_torch.run("cpu")
    assert line["value"] == 10.0 and line["vs_baseline"] == 5.0
    assert line["detail"]["student_train_step"] == {"error": "MemoryError: out of memory"}
    assert line["detail"]["tfam_train_step"]["seconds"] >= 0
    assert failures == ["student_train_step: MemoryError: out of memory"]


def test_a_pooled_serial_difference_fails_the_run(monkeypatch):
    _stub_sections(monkeypatch, delta=2e-5, tests={"status": "FAILED", "summary": "1 failed"})
    line, failures = bench_torch.run("cpu")
    # kept unrounded: its limit is below the line's rounding
    assert line["detail"]["serving"]["pooled_vs_serial_max_prob_delta"] == 2e-5
    assert failures[1:] == ["cuda_test: FAILED: 1 failed",
                            "serving: pooled vs serial probabilities differ by 2e-05 > 1e-05"]


def test_script_without_a_card_exits_non_zero_with_a_message():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run([sys.executable, str(ROOT / "bench_torch.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout == ""
    assert "torch.cuda.is_available() is False" in res.stderr


# ---------------------------------------------------------------------------
# the card tests' record
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stdout, tail, counts", [
    ("....\n400 passed, 3 deselected in 80.12s (0:01:20)\n",
     "400 passed, 3 deselected in 80.12s (0:01:20)", {"passed": 400}),
    ("..F.\nFAILED tests/test_torch_cuda.py::test_x - AssertionError\n"
     "1 failed, 398 passed, 2 skipped, 3 deselected in 90.00s\n",
     "1 failed, 398 passed, 2 skipped, 3 deselected in 90.00s",
     {"failed": 1, "passed": 398, "skipped": 2}),
    ("E\n1 passed, 2 errors in 1.00s\n", "1 passed, 2 errors in 1.00s",
     {"passed": 1, "error": 2}),
    ("no tests ran in 0.01s\n", "no tests ran in 0.01s", {}),
    ("", "", {}),
])
def test_pytest_summary_is_read_as_bench_py_reads_it(stdout, tail, counts):
    assert bench_torch.parse_pytest_summary(stdout) == (tail, counts)


def test_card_test_command_prints_the_summary_it_is_read_from():
    """The project's ``addopts`` hold ``-q``: the command must still end in
    pytest's counts (``-qq`` would drop them). Here, without a card, every
    card test skips."""
    res = subprocess.run([sys.executable, *bench_torch.CUDA_TEST_CMD], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    tail, counts = bench_torch.parse_pytest_summary(res.stdout)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    outcome = "passed" if torch.cuda.is_available() else "skipped"
    assert counts.get(outcome, 0) >= 400 and set(counts) <= {"passed", "skipped"}, tail


def test_cuda_test_records_the_subprocess(monkeypatch):
    calls = []

    def fake_run(cmd, **kw):
        calls.append((cmd, kw))
        return subprocess.CompletedProcess(cmd, 1, stdout="1 failed, 399 passed in 80s\n")

    monkeypatch.setattr(subprocess, "run", fake_run)
    out = bench_torch.bench_cuda_test("cuda", timeout_s=5)
    (cmd, kw), = calls
    assert cmd[1:] == ["-m", "pytest", "-o", "addopts=", "-m", "cuda", "--noconftest",
                       "-p", "no:cacheprovider", "tests/test_torch_cuda.py", "-q"]
    assert kw["timeout"] == 5 and Path(kw["cwd"]) == ROOT
    assert out["status"] == "FAILED" and out["returncode"] == 1
    assert out["failed"] == 1 and out["passed"] == 399
    assert out["summary"] == "1 failed, 399 passed in 80s" and out["duration_s"] >= 0

    def timeout(cmd, **kw):
        raise subprocess.TimeoutExpired(cmd, kw["timeout"])

    monkeypatch.setattr(subprocess, "run", timeout)
    out = bench_torch.bench_cuda_test("cuda", timeout_s=5)
    assert out["status"] == "FAILED" and "timed out" in out["error"]
    assert bench_torch.bench_cuda_test("cpu")["status"] == "skipped"
