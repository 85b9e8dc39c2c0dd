"""``tools/bench_memory_torch.py`` on the CPU: an arm that runs out of
memory reports ``oom``; B is reckoned from the 32:1 and 32:4 peaks and then
bracketed by measurement; a subset run merges its arms into the artifact."""

import importlib.util
import json
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
spec = importlib.util.spec_from_file_location("bench_memory_torch",
                                              ROOT / "tools" / "bench_memory_torch.py")
membench = importlib.util.module_from_spec(spec)
spec.loader.exec_module(membench)

GIB = 2**30


def test_arm_reports_oom(monkeypatch):
    """The shipped trainer at the recipe shape, its step raising the card's
    out-of-memory error: the arm records ``oom`` and does not raise."""
    from vimoclip_tpu_torch.train.student_trainer import StudentTrainer

    seen = []

    def out_of_memory(self, batch):
        seen.append(batch["motion_frames"].shape)
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")

    monkeypatch.setattr(StudentTrainer, "train_step", out_of_memory)
    rec = membench.arm(1, 1, device="cpu")
    assert rec["status"] == "oom" and "out of memory" in rec["oom_evidence"]
    assert seen == [(1, 29, 360, 640, 3)]
    assert rec["shape"] == [1, 29, 360, 640, 3] and "peak_allocated_bytes" not in rec


def test_arm_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        membench.main(["--arms", "32:1"])


def _peak(b, n, fixed=3 * GIB, per_row=0.6 * GIB, total=80 * GIB):
    peak = fixed + (b // n) * per_row
    status = "oom" if peak > total else "ok"
    return {"batch_size": b, "grad_accum": n, "status": status,
            "peak_allocated_bytes": int(min(peak, total)), "card_total_bytes": total}


def test_b_is_reckoned_then_bracketed():
    dense, accum = _peak(32, 1), _peak(32, 4)
    # the line through both: 3 GiB + 0.6 GiB a row passes 80 GiB at 129 rows
    assert membench.reckon_b(dense, accum) == 160
    ran = []

    def measure(b):
        ran.append(b)
        return _peak(b, 1)

    assert membench.find_b(measure, 160) == 160 and ran == [160, 128]
    ran.clear()
    assert membench.find_b(measure, 96) == 160 and ran == [96, 128, 160]
    ran.clear()
    assert membench.find_b(measure, 224) == 160 and ran == [224, 192, 160, 128]


def test_all_arms_and_subset_merge(tmp_path, monkeypatch):
    """The default arms resolve B and n (microbatches of 8); a later subset
    re-measures its arms and keeps the file's others."""
    calls = []

    def run_arm(b, n, device):
        calls.append((b, n))
        return _peak(b, n)

    monkeypatch.setattr(membench, "run_arm", run_arm)
    monkeypatch.setattr("vimoclip_tpu_torch.utils.device.describe_card",
                        lambda device: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr("vimoclip_tpu_torch.utils.device.resolve_device", lambda d: d)
    out = tmp_path / "m.json"
    assert membench.main(["--out", str(out)]) == 0
    assert calls == [(32, 1), (32, 4), (160, 1), (128, 1), (160, 20)]
    art = json.loads(out.read_text())
    arms = {(r["batch_size"], r["grad_accum"]): r["status"] for r in art["results"]}
    assert arms == {(32, 1): "ok", (32, 4): "ok", (128, 1): "ok", (160, 1): "oom",
                    (160, 20): "ok"}
    assert art["device"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    calls.clear()
    assert membench.main(["--out", str(out), "--arms", "32:4"]) == 0
    assert calls == [(32, 4)]
    assert len(json.loads(out.read_text())["results"]) == 5


def test_committed_artifact():
    """MEMBENCH_TORCH.json, from one card: 32:4 peaks below 32:1; B is the
    smallest multiple of 32 whose dense arm ran out, and B accumulated in
    microbatches of 8 trained."""
    art = json.loads((ROOT / "MEMBENCH_TORCH.json").read_text())
    assert "H100" in art["device"] and " W" in art["device"]
    arms = {(r["batch_size"], r["grad_accum"]): r for r in art["results"]}
    assert arms[32, 1]["status"] == arms[32, 4]["status"] == "ok"
    assert arms[32, 4]["peak_allocated_bytes"] < arms[32, 1]["peak_allocated_bytes"]
    dense = {b: r["status"] for (b, n), r in arms.items() if n == 1}
    b = min(size for size, status in dense.items() if status == "oom")
    assert b % 32 == 0 and dense[b - 32] == "ok"
    assert arms[b, b // membench.MICROBATCH]["status"] == "ok"
    assert all(r["status"] in ("ok", "oom") for r in art["results"])
