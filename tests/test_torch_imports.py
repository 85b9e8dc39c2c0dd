"""The port stands alone: no module of ``vimoclip_tpu_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package; entry points refuse a
missing card instead of falling back; CPU calls launch no kernel."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "vimoclip_tpu_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py")
)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax", "orbax", "vimoclip_tpu")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.relative_to(ROOT)}:{node.lineno} imports {bad}"


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'vimoclip_tpu'))\n"
        "print('BAD', bad)\n"
        "from vimoclip_tpu_torch.ops.kernels.flash_attention import flash_attention\n"
        "import torch\n"
        "q = torch.randn(1, 2, 5, 8)\n"
        "flash_attention(q, q, q)\n"
        "print('LAUNCHES', sum(flash_attention.launches.values()))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout
    assert "LAUNCHES 0" in res.stdout, res.stdout


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from vimoclip_tpu_torch.utils.device import resolve_device

    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_build_without_nvcc_raises(monkeypatch):
    from vimoclip_tpu_torch.ops.kernels import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()


def test_chip_smoke_refuses_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        res = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout


NEW_MODULES = ["vimoclip_tpu_torch.extraction", "vimoclip_tpu_torch.motion",
               "vimoclip_tpu_torch.pipeline", "vimoclip_tpu_torch.data.hdf5_schema",
               "vimoclip_tpu_torch.cli.extract_embeddings", "vimoclip_tpu_torch.cli.h5_merge",
               "vimoclip_tpu_torch.cli.h5_structure_checker",
               "vimoclip_tpu_torch.cli.generate_motion", "vimoclip_tpu_torch.cli.extract_frames",
               "vimoclip_tpu_torch.cli.run_pipeline", "vimoclip_tpu_torch.cli.serve",
               "vimoclip_tpu_torch.cli.benchmark", "vimoclip_tpu_torch.cli.convert",
               "vimoclip_tpu_torch.cli.run_experiments", "vimoclip_tpu_torch.utils.profiling",
               "vimoclip_tpu_torch.data.native", "vimoclip_tpu_torch.data.video_reader",
               "vimoclip_tpu_torch.ops.quant", "vimoclip_tpu_torch.ops.tome",
               "vimoclip_tpu_torch.fidelity"]


@pytest.mark.parametrize("module", NEW_MODULES)
def test_module_imports_without_host_libraries(module):
    """The card's machine has no cv2, h5py, pandas or PyYAML: the modules
    import them only where they are used."""
    code = (
        "import sys\n"
        "for name in ('cv2', 'h5py', 'pandas', 'yaml'): sys.modules[name] = None\n"
        f"import importlib; importlib.import_module({module!r})\n"
        "print('OK')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0 and "OK" in res.stdout, res.stderr


def test_new_entry_points_default_to_the_card(tmp_path):
    """Without a card, each new entry point raises at its default device,
    before it writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from vimoclip_tpu_torch.extraction import ClipExtractor, create_hdf5_dataset
    from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig
    from vimoclip_tpu_torch.motion import (
        PtlflowAdapter,
        generate_frame_diff_video,
        process_video_list,
    )
    from vimoclip_tpu_torch.pipeline import PipelineConfig, run_pipeline

    (tmp_path / "ann.txt").write_text("v.mp4 0\n")
    (tmp_path / "cls.csv").write_text("id,name\n0,a\n")
    (tmp_path / "list.txt").write_text("v.mp4\n")
    calls = [
        lambda: ClipExtractor({}, ClipVisionConfig()),
        lambda: ClipExtractor({}, ClipVisionConfig(), device="cuda"),
        lambda: create_hdf5_dataset(str(tmp_path), str(tmp_path / "ann.txt"),
                                    str(tmp_path / "cls.csv"), str(tmp_path / "out.h5"),
                                    {}, ClipVisionConfig()),
        lambda: PtlflowAdapter(torch.nn.Identity()),
        lambda: PtlflowAdapter(torch.nn.Identity(), device="cuda"),
        lambda: generate_frame_diff_video(str(tmp_path / "v.mp4"), str(tmp_path / "o.mp4")),
        lambda: process_video_list(str(tmp_path / "list.txt"), str(tmp_path),
                                   str(tmp_path / "motion")),
        lambda: run_pipeline(PipelineConfig(
            workdir=str(tmp_path / "run"), data_root=str(tmp_path),
            train_annotations="", val_annotations="", class_file="", clip_weights="",
            tfam_config="")),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ann.txt", "cls.csv", "list.txt"]
