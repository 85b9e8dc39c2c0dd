"""The port stands alone: no module of ``vimoclip_tpu_torch``, no
``tools/*_torch.py`` and not ``chip_smoke.py`` imports JAX or the JAX
package; entry points refuse a missing card instead of falling back; CPU
calls launch no kernel."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "vimoclip_tpu_torch"
TOOLS = sorted((ROOT / "tools").glob("*_torch.py"))
FILES = sorted(PORT.rglob("*.py")) + TOOLS + [ROOT / "chip_smoke.py"]
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
        "import importlib.util\n"
        f"for p in {[str(t) for t in TOOLS]!r}:\n"
        "    spec = importlib.util.spec_from_file_location('tool', p)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
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


@pytest.mark.parametrize("device, index", [("cuda:2", "2"), ("cuda", "0")])
def test_describe_card_queries_the_named_card(device, index, monkeypatch):
    """``describe_card`` asks ``nvidia-smi`` for the card ``device`` names
    (the current card when it names none) and returns its one line; the
    CPU needs no query."""
    import subprocess

    from vimoclip_tpu_torch.utils import device as dev_mod

    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout="NVIDIA H100 80GB HBM3, 700.00 W\n")

    monkeypatch.setattr(subprocess, "run", run)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert dev_mod.describe_card("cpu") == "cpu" and not calls
    assert dev_mod.describe_card(device) == "NVIDIA H100 80GB HBM3, 700.00 W"
    (cmd,) = calls
    assert cmd[0] == "nvidia-smi" and f"--id={index}" in cmd
    assert "--query-gpu=name,power.limit" in cmd and "--format=csv,noheader" in cmd


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_tables", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_names_no_fma_kernel_among_the_float32_kinds():
    """Every float32 kernel ``chip_smoke.py`` times runs on the tensor
    cores: its name is among those whose SASS phase 2 holds to HGMMA and
    UTMALDG (K2's dq sum, a plain sum of its shares, aside), K3's among
    them."""
    smoke = _chip_smoke()
    wgmma = {name for names in smoke.WGMMA_KERNELS.values() for name in names}
    for kind, by_dtype in smoke.KERNEL_NAMES.items():
        for name in by_dtype["float32"]:
            assert name in wgmma or name == "dq_reduce_kernel<float", (kind, name)
    assert smoke.KERNEL_NAMES["bwd_dq"]["float32"] == ("dq_tf32_kernel",)
    assert smoke.KERNEL_NAMES["bwd_dq_wide"]["float32"] == ("dq_tf32_wide_kernel",)


def test_chip_smoke_names_the_paired_bf16_dq_kernel_above_head_dim_128():
    """Above head dim 128 the bf16 K3 is the paired kernel, whose SASS phase
    2 holds to HGMMA and UTMALDG and whose build must show no spills."""
    smoke = _chip_smoke()
    assert smoke.KERNEL_NAMES["bwd_dq_wide"]["bfloat16"] == ("dq_pair_wgmma_kernel",)
    assert "dq_pair_wgmma_kernel" in smoke.WGMMA_KERNELS["flash_attention_bwd"]
    assert "dq_pair_wgmma_kernel" in smoke.NO_SPILL_KERNELS


def _global_kernels() -> set[str]:
    """The names of the ``__global__`` functions in the port's CUDA sources."""
    import re

    pattern = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s+)?"
                         r"(\w+)\s*\(")
    return {m.group(1) for src in sorted((PORT / "csrc").glob("*.cu"))
            for m in pattern.finditer(src.read_text())}


def test_chip_smoke_names_only_kernels_the_sources_define():
    """Every kernel name ``chip_smoke.py`` times, counts or checks the SASS
    of is a ``__global__`` function of ``csrc/`` (a template's
    instantiation, ``dq_reduce_kernel<...``, by its stem), so that a
    retired kernel's name cannot linger there."""
    smoke = _chip_smoke()
    defined = _global_kernels()
    assert {"dq_pair_wgmma_kernel", "dkv_pair_wgmma_kernel", "dq_reduce_kernel"} <= defined
    named = {n for by_dtype in smoke.KERNEL_NAMES.values() for names in by_dtype.values()
             for n in names}
    named |= {n for names in smoke.WGMMA_KERNELS.values() for n in names}
    named |= set(smoke.NO_SPILL_KERNELS)
    for name in sorted(named):
        assert name.split("<")[0] in defined, name


@pytest.mark.parametrize("kind, want_ms", [("fwd_lse", 0.0586), ("bwd_dqkv", 0.1464),
                                           ("bwd_dq", 0.0879), ("bwd_dkv", 0.117)])
def test_chip_smoke_bounds_every_float32_kind_at_the_tf32_rate(kind, want_ms):
    """``_bound`` gives each float32 kind, K3 included, the three-pass TF32
    rate (495 TFLOP/s over three) at (8, 8, 768, 768, 64), and the FMA rate
    only when asked for it (the parent's bound)."""
    smoke = _chip_smoke()
    shape = (8, 8, 768, 768, 64)
    ms, by = smoke._bound(kind, "float32", shape, 4, 0.1)
    assert (ms, by) == smoke._bound(kind, "float32", shape, 4, 0.1, smoke.PEAK_FLOPS["float32"])
    assert by == "operations" and ms == pytest.approx(want_ms, rel=2e-3)
    fma_ms, _ = smoke._bound(kind, "float32", shape, 4, 0.1, smoke.FMA_FLOPS)
    assert fma_ms > 2 * ms


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


@pytest.mark.parametrize("module", NEW_MODULES + [str(t.relative_to(ROOT)) for t in TOOLS])
def test_module_imports_without_host_libraries(module):
    """The card's machine has no cv2, h5py, pandas or PyYAML: the modules
    and the port's tools import them only where they are used."""
    if module.endswith(".py"):
        load = ("import importlib.util\n"
                f"spec = importlib.util.spec_from_file_location('tool', {module!r})\n"
                "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n")
    else:
        load = f"import importlib; importlib.import_module({module!r})\n"
    code = (
        "import sys\n"
        "for name in ('cv2', 'h5py', 'pandas', 'yaml'): sys.modules[name] = None\n"
        + load + "print('OK')\n"
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
