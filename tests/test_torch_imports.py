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
        "print('LAUNCHES', flash_attention.launches)\n"
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
