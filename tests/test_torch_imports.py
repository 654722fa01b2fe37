"""The port stands alone: no module of ``src/repro_torch``, not
``chip_smoke.py`` and no timing script under ``scripts/`` imports jax or
anything of the JAX package ``repro``."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    return (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
            + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "scripts").glob("*.py")))


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    assert path.exists(), path
    bad = _imported_roots(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_checker_sees_forbidden_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom repro.kernels import ops\n"
                 "from repro_torch import kernels\n")
    assert _imported_roots(f) & FORBIDDEN == {"jax", "repro"}


def test_training_slice_modules_are_checked():
    """The training slice's modules are among the files checked above."""
    checked = set(_port_files())
    for rel in ("optim/__init__.py", "optim/adamw.py", "data/__init__.py",
                "data/pipeline.py", "checkpoint/__init__.py",
                "checkpoint/manager.py", "distributed/ft.py", "launch/steps.py",
                "launch/train.py", "kernels/sliding_conv_bwd.py"):
        assert ROOT / "src" / "repro_torch" / rel in checked, rel


def test_int8_slice_modules_are_checked():
    """The int8 serving slice's modules are among the files checked above."""
    checked = set(_port_files())
    for rel in ("health.py", "optim/compress.py", "quant/__init__.py",
                "quant/qconv.py", "quant/calibrate.py", "quant/apply.py",
                "kernels/sliding_conv_quant.py"):
        assert ROOT / "src" / "repro_torch" / rel in checked, rel


def test_jamba_slice_modules_are_checked():
    """The jamba serving slice's modules are among the files checked
    above."""
    checked = set(_port_files())
    for rel in ("configs/jamba_1_5_large_398b.py", "models/mamba.py",
                "models/moe.py", "models/jamba.py", "core/conv.py",
                "kernels/sliding_conv1d.py", "kernels/sliding_conv_quant.py",
                "kernels/autotune.py"):
        assert ROOT / "src" / "repro_torch" / rel in checked, rel


def test_pool_and_scan_slice_modules_are_checked():
    """The pooling and scan slice's modules are among the files checked
    above."""
    checked = set(_port_files())
    for rel in ("core/sliding.py", "kernels/sliding_pool.py",
                "kernels/ssm_scan.py", "kernels/ops.py",
                "kernels/autotune.py"):
        assert ROOT / "src" / "repro_torch" / rel in checked, rel


def test_obs_slice_modules_are_checked():
    """The observability slice's modules are among the files checked
    above."""
    checked = set(_port_files())
    for rel in ("obs/__init__.py", "obs/__main__.py", "obs/logs.py",
                "obs/metrics.py", "obs/names.py", "obs/report.py",
                "obs/trace.py", "health.py", "launch/serve.py",
                "launch/train.py"):
        assert ROOT / "src" / "repro_torch" / rel in checked, rel
