"""The port stands alone: no module of ``src/repro_torch``, not
``chip_smoke.py``, no timing script under ``scripts/`` and no example port
``examples/*_torch.py`` imports jax or anything of the JAX package
``repro``."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    return (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
            + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "scripts").glob("*.py"))
            + sorted((ROOT / "examples").glob("*_torch.py")))


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


def test_tuning_slice_modules_are_checked():
    """The tuning slice's modules are among the files checked above: the
    cache and searches, the card timer, the plan functions and the
    dispatch that consults the cache."""
    checked = set(_port_files())
    for rel in ("kernels/autotune.py", "kernels/timing.py",
                "kernels/gemm_plan.py", "kernels/attention_decode.py",
                "kernels/ops.py", "health.py"):
        assert ROOT / "src" / "repro_torch" / rel in checked, rel


def test_examples_and_rwkv6_slice_files_are_checked():
    """The four example ports and the rwkv6 slice's modules are among the
    files checked above."""
    checked = set(_port_files())
    for name in ("edge_cnn", "quickstart", "serve_decode", "train_lm"):
        assert ROOT / "examples" / f"{name}_torch.py" in checked, name
    for rel in ("configs/rwkv6_1_6b.py", "models/rwkv6.py",
                "models/common.py", "models/__init__.py"):
        assert ROOT / "src" / "repro_torch" / rel in checked, rel


def test_robustness_slice_modules_are_checked():
    """The robustness slice's modules are among the files checked above:
    the fault switchboard, the breakers, the ladder, its hook sites and the
    catch layers."""
    checked = set(_port_files())
    for rel in ("faults.py", "health.py", "kernels/ops.py",
                "kernels/autotune.py", "checkpoint/manager.py",
                "distributed/ft.py", "quant/calibrate.py", "launch/serve.py",
                "launch/train.py", "launch/steps.py"):
        assert ROOT / "src" / "repro_torch" / rel in checked, rel


def test_analysis_slice_modules_are_checked():
    """The analysis gate's modules are among the files checked above."""
    checked = set(_port_files())
    for rel in ("analysis/__init__.py", "analysis/__main__.py",
                "analysis/contracts.py", "analysis/costmodel.py",
                "analysis/ranges.py", "analysis/lint.py", "analysis/bloat.py"):
        assert ROOT / "src" / "repro_torch" / rel in checked, rel


def test_mesh_slice_modules_are_checked():
    """The mesh runtime's modules are among the files checked above: the
    rules and Runtime, the mesh and its launcher, the collectives, the
    error-feedback all-reduce, the expert-parallel MoE, the models that
    take a Runtime, the synced step, the elastic checkpoints, the pipeline
    and the bridge's rank block."""
    checked = set(_port_files())
    for rel in ("distributed/sharding.py", "launch/mesh.py",
                "distributed/collectives.py", "optim/compress.py",
                "models/moe.py", "models/__init__.py",
                "models/transformer.py", "models/whisper.py",
                "models/common.py", "launch/steps.py",
                "checkpoint/manager.py", "distributed/pipeline.py",
                "bridge.py"):
        assert ROOT / "src" / "repro_torch" / rel in checked, rel


def test_tensor_parallel_slice_files_are_checked():
    """The Megatron and FSDP slice's modules are among the files checked
    above, and the helper its rank tests spawn imports neither jax nor
    repro."""
    checked = set(_port_files())
    for rel in ("distributed/sharding.py", "distributed/collectives.py",
                "optim/adamw.py", "optim/compress.py", "models/layers.py",
                "models/common.py", "launch/steps.py", "models/transformer.py",
                "models/moe.py", "models/llava.py", "models/whisper.py",
                "models/mamba.py", "models/jamba.py", "bridge.py",
                "checkpoint/manager.py", "models/rwkv6.py",
                "analysis/contracts.py", "launch/serve.py"):
        assert ROOT / "src" / "repro_torch" / rel in checked, rel
    assert ROOT / "scripts" / "gloo_probe.py" in checked
    helper = ROOT / "tests" / "torch_tp_common.py"
    assert not _imported_roots(helper) & FORBIDDEN
