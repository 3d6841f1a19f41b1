"""The PyTorch port imports neither JAX nor the reference package.

A subprocess imports ``repro_torch`` and every module under it and checks
``sys.modules``; an AST scan checks every port file and ``chip_smoke.py``
for ``import jax`` and for imports of ``repro`` / ``repro.*`` and of the
repository's ``benchmarks`` (the port's benchmark twins keep their own
copies).
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules() -> list[str]:
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(ROOT / "src").with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_imports_without_jax_or_repro():
    mods = _port_modules()
    for mod in ("repro_torch.kernels.fused_span.kernel",
                "repro_torch.kernels.flash_attention.kernel",
                "repro_torch.kernels.ssd_scan.kernel",
                "repro_torch.models.mamba",
                "repro_torch.models.moe", "repro_torch.models.encdec",
                "repro_torch.launch.serve",
                "repro_torch.occam.quant.casting",
                "repro_torch.occam.calibrate.timers",
                "repro_torch.occam.audit", "repro_torch.occam.audit.api",
                "repro_torch.occam.audit.concurrency",
                "repro_torch.occam.audit.__main__",
                "repro_torch.occam.serve", "repro_torch.occam.serve.engine",
                "repro_torch.occam.serve.router",
                "repro_torch.optim.adamw", "repro_torch.optim.compression",
                "repro_torch.data.pipeline",
                "repro_torch.checkpoint.checkpointer",
                "repro_torch.runtime.elastic", "repro_torch.launch.train_step",
                "repro_torch.launch.train", "repro_torch.runtime.pipeline",
                "repro_torch.models.sharding", "repro_torch.launch.mesh",
                "repro_torch.launch.specs", "repro_torch.launch.dryrun",
                "repro_torch.examples", "repro_torch.examples.quickstart",
                "repro_torch.examples.occam_cnn_pipeline",
                "repro_torch.examples.serve_pipeline",
                "repro_torch.examples.async_serve",
                "repro_torch.examples.train_tiny_lm",
                "repro_torch.benchmarks", "repro_torch.benchmarks.common",
                "repro_torch.benchmarks.audit_stamp",
                "repro_torch.benchmarks.tables",
                "repro_torch.benchmarks.occam_stap",
                "repro_torch.benchmarks.occam_serve",
                "repro_torch.benchmarks.occam_async",
                "repro_torch.benchmarks.occam_autoplan",
                "repro_torch.benchmarks.occam_quant",
                "repro_torch.benchmarks.occam_calibrate",
                "repro_torch.benchmarks.run",
                "repro_torch.benchmarks.smoke",
                "repro_torch.benchmarks.roofline"):
        assert mod in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'repro'\n"
        "             or m.startswith('repro.') or m == 'benchmarks'\n"
        "             or m.startswith('benchmarks.'))\n"
        "print(len(bad), bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "0 []", out.stdout


def test_occam_exports_audit_and_serve_without_jax():
    """``import repro_torch.occam`` alone brings the audit and the async
    engine, under the reference's names, and neither JAX nor ``repro``."""
    code = (
        "import importlib, sys\n"
        "from repro_torch import occam\n"
        "a = importlib.import_module('repro_torch.occam.audit')\n"
        "s = importlib.import_module('repro_torch.occam.serve')\n"
        "names = ['audit', 'AsyncEngine', 'AsyncTicket', 'Router',\n"
        "         'lint_serve', 'AdmissionError', 'AUDIT_RULES',\n"
        "         'AuditError', 'AuditReport', 'AuditWarning', 'Finding',\n"
        "         'serve']\n"
        "assert all(n in occam.__all__ and hasattr(occam, n)\n"
        "           for n in names)\n"
        "assert callable(occam.audit) and occam.serve is s\n"
        "assert occam.lint_serve is a.lint_serve\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'repro'\n"
        "             or m.startswith('repro.'))\n"
        "print(len(bad), bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "0 []", out.stdout


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_in_source(path):
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "repro", "benchmarks"}, roots
