"""The port imports nothing of JAX or of the JAX package.

Scans every module of frosting_tpu_torch/, chip_smoke.py and blend_ab.py for imports of
jax, jaxlib or frosting_tpu (the exact top-level name: frosting_tpu is a
prefix of frosting_tpu_torch), and imports the package in a fresh process
where importing jax fails.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "frosting_tpu"}
SOURCES = sorted((ROOT / "frosting_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "blend_ab.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    assert not _imported_roots(path) & FORBIDDEN


def test_scan_sees_the_forbidden_names(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text(
        "import jax.numpy as jnp\nfrom frosting_tpu.raster import render\n"
        "from frosting_tpu_torch.raster import render as r2\n"
    )
    assert _imported_roots(probe) & FORBIDDEN == {"jax", "frosting_tpu"}


def test_package_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "import frosting_tpu_torch.raster.render, frosting_tpu_torch.utils.viewer\n"
        "import frosting_tpu_torch.scene.synthetic, frosting_tpu_torch.scene.gaussians\n"
        "import frosting_tpu_torch.train.gs_trainer, frosting_tpu_torch.ops.ssim\n"
        "import frosting_tpu_torch.train.checkpoint, frosting_tpu_torch.utils.profiling\n"
        "import frosting_tpu_torch.bench.__main__, frosting_tpu_torch.bench.bench_1080p\n"
        "import frosting_tpu_torch.bench.perf_vpu_dtype, frosting_tpu_torch.bench.perf_scan_variants\n"
        "assert 'optax' not in sys.modules\n"
        "assert not any(m == 'frosting_tpu' or m.startswith('frosting_tpu.')\n"
        "               for m in sys.modules)\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
