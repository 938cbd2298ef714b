"""The port imports nothing of JAX or of the JAX package.

Scans every module of frosting_tpu_torch/, chip_smoke.py and the port's
measurement scripts (blend_ab.py, scan_ab.py, extract_parts.py,
cleaning_radius.py, qem_ab.py) for imports of jax, jaxlib or frosting_tpu (the exact top-level
name: frosting_tpu is a prefix of frosting_tpu_torch), and of PIL and
optax, which the GPU machines the port runs on do not have; imports the
package in a fresh process where importing jax, PIL or optax fails; and
checks that the port's host C++ sources (csrc/*.cpp, the QEM decimator
among them) include only standard headers and are built from the port's
own csrc/, not from frosting_tpu/native.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "frosting_tpu", "PIL", "optax"}
SOURCES = sorted((ROOT / "frosting_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "blend_ab.py", ROOT / "scan_ab.py", ROOT / "extract_parts.py",
    ROOT / "cleaning_radius.py", ROOT / "qem_ab.py"]


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
        "from frosting_tpu_torch.raster import render as r2\nfrom PIL import Image\n"
    )
    assert _imported_roots(probe) & FORBIDDEN == {"jax", "frosting_tpu", "PIL"}


def test_package_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['PIL'] = None\n"
        "sys.modules['optax'] = None\n"
        "import frosting_tpu_torch.raster.render, frosting_tpu_torch.utils.viewer\n"
        "import frosting_tpu_torch.scene.synthetic, frosting_tpu_torch.scene.gaussians\n"
        "import frosting_tpu_torch.train.gs_trainer, frosting_tpu_torch.ops.ssim\n"
        "import frosting_tpu_torch.train.checkpoint, frosting_tpu_torch.utils.profiling\n"
        "import frosting_tpu_torch.bench.__main__, frosting_tpu_torch.bench.bench_1080p\n"
        "import frosting_tpu_torch.bench.perf_vpu_dtype, frosting_tpu_torch.bench.perf_scan_variants\n"
        "import frosting_tpu_torch.stages_cli, frosting_tpu_torch.scene.dataset\n"
        "import frosting_tpu_torch.utils.image, frosting_tpu_torch.train.sugar_trainer\n"
        "import frosting_tpu_torch.extract.shell, frosting_tpu_torch.extract.meshclean\n"
        "import frosting_tpu_torch.extract.poisson, frosting_tpu_torch.extract.marching\n"
        "import frosting_tpu_torch.ops.mesh, frosting_tpu_torch.ops.mesh_raster\n"
        "import frosting_tpu_torch.models.frosting, frosting_tpu_torch.train.frosting_trainer\n"
        "import frosting_tpu_torch.pipeline, frosting_tpu_torch.ops.segment\n"
        "import frosting_tpu_torch.extract.texture, frosting_tpu_torch.models.mesh_bound\n"
        "import frosting_tpu_torch.train.refined_sugar, frosting_tpu_torch.models.editing\n"
        "import frosting_tpu_torch.metrics, frosting_tpu_torch.cli\n"
        "import frosting_tpu_torch.parallel.collectives, frosting_tpu_torch.parallel.exchange\n"
        "import frosting_tpu_torch.parallel.sharded_train, frosting_tpu_torch.parallel.multihost\n"
        "import frosting_tpu_torch.parallel.sharded_sugar\n"
        "import frosting_tpu_torch.parallel.sharded_frosting\n"
        "import frosting_tpu_torch.parallel.__main__ as parallel_main\n"
        "import frosting_tpu_torch.parallel.pipeline as parallel_pipeline\n"
        "import frosting_tpu_torch.parallel.report\n"
        "from frosting_tpu_torch import blender_cli, cli, stages_cli\n"
        "import inspect\n"
        "from frosting_tpu_torch import metrics, pipeline\n"
        "from frosting_tpu_torch.extract import meshclean\n"
        "assert cli.build_parser().parse_args(['-s', 'x']).device == 'cuda'\n"
        "assert parallel_main.parse_args([]).device == 'cuda'\n"
        "assert parallel_pipeline.parse_args([]).device == 'cuda'\n"
        "for fn in (pipeline.run_pipeline, metrics.get_lpips, metrics.LPIPS,\n"
        "           meshclean.nearest_distances, meshclean.remove_unsupported_vertices):\n"
        "    assert inspect.signature(fn).parameters['device'].default == 'cuda', fn\n"
        "for cmd in ('metrics', 'full-eval'):\n"
        "    assert stages_cli.build_parser().parse_args([cmd, '-s', 'x']).device == 'cuda'\n"
        "assert stages_cli.build_parser().parse_args(['train-sugar', '-s', 'x']).device == 'cuda'\n"
        "assert stages_cli.build_parser().parse_args(['extract-shell', '-s', 'x']).device == 'cuda'\n"
        "assert stages_cli.build_parser().parse_args(['train-frosting', '-s', 'x']).device == 'cuda'\n"
        "for cmd in ('train-refined-sugar', 'extract-texture', 'render', 'train-gs'):\n"
        "    assert stages_cli.build_parser().parse_args([cmd, '-s', 'x']).device == 'cuda'\n"
        "assert blender_cli.build_parser().parse_args(\n"
        "    ['--package', 'p', '--checkpoints', 'c', '--out', 'o']).device == 'cuda'\n"
        "assert not any(m == 'frosting_tpu' or m.startswith('frosting_tpu.')\n"
        "               for m in sys.modules)\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_host_sources_are_the_ports_own():
    from frosting_tpu_torch import _build

    csrc = ROOT / "frosting_tpu_torch" / "csrc"
    sources = sorted(csrc.glob("*.cpp"))
    assert {p.stem for p in sources} >= {"qem", "image_decode"}
    # a source includes system headers and the port's own host headers
    # (csrc/*.h, which include system headers only)
    for path in sources + sorted(csrc.glob("*.h")):
        includes = [line.split()[1] for line in path.read_text().splitlines()
                    if line.startswith("#include")]
        own = [i.strip('"') for i in includes if not i.startswith("<")]
        assert all((csrc / i).is_file() and i.endswith(".h") for i in own), (path.name, includes)
        assert path.suffix == ".cpp" or not own, (path.name, includes)
        assert "frosting_tpu/" not in path.read_text()
    for path in sources:
        assert _build.source_path(path.stem) == path
        assert _build.library_path(path.stem).parent == ROOT / "frosting_tpu_torch" / "_build"
