"""canvas_tpu_torch stands alone: it imports neither jax nor canvas_tpu (nor,
until its plot tool draws, matplotlib), and a run that asks for a CUDA
device where there is none raises."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "canvas_tpu_torch"
SOURCES = sorted(p.relative_to(REPO).as_posix()
                 for p in PACKAGE.rglob("*")
                 if p.suffix in (".py", ".cu", ".cpp") and p.is_file()
                 and "_build" not in p.parts)


def _python(code: str, **kw) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120, **kw)


def test_package_and_cli_import_without_jax():
    res = _python(
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import canvas_tpu_torch, canvas_tpu_torch.pipeline.cli\n"
        "import canvas_tpu_torch.pipeline.runner\n"
        "import canvas_tpu_torch.ops.cbs, canvas_tpu_torch.ops.cbs_device\n"
        "import canvas_tpu_torch.ops.cbs_mega\n"
        "import canvas_tpu_torch.ops.cbs_mega_cuda\n"
        "import canvas_tpu_torch.ops.arc_scan_cuda\n"
        "import canvas_tpu_torch.ops.threefry\n"
        "import canvas_tpu_torch.ops.smooth, canvas_tpu_torch.ops.ratio\n"
        "import canvas_tpu_torch.ops.fragments\n"
        "import canvas_tpu_torch.ops.clustering\n"
        "import canvas_tpu_torch.ops.meanshift\n"
        "import canvas_tpu_torch.ops.metrics, canvas_tpu_torch.ops.wavelets\n"
        "import canvas_tpu_torch.io.manifest\n"
        "import canvas_tpu_torch.models.diploid\n"
        "import canvas_tpu_torch.models.somatic\n"
        "import canvas_tpu_torch.models.somatic_grid\n"
        "import canvas_tpu_torch.models.common_cnv\n"
        "import canvas_tpu_torch.tools.evaluate_cnv\n"
        "import canvas_tpu_torch.tools.copy_number_oracle\n"
        "import canvas_tpu_torch.tools.sweep_parameters\n"
        "import canvas_tpu_torch.tools.optimize_somatic_model\n"
        "import canvas_tpu_torch.tools.plot_somatic_model\n"
        "import canvas_tpu_torch.wrapper\n"
        "import canvas_tpu_torch.parallel.mesh\n"
        "import canvas_tpu_torch.parallel.distributed\n"
        "import canvas_tpu_torch.pipeline.device_pipeline\n"
        "import canvas_tpu_torch.graft_entry\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None\n"
        "       and (m == 'canvas_tpu' or m.startswith('canvas_tpu.')\n"
        "            or m.split('.')[0] in ('jax', 'matplotlib'))]\n"
        "print('LOADED', bad)\n")
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout


@pytest.mark.parametrize("source", SOURCES)
def test_source_has_no_jax_or_reference_package(source):
    text = (REPO / source).read_text()
    assert not re.search(r"^\s*(import jax|from jax)", text, re.M)
    assert not re.search(r"canvas_tpu\.", text)
    assert "torch.compile" not in text


@pytest.mark.parametrize("script", ["chip_smoke.py", "kernel_variants.py"])
def test_chip_scripts_import_without_jax(script):
    """The scripts run on the card's machine, which has no JAX."""
    text = (REPO / script).read_text()
    assert not re.search(r"^\s*(import jax|from jax)", text, re.M)
    assert not re.search(r"canvas_tpu\.", text)
    res = _python("import sys\n"
                  "sys.modules['jax'] = None\n"
                  f"import {script[:-3]}\n")
    assert res.returncode == 0, res.stderr


def test_cuda_device_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from canvas_tpu_torch.config import resolve_device

    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    (tmp_path / "kmer.fa").write_text(">chr1\nACGT\n")
    res = subprocess.run(
        [sys.executable, "-m", "canvas_tpu_torch", "SmallPedigree-WGS",
         "--device", "cuda", "--bams", "a.bam", "--names", "a",
         "--types", "Proband", "-r", str(tmp_path), "-o",
         str(tmp_path / "out")],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "torch.cuda.is_available() is False" in res.stderr
