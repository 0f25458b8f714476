"""The port stands alone: no file of volumetricrenderer_tpu_torch/, not
chip_smoke.py and not the test workers of the data-parallel step and of
the sharded render imports JAX, optax, orbax or the JAX package (checked
on the source, since this test process has JAX loaded already), and the
renderer never falls back to the CPU when CUDA is missing."""

import ast
from pathlib import Path

import pytest
import torch

import volumetricrenderer_tpu_torch as vt
from volumetricrenderer_tpu_torch.ops import cuda

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "optax", "orbax", "volumetricrenderer_tpu")


def _port_files():
    files = sorted((ROOT / "volumetricrenderer_tpu_torch").rglob("*.py"))
    assert len(files) > 10
    return files + [ROOT / "chip_smoke.py",
                    ROOT / "tests" / "torch_sharded_worker.py",
                    ROOT / "tests" / "torch_shardmap_worker.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name in _imported(tree):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {name}"


def test_renderer_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vt.VolumetricRenderer(vt.FULL_CONFIG)
    assert vt.VolumetricRenderer(vt.FULL_CONFIG, device="cpu").device.type \
        == "cpu"


def test_cuda_table_struct_matches_header():
    """ops/cuda.py VrTables lists the fields of csrc/common.cuh's struct in
    the same order (the kernels read it by layout)."""
    src = (ROOT / "volumetricrenderer_tpu_torch/csrc/common.cuh").read_text()
    body = src[src.index("struct VrTables {"):src.index("};")]
    names = []
    for line in body.splitlines()[1:]:
        decl = line.split("//")[0].strip().rstrip(";")
        if not decl:
            continue
        decl = decl.replace("const ", "").replace("*", " ")
        names += [n.strip() for n in decl.split(None, 1)[1].split(",")]
    assert names == [f[0] for f in cuda.VrTables._fields_]
