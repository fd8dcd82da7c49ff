"""The port stands alone: no file of `mmtpu_torch/`, and not `chip_smoke.py`,
imports JAX, flax, optax, transformers, safetensors or the `mmtpu` package
(the name is matched exactly, so `mmtpu_torch` itself passes); its BERT and
checkpoint readers are its own. The card's machine has none of them, and
neither has PyYAML, which the port may import only inside its YAML loader,
nor pandas, sklearn, matplotlib, msgpack or (as far as is known) h5py,
which the port never imports (its metrics are its own numpy versions of
sklearn's), except matplotlib inside the embedding report's plotting
function and h5py inside the real MM-IMDb reader."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "mmtpu", "transformers", "safetensors"}
HOST_ONLY = {"pandas", "sklearn", "matplotlib", "msgpack", "h5py"}
PORT_FILES = sorted((REPO / "mmtpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imports(tree):
    """(top-level module name, node) for every import in the tree."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_mmtpu_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = sorted({name for name, _ in _imports(tree) if name in FORBIDDEN})
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


# the exceptions, each imported inside the one function that needs it, as
# mmtpu's: the embedding report draws its plots with matplotlib; the real
# MM-IMDb reader opens its HDF5 files with h5py
LAZY_HOST_ONLY = {("mmtpu_torch/reports/report.py", "matplotlib"),
                  ("mmtpu_torch/data/mmimdb.py", "h5py")}


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_host_only_libraries(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    rel = path.relative_to(REPO).as_posix()
    bad = sorted({name for name, node in _imports(tree) if name in HOST_ONLY
                  and not ((rel, name) in LAZY_HOST_ONLY and node.col_offset > 0)})
    assert not bad, f"{rel} imports {bad}"


def test_yaml_is_imported_only_inside_the_yaml_loader():
    where = []
    for path in PORT_FILES:
        tree = ast.parse(path.read_text(), filename=str(path))
        for name, node in _imports(tree):
            if name == "yaml":
                where.append((path.relative_to(REPO).as_posix(), node.col_offset > 0))
    assert where, "the YAML loader imports yaml somewhere"
    for rel, nested in where:
        assert rel == "mmtpu_torch/config/yaml_tags.py" and nested, (rel, nested)


def test_scan_catches_a_forbidden_import():
    tree = ast.parse("import os\nfrom mmtpu.ops import fused_mlp\nimport mmtpu_torch\n")
    assert [n for n, _ in _imports(tree) if n in FORBIDDEN] == ["mmtpu"]
