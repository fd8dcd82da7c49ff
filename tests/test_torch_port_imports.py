"""The port stands alone: no file of `mmtpu_torch/`, and not `chip_smoke.py`,
imports JAX, flax, optax, transformers, safetensors or the `mmtpu` package
(the name is matched exactly, so `mmtpu_torch` itself passes); its BERT and
checkpoint readers are its own. The port may import PyYAML only inside its
YAML loader, and never pandas, sklearn, matplotlib, msgpack, h5py,
seaborn, OpenCV or PIL (its metrics are its own numpy versions of
sklearn's), except matplotlib inside the embedding report's plotting
function, h5py inside the real MM-IMDb and IEMOCAP readers and the
monitor's storage (which its analyser calls), and the analysis copy's
libraries inside the functions that draw or tabulate with them: the card's
machine has no JAX, sklearn or h5py, so the port must not need them there."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "mmtpu", "transformers", "safetensors"}
HOST_ONLY = {"pandas", "sklearn", "matplotlib", "msgpack", "h5py", "seaborn", "cv2", "PIL"}
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
# MM-IMDb and IEMOCAP readers open their HDF5 files with h5py, and so do the
# monitor's storage and analyser (through the storage's `import_h5py`)
LAZY_HOST_ONLY = {("mmtpu_torch/reports/report.py", "matplotlib"),
                  ("mmtpu_torch/data/mmimdb.py", "h5py"),
                  ("mmtpu_torch/data/iemocap.py", "h5py"),
                  ("mmtpu_torch/monitor/storage.py", "h5py"),
                  # the analysis copy (mmtpu/analysis/) draws and tabulates
                  # offline: each library inside the functions that use it
                  ("mmtpu_torch/analysis/processing.py", "pandas"),
                  ("mmtpu_torch/analysis/plotting.py", "matplotlib"),
                  ("mmtpu_torch/analysis/plotting.py", "sklearn"),
                  ("mmtpu_torch/analysis/plotting.py", "cv2"),
                  ("mmtpu_torch/analysis/plotting.py", "PIL"),
                  ("mmtpu_torch/analysis/visualiser.py", "seaborn")}


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


# the serving export, the kernels' operators and Kinetics-Sounds: scanned
# like every other module of the port
EXPORT_SLICE = ("mmtpu_torch/ops/library.py", "mmtpu_torch/serving/export.py",
                "mmtpu_torch/data/kinetics_sounds.py", "mmtpu_torch/models/kinetics_sounds.py")


# IEMOCAP and the recurrent registry encoders
RECURRENT_SLICE = ("mmtpu_torch/data/iemocap.py", "mmtpu_torch/models/variational.py",
                   "mmtpu_torch/models/domain.py")


# data parallelism: the mesh and the ranks' launcher
PARALLEL_SLICE = ("mmtpu_torch/parallel/__init__.py", "mmtpu_torch/parallel/mesh.py",
                  "mmtpu_torch/parallel/launch.py")


# the model axis and the analysis copy
MODEL_AXIS_SLICE = ("mmtpu_torch/parallel/tensor.py", "mmtpu_torch/analysis/__init__.py",
                    "mmtpu_torch/analysis/processing.py", "mmtpu_torch/analysis/umap_lite.py",
                    "mmtpu_torch/analysis/plotting.py", "mmtpu_torch/analysis/comparison_plots.py",
                    "mmtpu_torch/analysis/visualiser.py")


# the monitor and the federated codec
MONITOR_SLICE = ("mmtpu_torch/monitor/__init__.py", "mmtpu_torch/monitor/monitor.py",
                 "mmtpu_torch/monitor/storage.py", "mmtpu_torch/monitor/analysis.py",
                 "mmtpu_torch/config/monitor.py", "mmtpu_torch/federated/__init__.py",
                 "mmtpu_torch/federated/federated_utils.py")


# the mesh of separately started processes and the rest of mmtpu's surface
MULTIHOST_SLICE = ("mmtpu_torch/parallel/multihost.py", "mmtpu_torch/utils/global_state.py",
                   "mmtpu_torch/utils/logging.py", "mmtpu_torch/models/tools.py")


@pytest.mark.parametrize("rel", EXPORT_SLICE + RECURRENT_SLICE + PARALLEL_SLICE + MONITOR_SLICE
                         + MODEL_AXIS_SLICE + MULTIHOST_SLICE)
def test_the_export_slice_is_scanned(rel):
    assert REPO / rel in PORT_FILES


def test_scan_catches_a_forbidden_import():
    tree = ast.parse("import os\nfrom mmtpu.ops import fused_mlp\nimport mmtpu_torch\n")
    assert [n for n, _ in _imports(tree) if n in FORBIDDEN] == ["mmtpu"]
