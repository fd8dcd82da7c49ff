"""The port's real AVMNIST reader, LeNet encoders and embedding export
against mmtpu's, on the CPU, from files and weights made from a numpy seed.

- `AVMNIST` on `.pt` files the test writes (a spectrogram wider than 94,
  one shorter than 32, one taller and wider), as `tests/test_datasets_io.py`
  tests mmtpu's: arrays and labels equal to mmtpu's exactly; each package
  reads the `.npy` sidecars the other wrote; the legacy `.npz` conversion;
  the cache keyed on the columns; a data directory that cannot be written;
  the missing-column error; the LUT constant equal to mmtpu's
  `_gist_earth_luma_lut()`.
- `LeNetEncoder` from shared weights (`from_jax_variables`): eval and
  train outputs, running statistics and input gradients within 1e-4, a
  padded batch among them (BatchNorm statistics from the real rows only).
- `_export_embeddings`: `{mod}_embeddings.npy` within 1e-4 of mmtpu's and
  `labels.npy` equal, from shared weights.
"""

import csv
import hashlib
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from mmtpu.data.avmnist import AVMNIST as JaxAVMNIST
from mmtpu.modalities import Modality as JaxModality
from mmtpu_torch.checkpoints import from_jax_variables
from mmtpu_torch.data import AVMNIST, resolve_dataset_name
from mmtpu_torch.modalities import Modality
from _torch_threads import few_threads  # noqa: E402,F401 — in-process comparisons only

TOL = 1e-4
SPEC_SHAPES = [(32, 94), (32, 120), (20, 94), (40, 100), (32, 94), (31, 50), (32, 94),
               (32, 94), (33, 95), (32, 94), (12, 130), (32, 94)]


def _write_pt_files(root, n=len(SPEC_SHAPES), seed=0):
    """One float32 spectrogram and one uint8 image `.pt` per sample under
    `root/pt`; returns the CSV rows (audio, image, label)."""
    rng = np.random.default_rng(seed)
    (root / "pt").mkdir(parents=True, exist_ok=True)
    rows = []
    for i in range(n):
        spec = torch.from_numpy(rng.normal(size=SPEC_SHAPES[i]).astype(np.float32))
        img = rng.integers(0, 256, size=(28, 28)).astype(np.uint8)
        sp, ip = root / "pt" / f"spec_{i}.pt", root / "pt" / f"img_{i}.pt"
        torch.save(spec, sp)
        torch.save(img, ip)
        rows.append((str(sp), str(ip), (3 * i + 1) % 10))
    return rows


def _write_csv(path, rows, header=("audio", "image", "label")):
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)
    return path


def _arrays(ds, A, I):
    return (np.asarray(ds.arrays[A]), np.asarray(ds.arrays[I]), np.asarray(ds.labels))


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.fixture
def written(tmp_path):
    """The same CSV bytes in two directories (one per package), pointing at
    one set of `.pt` files."""
    rows = _write_pt_files(tmp_path)
    return {"root": tmp_path, "rows": rows,
            "jax": _write_csv(tmp_path / "jax" / "train.csv", rows),
            "port": _write_csv(tmp_path / "port" / "train.csv", rows)}


def test_lut_constant_is_mmtpus_gist_earth_luma():
    from mmtpu.data.avmnist import _gist_earth_luma_lut

    from mmtpu_torch.data.avmnist import GIST_EARTH_LUMA

    want = _gist_earth_luma_lut()
    assert GIST_EARTH_LUMA.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(GIST_EARTH_LUMA, want)


def test_reader_arrays_equal_mmtpus_and_caches_cross_read(written):
    assert resolve_dataset_name("AVMNIST") is AVMNIST
    theirs = _arrays(JaxAVMNIST(written["jax"], "train"), JaxModality.AUDIO, JaxModality.IMAGE)
    ours_ds = AVMNIST(written["port"], "train")
    ours = _arrays(ours_ds, Modality.AUDIO, Modality.IMAGE)
    _assert_same(ours, theirs)
    assert ours[0].shape == (len(SPEC_SHAPES), 32, 94) and ours[1].shape[1:] == (28, 28, 1)
    assert ours[2].dtype == np.int64
    assert isinstance(ours_ds.arrays[Modality.AUDIO], np.memmap)
    # the cropped and padded spectrograms: the wide one keeps its first 94
    # columns, the short one has zero rows from 20 on
    spec1 = torch.load(written["rows"][1][0], weights_only=True).numpy()
    np.testing.assert_array_equal(ours[0][1], spec1[:, :94])
    assert not ours[0][2, 20:].any()
    # the sidecars have the same names in both directories
    names = {p: sorted(q.name for q in written[p].parent.glob("*.npy")) for p in ("jax", "port")}
    assert names["jax"] == names["port"] and len(names["port"]) == 3

    # without the .pt files each package reads the other's sidecars
    shutil.move(str(written["root"] / "pt"), str(written["root"] / "gone"))
    _assert_same(_arrays(AVMNIST(written["jax"], "train"), Modality.AUDIO, Modality.IMAGE),
                 theirs)
    _assert_same(_arrays(JaxAVMNIST(written["port"], "train"), JaxModality.AUDIO,
                         JaxModality.IMAGE), theirs)


def test_legacy_npz_converts_to_mmap_sidecars(tmp_path):
    rng = np.random.default_rng(3)
    index = _write_csv(tmp_path / "train.csv", [("absent.pt", "absent.pt", i % 10)
                                                 for i in range(5)])
    audio = rng.normal(size=(5, 32, 94)).astype(np.float32)
    image = rng.random((5, 28, 28, 1)).astype(np.float32)
    labels = np.arange(5, dtype=np.int64) % 10
    h = hashlib.sha1(index.read_bytes())
    h.update(b"audio|image|label")
    digest = h.hexdigest()[:12]
    np.savez(tmp_path / f"train.{digest}.npz", audio=audio, image=image, labels=labels)

    ds = AVMNIST(index, "train")
    assert isinstance(ds.arrays[Modality.AUDIO], np.memmap)
    _assert_same(_arrays(ds, Modality.AUDIO, Modality.IMAGE), (audio, image, labels))
    assert (tmp_path / f"train.{digest}.audio.npy").exists()
    # mmtpu serves the sidecars the port converted
    _assert_same(_arrays(JaxAVMNIST(index, "train"), JaxModality.AUDIO, JaxModality.IMAGE),
                 (audio, image, labels))


def test_cache_is_keyed_on_the_columns(tmp_path):
    """A cache built from the default columns is not served to a request
    for other columns: both packages read `alt` labels from the files."""
    rows = _write_pt_files(tmp_path, n=6, seed=5)
    rows = [(a, i, lab, (lab + 4) % 10) for a, i, lab in rows]
    index = _write_csv(tmp_path / "train.csv", rows, ("audio", "image", "label", "alt"))
    AVMNIST(index, "train")
    ours = AVMNIST(index, "train", labels_column="alt")
    theirs = JaxAVMNIST(index, "train", labels_column="alt")
    np.testing.assert_array_equal(ours.labels, [r[3] for r in rows])
    np.testing.assert_array_equal(ours.labels, theirs.labels)
    assert len(list(tmp_path.glob("train.*.labels.npy"))) == 2


def test_unwritable_data_dir_warns_and_serves_from_memory(written, monkeypatch, caplog):
    want = _arrays(JaxAVMNIST(written["jax"], "train"), JaxModality.AUDIO, JaxModality.IMAGE)

    def refuse(*a, **k):
        raise OSError("read-only file system")

    monkeypatch.setattr(np, "save", refuse)
    with caplog.at_level("WARNING", logger="mmtpu_torch"):
        ds = AVMNIST(written["port"], "train")
    assert "could not write AVMNIST cache" in caplog.text
    assert not isinstance(ds.arrays[Modality.AUDIO], np.memmap)
    assert not list(written["port"].parent.glob("*.npy"))
    _assert_same(_arrays(ds, Modality.AUDIO, Modality.IMAGE), want)


def test_missing_column_raises_mmtpus_error(tmp_path):
    index = _write_csv(tmp_path / "train.csv", [("a.pt", "i.pt", 1)], ("audio", "img", "label"))
    with pytest.raises(ValueError) as ours:
        AVMNIST(index, "train")
    with pytest.raises(ValueError) as theirs:
        JaxAVMNIST(index, "train")
    assert str(ours.value) == str(theirs.value) == "Missing required columns: ['image']"


# -- LeNet ------------------------------------------------------------------------

def _perturbed_variables(module, xs, seed):
    """mmtpu's initial variables for inputs `xs` with BatchNorm scale/shift,
    biases and running statistics drawn from a seed."""
    v = jax.tree_util.tree_map(np.asarray, dict(module.init(
        jax.random.PRNGKey(seed), *[jnp.asarray(x) for x in xs], train=False)))
    g = np.random.default_rng(seed)
    out = {}
    for col, tree in v.items():
        flat = flatten_dict(tree)
        for path, val in flat.items():
            if path[-1] == "scale":
                val = (1 + 0.1 * g.normal(size=val.shape)).astype(np.float32)
            elif path[-1] in ("bias", "mean"):
                val = (0.1 * g.normal(size=val.shape)).astype(np.float32)
            elif path[-1] == "var":
                val = g.uniform(0.5, 1.5, size=val.shape).astype(np.float32)
            flat[path] = val
        out[col] = unflatten_dict(flat)
    return out


@pytest.mark.parametrize("padded", [False, True], ids=["full", "padded"])
@pytest.mark.parametrize("shape", [(10, 32, 94), (10, 28, 28, 1)], ids=["audio", "image"])
def test_lenet_encoder_matches_mmtpu(shape, padded):
    from mmtpu.models import norm as jax_norm
    from mmtpu.models.lenet import LeNetEncoder as JaxLeNet

    from mmtpu_torch.models import build_module
    from mmtpu_torch.models.norm import batch_mask

    g = np.random.default_rng(len(shape) + 2 * padded)
    x = g.normal(size=shape).astype(np.float32)
    mask = np.ones(shape[0], np.float32)
    if padded:
        mask[7:] = 0
        x[7:] = 0
    jm = JaxLeNet(in_channels=1, hidden_dim=32)
    v = _perturbed_variables(jm, [x], seed=len(shape))
    pm = build_module("lenetencoder", in_channels=1, hidden_dim=32)
    pm.load_state_dict(from_jax_variables(v["params"], v["batch_stats"], target=pm))
    cot = g.normal(size=(shape[0], 32)).astype(np.float32)

    pm.eval()
    np.testing.assert_allclose(pm(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jm.apply(v, jnp.asarray(x), train=False)),
                               rtol=TOL, atol=TOL)

    def f(xx):
        y, upd = jm.apply(v, xx, train=True, mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, upd)

    with jax_norm.batch_mask(jnp.asarray(mask) if padded else None):
        (_, (want, upd)), want_gx = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    pm.train()
    xt = torch.from_numpy(x).requires_grad_()
    with batch_mask(torch.from_numpy(mask) if padded else None):
        got = pm(xt)
    (got * torch.from_numpy(cot)).sum().backward()
    real = mask > 0
    np.testing.assert_allclose(got.detach().numpy()[real], np.asarray(want)[real],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_gx), rtol=TOL, atol=TOL)
    for bn in ("bn1", "bn2"):
        stats = upd["batch_stats"][bn]
        np.testing.assert_allclose(getattr(pm, bn).running_mean.numpy(), stats["mean"],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(getattr(pm, bn).running_var.numpy(), stats["var"],
                                   rtol=TOL, atol=TOL)


def test_lenet_yaml_tags_and_registry_names():
    from mmtpu_torch.config.yaml_tags import MODEL_TAGS
    from mmtpu_torch.models import build_module

    for tag, name, maps in (("!LeNet5", "lenet5", (6, 16)),
                            ("!LeNet5Enhanced", "lenet5enhanced", (16, 32)),
                            ("!LeNetEncoder", "lenetencoder", (6, 16))):
        assert MODEL_TAGS[tag] == name
        m = build_module(name, in_channels=1, hidden_dim=24)
        assert (m.conv1.out_channels, m.conv2.out_channels) == maps and m.hidden_dim == 24


# -- embeddings export ------------------------------------------------------------

def test_export_embeddings_matches_mmtpu(tmp_path):
    from mmtpu.cli.train_multimodal import _export_embeddings as jax_export
    from mmtpu.data.avmnist import SyntheticAVMNIST as JaxSynthetic
    from mmtpu.data.loader import BatchLoader as JaxLoader
    from mmtpu.models.registry import build_module as jax_build

    from mmtpu_torch.cli.train_multimodal import _export_embeddings
    from mmtpu_torch.data import BatchLoader, SyntheticAVMNIST
    from mmtpu_torch.models import build_module

    def enc(build):
        return {f"{m}_encoder": build("lenetencoder", in_channels=1, hidden_dim=16)
                for m in ("audio", "image")}

    jm = jax_build("avmnist", hidden_dim=32, dropout=0.5, **enc(jax_build))
    pm = build_module("avmnist", hidden_dim=32, dropout=0.5, **enc(build_module))
    kw = dict(split="test", num_samples=21, seed=7, selected_patterns=["ai", "a"])
    jds, pds = JaxSynthetic(**kw), SyntheticAVMNIST(**kw)
    x = [jds.arrays[JaxModality.AUDIO][:2], jds.arrays[JaxModality.IMAGE][:2]]
    v = _perturbed_variables(jm, x, seed=1)
    pm.load_state_dict(from_jax_variables(v["params"], v["batch_stats"], target=pm))
    mods = [JaxModality.AUDIO, JaxModality.IMAGE]
    out = {}
    for name, export, args in (
            ("jax", jax_export, (jm, SimpleNamespace(variables=v), JaxLoader(jds, 8), mods)),
            ("port", _export_embeddings, (pm, BatchLoader(pds, 8),
                                          [Modality.AUDIO, Modality.IMAGE], torch.device("cpu")))):
        cfg = SimpleNamespace(logging=SimpleNamespace(metrics_path=str(tmp_path / name)))
        out[name] = export(cfg, *args)
    files = {n: sorted(p.name for p in out[n].iterdir()) for n in out}
    assert files["port"] == files["jax"] == ["audio_embeddings.npy", "image_embeddings.npy",
                                             "labels.npy"]
    np.testing.assert_array_equal(np.load(out["port"] / "labels.npy"),
                                  np.load(out["jax"] / "labels.npy"))
    assert np.load(out["port"] / "labels.npy").shape == (21,)  # the "ai" rows only
    for mod in ("audio", "image"):
        np.testing.assert_allclose(np.load(out["port"] / f"{mod}_embeddings.npy"),
                                   np.load(out["jax"] / f"{mod}_embeddings.npy"),
                                   rtol=TOL, atol=TOL)

