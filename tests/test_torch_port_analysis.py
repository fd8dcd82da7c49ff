"""The analysis copy (`mmtpu_torch/analysis/`) against mmtpu's
(`mmtpu/analysis/`), on the same test-written run JSON: mmtpu's
`tests/test_analysis.py` and `tests/test_comparison_plots.py` cases through
both packages.

- processing: the run discovery, the tables, aggregates, statistics,
  p-values and FDR within 1e-12, the LaTeX text equal;
- plots: both packages write the same files (names, and PNGs that open);
- UMAP: the port's kNN (torch) equals mmtpu's sklearn graph, the fuzzy set
  within 1e-6; a layout of one moving epoch (`n_epochs=2`: the second
  epoch's step size is 0) within 1e-5 of mmtpu's; the 200-epoch layouts'
  15-NN trustworthiness within 0.01 of mmtpu's. Further epochs are not held
  point for point: the layout's repulsive steps amplify an ulp of float32
  `pow` (numpy's SIMD one against torch's) a hundredfold or more per epoch.
"""

import json
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
from threadpoolctl import threadpool_limits

from mmtpu.analysis import comparison_plots as jcp
from mmtpu.analysis import plotting as jplot
from mmtpu.analysis import processing as jproc
from mmtpu.analysis import umap_lite as jumap
from mmtpu.analysis.visualiser import ExperimentVisualiser as JVisualiser
from mmtpu_torch.analysis import comparison_plots as pcp
from mmtpu_torch.analysis import plotting as pplot
from mmtpu_torch.analysis import processing as pproc
from mmtpu_torch.analysis import umap_lite as pumap
from mmtpu_torch.analysis.visualiser import ExperimentVisualiser as PVisualiser
from _torch_threads import few_threads  # noqa: E402,F401 — in-process comparisons only

TOL = 1e-12
FUZZY_TOL = 1e-6
LAYOUT_TOL = 1e-5
TRUST_TOL = 0.01


@pytest.fixture(autouse=True)
def _one_native_thread():
    """sklearn's t-SNE and numpy's BLAS on one thread, in both packages
    alike: beside the other test workers, their thread pools oversubscribe
    the host's cores and a t-SNE of 120 points takes minutes."""
    with threadpool_limits(limits=1):
        yield


@pytest.fixture()
def clustered_points():
    """mmtpu's tests/test_analysis.py fixture."""
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=8.0, size=(3, 16))
    pts = np.concatenate(
        [c + rng.normal(scale=0.5, size=(40, 16)) for c in centers]).astype(np.float32)
    return pts, np.repeat(np.arange(3), 40)


def _fake_runs(tmp_path, n_runs=4):
    """mmtpu's tests/test_analysis.py runs: test and validation records."""
    rng = np.random.default_rng(1)
    files = []
    for r in range(1, n_runs + 1):
        d = tmp_path / "metrics" / str(r)
        d.mkdir(parents=True)
        rec = {"index": 0, "accuracy_ATV": float(rng.normal(0.9, 0.01)),
               "accuracy_A": float(rng.normal(0.6, 0.02)),
               "f1_weighted_ATV": float(rng.normal(0.88, 0.01)),
               "f1_weighted_A": float(rng.normal(0.55, 0.02)), "loss": 0.3, "split": "test"}
        (d / "test_metrics.json").write_text(json.dumps([rec]))
        val = [{"index": e, "accuracy_ATV": 0.5 + 0.1 * e, "accuracy_A": 0.4 + 0.05 * e,
                "loss": 1.0 - 0.1 * e, "split": "validation", "Epoch": e + 1}
               for e in range(3)]
        (d / "validation_metrics.json").write_text(json.dumps(val))
        epochs = [{"epoch": e + 1,
                   "train": {"loss": 1.0 - 0.1 * e, "timing": {"total_time": 2.0 + r}},
                   "validation": {"loss": 1.1 - 0.1 * e, "timing": {"total_time": 0.5},
                                  "AI": {"accuracy": float(rng.normal(0.5 + 0.1 * e, 0.01))},
                                  "metrics": {"mae": float(rng.normal(1.0 - 0.1 * e, 0.01))}}}
                  for e in range(3)]
        (d / "epoch_metrics.json").write_text(json.dumps(epochs))
        files.append(d)
    return files


def _frames_equal(a, b):
    pd.testing.assert_frame_equal(a, b, check_exact=False, rtol=TOL, atol=TOL)


def _close(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, (list, tuple, np.ndarray)):
        np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float), rtol=TOL,
                                   atol=TOL)
    elif isinstance(a, float):
        assert a == pytest.approx(b, rel=TOL, abs=TOL) or (np.isnan(a) and np.isnan(b))
    else:
        assert a == b


# -- processing -------------------------------------------------------------------------


def test_run_discovery_loaders_and_extractors(tmp_path):
    files = _fake_runs(tmp_path)
    assert pproc.get_run_data(tmp_path) == jproc.get_run_data(tmp_path) == files
    for key in ("f1_weighted_AI", "accuracy_ATV"):
        assert pproc.extract_metric(key) == jproc.extract_metric(key)
        assert pproc.extract_modality_availability(key) == \
            jproc.extract_modality_availability(key)
    _frames_equal(pproc.load_all_test_metrics(files), jproc.load_all_test_metrics(files))
    _frames_equal(pproc.load_validation_metrics_df(files[0]),
                  jproc.load_validation_metrics_df(files[0]))
    assert pproc.load_epoch_metrics(files[0] / "epoch_metrics.json") == \
        jproc.load_epoch_metrics(files[0] / "epoch_metrics.json")


def test_tables_statistics_and_fdr_match_mmtpu(tmp_path):
    files = _fake_runs(tmp_path)
    indexed = {pkg: pkg.to_metric_modality_index(pkg.load_all_test_metrics(files))
               for pkg in (jproc, pproc)}
    _frames_equal(indexed[pproc], indexed[jproc])
    stats = {pkg: pkg.calculate_stats(indexed[pkg]) for pkg in (jproc, pproc)}
    for key in ("basic_stats", "confidence_intervals"):
        _frames_equal(stats[pproc][key], stats[jproc][key])
    within = {pkg: pkg.calculate_within_modality_stats(indexed[pkg], {"accuracy": 0.5},
                                                       baseline_modality="ATV")
              for pkg in (jproc, pproc)}
    for got, want in zip(within[pproc], within[jproc]):
        _frames_equal(got, want)
        assert "p_value_corrected" in got.columns
    p = np.random.default_rng(3).random(40) * 0.1
    np.testing.assert_allclose(pproc.fdr_bh(p), jproc.fdr_bh(p), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(pproc.fdr_bh([0.01, 0.04, 0.03, 0.005]),
                               [0.02, 0.04, 0.04, 0.02], rtol=TOL)
    idf = {pkg: pkg.load_all_validation_metrics(files) for pkg in (jproc, pproc)}
    _frames_equal(idf[pproc], idf[jproc])
    split = {pkg: pkg.split_validation_metrics_by_available_modalities(idf[pkg], ["ATV", "A"])
             for pkg in (jproc, pproc)}
    assert sorted(split[pproc]) == sorted(split[jproc])
    for metric in split[jproc]:
        _frames_equal(split[pproc][metric], split[jproc][metric])
    pivot = {pkg: pkg.pivot_data_to_modalities_available(within[pkg][1].rename(
        columns={"t_statistic": "Value"})) for pkg in (jproc, pproc)}
    _frames_equal(pivot[pproc], pivot[jproc])
    for pkg, name in ((jproc, "j.tex"), (pproc, "p.tex")):
        pkg.write_latex_to_file(stats[pkg]["basic_stats"], tmp_path / name)
    assert (tmp_path / "p.tex").read_text() == (tmp_path / "j.tex").read_text()


def test_aggregates_significance_and_thresholds_match_mmtpu(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    runs_a, _ = _fake_runs(a), _fake_runs(b, n_runs=3)
    for metric, mode in (("accuracy", "max"), ("mae", "min")):
        _close(pproc.aggregate_runs(a, metric, mode=mode), jproc.aggregate_runs(a, metric,
                                                                                mode=mode))
        _close(pproc.compare_experiments(a, b, metric, mode=mode),
               jproc.compare_experiments(a, b, metric, mode=mode))
    _close(pproc.significance_test([0.1, 0.3, 0.2], [0.5, 0.4, 0.45, 0.6]),
           jproc.significance_test([0.1, 0.3, 0.2], [0.5, 0.4, 0.45, 0.6]))
    history = pproc.load_epoch_metrics(runs_a[0] / "epoch_metrics.json")
    for threshold in (0.55, 0.65, 2.0):
        assert pproc.epochs_to_threshold(history, "accuracy", threshold, "validation") == \
            jproc.epochs_to_threshold(history, "accuracy", threshold, "validation")
    paths = [runs_a[1] / "epoch_metrics.json"]
    _close(pproc.phase_time_comparison(paths, runs_a[0] / "epoch_metrics.json",
                                       runs_a[2] / "epoch_metrics.json"),
           jproc.phase_time_comparison(paths, runs_a[0] / "epoch_metrics.json",
                                       runs_a[2] / "epoch_metrics.json"))
    rows = {"scratch": {"acc": 0.91234567, "n": 3}, "pre_trained": {"acc": 0.95, "n": 4}}
    assert pproc.latex_table(rows, caption="c") == jproc.latex_table(rows, caption="c")


def test_confusion_and_embedding_loaders_match_mmtpu(tmp_path):
    cms = {"AI": [np.eye(3, dtype=int) * (i + 1) for i in range(2)]}
    np.save(tmp_path / "confusion_matrices_test.npy", cms, allow_pickle=True)
    got = pproc.load_all_confusion_matrices([tmp_path], "test")
    want = jproc.load_all_confusion_matrices([tmp_path], "test")
    means = [pkg.compute_mean_confusion_matrix_per_epoch({k: v["AI"] for k, v in d.items()})
             for pkg, d in ((pproc, got), (jproc, want))]
    for a, b in zip(*means):
        np.testing.assert_array_equal(a, b)
    d = tmp_path / "embeddings"
    d.mkdir()
    np.save(d / "audio_embeddings.npy", np.arange(40.0).reshape(5, 8))
    np.save(d / "audio_reconstructions.npy", np.zeros((5, 8)))
    for recon in (False, True):
        np.testing.assert_array_equal(pproc.load_embeddings(tmp_path, "audio", recon),
                                      jproc.load_embeddings(tmp_path, "audio", recon))


# -- plots ----------------------------------------------------------------------------------


def _pngs(root: Path) -> list:
    from PIL import Image

    names = sorted(p.relative_to(root).as_posix() for p in root.rglob("*.png"))
    for name in names:
        with Image.open(root / name) as im:
            assert im.size[0] > 50 and im.size[1] > 50, name
    return names


def _plots(pkg, out: Path, runs: dict, histories: dict, pts, labels) -> None:
    out.mkdir()
    pkg.plot_metric_curves(histories, "accuracy", out=out / "metric_curves.png")
    pkg.plot_loss_curves(histories, out=out / "loss_curves.png")
    pkg.plot_confusion_matrix(np.array([[5, 1], [2, 7]]), out=out / "confusion.png")
    pkg.plot_pattern_comparison({"a": {"acc_AI": 0.9, "acc_A": 0.6}, "b": {"acc_AI": 0.8}},
                                "acc", out=out / "pattern_comparison.png")
    kwargs = {"device": "cpu"} if pkg is pplot else {}
    for method in ("pca", "umap", "tsne"):
        pkg.plot_embeddings_projection(pts, labels, method=method, out=out / f"{method}.png",
                                       **kwargs)
    pkg.plot_modality_available_results_with_significance(runs, "accuracy",
                                                          out=out / "sig.png")


def test_plots_write_the_same_files(tmp_path, clustered_points):
    rng = np.random.default_rng(0)
    runs = {"scratch": {"AI": list(rng.normal(0.85, 0.01, 5)),
                        "A": list(rng.normal(0.60, 0.02, 5))},
            "pretrained": {"AI": list(rng.normal(0.95, 0.01, 5)),
                           "A": list(rng.normal(0.80, 0.02, 5))}}
    history = jproc.load_epoch_metrics(_fake_runs(tmp_path / "runs")[0] / "epoch_metrics.json")
    pts, labels = clustered_points
    for pkg, name in ((jplot, "mmtpu"), (pplot, "port")):
        _plots(pkg, tmp_path / name, runs, {"run": history}, pts, labels)
    assert _pngs(tmp_path / "port") == _pngs(tmp_path / "mmtpu")
    for p in (0.0001, 0.005, 0.03, 0.2):
        assert pplot.get_significance_stars(p) == jplot.get_significance_stars(p)


def _make_run(root: Path, n_epochs=6, seed=0):
    """mmtpu's tests/test_comparison_plots.py run."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    train, epochs = [], []
    for e in range(1, n_epochs + 1):
        flat = {"loss": float(3.0 / e + rng.random() * 0.1), "accuracy_AI": float(1 - 1 / (e + 1))}
        for m in ("f1", "precision", "recall"):
            for fl in ("macro", "micro", "weighted"):
                flat[f"{m}_{fl}_AI"] = float(1 - 1 / (e + 1) + rng.random() * 0.02)
        train.append(flat)
        epochs.append({"epoch": e,
                       "train": {"loss": flat["loss"],
                                 "timing": {"total_time": 2.0 + rng.random(),
                                            "avg_batch_time": 0.1}},
                       "validation": {"loss": flat["loss"] * 1.1,
                                      "timing": {"total_time": 0.5, "avg_batch_time": 0.1}}})
    epochs.append({"test": {"loss": 0.4, "timing": {"total_time": 0.7}}})
    (root / "train_metrics.json").write_text(json.dumps(train))
    (root / "epoch_metrics.json").write_text(json.dumps(epochs))


def test_comparison_figures_match_mmtpu(tmp_path, capsys):
    pre, base = tmp_path / "pre", tmp_path / "base"
    for d, s in ((pre, 1), (base, 2)):
        _make_run(d, seed=s)
    for pkg, name in ((jcp, "mmtpu"), (pcp, "port")):
        out = tmp_path / name
        out.mkdir()
        tr = [pkg.load_train_metrics(d / "train_metrics.json") for d in (pre, base)]
        ep = [jproc.load_epoch_metrics(d / "epoch_metrics.json") for d in (pre, base)]
        pkg.plot_model_comparison(tr[0], tr[1], out)
        pkg.plot_additional_metrics(tr[0], tr[1], out)
        pkg.plot_cumulative_time(ep[0], ep[1], out)
        pkg.plot_loss_and_epoch_times({"pre": ep[0], "base": ep[1]}, out)
        pkg.plot_phase_time_bars({"pre": ep[0], "base": ep[1]}, out)
        pkg.plot_total_training_time(20.0, {"audio": 5.0}, 12.0, out)
        printed = capsys.readouterr().out
        assert "Detailed time statistics" in printed
    names = _pngs(tmp_path / "port")
    assert names == _pngs(tmp_path / "mmtpu") and len(names) == 7


def test_visualiser_writes_the_same_views(tmp_path):
    rng = np.random.default_rng(0)
    rows = [{"Modality Availability": cond, "accuracy": float(rng.normal(base, 0.02)),
             "f1_weighted": float(rng.normal(base - 0.05, 0.02))}
            for cond, base in (("Full", 0.9), ("Audio Only", 0.6), ("Image Only", 0.7))
            for _ in range(6)]
    df = pd.DataFrame(rows)
    outs = {}
    for cls, name in ((JVisualiser, "mmtpu"), (PVisualiser, "port")):
        vis = cls(tmp_path / name)
        outs[name] = vis.create_all_visualizations(df, ["accuracy", "f1_weighted"], "Full")
        vis.plot_validation_over_epochs({"Full": [0.5, 0.7], "Audio Only": [0.4, 0.5]},
                                        "accuracy")
    assert sorted(outs["port"]) == sorted(outs["mmtpu"]) and len(outs["port"]) == 9
    assert _pngs(tmp_path / "port") == _pngs(tmp_path / "mmtpu")


# -- UMAP -------------------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(120, 16), (400, 192)])
def test_umap_graph_equals_mmtpus_sklearn_graph(shape, clustered_points):
    from sklearn.neighbors import NearestNeighbors

    x = clustered_points[0] if shape == (120, 16) else \
        np.random.default_rng(5).normal(size=shape).astype(np.float32)
    k = 15
    dist, idx = NearestNeighbors(n_neighbors=k + 1).fit(x).kneighbors(x)
    want = jumap._fuzzy_simplicial_set(idx[:, 1:], dist[:, 1:])
    pidx, pdist = pumap._knn(torch.from_numpy(x), k)
    np.testing.assert_array_equal(pidx.numpy(), idx[:, 1:])
    head, tail, weight = pumap._fuzzy_simplicial_set(pidx, pdist)
    np.testing.assert_array_equal(head.numpy(), want.row)
    np.testing.assert_array_equal(tail.numpy(), want.col)
    np.testing.assert_allclose(weight.numpy(), want.data, rtol=0, atol=FUZZY_TOL)
    assert pumap._find_ab(0.1) == jumap._find_ab(0.1)


def test_umap_one_layout_epoch_matches_mmtpu(clustered_points):
    pts, _ = clustered_points
    want = jumap.umap_embed(pts, n_epochs=2, random_state=7)
    got = pumap.umap_embed(pts, n_epochs=2, random_state=7, device="cpu")
    assert got.dtype == np.float32 and got.shape == (120, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=LAYOUT_TOL)
    # the layout moved: not the PCA start
    assert np.abs(got - pumap._pca_start(pts, 2)).max() > 1e-2


def test_umap_200_epochs_as_trustworthy_as_mmtpus(clustered_points):
    from sklearn.manifold import trustworthiness

    pts, labels = clustered_points
    want = jumap.umap_embed(pts, random_state=0)
    got = pumap.umap_embed(pts, random_state=0, device="cpu")
    np.testing.assert_array_equal(got, pumap.umap_embed(pts, random_state=0, device="cpu"))
    tw = [trustworthiness(pts, e, n_neighbors=15) for e in (got, want)]
    assert abs(tw[0] - tw[1]) <= TRUST_TOL, tw
    # mmtpu's own check: the clusters stay apart
    cents = np.stack([got[labels == k].mean(0) for k in range(3)])
    spread = np.mean([np.linalg.norm(got[labels == k] - cents[k], axis=1).mean()
                      for k in range(3)])
    sep = min(np.linalg.norm(cents[a] - cents[b]) for a in range(3) for b in range(a + 1, 3))
    assert sep > 2 * spread, (sep, spread)


def test_umap_defaults_to_the_card():
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda|nvidia|torch not compiled"):
        pumap.umap_embed(np.zeros((20, 4), np.float32) + np.arange(20)[:, None])
