"""The port's TensorBoard writer, the recorder's TensorBoard path, the LaTeX
and embedding reports and the cross-validation aggregate against mmtpu's,
on the CPU, from the same inputs made from a numpy seed:

- `utils/tb_writer.SummaryWriter`: the same file name and bytes as mmtpu's
  for the same scalars, steps and a fixed wall time; standard TensorBoard
  reads them back;
- `MetricRecorder(tensorboard_path=..., tb_record_only=...)`: the same
  event bytes as mmtpu's recorder for the same epochs' results (tags
  `{group}_{key}`, no key containing 'loss', anchored regexes, nothing
  from the test pass);
- `LatexReport` and `ExperimentReportGenerator`: the same `report.tex`,
  and `split_missing_conditions` the same tables;
- `EmbeddingVisualizationReport`: the same plot files;
- `aggregate_cv_metrics`: equal on the same fold histories.
"""

import socket
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_threads import few_threads  # noqa: E402,F401 — in-process comparisons only

METRICS = {"metrics": {
    "accuracy": {"function": "sklearn.metrics.accuracy_score", "kwargs": {}},
    "f1_macro": {"function": "sklearn.metrics.f1_score",
                 "kwargs": {"average": "macro", "zero_division": 0}},
    "ConfusionMatrix": {"function": "sklearn.metrics.confusion_matrix",
                        "kwargs": {"labels": list(range(4))}}},
    "groups": {"classification": ["accuracy", "f1_macro", "ConfusionMatrix"]}}


@pytest.fixture
def fixed_clock(monkeypatch):
    """Both writers stamp events with time.time(): hold it still."""
    monkeypatch.setattr(time, "time", lambda: 1767225600.25)
    monkeypatch.setattr(socket, "gethostname", lambda: "host")


def _event_files(root: Path):
    return {p.name: p.read_bytes() for p in sorted(root.glob("events.out.tfevents.*"))}


def test_tb_writer_bytes_equal_mmtpus(tmp_path, fixed_clock):
    from mmtpu.utils.tb_writer import SummaryWriter as JaxWriter

    from mmtpu_torch.utils.tb_writer import SummaryWriter

    for name, cls in (("jax", JaxWriter), ("port", SummaryWriter)):
        w = cls(tmp_path / name)
        w.add_scalar("classification_accuracy_AI", 0.75, 3)
        w.add_scalar("x", -2.5e-7, 0)
        w.add_scalar("negative_step", 1.0, -4)
        w.add_scalars("group", {"a": 1, "b": 2.5}, 12345678901)
        w.close()
    ours, theirs = _event_files(tmp_path / "port"), _event_files(tmp_path / "jax")
    assert ours == theirs and len(ours) == 1

    from tensorboard.backend.event_processing.event_file_loader import EventFileLoader

    seen = {}
    for event in EventFileLoader(str(tmp_path / "port" / next(iter(ours)))).Load():
        for value in getattr(event.summary, "value", []):
            v = value.tensor.float_val[0] if value.tensor.float_val else value.simple_value
            seen[value.tag] = (v, event.step)
    assert seen["classification_accuracy_AI"] == (0.75, 3)
    assert seen["group/b"] == (2.5, 12345678901)


def _feed(recorder, preds, labels, pids, vocab, as_tensor):
    conv = torch.from_numpy if as_tensor else (lambda a: a)
    recorder.update_group_ids("classification", conv(preds), conv(labels), conv(pids), vocab,
                              conv(np.ones(len(preds), np.float32)))


@pytest.mark.parametrize("record_only", [None, ["accuracy", "f1_macro_A$"]],
                         ids=["all", "record_only"])
def test_recorder_writes_mmtpus_events(tmp_path, fixed_clock, record_only):
    from mmtpu.config.metrics import MetricConfig as JaxMetricConfig
    from mmtpu.train.recorder import MetricRecorder as JaxRecorder

    from mmtpu_torch.config.metrics import MetricConfig
    from mmtpu_torch.train.recorder import MetricRecorder

    recorders = {
        "jax": JaxRecorder(JaxMetricConfig.from_dict(METRICS), tensorboard_path=tmp_path / "jax",
                           tb_record_only=record_only),
        "port": MetricRecorder(MetricConfig.from_dict(METRICS),
                               tensorboard_path=str(tmp_path / "port"),
                               tb_record_only=record_only),
    }
    g = np.random.default_rng(9)
    data = [(g.integers(0, 4, 24), g.integers(0, 4, 24), g.integers(0, 2, 24).astype(np.int32))
            for _ in range(3)]
    for name, rec in recorders.items():
        for epoch, (preds, labels, pids) in enumerate(data, start=1):
            rec.reset()
            _feed(rec, preds, labels, pids, ["ai", "a"], name == "port")
            skip = epoch == 3  # the test pass: nothing goes to TensorBoard
            rec.calculate_all_groups(epoch=None if skip else epoch, loss=0.5 + epoch,
                                     skip_tensorboard=skip)
        rec.close()
    ours, theirs = _event_files(tmp_path / "port"), _event_files(tmp_path / "jax")
    assert ours == theirs
    payload = next(iter(ours.values()))
    assert b"classification_accuracy_AI" in payload and b"loss" not in payload
    assert (b"classification_f1_macro_AI" in payload) == (record_only is None)


def _history(g, epochs=3):
    keys = ("accuracy_AI", "accuracy_A", "f1_macro_AI", "loss", "MSA_Acc_2_ATV", "f1_weighted")
    return [{**{k: float(g.random()) for k in keys}, "ConfusionMatrix_AI": [[1, 2], [3, 4]],
             "count": int(g.integers(1, 9))} for _ in range(epochs)]


def test_latex_report_matches_mmtpu(tmp_path):
    from mmtpu.reports.report import ExperimentReportGenerator as JaxGenerator
    from mmtpu.reports.report import LatexReport as JaxLatex
    from mmtpu.reports.report import split_missing_conditions as jax_split

    from mmtpu_torch.models import build_module
    from mmtpu_torch.reports import ExperimentReportGenerator, LatexReport
    from mmtpu_torch.reports import split_missing_conditions

    g = np.random.default_rng(2)
    hist = {"train": _history(g), "validation": _history(g)}
    test = {"test": _history(g, 1)[0]}
    timing = {"train": [1.23456, 2.5], "validation": [0.5, 0.25]}
    info = {"total_parameters": 1234, "size_mb": 0.005}
    final = {k: v for k, v in hist["validation"][-1].items() if isinstance(v, (int, float))}
    conds = {"validation-AI": {"accuracy": 0.5, "f1_macro": 0.25}, "test-A": {"x_y": 1}}
    assert split_missing_conditions(final) == jax_split(final)
    JaxLatex(tmp_path / "jax", "My_Run-1 x").generate(info, final, timing, conds)
    LatexReport(tmp_path / "port", "My_Run-1 x").generate(info, final, timing, conds)
    assert (tmp_path / "port/report.tex").read_text() == (tmp_path / "jax/report.tex").read_text()

    # through the generators: the parameter count from each package's model
    model = build_module("lenetencoder", in_channels=1, hidden_dim=8)
    n = sum(p.numel() for p in model.parameters())
    jax_params = {"w": np.zeros(n, np.float32)}
    for name, gen, kw in (("jax", JaxGenerator, {"params": jax_params}),
                          ("port", ExperimentReportGenerator, {"model": model})):
        gen(tmp_path / f"{name}_gen", "Run_X").generate_report(
            metrics_history=hist, timing_history=timing, test_metrics=test, **kw)
    tex = [(tmp_path / f"{p}_gen/report.tex").read_text() for p in ("port", "jax")]
    assert tex[0] == tex[1] and "\\subsection{test-ATV}" in tex[0]


def test_embedding_plots_match_mmtpus_files(tmp_path):
    pytest.importorskip("matplotlib")
    from mmtpu.reports.report import EmbeddingVisualizationReport as JaxEmbeddingReport

    from mmtpu_torch.reports import EmbeddingVisualizationReport

    g = np.random.default_rng(5)
    emb = tmp_path / "embeddings"
    emb.mkdir()
    np.save(emb / "audio_embeddings.npy", g.normal(size=(30, 6)).astype(np.float32))
    np.save(emb / "image_embeddings.npy", g.normal(size=(30, 4)).astype(np.float32))
    np.save(emb / "tiny_embeddings.npy", g.normal(size=(2, 4)).astype(np.float32))
    np.save(emb / "labels.npy", g.integers(0, 10, 30))
    ours = EmbeddingVisualizationReport(tmp_path / "port").generate(emb)
    theirs = JaxEmbeddingReport(tmp_path / "jax").generate(emb)
    assert Path(ours).name == Path(theirs).name == "audio_embeddings_pca.png"
    names = [sorted(p.name for p in (tmp_path / d).iterdir()) for d in ("port", "jax")]
    assert names[0] == names[1] == ["audio_embeddings_pca.png", "image_embeddings_pca.png"]
    assert EmbeddingVisualizationReport(tmp_path / "x").generate(tmp_path / "absent") is None


@pytest.mark.parametrize("kind", ["epochs", "test", "uneven", "empty"])
def test_aggregate_cv_metrics_matches_mmtpu(kind):
    from mmtpu.cli.train_multimodal import aggregate_cv_metrics as jax_aggregate

    from mmtpu_torch.cli.train_multimodal import aggregate_cv_metrics

    g = np.random.default_rng(11)
    folds = {
        "epochs": [_history(g) for _ in range(3)],
        "test": [_history(g, 1)[0] for _ in range(4)],
        "uneven": [_history(g, 3), _history(g, 2), _history(g, 4)],
        "empty": [],
    }[kind]
    for fold in folds:
        for entry in (fold if isinstance(fold, list) else [fold]):
            entry["flag"] = True  # booleans are not averaged
    got, want = aggregate_cv_metrics(folds), jax_aggregate(folds)
    assert got == want
    if kind != "empty":
        assert "flag" not in got[0] and "ConfusionMatrix_AI" not in got[0]
