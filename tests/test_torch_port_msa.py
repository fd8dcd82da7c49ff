"""The port's MOSI metrics against mmtpu's on the CPU: the MSA metrics,
`mosei_regression`, `pearson`, `cosine_similarity` and
`confusion_matrix_from_logits` (the port's numpy versions against mmtpu's
sklearn-backed ones), and what the recorder, the epoch-metrics nesting and
the records report make of the MSA keys over all seven patterns.

Inputs come from numpy seeds. Tolerances: rounded values equal; unrounded
ones (pearson, cosine similarity) within 1e-12."""

import json
import logging

import numpy as np
import pytest
import torch

from mmtpu.metrics import corr as jax_corr
from mmtpu.metrics import msa as jax_msa
from mmtpu_torch.metrics import corr, msa
from _torch_threads import few_threads  # noqa: E402,F401 — in-process comparisons only

EXACT = 1e-12
# the seven MOSI patterns, spelled with 'z' for a missing modality as the
# reference's configs may spell them; the recorder strips the 'z'
Z_VOCAB = ["atv", "atz", "azv", "ztv", "azz", "ztz", "zzv"]


def _classes(seed, n=50, present=(0, 1, 2)):
    g = np.random.default_rng(seed)
    return g.choice(present, n).astype(np.int64), g.choice((0, 1, 2), n).astype(np.int64)


def _same_outcome(ours, theirs):
    """Both raise ValueError, or both return the same dict (rounded values
    equal, same key order)."""
    try:
        want = theirs()
    except ValueError:
        with pytest.raises(ValueError, match="empty"):
            ours()
        return None
    got = ours()
    assert list(got) == list(want)
    assert got == want
    return got


@pytest.mark.parametrize("case", ["mixed", "no_neutral", "one_class", "all_neutral"])
@pytest.mark.parametrize("seed", range(3))
def test_msa_binary_classification_matches_mmtpu(case, seed):
    """The 20 Has0_/Non0_ keys; Recall_* and Precision_* are the F1 value.
    All-neutral truth leaves Non0 empty: sklearn, and so mmtpu, raise."""
    present = {"mixed": (0, 1, 2), "no_neutral": (0, 2), "one_class": (2,),
               "all_neutral": (1,)}[case]
    y_true, y_pred = _classes(seed, present=present)
    got = _same_outcome(lambda: msa.msa_binary_classification(y_true, y_pred),
                        lambda: jax_msa.msa_binary_classification(y_true, y_pred))
    if case == "all_neutral":
        assert got is None
        return
    assert len(got) == 20
    for prefix in ("Non0", "Has0"):
        for avg in ("weighted", "macro", "micro"):
            f1 = got[f"{prefix}_F1_{avg}"]
            assert got[f"{prefix}_Recall_{avg}"] == got[f"{prefix}_Precision_{avg}"] == f1
    assert all(v == round(v, 4) for v in got.values())


@pytest.mark.parametrize("case", ["mixed", "with_zeros", "all_zero"])
def test_mosei_regression_matches_mmtpu(case):
    g = np.random.default_rng({"mixed": 0, "with_zeros": 1, "all_zero": 2}[case])
    y_true = g.uniform(-3.5, 3.5, 60)
    y_pred = g.uniform(-3.5, 3.5, 60)
    if case == "with_zeros":
        y_true[::4] = 0.0
        y_pred[1::5] = 0.0
    if case == "all_zero":
        y_true[:] = 0.0
    got = _same_outcome(lambda: msa.mosei_regression(y_true, y_pred),
                        lambda: jax_msa.mosei_regression(y_true, y_pred))
    assert (got is None) == (case == "all_zero")
    assert msa.old_mosei_regression is msa.mosei_regression


def test_msa_binarize_and_confusion_matrix_match_mmtpu():
    y_true, y_pred = _classes(4)
    for a, b in zip(msa.msa_binarize(y_pred, y_true), jax_msa.msa_binarize(y_pred, y_true)):
        np.testing.assert_array_equal(a, b)
    for kw in ({}, {"labels": [0, 1, 2, 3]}, {"normalize": "true"}):
        np.testing.assert_array_equal(msa.confusion_matrix_from_logits(y_true, y_pred, **kw),
                                      jax_msa.confusion_matrix_from_logits(y_true, y_pred, **kw))


@pytest.mark.parametrize("seed", range(3))
def test_pearson_matches_mmtpu(seed):
    g = np.random.default_rng(seed)
    y_true = g.normal(size=40)
    y_pred = 0.5 * y_true + g.normal(size=40)
    got, want = corr.pearson(y_true, y_pred), jax_corr.pearson(y_true, y_pred)
    assert isinstance(got, float) and abs(got - want) <= EXACT


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("same", [False, True], ids=["a_b", "a_a"])
def test_cosine_similarity_matches_mmtpu(dtype, same):
    """The mean of sklearn's pairwise cosine similarity, a zero row included."""
    from mmtpu.metrics import cosine_similarity as jax_cosine

    g = np.random.default_rng(7)
    a = g.normal(size=(9, 6)).astype(dtype)
    b = a if same else g.normal(size=(5, 6)).astype(dtype)
    a[3] = 0.0
    got, want = corr.cosine_similarity(a, b), jax_cosine(a, b)
    assert np.asarray(got).dtype == np.asarray(want).dtype
    assert abs(float(got) - float(want)) <= (1e-6 if dtype == np.float32 else EXACT)
    with pytest.raises(ValueError):
        corr.cosine_similarity(a[0], b[0])


def test_every_mmtpu_metric_name_resolves_in_the_port():
    """`metrics.<name>` in a config resolves for every name mmtpu's metrics
    package exports, to the port's own function."""
    import mmtpu.metrics as jax_metrics
    import mmtpu_torch.metrics as port_metrics
    from mmtpu_torch.config.metrics import MetricDef

    assert sorted(port_metrics.__all__) == sorted(jax_metrics.__all__)
    for name in jax_metrics.__all__:
        fn = MetricDef(f"metrics.{name}").load()
        assert fn is getattr(port_metrics, name) and fn.__module__.startswith("mmtpu_torch.")


MSA_SPEC = {"metrics": {
    "MSA": {"function": "metrics.msa_binary_classification", "kwargs": {}},
    "accuracy": {"function": "sklearn.metrics.accuracy_score", "kwargs": {}}},
    "groups": {"classification": ["MSA", "accuracy"]}}


def _recorded(seed, neutral_pattern=None):
    """(port results, mmtpu results) for three batches of 16 over the seven
    'z'-spelled patterns, padded rows at the end of each batch; with
    `neutral_pattern`, every label of that pattern is neutral."""
    from mmtpu.config.metrics import MetricConfig as JaxMetricConfig
    from mmtpu.train.recorder import MetricRecorder as JaxRecorder
    from mmtpu_torch.config.metrics import MetricConfig
    from mmtpu_torch.train.recorder import MetricRecorder

    ours = MetricRecorder(MetricConfig.from_dict(MSA_SPEC))
    theirs = JaxRecorder(JaxMetricConfig.from_dict(MSA_SPEC))
    g = np.random.default_rng(seed)
    for _ in range(3):
        preds, labels = g.integers(0, 3, 16), g.integers(0, 3, 16)
        pids = g.integers(0, 7, 16).astype(np.int32)
        if neutral_pattern is not None:
            labels[pids == neutral_pattern] = 1
        mask = np.ones(16, np.float32)
        mask[13:] = 0
        ours.update_group_ids("classification", torch.from_numpy(preds),
                              torch.from_numpy(labels), torch.from_numpy(pids), Z_VOCAB,
                              torch.from_numpy(mask))
        theirs.update_group_ids("classification", preds, labels, pids, Z_VOCAB, mask)
    return ours.calculate_all_groups(loss=0.5), theirs.calculate_all_groups(loss=0.5)


@pytest.mark.parametrize("neutral_pattern", [None, 4], ids=["all", "one_pattern_neutral"])
def test_recorder_and_nesting_with_msa_keys_match_mmtpu(neutral_pattern, caplog):
    """MSA keys `MSA_{key}_{PATTERN}` with the 'z' stripped; a pattern whose
    labels are all neutral loses its MSA keys (the metric raised) in both;
    the epoch-metrics nesting puts 5-part keys under parts[3] in both (the
    reference's quirk: MSA_Non0_F1_weighted_ATV under 'weighted')."""
    from mmtpu.train.loop import _nest_epoch_metrics as jax_nest
    from mmtpu_torch.train.loop import _nest_epoch_metrics
    from mmtpu_torch.utils import flatten_leaves

    with caplog.at_level(logging.ERROR):
        got, want = _recorded(3, neutral_pattern)
    assert list(got) == list(want) == ["classification"]
    got, want = got["classification"], want["classification"]
    assert list(got) == list(want)
    assert got == want
    patterns = {k.rsplit("_", 1)[1] for k in got if k.startswith("MSA_")}
    expected = {"ATV", "AT", "AV", "TV", "A", "T", "V"}
    if neutral_pattern is not None:
        expected.discard(Z_VOCAB[neutral_pattern].replace("z", "").upper())
        assert "Metric MSA failed" in caplog.text
    assert patterns == expected
    assert {k for k in got if k.startswith("accuracy_")} == {f"accuracy_{p}" for p in
                                                            ("ATV", "AT", "AV", "TV", "A",
                                                             "T", "V")}
    flat = flatten_leaves({"classification": got})
    nested = _nest_epoch_metrics(flat)
    assert nested == jax_nest(flat)
    assert json.dumps(nested) == json.dumps(jax_nest(flat))  # same order too
    assert set(nested["weighted"]) == {f"MSA_{s}_{m}" for s in ("Non0", "Has0")
                                       for m in ("F1", "Recall", "Precision")}
    assert nested["ATV"] == {"MSA_Non0_Accuracy": got["MSA_Non0_Accuracy_ATV"],
                             "MSA_Has0_Accuracy": got["MSA_Has0_Accuracy_ATV"]}


def test_records_report_takes_msa_keys_as_mmtpu(tmp_path):
    """`{split}_metrics.json` from MSA-keyed histories: the same records as
    mmtpu's pandas-backed report, MSA columns included, no f1_* assumed."""
    from mmtpu.reports.report import MetricsReport as JaxMetricsReport
    from mmtpu_torch.reports import MetricsReport

    epochs = [_recorded(s)[0]["classification"] for s in (5, 6)]
    test = _recorded(7, neutral_pattern=2)[0]["classification"]
    history = {"train": epochs, "validation": list(reversed(epochs))}
    MetricsReport(tmp_path / "port").generate(history, {"test": test})
    JaxMetricsReport(tmp_path / "jax").generate(history, {"test": test})
    for split in ("train", "validation", "test"):
        got = json.loads((tmp_path / "port" / f"{split}_metrics.json").read_text())
        want = json.loads((tmp_path / "jax" / f"{split}_metrics.json").read_text())
        assert got == want, split
        assert any(k.startswith("MSA_Has0_F1_macro_") for k in got[0])
