"""Batch inference over a trained run (counterpart of `mmtpu/cli/predict.py`).

    python -m mmtpu_torch.cli.predict --config X.yaml --run_id N \
        [--checkpoint best|last|epoch_K|/path.pth] [--split test] \
        [--out preds.json] [--cpu]

Loads `<model_output_path>/<checkpoint>.pth` (or an explicit path: the
port's `.pth`, a reference `.pth` or an mmtpu `.ckpt`; a missing name
resolves to its sibling, so an mmtpu run's `best.ckpt` serves), evaluates the requested split
through the eval-mode forward (the missing-pattern product included) on
the GPU — on the CPU with `--cpu` — and writes the same JSON as mmtpu: one
record per real (sample, pattern) visit (pattern, pred, label, correct)
plus a per-pattern accuracy summary; for MM-IMDb's multilabel task `pred`
and `label` are the 23 genre flags and `correct` means all of them agree. Padded tail rows are dropped. The MSA
families with their own train steps (MMIN, RedCore, Self-MM) exit with
mmtpu's message, in `predict` and `serve`.
Serving-artifact export (mmtpu's `--export`) is not ported yet.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

from mmtpu_torch.cli import common


def arg_parser():
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", required=True,
                   help="Path to a YAML config, or its plain-dict form as .json")
    p.add_argument("--run_id", type=int, default=1)
    p.add_argument(
        "--checkpoint", default="best",
        help="best | last | epoch_K | explicit .pth or .ckpt path",
    )
    p.add_argument("--split", default="test")
    p.add_argument(
        "--out", default=None,
        help="Predictions JSON path (default: "
             "<metrics_path>/predictions_<split>.json)",
    )
    p.add_argument("--cpu", action="store_true", help="Run on the CPU instead of CUDA")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--dry-run", dest="dry_run", action="store_true",
                   help=argparse.SUPPRESS)  # accepted for CLI compatibility
    # no training here: the monitor setting is not read (as mmtpu's)
    p.set_defaults(disable_monitoring=True)
    return p


def build_task_and_loader(cfg, args, device: torch.device):
    """Model (weights from the run's checkpoint) + task + the split's loader."""
    from mmtpu_torch.checkpoints.manager import load_encoder_checkpoint
    from mmtpu_torch.train.step import ClassificationTask

    mt = cfg.model.model_type.lower()
    if mt in ("mmin", "redcore", "self-mm", "self_mm"):
        raise SystemExit(
            f"predict: {mt} uses a custom multi-network step; export its "
            "frozen encoders via the training driver instead"
        )
    mods = common.modalities_for_model(cfg.model.model_type)
    if args.split not in cfg.data.datasets:
        raise SystemExit(
            f"predict: split {args.split!r} not in config data splits "
            f"{sorted(cfg.data.datasets)}"
        )
    model = common.build_model_from_config(cfg.model)
    report = load_encoder_checkpoint(common.checkpoint_path(cfg, args.checkpoint), model)
    if report.fallback:
        print(f"predict: filled by shape from {report.path}: {report.fallback}", flush=True)
    if report.kept:
        print(f"predict: no source in {report.path} for {report.kept}; kept their "
              "initial values", flush=True)
    model.to(device).eval()
    loader = cfg.data.build_loader(args.split, seed=cfg.experiment.seed)
    task = ClassificationTask(
        model=model,
        loss_group=cfg.training.loss_functions,
        input_keys=[str(m) for m in mods],
        multilabel=mt == "mmimdb",
    )
    return task, loader


def predict_split(task, loader, device: torch.device):
    """Eval-mode predictions over the loader's (pattern × sample) product.

    Returns (records, per-pattern accuracy dict)."""
    from mmtpu_torch.train.step import make_eval_step

    eval_step = make_eval_step(task, device)
    vocab = loader.pattern_vocab
    keys = ("preds", "labels", "pattern_id", "sample_mask")
    # outputs stay on the device until the pass ends: one copy to the host
    # instead of a synchronising copy per batch, so the host can enqueue the
    # next batch while the device runs this one
    outs = {k: [] for k in keys}
    for batch in loader:
        out = eval_step(batch)
        for k in keys:
            outs[k].append(out[k])
    host = {k: torch.cat(v).cpu().numpy() for k, v in outs.items() if v}
    records = []
    hits: dict = {}
    totals: dict = {}
    if not host:
        return records, {}
    preds, labels, pids = host["preds"], host["labels"], host["pattern_id"]
    for i in np.nonzero(host["sample_mask"] > 0)[0]:
        pattern = vocab[int(pids[i])]
        correct = bool(np.all(preds[i] == labels[i]))
        records.append(
            {"pattern": pattern, "pred": preds[i].tolist(),
             "label": labels[i].tolist(), "correct": correct}
        )
        hits[pattern] = hits.get(pattern, 0) + int(correct)
        totals[pattern] = totals.get(pattern, 0) + 1
    summary = {p: round(hits[p] / totals[p], 4) for p in sorted(totals)}
    return records, summary


def run(args):
    """Returns (output path, records, summary)."""
    device = common.resolve_device(args.cpu)
    cfg = common.load_config(args)
    task, loader = build_task_and_loader(cfg, args, device)
    records, summary = predict_split(task, loader, device)
    out_path = Path(
        args.out or Path(cfg.logging.metrics_path) / f"predictions_{args.split}.json"
    )
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(
        json.dumps(
            {"split": args.split, "checkpoint": args.checkpoint,
             "accuracy_per_pattern": summary, "predictions": records},
            indent=2,
        )
    )
    print(f"{len(records)} predictions on {device} → {out_path}; "
          f"per-pattern acc {summary}", flush=True)
    return out_path, records, summary


def main(argv=None) -> int:
    run(arg_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
