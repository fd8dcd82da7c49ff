"""Stacked training: K member runs advance as ONE program (counterpart of
`mmtpu/cli/stacked_cv.py`).

Two member kinds share the engine:
- CV folds (`run`, --stacked-folds): members differ by the `cv_no` set in
  every dataset's kwargs and write `fold_{k}/` outputs, as sequential CV;
- repeat runs (`run_repeat`, --stacked-runs K): member i is run_id + i with
  seed + i, loaded through `common.derive_member_args`, the recipe of the
  sequential sweep (`train_multimodal.sequential_runs`).

Every step is the members' vmapped step (`train/stacked.py`). Per-member
outputs keep the sequential schema: epoch_metrics.json, member-scoped best
checkpoints, the reports and, for CV, `{split}_metrics_agg.json`. Early
stopping is tracked per member for the best checkpoint but stops nothing:
every member runs the configured epochs, as in mmtpu. The LR scale is set
per member.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from mmtpu_torch.cli import common
from mmtpu_torch.train.loop import _jsonable, resolve_save_target, split_epoch_entry
from mmtpu_torch.train.stacked import StackedLoaderGroup, StackedModel
from mmtpu_torch.utils import flatten_leaves


def _member_loss(losses: np.ndarray, masks: np.ndarray, member: int) -> float:
    """Mean loss over the member's REAL steps: lockstep steps where the
    member was exhausted carry all-zero sample masks and are left out.
    `losses` (steps, K) and `masks` (steps, K, B) are host arrays, copied
    once per epoch."""
    ls = losses[:, member]
    valid = masks[:, member].sum(axis=-1) > 0
    n = max(int(valid.sum()), 1)
    return float(np.sum(ls * valid) / n)


def _make_task(cfg):
    from mmtpu_torch.train.step import ClassificationTask

    mods = common.modalities_for_model(cfg.model.model_type)
    task = ClassificationTask(model=None, loss_group=cfg.training.loss_functions,
                              input_keys=[str(m) for m in mods],
                              multilabel=cfg.model.model_type.lower() == "mmimdb")
    return task


def _assemble_member(cfg, args, device, do_train: bool) -> tuple:
    """One member's loaders, model, state and services from the currently
    set cfg paths, by run_single's construction path. Returns (state, ctx)."""
    from mmtpu_torch.utils import clean_checkpoints

    cfg.logging.create_directories()
    clean_checkpoints(cfg.logging.model_output_path)
    loaders = common.build_all_loaders(
        cfg, is_train=do_train, is_test=cfg.experiment.is_test and not args.skip_test)
    seed = int(cfg.experiment.seed)
    model = common.init_model(common.build_model_from_config(cfg.model), seed, device)
    common.load_pretrained_encoders(model, cfg.model.pretrained_encoders, cfg.logging)
    kw = cfg.model.kwargs
    clip = kw.get("clip") or kw.get("grad_clip") or kw.get("clip_grad_norm")
    state = common.make_state(model, cfg.training, clip=clip)
    state.generator = common.use_run_generator(model, seed, device)
    ctx = {
        "loaders": loaders,
        "recorder": common.make_recorder(cfg),
        "ckpt": common.make_checkpoint_manager(cfg),
        "early": common.make_early_stopping(cfg),
        "lr": common.make_lr_controller(cfg.training),
        "metrics_path": Path(cfg.logging.metrics_path),
        "epoch_metrics": [],
        "history": {"train": [], "validation": []},
        "timing": {"train": [], "validation": []},
    }
    return state, ctx


def run(cfg, args, device: torch.device, json_nesting: str = "reference") -> int:
    """--stacked-folds: all K CV folds in one program."""
    folds = int(cfg.experiment.cross_validation)
    base_metrics_path = Path(cfg.logging.metrics_path)
    base_model_path = Path(cfg.logging.model_output_path)
    task = _make_task(cfg)
    do_train = cfg.experiment.is_train and not args.skip_train
    states, members = [], []
    for fold in range(1, folds + 1):
        cfg.logging.metrics_path = str(base_metrics_path / f"fold_{fold}")
        cfg.logging.model_output_path = str(base_model_path / f"fold_{fold}")
        for ds_cfg in cfg.data.datasets.values():
            ds_cfg.kwargs["cv_no"] = fold
        state, ctx = _assemble_member(cfg, args, device, do_train)
        states.append(state)
        members.append(ctx)
    cfg.logging.metrics_path = str(base_metrics_path)
    cfg.logging.model_output_path = str(base_model_path)
    return _run_stacked(cfg, args, device, task, states, members, json_nesting,
                        agg_path=base_metrics_path, unit="fold")


def run_repeat(args, device: torch.device, json_nesting: str = "reference") -> int:
    """--stacked-runs K: run_ids run_id..run_id+K-1 in one program, member i
    seeded seed+i, each member's config loaded as the sequential sweep
    loads it."""
    from mmtpu_torch.utils import configure_logger

    k = int(args.stacked_runs)
    base_run = int(args.run_id)
    cfg0 = task = None
    states, members = [], []
    for i in range(k):
        sub = common.derive_member_args(args, base_run, i)
        cfg = common.load_config(sub)
        if cfg0 is None:
            cfg0, task = cfg, _make_task(cfg)
        state, ctx = _assemble_member(cfg, args, device,
                                      cfg.experiment.is_train and not args.skip_train)
        states.append(state)
        members.append(ctx)
    # each member's load_config pointed the log at its own run_<id>.log; the
    # K runs train as one program, so its lines go to one sweep-scoped file
    configure_logger(cfg0.logging.log_path, suffix=f"runs_{base_run}-{base_run + k - 1}_stacked")
    import logging

    logging.getLogger(__name__).info(
        "stacked --stacked-runs sweep: training-phase logs for runs %d..%d are combined in "
        "this file (per-run metrics/checkpoints stay run_id-scoped)", base_run, base_run + k - 1)
    return _run_stacked(cfg0, args, device, task, states, members, json_nesting,
                        agg_path=None, unit="run")


def _run_split(stacked: StackedModel, members, split: str, epoch: int, train: bool,
               group: str, device: torch.device):
    """One epoch of `split` for every member in lockstep; per member the
    flattened metrics with the loss, and the epoch's seconds."""
    losses, masks = [], []
    t0 = time.time()
    for host_batch in StackedLoaderGroup([c["loaders"][split] for c in members]):
        out = (stacked.train_step if train else stacked.eval_step)(host_batch, device)
        losses.append(out["loss"])
        masks.append(out["sample_mask"])
        for f, c in enumerate(members):
            pattern_id = out.get("pattern_id")
            c["recorder"].update_group_ids(
                group, out["preds"][f], out["labels"][f],
                pattern_id[f] if pattern_id is not None
                else torch.zeros_like(out["preds"][f], dtype=torch.int32),
                c["loaders"][split].pattern_vocab, out["sample_mask"][f])
    # one copy of the epoch's (steps, K) losses and masks, which also waits
    # for the device, so `elapsed` covers the work
    losses = torch.stack(losses).float().cpu().numpy()
    masks = torch.stack(masks).cpu().numpy()
    elapsed = time.time() - t0
    per_member = []
    for f, c in enumerate(members):
        loss = _member_loss(losses, masks, f)
        metrics = flatten_leaves(c["recorder"].calculate_all_groups(epoch=epoch, loss=loss))
        metrics["loss"] = loss
        c["recorder"].reset()
        per_member.append(metrics)
        if split in c["timing"]:
            c["timing"][split].append(elapsed)
    return per_member, elapsed


def _run_stacked(cfg, args, device, task, states, members, json_nesting: str,
                 agg_path: Optional[Path], unit: str) -> int:
    from mmtpu_torch.cli.train_multimodal import aggregate_cv_metrics
    from mmtpu_torch.reports import ExperimentReportGenerator, MetricsReport

    k = len(members)
    group = next(iter(cfg.metrics.groups), "classification")
    do_train = cfg.experiment.is_train and not args.skip_train
    if args.dry_run or cfg.experiment.dry_run:
        for c in members:
            c["recorder"].close()
        print(f"dry run complete — {k} {unit}s stacked, state/loaders built", flush=True)
        return 0

    task.model = states[0].model
    stacked = StackedModel(task, states)
    epochs = cfg.training.epochs if do_train else 0
    for epoch in range(1, epochs + 1):
        train_m, t_tr = _run_split(stacked, members, "train", epoch, True, group, device)
        val_m, t_va = _run_split(stacked, members, "validation", epoch, False, group, device)
        scales = []
        for f, c in enumerate(members):
            c["history"]["train"].append(dict(train_m[f]))
            c["history"]["validation"].append(dict(val_m[f]))
            n_tr = max(len(c["loaders"]["train"]), 1)
            n_va = max(len(c["loaders"]["validation"]), 1)
            c["epoch_metrics"].append({
                "epoch": epoch,
                "train": split_epoch_entry(train_m[f]["loss"], train_m[f], t_tr, n_tr,
                                           json_nesting),
                "validation": split_epoch_entry(val_m[f]["loss"], val_m[f], t_va, n_va,
                                                json_nesting),
            })
            c["metrics_path"].mkdir(parents=True, exist_ok=True)
            (c["metrics_path"] / "epoch_metrics.json").write_text(
                json.dumps(_jsonable(c["epoch_metrics"]), indent=4))
            target = resolve_save_target(val_m[f], cfg.logging.save_metric)
            if c["early"].step(float(target)):
                c["ckpt"].save_checkpoint(stacked.member_state(f), epoch, float(target))
            if c["lr"] is not None:
                metric = val_m[f]["loss"] if c["lr"].kind == "plateau" else None
                scales.append(c["lr"].step(metric))
            else:
                scales.append(1.0)
        stacked.optimizer.lr_scale.copy_(torch.tensor(scales, dtype=torch.float32))
        print(f"epoch {epoch}/{epochs} — {unit} losses "
              f"{[round(m['loss'], 4) for m in train_m]}", flush=True)

    # test: each member's best restored, evaluated stacked
    member_test: List[Dict[str, Any]] = []
    test_split = next((s for s in members[0]["loaders"]
                       if s not in ("train", "validation", "embeddings")), None)
    for f in range(k):
        stacked.member_state(f)
    if test_split is not None:
        for f, c in enumerate(members):
            try:
                c["ckpt"].load_checkpoint(states[f], "best")
            except FileNotFoundError:
                pass
        stacked.restack()
        test_m, t_te = _run_split(stacked, members, test_split, 0, False, group, device)
        for f, c in enumerate(members):
            member_test.append(test_m[f])
            MetricsReport(c["metrics_path"]).generate({}, {test_split: test_m[f]})
            if test_split == "test" and json_nesting == "reference":
                # the sequential schema's trailing test entry, no 'metrics' bucket
                entry = split_epoch_entry(test_m[f]["loss"], test_m[f], t_te,
                                          len(c["loaders"][test_split]), json_nesting)
                entry.pop("metrics", None)
                c["epoch_metrics"].append({"test": entry})
                (c["metrics_path"] / "epoch_metrics.json").write_text(
                    json.dumps(_jsonable(c["epoch_metrics"]), indent=4))

    for f, c in enumerate(members):
        ExperimentReportGenerator(
            c["metrics_path"] / "report", cfg.experiment.name, metrics_dir=c["metrics_path"],
        ).generate_report(
            metrics_history=c["history"], timing_history=c["timing"], model=states[f].model,
            test_metrics={test_split: member_test[f]} if f < len(member_test) else {})
        c["recorder"].close()

    if agg_path is not None:
        for name, agg in (
            ("train", aggregate_cv_metrics([c["history"]["train"] for c in members])),
            ("validation", aggregate_cv_metrics([c["history"]["validation"] for c in members])),
            ("test", aggregate_cv_metrics(member_test)),
        ):
            if agg:
                (agg_path / f"{name}_metrics_agg.json").write_text(json.dumps(agg, indent=4))
    print(f"stacked training complete: {k} {unit}s in one program", flush=True)
    return 0
