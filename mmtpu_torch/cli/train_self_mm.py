"""Self-MM's driver (counterpart of mmtpu/cli/train_self_mm.py), reached
through `train_multimodal` for `model_type: self-mm` / `self_mm`.

Its own epoch loop around the label banks: the model from the run's seed
with the run's generator (dropouts, and BERT's when it fine-tunes), the
banks sized by the post dims and prefilled from one pass of the train
loader, then per epoch the train steps (`train/self_mm_step.py`, the
refinement from epoch 2), the validation pass, `epoch_metrics.json` in
mmtpu's shape (`train`: loss, timing, flat metrics; `validation`: loss,
flat metrics), the best checkpoint by `save_metric`, early stopping and
the plateau LR. Then the best checkpoint restored and tested:
`test_metrics.json` through `MetricsReport` and a final `{"test": ...}`
entry with its `metrics` bucket popped. The banks are not checkpointed, as
in mmtpu; `--resume` and `--profile` are not read, as in mmtpu.

In a data-parallel rank (`mesh`) the model starts from rank 0's weights,
every step takes this rank's rows of the global batch and updates the
banks from the whole global batch (`train/self_mm_step.py`), and at each
pass's end the outputs are gathered in global-batch order and the losses'
shares summed (`train/loop.py`'s `gathered_steps`), so every rank records
and decides what one process does; rank 0 alone writes the records and
the checkpoints, and the ranks meet before the best one is restored.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import torch

from mmtpu_torch.cli import common


def assemble(cfg, device: torch.device):
    """(model, task, state) from the config and the run's seed."""
    from mmtpu_torch.train.self_mm_step import SelfMMTask

    seed = cfg.experiment.seed
    model = common.init_model(common.build_model_from_config(cfg.model), seed, device)
    kw = cfg.model.kwargs
    state = common.make_state(model, cfg.training,
                              clip=kw.get("clip") or kw.get("grad_clip")
                              or kw.get("clip_grad_norm"))
    state.generator = common.use_run_generator(model, seed, device)
    task = SelfMMTask(model=model, need_data_aligned=bool(kw.get("need_data_aligned", False)),
                      H=float(kw.get("H", 3.0)))
    return model, task, state


def bank_dims(cfg) -> dict:
    kw = cfg.model.kwargs
    return {m: int(kw[f"post_{'fusion' if m == 'multimodal' else m}_dim"])
            for m in ("multimodal", "audio", "video", "text")}


def run(cfg, args, device: torch.device, mesh=None) -> int:
    """One Self-MM run, in this rank of `mesh` where there is one."""
    from mmtpu_torch.parallel.mesh import replicate
    from mmtpu_torch.reports import MetricsReport
    from mmtpu_torch.train.loop import gathered_steps, resolve_save_target, split_epoch_entry
    from mmtpu_torch.train.managers import ManagerState
    from mmtpu_torch.train.optim import set_lr_scale
    from mmtpu_torch.train.self_mm_step import (
        init_manager_labels,
        make_self_mm_eval_step,
        make_self_mm_train_step,
    )
    from mmtpu_torch.utils import flatten_leaves

    common.check_rank(cfg, args, device, mesh)
    writes = mesh is None or mesh.is_writer  # on a mesh, rank 0 alone writes files
    loaders = common.build_all_loaders(cfg, is_train=not args.skip_train,
                                       is_test=not args.skip_test)
    model, task, state = assemble(cfg, device)
    if mesh is not None:
        replicate(model, mesh)
        state.mesh = mesh
        common.seed_rank_streams(mesh, cfg.experiment.seed, state.generator)
    eval_step = make_self_mm_eval_step(task, device, mesh)
    recorder = common.make_recorder(cfg, mesh)
    ckpt = common.make_checkpoint_manager(cfg)
    early = common.make_early_stopping(cfg)
    lr = common.make_lr_controller(cfg.training)
    metrics_path = Path(cfg.logging.metrics_path)
    group = next(iter(cfg.metrics.groups), "regression")

    if args.dry_run or cfg.experiment.dry_run:
        recorder.close()
        print("dry run complete", flush=True)
        return 0

    epoch_metrics = []
    metrics_history = {"train": [], "validation": []}

    def record(outs, loader) -> float:
        """Record a pass's step outputs (gathered in global order on a
        mesh); the mean of its losses."""
        if mesh is not None and outs:
            outs = gathered_steps(mesh, outs)
        for out in outs:
            recorder.update_group_ids(group, out["preds"], out["labels"], out["pattern_id"],
                                      loader.pattern_vocab, out.get("sample_mask"))
        losses = [out["loss"] for out in outs]
        return float(torch.stack(losses).float().mean().item()) if losses else 0.0

    def eval_split(split):
        recorder.reset()
        loss = record([eval_step(batch) for batch in loaders[split]], loaders[split])
        metrics = flatten_leaves(recorder.calculate_all_groups(skip_tensorboard=split == "test"))
        metrics["loss"] = loss
        return loss, metrics

    def write_records() -> None:
        if not writes:
            return
        metrics_path.mkdir(parents=True, exist_ok=True)
        (metrics_path / "epoch_metrics.json").write_text(
            json.dumps(epoch_metrics, indent=4, default=float))

    if not args.skip_train:
        managers = ManagerState.create(loaders["train"].dataset.num_samples, bank_dims(cfg),
                                       device=device)
        init_manager_labels(managers, loaders["train"])
        train_step = make_self_mm_train_step(task, state, device)
        for epoch in range(1, cfg.training.epochs + 1):
            recorder.reset()
            t0 = time.time()
            train_loss = record([train_step(managers, batch, epoch)
                                 for batch in loaders["train"]], loaders["train"])
            train_time = time.time() - t0
            train_metrics = flatten_leaves(recorder.calculate_all_groups(epoch=epoch))
            val_loss, val_metrics = eval_split("validation")
            print(f"epoch {epoch}/{cfg.training.epochs} — train {train_loss:.4f}, "
                  f"val {val_loss:.4f}", flush=True)
            metrics_history["train"].append({**train_metrics, "loss": train_loss})
            metrics_history["validation"].append(dict(val_metrics))
            epoch_metrics.append({
                "epoch": epoch,
                "train": {"loss": train_loss, "timing": {"total_time": train_time},
                          "metrics": train_metrics},
                "validation": {"loss": val_loss, "metrics": val_metrics},
            })
            write_records()
            target = resolve_save_target(val_metrics, cfg.logging.save_metric)
            if early.step(float(target)) and writes:
                ckpt.save_checkpoint(state, epoch, float(target))
            if early.should_stop:
                break
            if lr is not None:
                set_lr_scale(state.optimizer,
                             lr.step(val_loss if lr.kind == "plateau" else None))

    if not args.skip_test and "test" in loaders:
        if mesh is not None:
            mesh.barrier()  # rank 0 wrote the best checkpoint
        try:
            ckpt.load_checkpoint(state, "best")
        except FileNotFoundError:
            print("no best checkpoint — testing current params", flush=True)
        t0 = time.time()
        test_loss, test_metrics = eval_split("test")
        elapsed = time.time() - t0
        shown = {k: round(v, 4) for k, v in test_metrics.items() if isinstance(v, (int, float))}
        print(f"test metrics: {shown}", flush=True)
        if writes:
            MetricsReport(metrics_path).generate(metrics_history, {"test": test_metrics})
        entry = {"test": split_epoch_entry(test_loss, test_metrics, elapsed,
                                           len(loaders["test"]), "reference")}
        entry["test"].pop("metrics", None)  # the reference's test entry shape
        epoch_metrics.append(entry)
        write_records()
    recorder.close()
    return 0

