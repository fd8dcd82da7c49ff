"""The driver of the MSA families with their own train steps, MMIN and
RedCore (counterpart of mmtpu/cli/msa_runners.py), reached through
`train_multimodal` for `model_type: mmin` and `redcore`.

The model from the run's seed; the global-norm clip from the model's
`clip`, `grad_clip` or `clip_grad_norm`. MMIN: the frozen teacher from
`pretrained_model` (a spec), its `pretrained_path` formatted with the
environment and `{run_id}` and restored by `load_encoder_checkpoint` (the
port's `.pth` strictly, mmtpu's `.ckpt` sibling through its decoder), in
eval mode with no gradient and outside the model and its optimizer.
RedCore: the β schedule in the train step's closure, from the model's
`eta`, `loss_beta`, `interval_i`, `eta_ext` and `lambda_one`, and not
checkpointed. Then the `TrainLoop` with the family's step builders, the
recorder, checkpoints, early stopping and scheduler; `--dry-run`,
`--skip-train` and `--skip-test` as mmtpu's. As in mmtpu, this driver
writes no report and takes no `--resume` or `--profile`.

In a data-parallel rank (`mesh`) every rank restores the teacher from its
file and trains on its rows of every global batch (`train/mmin_step.py`,
`train/redcore_step.py`: the global masked means, RedCore's schedule from
the global MSEs); rank 0 alone writes the files. Cross-validation runs its
folds one after another on the mesh.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Callable, Tuple

import torch

from mmtpu_torch.cli import common


def _teacher(cfg, args, device: torch.device):
    """The teacher of an MMIN config, restored, or None (`MMINTask`
    freezes it)."""
    from mmtpu_torch.checkpoints.manager import load_encoder_checkpoint
    from mmtpu_torch.utils import SafeDict, format_path_with_env

    spec = cfg.model.kwargs.get("pretrained_model")
    if spec is None or not hasattr(spec, "build"):
        return None
    teacher = common.init_model(spec.build(), cfg.experiment.seed, device)
    path = getattr(teacher, "pretrained_path", None)
    if path:
        report = load_encoder_checkpoint(
            format_path_with_env(str(path)).format_map(SafeDict(run_id=args.run_id)), teacher)
        print(f"MMIN teacher restored from {report.path}", flush=True)
    return teacher


@dataclasses.dataclass
class MSARun:
    """What `assemble` builds for one MMIN or RedCore run."""

    model: torch.nn.Module
    task: Any
    state: Any
    step_builders: Tuple[Callable, Callable]


def assemble(cfg, args, device: torch.device) -> MSARun:
    """The model from the seed with the run's generator, its train state,
    the task (MMIN's with its frozen teacher) and the step builders
    (RedCore's train step holding the schedule)."""
    from mmtpu_torch.models.rng import use_generator

    seed = cfg.experiment.seed
    model = common.init_model(common.build_model_from_config(cfg.model), seed, device)
    generator = torch.Generator(device=device).manual_seed(int(seed))
    use_generator(model, generator)
    kw = cfg.model.kwargs
    state = common.make_state(model, cfg.training,
                              clip=kw.get("clip") or kw.get("grad_clip")
                              or kw.get("clip_grad_norm"))
    state.generator = generator
    if cfg.model.model_type.lower() == "mmin":
        from mmtpu_torch.train import mmin_step

        task = mmin_step.MMINTask(model=model, loss_group=cfg.training.loss_functions,
                                  teacher_model=_teacher(cfg, args, device))
        return MSARun(model, task, state, (mmin_step.make_mmin_train_step,
                                           mmin_step.make_mmin_eval_step))
    from mmtpu_torch.train import redcore_step

    task = redcore_step.RedCoreTask(
        model=model, loss_group=cfg.training.loss_functions,
        loss_beta=kw.get("loss_beta", 0.95), interval_i=kw.get("interval_i", 2),
        eta_ext=kw.get("eta_ext", 1.5), lambda_one=kw.get("lambda_one", 0.0008))
    sched = redcore_step.RedCoreSchedState.create(eta=kw.get("eta", 0.001), device=device)

    def make_train(task, state, device):
        return redcore_step.RedCoreTrainStep(task, state, device, sched=sched)

    return MSARun(model, task, state, (make_train, redcore_step.make_redcore_eval_step))


def run(cfg, args, device: torch.device, mesh=None) -> int:
    """One MMIN or RedCore run, in this rank of `mesh` where there is one."""
    from mmtpu_torch.train.loop import TrainLoop

    common.check_rank(cfg, args, device, mesh)
    loaders = common.build_all_loaders(cfg, is_train=not args.skip_train,
                                       is_test=not args.skip_test)
    built = assemble(cfg, args, device)
    if mesh is not None:
        common.seed_rank_streams(mesh, cfg.experiment.seed, built.state.generator)
    recorder = common.make_recorder(cfg, mesh)
    loop = TrainLoop(
        task=built.task, state=built.state, loaders=loaders, recorder=recorder,
        checkpoint_manager=common.make_checkpoint_manager(cfg), device=device,
        epochs=cfg.training.epochs, save_metric=cfg.logging.save_metric,
        early_stopping=common.make_early_stopping(cfg),
        lr_controller=common.make_lr_controller(cfg.training),
        metrics_path=Path(cfg.logging.metrics_path),
        group_name=next(iter(cfg.metrics.groups), "classification"),
        step_builders=built.step_builders,
        print_interval=cfg.experiment.train_print_interval_epochs, mesh=mesh,
    )
    if cfg.experiment.dry_run:
        recorder.close()
        print("dry run complete", flush=True)
        return 0
    if not args.skip_train:
        loop.run()
    if not args.skip_test:
        loop.test(splits=[s for s in loaders if s not in ("train", "validation")])
    recorder.close()
    return 0
