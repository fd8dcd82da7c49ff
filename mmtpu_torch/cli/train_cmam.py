"""C-MAM training entry point (counterpart of `mmtpu/cli/train_cmam.py`).

    python -m mmtpu_torch.cli.train_cmam --config X.yaml --run_id N \
        [--seed S] [--epochs N] [--dry-run] [--skip-train] [--skip-test] [--resume] \
        [--disable_monitoring] [--profile] [--stacked-runs K] [--data-parallel N] [--cpu]

Builds the frozen base model from the config's `model` (restoring its
`pretrained_path`: the port's `.pth`, an mmtpu `.ckpt` or a reference
`.pth`), the C-MAM from `cmam` (`CMAM`, or `dual_cmam`/`DualCMAM`), copies
the base encoders' parameters into the C-MAM's input encoders named by
`load_pretrained_encoder_state_for` (parameters only: the C-MAM's BatchNorm
statistics keep their initial values, as in mmtpu), and trains the C-MAM
against the frozen base (`train/cmam_step.py`) with the `classification`
and `reconstruction` metric groups. Writes mmtpu's files: the epoch
metrics, the checkpoints under `.pth` names, and
`{train,validation,test}_metrics.json` as the nested group records with
`loss` and the loss terms' columns. Runs on the GPU unless `--cpu`; on the
GPU a UttFusion base and a DualCMAM's LSTM encoder run the `lstm` kernel.

`--stacked-runs K` runs the members run_id..run_id+K-1 one after another,
as mmtpu does. `--export-serving` (mmtpu's `jax.export` artifact) waits for
the port's serving export and raises.
"""

from __future__ import annotations

import dataclasses
import logging
import sys
from pathlib import Path
from typing import Any, Callable, Tuple

import torch

from mmtpu_torch.cli import common
from mmtpu_torch.modalities import Modality

logger = logging.getLogger(__name__)

DUAL_TYPES = ("dual_cmam", "dualcmam")


def main(argv=None) -> int:
    parser = common.standard_arg_parser(__doc__)
    parser.add_argument("--export-serving", "--export_serving", dest="export_serving",
                        default=None, metavar="PATH",
                        help="mmtpu's missing-modality serving artifact: not ported (raises)")
    args = parser.parse_args(argv)
    if args.export_serving:
        raise NotImplementedError(
            "--export-serving: the serving export is not ported to mmtpu_torch yet "
            "(ROADMAP.md item 7, serving export)")
    return common.run_id_sweep(args, run)


def copy_encoder_parameters(base: torch.nn.Module, cmam: torch.nn.Module, mods,
                            dual: bool) -> list:
    """`load_pretrained_encoder_state_for`: each named modality's base
    `{mod}_encoder` parameters into the C-MAM's encoder for it (DualCMAM:
    its one `encoder`). Parameters only; buffers keep their values.
    Returns the modalities copied."""
    copied = []
    for mod in mods or ():
        mod = str(Modality(str(mod)))
        src = getattr(base, f"{mod}_encoder", None)
        if dual:
            dst = cmam.encoder
        else:
            dst = cmam.input_encoders[mod] if mod in cmam.input_encoders else None
        if src is None or dst is None:
            logger.warning(f"could not copy base {mod} encoder into CMAM")
            print(f"could not copy base {mod} encoder into CMAM", flush=True)
            continue
        with torch.no_grad():
            ours = dict(dst.named_parameters())
            for name, p in src.named_parameters():
                ours[name].copy_(p)
        copied.append(mod)
        print(f"copied base {mod} encoder parameters into the CMAM", flush=True)
    return copied


@dataclasses.dataclass
class CMAMRun:
    """What `assemble` builds for one C-MAM run."""

    base: torch.nn.Module
    cmam: torch.nn.Module
    task: Any
    state: Any
    step_builders: Tuple[Callable, Callable]


def assemble(cfg, device: torch.device) -> CMAMRun:
    """The frozen base (restored from `pretrained_path`), the C-MAM with its
    dropout generator and the base encoders' parameters it asks for, the
    train state over the C-MAM alone, the task and its step builders."""
    from mmtpu_torch.checkpoints.manager import load_encoder_checkpoint
    from mmtpu_torch.models.rng import use_generator
    from mmtpu_torch.train import cmam_step
    from mmtpu_torch.train.cmam_loss import CMAMLoss

    seed = cfg.experiment.seed
    base = common.init_model(common.build_model_from_config(cfg.model), seed, device)
    pretrained = cfg.model.kwargs.get("pretrained_path")
    if pretrained:
        report = load_encoder_checkpoint(cfg.logging.format_path(str(pretrained)), base)
        print(f"restored base model from {report.path} ({report.format})", flush=True)
    base.eval().requires_grad_(False)

    kw = cfg.cmam.kwargs
    dual = cfg.cmam.model_type.lower() in DUAL_TYPES
    cmam = common.init_model(common.build_model_from_config(cfg.cmam), seed, device)
    generator = torch.Generator(device=device).manual_seed(int(seed))
    use_generator(cmam, generator)
    copy_encoder_parameters(base, cmam, kw.get("load_pretrained_encoder_state_for"), dual)
    state = common.make_state(cmam, cfg.training, clip=kw.get("clip") or kw.get("grad_clip"))
    state.generator = generator

    cmam_term = next((t for t in cfg.training.loss_functions.values()
                      if isinstance(t.loss_fn, CMAMLoss)), None)
    common_task = dict(
        cmam_model=cmam, base_model=base, base_model_type=cfg.model.model_type,
        loss=cmam_term.loss_fn if cmam_term else CMAMLoss(), labels_key="labels",
        multilabel=cfg.model.model_type.lower() == "mmimdb",
        binary_threshold=float(cfg.model.kwargs.get("binary_threshold", 0.5)))
    if dual:
        task = cmam_step.DualCMAMTask(
            **common_task, input_modalities=[str(Modality(str(cmam.input_modality)))],
            target_modality=str(Modality(str(cmam.target_modality_one))),
            target_modality_two=str(Modality(str(cmam.target_modality_two))))
        builders = (cmam_step.make_dual_cmam_train_step, cmam_step.make_dual_cmam_eval_step)
    else:
        target = kw.get("target_modality", kw.get("target_modality_one", cfg.target_modality))
        task = cmam_step.CMAMTask(
            **common_task,
            input_modalities=sorted(str(Modality(str(k))) for k in cmam.input_encoders),
            target_modality=str(Modality(str(target))))
        builders = (cmam_step.make_cmam_train_step, cmam_step.make_cmam_eval_step)
    return CMAMRun(base=base, cmam=cmam, task=task, state=state, step_builders=builders)


def record(recorder, out, vocab) -> None:
    """The classification group from the predictions and labels, the
    reconstruction group from the reconstructed and the teacher's
    embeddings, each when the config has it."""
    pattern_id = out.get("pattern_id")
    if pattern_id is None:
        pattern_id = torch.zeros(out["labels"].shape[0], dtype=torch.int32,
                                 device=out["labels"].device)
    groups = recorder.config.groups
    if "preds" in out and "classification" in groups:
        recorder.update_group_ids("classification", out["preds"], out["labels"],
                                  pattern_id, vocab, out.get("sample_mask"))
    if "reconstruction" in groups:
        recorder.update_group_ids("reconstruction", out["rec_embd"], out["target_embd"],
                                  pattern_id, vocab, out.get("sample_mask"))


def run(args) -> int:
    """One C-MAM run."""
    from mmtpu_torch.config.cmam import CMAMConfig
    from mmtpu_torch.reports import ExperimentReportGenerator
    from mmtpu_torch.train.loop import TrainLoop

    device = common.resolve_device(args.cpu)
    cfg = common.finalize_config(CMAMConfig.load(args.config, run_id=args.run_id), args)
    common.resolve_mesh(cfg, args, device)
    loaders = common.build_all_loaders(cfg, is_train=not args.skip_train,
                                       is_test=not args.skip_test)
    built = assemble(cfg, device)
    recorder = common.make_recorder(cfg)
    loop = TrainLoop(
        task=built.task, state=built.state, loaders=loaders, recorder=recorder,
        checkpoint_manager=common.make_checkpoint_manager(cfg), device=device,
        epochs=cfg.training.epochs, save_metric=cfg.logging.save_metric,
        early_stopping=common.make_early_stopping(cfg),
        lr_controller=common.make_lr_controller(cfg.training),
        metrics_path=Path(cfg.logging.metrics_path),
        group_name=next(iter(cfg.metrics.groups), "classification"),
        print_interval=cfg.experiment.train_print_interval_epochs,
        resume=args.resume, record_fn=record, step_builders=built.step_builders,
    )
    if cfg.experiment.dry_run:
        recorder.close()
        print("dry run complete", flush=True)
        return 0
    if not args.skip_train:
        with common.ProfilerSession(getattr(args, "profile", False), cfg.logging.log_path):
            loop.run()
    if not args.skip_test:
        loop.test(splits=[s for s in loaders if s not in ("train", "validation")])
    # {train,validation,test}_metrics.json as the reference's records: the
    # nested group dicts, loss, and the term columns
    ExperimentReportGenerator(
        Path(cfg.logging.metrics_path) / "report", cfg.experiment.name,
        metrics_dir=cfg.logging.metrics_path,
    ).generate_report(metrics_history=loop.metrics_history_nested,
                      timing_history=loop.timing_history, model=built.cmam,
                      test_metrics=loop.test_metrics_nested)
    recorder.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
