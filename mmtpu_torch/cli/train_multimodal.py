"""Multimodal training entry point (counterpart of `mmtpu/cli/train_multimodal.py`).

    python -m mmtpu_torch.cli.train_multimodal --config X.yaml --run_id N \
        [--seed S] [--epochs N] [--dry-run] [--skip-train] [--skip-test] [--resume] [--cpu]

Trains `model_type: AVMNIST` (the late-fusion model, with the pretrained
encoders the config names), then tests the best checkpoint over the
missing-modality patterns and writes the reports. Validation and test run
the eval forward, whose fusion head is the `fused_mlp` kernel on the GPU.
Other model types, cross-validation and the stacked runs are not ported
yet and raise.
"""

from __future__ import annotations

import sys
from pathlib import Path

from mmtpu_torch.cli import common

PORTED_MODEL_TYPES = ("avmnist",)


def main(argv=None) -> int:
    args = common.standard_arg_parser(__doc__).parse_args(argv)
    return route(args)


def route(args, json_nesting: str = "reference") -> int:
    """Shared by train_multimodal and train_avmnist (which differs only in
    the nesting of epoch_metrics.json)."""
    device = common.resolve_device(args.cpu)
    cfg = common.load_config(args)
    if cfg.experiment.cross_validation:
        raise NotImplementedError("cross-validation is not ported to mmtpu_torch yet")
    return run_single(cfg, args, device, json_nesting=json_nesting)


def run_single(cfg, args, device, json_nesting: str = "reference") -> int:
    from mmtpu_torch.reports import ExperimentReportGenerator
    from mmtpu_torch.train.loop import TrainLoop
    from mmtpu_torch.train.step import ClassificationTask
    from mmtpu_torch.utils import clean_checkpoints

    if cfg.model.model_type.lower() not in PORTED_MODEL_TYPES:
        raise NotImplementedError(
            f"training model_type {cfg.model.model_type!r} is not ported to mmtpu_torch "
            f"yet (ported: {', '.join(PORTED_MODEL_TYPES)})")
    clean_checkpoints(cfg.logging.model_output_path)
    loaders = common.build_all_loaders(
        cfg, is_train=cfg.experiment.is_train and not args.skip_train,
        is_test=cfg.experiment.is_test and not args.skip_test)
    mods = common.modalities_for_model(cfg.model.model_type)
    model = common.init_model(common.build_model_from_config(cfg.model),
                              cfg.experiment.seed, device)
    common.load_pretrained_encoders(model, cfg.model.pretrained_encoders, cfg.logging)
    kw = cfg.model.kwargs
    clip = kw.get("clip") or kw.get("grad_clip") or kw.get("clip_grad_norm")
    state = common.make_state(model, cfg.training, clip=clip)
    task = ClassificationTask(model=model, loss_group=cfg.training.loss_functions,
                              input_keys=[str(m) for m in mods])
    loop = TrainLoop(
        task=task, state=state, loaders=loaders, recorder=common.make_recorder(cfg),
        checkpoint_manager=common.make_checkpoint_manager(cfg), device=device,
        epochs=cfg.training.epochs, save_metric=cfg.logging.save_metric,
        early_stopping=common.make_early_stopping(cfg),
        lr_controller=common.make_lr_controller(cfg.training),
        metrics_path=Path(cfg.logging.metrics_path),
        group_name=next(iter(cfg.metrics.groups), "classification"),
        print_interval=cfg.experiment.train_print_interval_epochs,
        json_nesting=json_nesting, run_id=args.run_id, resume=args.resume,
    )
    if cfg.experiment.dry_run:
        print("dry run complete — config, data, model, state all built", flush=True)
        return 0
    results = {}
    if not args.skip_train and cfg.experiment.is_train:
        loop.run()
    if not args.skip_test and cfg.experiment.is_test:
        results = loop.test(splits=[s for s in loaders
                                    if s not in ("train", "validation", "embeddings")])
        for split, metrics in results.items():
            shown = {k: round(v, 4) for k, v in metrics.items() if isinstance(v, (int, float))}
            print(f"{split} metrics: {shown}", flush=True)
    ExperimentReportGenerator(
        Path(cfg.logging.metrics_path) / "report", cfg.experiment.name,
        metrics_dir=cfg.logging.metrics_path,
    ).generate_report(metrics_history=loop.metrics_history,
                      timing_history=loop.timing_history, model=model, test_metrics=results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
