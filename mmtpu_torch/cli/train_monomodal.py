"""Monomodal encoder pretraining (counterpart of `mmtpu/cli/train_monomodal.py`).

    python -m mmtpu_torch.cli.train_monomodal --config X.yaml --run_id N \
        [--seed S] [--epochs N] [--dry-run] [--skip-train] [--skip-test] [--resume] \
        [--disable_monitoring] [--profile] [--stacked-runs K] [--data-parallel N] [--cpu]

Wraps the config's one encoder in a linear-head classifier, trains it on
the raw (unmasked) modality, and on every best epoch writes the handoff
`encoder_{modality}_best.pth` that the multimodal run's
`pretrained_encoders` loads. Runs on the GPU unless `--cpu`.
`--stacked-runs K` runs the members run_id..run_id+K-1 (seed + i) one after
another, as mmtpu's driver does (it has no stacking engine).
`--data-parallel N`, N > 1, trains on N devices, one process per rank, as
`train_multimodal` does; rank 0 alone writes the files. With
`monitoring.enabled: true` and a `logging.monitor_path` the run writes
mmtpu's `<monitor_path>/monitor_data.h5` (`mmtpu_torch/monitor`).
"""

from __future__ import annotations

import sys
from pathlib import Path

from mmtpu_torch.cli import common


def main(argv=None) -> int:
    args = common.standard_arg_parser(__doc__).parse_args(argv)
    mesh = common.rank_mesh()
    rc = common.run_ranks(args, common.resolve_device(args.cpu, mesh),
                          "mmtpu_torch.cli.train_monomodal", argv, mesh)
    if rc is not None:
        return rc
    return common.run_id_sweep(args, lambda sub: run(sub, mesh))


def run(args, mesh=None) -> int:
    """One monomodal run, in this rank of `mesh` where there is one."""
    from mmtpu_torch.models.registry import build_module
    from mmtpu_torch.reports import ExperimentReportGenerator
    from mmtpu_torch.train.loop import TrainLoop
    from mmtpu_torch.train.step import MonomodalTask

    device = common.resolve_device(args.cpu, mesh)
    cfg = common.load_config(args, mesh)
    common.check_rank(cfg, args, device, mesh)
    writes = mesh is None or mesh.is_writer  # on a mesh, rank 0 alone writes files
    modality = common.infer_monomodal_modality(cfg)
    encoder_spec = _find_encoder_spec(cfg, modality)
    model = build_module("monomodal_encoder", encoder=encoder_spec,
                         output_dim=_infer_output_dim(cfg, encoder_spec),
                         num_classes=common.infer_num_classes(cfg))
    model = common.init_model(model, cfg.experiment.seed, device)
    if mesh is not None:
        common.seed_rank_streams(mesh, cfg.experiment.seed)
    loaders = common.build_all_loaders(cfg, is_train=not args.skip_train,
                                       is_test=not args.skip_test)
    state = common.make_state(model, cfg.training)
    task = MonomodalTask(model=model, loss_group=cfg.training.loss_functions,
                         input_keys=[str(modality)])
    ckpt = common.make_checkpoint_manager(cfg)
    mod_upper = str(modality).upper()

    def add_plain_accuracy(metrics):
        # an unsuffixed accuracy beside the {metric}_{MODALITY} keys
        if f"accuracy_{mod_upper}" in metrics:
            metrics.setdefault("accuracy", metrics[f"accuracy_{mod_upper}"])
        return metrics

    any_loader = next(iter(loaders.values()))
    recorder = common.make_recorder(cfg, mesh)
    loop = TrainLoop(
        task=task, state=state, loaders=loaders, recorder=recorder,
        checkpoint_manager=ckpt, device=device, epochs=cfg.training.epochs,
        save_metric=cfg.logging.save_metric,
        early_stopping=common.make_early_stopping(cfg),
        lr_controller=common.make_lr_controller(cfg.training),
        metrics_path=Path(cfg.logging.metrics_path),
        group_name=next(iter(cfg.metrics.groups), "classification"),
        on_best=lambda st, epoch: ckpt.save_encoder(st.model.encoder, str(modality),
                                                    st.mesh),
        print_interval=cfg.experiment.train_print_interval_epochs,
        # metric keys carry the MODALITY name, not the pattern letter
        vocab_override=[str(modality)] * len(any_loader.pattern_vocab),
        metrics_postprocess=add_plain_accuracy,
        resume=args.resume,
        eval_batch_factor=getattr(args, "eval_batch_factor", None), mesh=mesh,
        monitor=common.make_monitor(cfg, resume=args.resume, mesh=mesh),
    )
    if cfg.experiment.dry_run:
        recorder.close()
        print("dry run complete", flush=True)
        return 0
    results = {}
    if not args.skip_train:
        with common.ProfilerSession(getattr(args, "profile", False) and writes,
                                    cfg.logging.log_path):
            loop.run()
    if not args.skip_test:
        results = loop.test(splits=[s for s in loaders if s not in ("train", "validation")])
    if writes:
        ExperimentReportGenerator(Path(cfg.logging.metrics_path) / "report",
                                  cfg.experiment.name).generate_report(
            metrics_history=loop.metrics_history, timing_history=loop.timing_history,
            model=model, test_metrics=results)
    recorder.close()
    final = Path(cfg.logging.model_output_path) / f"encoder_{modality}_best.pth"
    print(f"encoder artifact: {final}", flush=True)
    return 0


def _find_encoder_spec(cfg, modality):
    """`{modality}_encoder` first, then UttFusion-style net{A,V,T}, then any
    `*_encoder` / `net*` entry of the model kwargs."""
    kwargs = cfg.model.kwargs
    spec = kwargs.get(f"{modality}_encoder")
    if spec is None:
        net_key = {"audio": "netA", "video": "netV", "text": "netT"}.get(str(modality))
        spec = kwargs.get(net_key) if net_key else None
    if spec is None:
        spec = next((v for k, v in kwargs.items()
                     if k.endswith("_encoder") or k.startswith("net")), None)
    if spec is None:
        raise ValueError("No encoder found in configuration")
    return spec


def _infer_output_dim(cfg, encoder_spec) -> int:
    """Spec dims, then model-level dims, then model-type fallbacks."""
    if "output_dim" in cfg.model.kwargs:
        return int(cfg.model.kwargs["output_dim"])
    for k in ("output_dim", "hidden_dim", "hidden_size", "embd_size"):
        if k in getattr(encoder_spec, "kwargs", {}):
            return int(encoder_spec.kwargs[k])
    if "hidden_dim" in cfg.model.kwargs:
        return int(cfg.model.kwargs["hidden_dim"])
    mt = cfg.model.model_type.lower()
    if "mmimdb" in mt:
        return 512
    if "avmnist" in mt:
        return 128
    if "utt" in mt or "mosi" in mt:
        return 64
    return 128


if __name__ == "__main__":
    sys.exit(main())
