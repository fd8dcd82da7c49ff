"""Multimodal training entry point (counterpart of `mmtpu/cli/train_multimodal.py`).

    python -m mmtpu_torch.cli.train_multimodal --config X.yaml --run_id N \
        [--seed S] [--epochs N] [--dry-run] [--skip-train] [--skip-test] [--resume] \
        [--disable_monitoring] [--profile] [--stacked-runs K] [--data-parallel N] \
        [--eval-batch-factor N] [--stacked-folds] [--cpu]

Trains `model_type: AVMNIST` (the late-fusion model, with the pretrained
encoders the config names: the port's handoff, a reference `.pth` or an
mmtpu `.ckpt`) and MOSI UttFusion (`utt-fusion`, `utt_fusion`,
`UttFusionModel`: audio, video and text, the model's `clip` as the
global-norm gradient clip), then tests the best checkpoint over the
missing-modality patterns, exports the `embeddings` split's per-modality
embeddings when the config has one, and writes the reports. On the GPU the
AVMNIST fusion head runs the `fused_mlp` kernel in validation and test, and
UttFusion's two LSTM encoders run the `lstm` kernel, one launch per forward,
in every train and eval step. `mmin` and `redcore` train through their own
steps (`cli/msa_runners.py`): MMIN's audio and video LSTMs run the kernel
in one launch per forward, and its frozen UttFusion teacher two more per
train batch. Self-MM (`self-mm`, `self_mm`) trains through its own driver
with the label banks (`cli/train_self_mm.py`): its audio and video
AuViSubNets run the kernel once each per forward. MM-IMDb (`mmimdb`: GMU
or multimodal pooling over the image and text features, the MaxOut genre
classifier) trains as a multilabel task (sigmoid > 0.5 predictions, the
23 genres' F1s) and runs no kernel; its dropout draws from the run's
generator.

`experiment.cross_validation: K` runs K folds, each with `cv_no` set in
every dataset's kwargs and its outputs under `fold_<k>/`, then writes the
per-epoch means of every metric over the folds to
`{train,validation,test}_metrics_agg.json`. `--stacked-runs K` runs the K
members run_id..run_id+K-1 (seed + i) one after another, each with its own
outputs: mmtpu's sequential path, which mmtpu's vmapped engine equals; the
vmapped engine, `--stacked-folds` and data parallelism over several devices
are not ported and raise (ROADMAP item 12); MMIN, RedCore and Self-MM take the
sequential runs and folds, as in mmtpu. Other model types raise.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

from mmtpu_torch.cli import common

PORTED_MODEL_TYPES = ("avmnist", "utt-fusion", "utt_fusion", "uttfusionmodel", "mmin",
                      "redcore", "self-mm", "self_mm", "mmimdb")
CUSTOM_STEP_TYPES = ("mmin", "redcore", "self-mm", "self_mm")  # mmtpu stacks none of them


def main(argv=None) -> int:
    args = common.standard_arg_parser(__doc__).parse_args(argv)
    device = common.resolve_device(args.cpu)
    return route(common.load_config(args), args, device)


def _stacked_fallback_reason(cfg, args, flag: str = "--stacked-folds"):
    """Why mmtpu's stacked engines would not apply and it would run
    sequentially instead (None when they would)."""
    mt = cfg.model.model_type.lower()
    if mt in CUSTOM_STEP_TYPES:
        return f"{flag} unsupported for {mt}"
    dp = getattr(args, "data_parallel", None)
    if dp is None:
        dp = cfg.experiment.data_parallel
    if dp and dp != 1:
        return f"stacking is single-device and data_parallel={dp} was requested"
    if getattr(args, "resume", False):
        return "--resume is not supported by stacking"
    return None


def route(cfg, args, device, json_nesting: str = "reference") -> int:
    """Single run, cross-validation or a --stacked-runs sweep. Shared by
    train_multimodal and train_avmnist (which differs only in the nesting
    of epoch_metrics.json)."""
    runs = int(getattr(args, "stacked_runs", 0) or 0)
    if runs > 1:
        if not cfg.experiment.cross_validation:
            reason = _stacked_fallback_reason(cfg, args, "--stacked-runs")
            if reason is None:
                print(f"--stacked-runs {runs}: mmtpu's vmapped engine is not ported "
                      f"({common.ROADMAP_SYSTEMS}); running the members one after another, "
                      "mmtpu's sequential path", flush=True)
            else:
                print(f"{reason}; falling back to sequential runs", flush=True)
        return sequential_runs(args, device, json_nesting=json_nesting)
    if cfg.experiment.cross_validation:
        if getattr(args, "stacked_folds", False):
            reason = _stacked_fallback_reason(cfg, args)
            if reason is None:
                raise NotImplementedError(
                    "--stacked-folds: mmtpu's vmapped fold engine is not ported to "
                    f"mmtpu_torch ({common.ROADMAP_SYSTEMS}); it runs every fold for its "
                    "full epochs, so sequential folds would write other results")
            print(f"{reason}; falling back to sequential CV", flush=True)
        return main_cross_validation(cfg, args, device, json_nesting=json_nesting)
    return run_single(cfg, args, device, json_nesting=json_nesting)


def sequential_runs(args, device, json_nesting: str = "reference") -> int:
    """--stacked-runs K one member after another (mmtpu's `sequential_runs`,
    the reference's run_n.sh loop): each member, from `derive_member_args`,
    loads its config anew; the sweep stops at the first failure."""
    def run_one(sub) -> int:
        return route(common.load_config(sub), sub, device, json_nesting=json_nesting)

    return common.run_id_sweep(args, run_one)


def run_single(cfg, args, device, cv_no=None, json_nesting: str = "reference",
               collect=None) -> int:
    """Train and test one run. `cv_no` is the fold a cross-validation run
    injects into every dataset's kwargs; `collect`, when a dict, receives
    the train and validation metric histories and the test metrics."""
    from mmtpu_torch.reports import ExperimentReportGenerator
    from mmtpu_torch.train.loop import TrainLoop
    from mmtpu_torch.train.step import ClassificationTask
    from mmtpu_torch.utils import clean_checkpoints

    if cv_no is not None:
        for ds_cfg in cfg.data.datasets.values():
            ds_cfg.kwargs["cv_no"] = cv_no
    mt = cfg.model.model_type.lower()
    if mt not in PORTED_MODEL_TYPES:
        raise NotImplementedError(
            f"training model_type {cfg.model.model_type!r} is not ported to mmtpu_torch "
            f"yet (ported: {', '.join(PORTED_MODEL_TYPES)})")
    if mt in ("mmin", "redcore"):
        from mmtpu_torch.cli import msa_runners

        return msa_runners.run(cfg, args, device)
    if mt in ("self-mm", "self_mm"):
        from mmtpu_torch.cli import train_self_mm

        return train_self_mm.run(cfg, args, device)
    common.resolve_mesh(cfg, args, device)
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
    state.generator = common.use_run_generator(model, cfg.experiment.seed, device)
    task = ClassificationTask(model=model, loss_group=cfg.training.loss_functions,
                              input_keys=[str(m) for m in mods], multilabel=mt == "mmimdb")
    recorder = common.make_recorder(cfg)
    loop = TrainLoop(
        task=task, state=state, loaders=loaders, recorder=recorder,
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
        recorder.close()
        print("dry run complete — config, data, model, state all built", flush=True)
        return 0
    results = {}
    if not args.skip_train and cfg.experiment.is_train:
        with common.ProfilerSession(getattr(args, "profile", False), cfg.logging.log_path):
            loop.run()
    if not args.skip_test and cfg.experiment.is_test:
        results = loop.test(splits=[s for s in loaders
                                    if s not in ("train", "validation", "embeddings")])
        for split, metrics in results.items():
            shown = {k: round(v, 4) for k, v in metrics.items() if isinstance(v, (int, float))}
            print(f"{split} metrics: {shown}", flush=True)
    embeddings_dir = None
    if "embeddings" in loaders and hasattr(model, "encode"):
        embeddings_dir = _export_embeddings(cfg, model, loaders["embeddings"], mods, device)
    ExperimentReportGenerator(
        Path(cfg.logging.metrics_path) / "report", cfg.experiment.name,
        metrics_dir=cfg.logging.metrics_path,
    ).generate_report(metrics_history=loop.metrics_history,
                      timing_history=loop.timing_history, model=model, test_metrics=results,
                      embeddings_dir=embeddings_dir)
    recorder.close()
    if collect is not None:
        collect["train"] = loop.metrics_history["train"]
        collect["validation"] = loop.metrics_history["validation"]
        collect["test"] = results.get("test", {})
    return 0


def aggregate_cv_metrics(fold_metrics):
    """The mean of every numeric metric per epoch across folds (mmtpu's
    `aggregate_cv_metrics`): a list of epoch dicts per fold, or one dict per
    fold (test metrics); as many epochs as the shortest fold has."""
    if not fold_metrics:
        return []
    if isinstance(fold_metrics[0], dict):
        fold_metrics = [[m] for m in fold_metrics]
    n_epochs = min(len(fold) for fold in fold_metrics)
    aggregated = []
    for e in range(n_epochs):
        values = {}
        for fold in fold_metrics:
            for name, v in fold[e].items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    values.setdefault(name, []).append(v)
        aggregated.append({k: float(np.mean(v)) for k, v in values.items()})
    return aggregated


def main_cross_validation(cfg, args, device, json_nesting: str = "reference") -> int:
    """K-fold driver (mmtpu's `main_cross_validation`): each fold runs with
    its metrics and models under `fold_<k>/`, then the per-epoch means over
    the folds go to `{train,validation,test}_metrics_agg.json`."""
    folds = int(cfg.experiment.cross_validation)
    base_metrics_path = Path(cfg.logging.metrics_path)
    base_model_path = Path(cfg.logging.model_output_path)
    fold_train, fold_val, fold_test = [], [], []
    for fold in range(1, folds + 1):
        print(f"fold {fold}/{folds}", flush=True)
        cfg.logging.metrics_path = str(base_metrics_path / f"fold_{fold}")
        cfg.logging.model_output_path = str(base_model_path / f"fold_{fold}")
        cfg.logging.create_directories()
        collected = {}
        run_single(cfg, args, device, cv_no=fold, json_nesting=json_nesting,
                   collect=collected)
        if collected.get("train"):
            fold_train.append(collected["train"])
            fold_val.append(collected["validation"])
        if collected.get("test"):
            fold_test.append(collected["test"])
    for name, folds_metrics in (("train", fold_train), ("validation", fold_val),
                                ("test", fold_test)):
        agg = aggregate_cv_metrics(folds_metrics)
        if agg:
            (base_metrics_path / f"{name}_metrics_agg.json").write_text(
                json.dumps(agg, indent=4))
    cfg.logging.metrics_path = str(base_metrics_path)
    cfg.logging.model_output_path = str(base_model_path)
    return 0


def _export_embeddings(cfg, model, loader, mods, device) -> Path:
    """The `embeddings` split's per-modality embeddings in eval mode, real
    rows of the full-modality pattern only: `{mod}_embeddings.npy` and
    `labels.npy` under `<metrics_path>/embeddings/`."""
    out_dir = Path(cfg.logging.metrics_path) / "embeddings"
    out_dir.mkdir(parents=True, exist_ok=True)
    full = loader.dataset.get_full_modality()
    vocab = loader.pattern_vocab
    chunks = {str(m): [] for m in mods}
    labels = []
    model.eval()
    with torch.no_grad():
        for batch in loader:
            keep = batch["sample_mask"].astype(bool)
            keep &= np.asarray([vocab[i] == full for i in batch["pattern_id"]])
            if not keep.any():
                continue
            outs = model.encode(*[torch.from_numpy(np.ascontiguousarray(batch[str(m)]))
                                  .to(device) for m in mods])
            for m, o in zip(mods, outs):
                chunks[str(m)].append(o.cpu().numpy()[keep])
            labels.append(batch["labels"][keep])
    for m in mods:
        if chunks[str(m)]:
            np.save(out_dir / f"{m}_embeddings.npy", np.concatenate(chunks[str(m)]))
    if labels:
        np.save(out_dir / "labels.npy", np.concatenate(labels))
    print(f"embeddings exported to {out_dir}", flush=True)
    return out_dir


if __name__ == "__main__":
    sys.exit(main())
