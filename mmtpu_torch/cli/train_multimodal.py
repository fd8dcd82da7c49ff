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
generator. Kinetics-Sounds (`kineticssounds`: the three-ConvBlock audio
encoder and the video MLP over 400-d features, 26 classes, patterns over
audio and video) trains as AVMNIST does, with a plain head: no kernel, as in
mmtpu; its dropouts draw from the run's generator. With
`monitoring.enabled: true` and a `logging.monitor_path`, the runs of the
generic loop (every type above but MMIN, RedCore and Self-MM, as in mmtpu)
write mmtpu's `<monitor_path>/monitor_data.h5` (`mmtpu_torch/monitor`).

`experiment.cross_validation: K` runs K folds, each with `cv_no` set in
every dataset's kwargs and its outputs under `fold_<k>/`, then writes the
per-epoch means of every metric over the folds to
`{train,validation,test}_metrics_agg.json`. `--stacked-folds` trains all K
folds as ONE vmapped program, and `--stacked-runs K` the K members
run_id..run_id+K-1 (seed + i), each member with its own outputs in the
sequential schema (`cli/stacked_cv.py`); MMIN, RedCore and Self-MM, a
data_parallel other than 1, `--resume`, and `--stacked-runs` on a CV config
take mmtpu's sequential runs and folds instead.

`--data-parallel N` (or `experiment.data_parallel: N`), N > 1, trains every
model type above, MMIN, RedCore and Self-MM included, on N devices: `main`
starts one process per rank (`parallel/launch.py`; N GPUs over NCCL, or
with `--cpu` N processes over gloo), each runs this driver on its rows of
every global batch, with mmtpu's numbers (the global masked loss, the
gradients summed over the ranks, BatchNorm over the global batch, RedCore's
schedule from the global MSEs, Self-MM's banks from the global batch, the
metrics from the gathered outputs), and rank 0 alone writes the files and
the console lines. Folds and runs go one after another on the mesh. Other
model types (MulT's `mult` and GCNet's `gcnet` among them, which train only
through the registry, as in mmtpu) raise mmtpu's `ValueError: Unknown model
type` where mmtpu's does, after the loaders are built.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

from mmtpu_torch.cli import common

# mmtpu stacks none of them: they run their folds and runs one after another
CUSTOM_STEP_TYPES = ("mmin", "redcore", "self-mm", "self_mm")


def main(argv=None, json_nesting: str = "reference",
         module: str = "mmtpu_torch.cli.train_multimodal") -> int:
    args = common.standard_arg_parser(__doc__).parse_args(argv)
    mesh = common.rank_mesh()
    device = common.resolve_device(args.cpu, mesh)
    rc = common.run_ranks(args, device, module, argv, mesh)
    if rc is not None:
        return rc
    return route(common.load_config(args, mesh), args, device, json_nesting=json_nesting,
                 mesh=mesh)


def _stacked_fallback_reason(cfg, args, flag: str = "--stacked-folds", mesh=None):
    """Why mmtpu's stacked engines would not apply and it would run
    sequentially instead (None when they would); `mesh`, this rank's."""
    mt = cfg.model.model_type.lower()
    if mt in CUSTOM_STEP_TYPES:
        return f"{flag} unsupported for {mt}"
    dp = getattr(args, "data_parallel", None)
    if dp is None:
        dp = cfg.experiment.data_parallel
    if mesh is not None:
        dp = mesh.data_size
    if dp and dp != 1:
        return f"stacking is single-device and data_parallel={dp} was requested"
    if getattr(args, "resume", False):
        return "--resume is not supported by stacking"
    return None


def route(cfg, args, device, json_nesting: str = "reference", mesh=None) -> int:
    """Single run, cross-validation or a --stacked-runs sweep, in this rank
    of `mesh` where there is one. Shared by train_multimodal and
    train_avmnist (which differs only in the nesting of
    epoch_metrics.json)."""
    runs = int(getattr(args, "stacked_runs", 0) or 0)
    if runs > 1:
        if cfg.experiment.cross_validation:
            # no run-stacking engine for CV (the member axis is the folds):
            # the K repeats run one after another, as run_n.sh would
            print(f"--stacked-runs with a cross-validation config runs the {runs} repeats "
                  "sequentially (use --stacked-folds to stack folds within each run)",
                  flush=True)
            return sequential_runs(args, device, json_nesting=json_nesting, mesh=mesh)
        reason = _stacked_fallback_reason(cfg, args, "--stacked-runs", mesh)
        if reason is None:
            from mmtpu_torch.cli import stacked_cv

            return stacked_cv.run_repeat(args, device, json_nesting=json_nesting)
        print(f"{reason}; falling back to sequential runs", flush=True)
        return sequential_runs(args, device, json_nesting=json_nesting, mesh=mesh)
    if cfg.experiment.cross_validation:
        if getattr(args, "stacked_folds", False):
            reason = _stacked_fallback_reason(cfg, args, mesh=mesh)
            if reason is None:
                from mmtpu_torch.cli import stacked_cv

                return stacked_cv.run(cfg, args, device, json_nesting=json_nesting)
            print(f"{reason}; falling back to sequential CV", flush=True)
        return main_cross_validation(cfg, args, device, json_nesting=json_nesting, mesh=mesh)
    return run_single(cfg, args, device, json_nesting=json_nesting, mesh=mesh)


def sequential_runs(args, device, json_nesting: str = "reference", mesh=None) -> int:
    """--stacked-runs K one member after another (mmtpu's `sequential_runs`,
    the reference's run_n.sh loop): each member, from `derive_member_args`,
    loads its config anew; the sweep stops at the first failure."""
    def run_one(sub) -> int:
        return route(common.load_config(sub, mesh), sub, device, json_nesting=json_nesting,
                     mesh=mesh)

    return common.run_id_sweep(args, run_one)


def run_single(cfg, args, device, cv_no=None, json_nesting: str = "reference",
               collect=None, mesh=None) -> int:
    """Train and test one run, in this rank of `mesh` where there is one.
    `cv_no` is the fold a cross-validation run injects into every dataset's
    kwargs; `collect`, when a dict, receives the train and validation
    metric histories and the test metrics."""
    from mmtpu_torch.reports import ExperimentReportGenerator
    from mmtpu_torch.train.loop import TrainLoop
    from mmtpu_torch.train.step import ClassificationTask
    from mmtpu_torch.utils import clean_checkpoints

    if cv_no is not None:
        for ds_cfg in cfg.data.datasets.values():
            ds_cfg.kwargs["cv_no"] = cv_no
    mt = cfg.model.model_type.lower()
    if mt in ("mmin", "redcore"):
        from mmtpu_torch.cli import msa_runners

        return msa_runners.run(cfg, args, device, mesh=mesh)
    if mt in ("self-mm", "self_mm"):
        from mmtpu_torch.cli import train_self_mm

        return train_self_mm.run(cfg, args, device, mesh=mesh)
    common.check_rank(cfg, args, device, mesh)
    writes = mesh is None or mesh.is_writer  # on a mesh, rank 0 alone writes files
    if writes:
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
    if mesh is not None:
        common.seed_rank_streams(mesh, cfg.experiment.seed, state.generator)
    task = ClassificationTask(model=model, loss_group=cfg.training.loss_functions,
                              input_keys=[str(m) for m in mods], multilabel=mt == "mmimdb")
    recorder = common.make_recorder(cfg, mesh)
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
        eval_batch_factor=getattr(args, "eval_batch_factor", None), mesh=mesh,
        monitor=common.make_monitor(cfg, resume=args.resume, mesh=mesh),
    )
    if cfg.experiment.dry_run:
        recorder.close()
        print("dry run complete — config, data, model, state all built", flush=True)
        return 0
    results = {}
    if not args.skip_train and cfg.experiment.is_train:
        with common.ProfilerSession(getattr(args, "profile", False) and writes,
                                    cfg.logging.log_path):
            loop.run()
    if not args.skip_test and cfg.experiment.is_test:
        results = loop.test(splits=[s for s in loaders
                                    if s not in ("train", "validation", "embeddings")])
        for split, metrics in results.items():
            shown = {k: round(v, 4) for k, v in metrics.items() if isinstance(v, (int, float))}
            print(f"{split} metrics: {shown}", flush=True)
    if writes:
        embeddings_dir = None
        if "embeddings" in loaders and hasattr(model, "encode"):
            embeddings_dir = _export_embeddings(cfg, model, loaders["embeddings"], mods, device)
        ExperimentReportGenerator(
            Path(cfg.logging.metrics_path) / "report", cfg.experiment.name,
            metrics_dir=cfg.logging.metrics_path,
        ).generate_report(metrics_history=loop.metrics_history,
                          timing_history=loop.timing_history, model=model,
                          test_metrics=results, embeddings_dir=embeddings_dir)
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


def main_cross_validation(cfg, args, device, json_nesting: str = "reference",
                          mesh=None) -> int:
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
                   collect=collected, mesh=mesh)
        if collected.get("train"):
            fold_train.append(collected["train"])
            fold_val.append(collected["validation"])
        if collected.get("test"):
            fold_test.append(collected["test"])
    for name, folds_metrics in (("train", fold_train), ("validation", fold_val),
                                ("test", fold_test)):
        agg = aggregate_cv_metrics(folds_metrics)
        if agg and (mesh is None or mesh.is_writer):
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
