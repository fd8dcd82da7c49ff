#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (`mmtpu_torch`) on one GPU.

    python3 chip_smoke.py

Drives the port's serving paths at the full width of two models, from seeded
random weights: the AVMNIST late-fusion model (ResNet18 audio encoder,
hidden 64; ResNet34 image encoder, hidden 128; head 192→128→64→10) and the
MOSI UttFusion model at its published widths (LSTM 5→64 audio, LSTM 20→64
video, pooling 'last'; TextCNN 768→64 with 128 channels, heights 3/4/5;
FcClassifier 192→[192, 64, 32]→3; batch 32, aligned T = 50):

1. build   — compiles every kernel from `mmtpu_torch/ops/csrc`, one nvcc per
             source, all started together;
2. kernels — each kernel against its plain PyTorch version on the card, at
             the shapes the paths give it (the MLP also with a misaligned
             weight view and with a chain too wide to stay in shared
             memory), with timings (CUDA events per call, the host's wall
             time per launch, profiler device time); the LSTM also against
             `torch.nn.LSTM` as the library's call, and its gradient against
             autograd through the plain scan;
3. predict — the `predict` entry over a synthetic test split, once per
             model (AVMNIST: 1000 samples × ai/a/i, batch 128; UttFusion:
             686 samples × 7 patterns = 4802 visits, batch 32); logits
             checked against the port on the CPU; the model's kernel must be
             launched exactly once per batch;
4. serve   — the HTTP server in process, once per model: concurrent /predict
             requests (some with a modality zeroed) and one /predict_batch,
             each answer checked against the Predictor; a request that
             lacks an input key must get 400; the same requests against a
             server with no model give the host's ceiling;
5. train   — the AVMNIST pretrain-then-fine-tune pipeline through the
             training entry points' `main` on the card, at the widths of
             configs/avmnist/synthetic_mono_audio.yaml and
             synthetic_multimodal_pretrained.yaml (2048 train samples, 512
             validation and 512 test, batch 128, 2 epochs): `train_monomodal`
             writes the audio handoff, `train_multimodal` fine-tunes from it
             (its audio encoder at epoch 0 must be the handoff's, and
             `fused_mlp` must run once per validation and test batch and in
             no train forward), and again from scratch; then a profiled
             window of train steps, and the first three train steps (and one
             with a padded tail) on the card against the CPU;
6. train utt — MOSI UttFusion training through `train_multimodal.main` at
             the published widths on synthetic_mosi at CMU-MOSI's split
             sizes (1284 train, 229 validation, 686 test; T = 50, batch 32,
             2 epochs, train pattern `atv` with audio and video missing at
             0.2, evaluation over the seven patterns): `lstm` must launch
             once per train, validation and test batch; the MSA keys of
             test_metrics.json; a profiled window of 8 train steps
             (launches per step, busy share); the first three train steps
             (where `clip` scales the gradients) and the epoch's padded
             tail on the card against the CPU.

7. reader  — the paper's own fine-tune configs (plain-dict twins of
             configs/avmnist/multimodal_resnet_{pretrained,scratch}.yaml:
             ResNet18/ResNet34 at full width, the files' optimizer groups,
             scheduler and metrics, batch 128) fed by the real AVMNIST
             reader from `.pt` files this run writes (2048/512/512
             samples): the arrays checked byte for byte and timed from the
             files and from the `.npy` sidecars; `train_avmnist` on the
             pretrained twin from phase 5's audio handoff, 2 epochs, with
             `--profile` and TensorBoard (the trace and the tfevents file
             must be written; `fused_mlp` exactly 36 launches); the scratch
             twin as a two-fold cross-validation (`fold_1/`, `fold_2/`, the
             three `*_metrics_agg.json`; 72 launches) and as a
             `--stacked-runs 2` sweep at 512/128/128 samples (runs 1 and 2,
             seeds 42 and 43; twice one member's launches).

8. shipped — the shipped-weights flow (plain-dict twins of
             configs/avmnist/shipped_wheights_{finetune,finetune_audiofix,
             scratch}.yaml: MNISTAudio and MNISTImage, 32/64 channels,
             hidden 64; head 128→128→64→10, dropout 0.5; the files' Adam
             groups and plateau scheduler; batch 128) on phase 7's `.pt`
             files: a reference-layout image-encoder `.pth` written from the
             seed (30 tensors, wrapped in `model_state_dict` with a
             `module.` prefix) loads byte for byte and replays the reference
             module within 1e-4 on the card; `train_multimodal.main` runs
             the three twins for 2 epochs (the image encoder at epoch 0 the
             file's in two of them; the audiofix groups at 5e-4 / 1e-4;
             `fused_mlp` exactly 36 launches each; mmtpu's test keys);
             predict on the fine-tune's best.pth against the CPU; a
             profiled window of 8 fine-tune train steps; three
             train steps with each of rmsprop (with and without momentum),
             adagrad, adadelta, adamax, asgd and sparse_adam on the card
             against the CPU, and lbfgs raising on both. The kernels phase
             also holds `fused_mlp` at the head's dims [128, 128, 64, 10].

9. cmam    — C-MAM through `train_cmam.main`, both kinds at full width:
             a twin of configs/avmnist/cmam_audio_to_image.yaml (ResNet18
             student, hidden 64, AssociationNetwork 64→256→128 with
             BatchNorm and dropout 0.25, against phase 5's scratch
             fine-tune restored from its best.pth, on phase 7's `.pt` files,
             2048/512/512 samples, batch 128, 2 epochs) and of
             configs/mosi/synthetic_dual_cmam.yaml at the published
             UttFusion widths (LSTM 5→64 student, decoders 64→64→64,
             against phase 6's model; 1284/229/686 samples, T = 50, batch
             32, 2 epochs): the teacher's state hash equal to its file's
             before the run and after it, `fused_mlp` never launched,
             `lstm` three times per DualCMAM batch, mmtpu's record keys
             (the nested groups, loss, the term columns); a profiled window
             of 8 train steps and the first three steps and a padded-tail
             step on the card against the CPU, for each kind.

10. msa    — MMIN and RedCore through `train_multimodal.main` at full width on
             synthetic_mosi at CMU-MOSI's split sizes (1284/229/686, T = 50,
             batch 32, 2 epochs, train `atv` with audio and video missing at
             0.2, evaluation over `atv`, `at`, `tv`): a twin of
             configs/mosi/synthetic_mmin_teacher.yaml (the student at the
             published UttFusion widths, AE 256,128,64 in 5 blocks,
             classifier 320→[128,128]→3) over phase 6's model as its frozen
             teacher, restored from its best.pth: the teacher's state hash
             equal to its file's before the run and after it, `lstm` exactly
             3 per train batch and 1 per evaluation batch (355), `fused_mlp`
             never; and a RedCore twin (Transformer encoders, embedding 64;
             the MMIN twin's AE; ResidualXE generators 128→64) launching
             neither kernel; for each, a profiled window of 8 train steps and
             the first three steps and the padded tail on the card against
             the CPU (RedCore's dropouts and VAE sample neutralised, its β
             and η after three steps compared).

11. self-mm, mmimdb — (a) Self-MM through `train_multimodal.main` at the
             widths of MMSA's config_regression.json for self_mm on mosi
             (BERT-base text, AuViSubNet audio 5→16 and video 20→32, post
             dims 128/32/16/32) on synthetic_mosi in `text_mode: bert` at
             1284/229/686, T = 50, batch 32, 2 epochs: twice, with the
             fresh BERT frozen and fine-tuned from an HF-style directory
             this run writes from the seed (`config.json`,
             `pytorch_model.bin`); `lstm` exactly 2 per train, validation
             and test batch (240), `fused_mlp` never; the banks finite on
             the card after the run, the unimodal labels within ±3; the
             checkpoints' size; a profiled window of 8 epoch-2 train steps;
             the first three steps, the padded tail and one epoch-2 step
             (the label refinement) on the card against the CPU, gradients
             of BERT included when it fine-tunes. (b) MM-IMDb at the
             published GMU widths (configs/mmimdb/synthetic_gmu.yaml: 4096
             and 300 features, 512 hidden, 23 genres) at MM-IMDb's split
             sizes 15,552/2,608/7,799, batch 64, 2 epochs, evaluation over
             `it`, `i`, `t`: no launch of either kernel, mmtpu's F1 keys;
             predict on the best checkpoint against the CPU; the server's
             multilabel answers and a 400 for a request without `text`; a
             profiled window; the first three steps and a padded tail GPU
             vs CPU (gradients in float64). Phase 2 also holds `lstm` at
             Self-MM's two shapes, G=1 B=32 T=50 H=16 and H=32.

    python3 chip_smoke.py --train-only    # build, then phases 5 and 6 alone
    python3 chip_smoke.py --reader-only   # build, the audio pretraining, phase 7
    python3 chip_smoke.py --shipped-only  # build, phase 7's .pt files, phase 8
    python3 chip_smoke.py --cmam-only     # build, phase 7's .pt files, seeded
                                          # teachers, phase 9
    python3 chip_smoke.py --msa-only      # build, a seeded UttFusion teacher,
                                          # phase 10
    python3 chip_smoke.py --self-mm-only  # build, phase 11 (a)
    python3 chip_smoke.py --mmimdb-only   # build, phase 11 (b)

Prints a `kernels` JSON line, the card's name and power limit, and as the
last line `{"ok": true, "device": {...}}`. Any failure exits non-zero
without that line. There is no CPU path: without a GPU it fails. Imports
nothing of JAX or of the `mmtpu` package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 42
HEAD_DIMS = [192, 128, 64, 10]
KERNEL_TOL = 1e-5  # fp32; kernel and cuBLAS sum in different orders
LSTM_TOL_LONG = 1e-4  # T = 400: rounding differences pass through 400 dependent steps
LSTM_GRAD_TOL = 1e-4  # kernel forward + plain recompute vs autograd through the plain scan
LIBRARY_TOL = 1e-3  # nn.LSTM (cuDNN, fp32) vs projection + kernel: the yardstick's sanity
LSTM_GATE_OPS = 20  # per (row, step, unit): 3 σ (4 ops each), 2 tanh, 3 ·, 1 +, and the freeze
CPU_TOL = 1e-3  # GPU (TF32 off) vs CPU forward of the full model
SERVE_TOL = 1e-4  # micro-batched rows vs a direct Predictor call
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOP_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores


def smoke_config(num_samples: int = 1000, batch_size: int = 128,
                 out_root: str = "./experiments_output") -> dict:
    """The plain-dict twin of configs/avmnist/synthetic_multimodal_pretrained.yaml;
    the test split's size and batch are this run's, the rest is the file's."""
    patterns = {
        "modalities": {
            "audio": {"missing_rate": 0.0},
            "image": {"missing_rate": 0.0},
        },
    }

    def split(name, n, bs, selected, **extra):
        return {
            "dataset": "synthetic_avmnist",
            "data_fp": "unused",
            "split": name,
            "target_modality": "MULTIMODAL",
            "batch_size": bs,
            **extra,
            "kwargs": {"num_samples": n},
            "missing_patterns": {**patterns, "selected_patterns": selected},
        }

    name = "Synthetic_AVMNIST_Multimodal_Pretrained"
    return {
        "experiment": {"name": name, "seed": SEED, "device": "tpu",
                       "is_train": True, "is_test": True},
        "model": {
            "name": name,
            "model_type": "AVMNIST",
            "audio_encoder": {"__module_spec__": "resnet18", "in_channels": 1,
                              "hidden_dim": 64},
            "image_encoder": {"__module_spec__": "resnet34", "in_channels": 1,
                              "hidden_dim": 128},
            "hidden_dim": 128,
            "dropout": 0.5,
            "fusion_fn": "concat",
            "pretrained_encoders": {
                "audio": "./experiments_output/Synthetic_AVMNIST_Audio_Encoder/"
                         "models/{run_id}/encoder_audio_best.ckpt",
            },
        },
        "training": {
            "epochs": 2,
            "early_stopping": True,
            "early_stopping_patience": 5,
            "num_modalities": 2,
            "optimizer": {"name": "Adam",
                          "default_kwargs": {"lr": 0.0005, "weight_decay": 0.0001}},
            "encoder_optimizer": {"name": "Adam",
                                  "default_kwargs": {"lr": 0.0001,
                                                     "weight_decay": 0.0001}},
            "modality_specific_params": {
                "audio_encoder": {"lr": 0.0001, "weight_decay": 0.0002},
                "image_encoder": {"lr": 0.0001, "weight_decay": 0.0002},
            },
            "scheduler": "plateau",
            "scheduler_kwargs": {"mode": "min", "factor": 0.5, "patience": 5,
                                 "min_lr": 0.00001},
            "loss_functions": {
                "cross_entropy": {"loss_name": "cross_entropy", "loss_args": {},
                                  "weight": 1.0},
            },
        },
        "data": {
            "datasets": {
                "train": split("train", 256, 64, ["ai"], shuffle=True),
                "validation": split("valid", 96, 64, ["ai", "a", "i"]),
                "test": split("test", num_samples, batch_size, ["ai", "a", "i"]),
            },
        },
        "metrics": {
            "metrics": {
                "accuracy": {"function": "sklearn.metrics.accuracy_score",
                             "kwargs": {}},
                "f1_weighted": {"function": "sklearn.metrics.f1_score",
                                "kwargs": {"average": "weighted",
                                           "zero_division": 0}},
                "ConfusionMatrix": {"function": "sklearn.metrics.confusion_matrix",
                                    "kwargs": {"labels": list(range(10))}},
            },
            "groups": {"classification": ["accuracy", "f1_weighted",
                                          "ConfusionMatrix"]},
        },
        "logging": {
            "log_path": f"{out_root}/{{experiment_name}}/logs/{{run_id}}",
            "model_output_path": f"{out_root}/{{experiment_name}}/models/{{run_id}}",
            "metrics_path": f"{out_root}/{{experiment_name}}/metrics/{{run_id}}",
            "save_metric": "loss",
        },
        "monitoring": {"enabled": False},
    }


def mosi_smoke_config(num_samples: int = 686, batch_size: int = 32, seq_len: int = 50,
                      out_root: str = "./experiments_output", train_samples: int = 128,
                      validation_samples: int = 64) -> dict:
    """The plain-dict twin of configs/mosi/synthetic_utt_fusion.yaml with the
    model at its published widths (LSTM hidden 64 and pooling 'last', TextCNN
    with 128 channels, FcClassifier 192→[192, 64, 32]→3); the split sizes
    are this run's (686 is the size of the real MOSI test split; the file
    has 128 / 64 / 64), the rest is the file's."""
    def split(name, n, rates, **extra):
        return {
            "dataset": "synthetic_mosi",
            "data_fp": "unused",
            "split": name,
            "target_modality": "MULTIMODAL",
            "batch_size": batch_size,
            **extra,
            "kwargs": {"num_samples": n, **({"seq_len": seq_len} if seq_len != 50 else {})},
            "missing_patterns": {"modalities": rates},
        }

    present = {m: {"missing_rate": 0.0} for m in ("audio", "video", "text")}
    dropped = {
        "audio": {"missing_rate": 0.2, "apply_to": ["atv"]},
        "video": {"missing_rate": 0.2, "apply_to": ["atv"]},
        "text": {"missing_rate": 0.0},
    }
    train = split("train", train_samples, dropped, shuffle=True)
    train["missing_patterns"]["selected_patterns"] = ["atv"]
    name = "Synthetic_MOSI_UttFusion"
    return {
        "experiment": {"name": name, "seed": SEED, "device": "tpu",
                       "is_train": True, "is_test": True},
        "model": {
            "name": "UttFusion",
            "model_type": "utt-fusion",
            "netA": {"__module_spec__": "lstmencoder", "input_size": 5,
                     "hidden_size": 64, "embd_method": "last"},
            "netV": {"__module_spec__": "lstmencoder", "input_size": 20,
                     "hidden_size": 64, "embd_method": "last"},
            "netT": {"__module_spec__": "textcnn", "input_size": 768, "embd_size": 64,
                     "in_channels": 1, "out_channels": 128,
                     "kernel_heights": [3, 4, 5], "dropout": 0.5},
            "netC": {"__module_spec__": "fcclassifier", "input_dim": 192,
                     "layers": [192, 64, 32], "output_dim": 3, "dropout": 0.5},
            "clip": 0.5,
        },
        "training": {
            "epochs": 2,
            "early_stopping": False,
            "early_stopping_patience": 5,
            "num_modalities": 3,
            "optimizer": {"name": "Adam",
                          "default_kwargs": {"lr": 0.001, "weight_decay": 0.0001}},
            "loss_functions": {
                "cross_entropy": {"loss_name": "cross_entropy", "loss_args": {},
                                  "weight": 1.0},
            },
        },
        "data": {
            "datasets": {
                "train": train,
                "validation": split("valid", validation_samples, present),
                "test": split("test", num_samples, present),
            },
        },
        "metrics": {
            "metrics": {
                "MSA": {"function": "metrics.msa_binary_classification", "kwargs": {}},
                "accuracy": {"function": "sklearn.metrics.accuracy_score", "kwargs": {}},
            },
            "groups": {"classification": ["MSA", "accuracy"]},
        },
        "logging": {
            "log_path": f"{out_root}/{{experiment_name}}/logs/{{run_id}}",
            "model_output_path": f"{out_root}/{{experiment_name}}/models/{{run_id}}",
            "metrics_path": f"{out_root}/{{experiment_name}}/metrics/{{run_id}}",
            "save_metric": "loss",
        },
        "monitoring": {"enabled": False},
    }


def say(msg: str) -> None:
    print(msg, flush=True)


def kernel_counters() -> dict:
    """Kernel name → the wrapper that counts its launches."""
    from mmtpu_torch.ops import fused_mlp, lstm_sequence_stacked

    return {"fused_mlp": fused_mlp, "lstm": lstm_sequence_stacked}


def reset_counts() -> None:
    for wrapper in kernel_counters().values():
        wrapper.launches = 0


def read_counts() -> dict:
    return {name: wrapper.launches for name, wrapper in kernel_counters().items()}


def event_ms(fn, iters: int = 200, repeats: int = 7, warmup: int = 20) -> float:
    """Median over `repeats` of the CUDA-event time per call of `iters`
    back-to-back calls (what a caller pays per call, launch included)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def host_ms(fn, iters: int = 200, repeats: int = 5) -> float:
    """Median over `repeats` of the host's wall time per call of `iters`
    back-to-back calls with no synchronisation: what a launch costs the
    caller's thread (checks, allocation, the launch itself)."""
    import torch

    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / iters)
    torch.cuda.synchronize()
    return statistics.median(times)


def device_breakdown(fn, top: int = 6) -> dict:
    """Run `fn` once under torch.profiler: device time summed over every
    kernel, the host wall time of the profiled run, the device time of the
    port's own kernels, and the kernels that took the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if "CUDA" in str(getattr(e, "device_type", ""))]
    dev_us = {e.key: getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0)) for e in kernels}
    total_ms = sum(dev_us.values()) / 1e3
    ranked = sorted(kernels, key=lambda e: -dev_us[e.key])[:top]
    host_ops = sorted((e for e in events if e not in kernels),
                      key=lambda e: -e.self_cpu_time_total)[:top]
    return {
        "device_ms": total_ms,
        "profiled_wall_ms": wall_ms,
        # kernels the device ran, and the host's launch calls
        "kernel_events": sum(e.count for e in kernels),
        "launch_calls": sum(e.count for e in events if e not in kernels
                            and "LaunchKernel" in e.key),
        # by the names of the __global__ functions in mmtpu_torch/ops/csrc
        "own_ms": {name: sum(v for k, v in dev_us.items() if f"{name}_kernel" in k) / 1e3
                   for name in kernel_counters()},
        "own_calls": {name: sum(e.count for e in kernels if f"{name}_kernel" in e.key)
                      for name in kernel_counters()},
        "top": [(e.key[:70], round(dev_us[e.key] / 1e3, 4), e.count) for e in ranked],
        "top_host": [(e.key[:50], round(e.self_cpu_time_total / 1e3, 3), e.count)
                     for e in host_ops],
    }


def own_device_ms(fn, name: str, calls: int = 100) -> float:
    """Mean device time of one launch of the port's kernel `name` while `fn`
    runs `calls` times under the profiler: its summed time over the launches
    the profiler recorded. (Now and then the profiler keeps fewer events than
    were launched; a sum over a fixed count would then read low.)"""
    brk = device_breakdown(lambda: [fn() for _ in range(calls)])
    recorded = brk["own_calls"][name]
    if not recorded:
        raise AssertionError(f"the profiler recorded no {name} kernel in {calls} calls")
    if recorded != calls:
        say(f"[kernels] (the profiler kept {recorded} of {calls} {name} launches)")
    return brk["own_ms"][name] / recorded


def _bound(nbytes: float, flops: float) -> tuple:
    """The larger of bytes over the HBM rate and FLOPs over the float32
    rate, in ms, and which one it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def mlp_bound_ms(batch: int, dims) -> tuple:
    """Least time for the chain on an H100: bytes moved (x, weights, biases
    read once, logits written once) and the chain's FLOPs."""
    params = sum(i * o + o for i, o in zip(dims[:-1], dims[1:]))
    nbytes = 4 * (batch * dims[0] + params + batch * dims[-1])
    flops = 2 * batch * sum(i * o for i, o in zip(dims[:-1], dims[1:]))
    return _bound(nbytes, flops)


def lstm_bound_ms(G: int, B: int, T: int, H: int, lengths=None) -> tuple:
    """Least time for the recurrence on an H100. Bytes: xw read for every
    live step, wh, h0, c0 read once, outputs, hT, cT written once (and the
    lengths). FLOPs: per live (row, step) the h·wh product, 2·H·4H, and the
    gate pass, LSTM_GATE_OPS·H. A row frozen by its length needs neither
    its xw nor any arithmetic, so with lengths only Σ min(len, T) steps count."""
    live = G * B * T if lengths is None else int(lengths.clamp(max=T).sum().item())
    nbytes = 4 * (live * 4 * H + G * H * 4 * H + 4 * G * B * H + G * B * T * H)
    if lengths is not None:
        nbytes += 4 * G * B
    flops = live * (2 * H * 4 * H + LSTM_GATE_OPS * H)
    return _bound(nbytes, flops)


def phase_build() -> None:
    from mmtpu_torch.ops import KERNELS, _build

    t0 = time.perf_counter()
    logs = _build.build(KERNELS)
    say(f"[build] {list(KERNELS)} in {time.perf_counter() - t0:.2f} s "
        f"(one nvcc per source, together; sm_90a) → {_build.BUILD_DIR}")
    for name, log in logs.items():
        for line in log.strip().splitlines():
            say(f"[build] {name}: {line.strip()}")


def phase_kernels_mlp(dev) -> dict:
    """fused_mlp vs fused_mlp_reference on the card; timings at the batch
    sizes the path uses (predict batch 128, and 1024)."""
    import torch

    from mmtpu_torch.ops import fused_mlp, fused_mlp_reference
    from mmtpu_torch.ops.fused_mlp import bulk_copy_ok, chain_plan

    g = torch.Generator().manual_seed(SEED)
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def layers(dims):
        ws = [(torch.randn(o, i, generator=g) / i ** 0.5).to(dev)
              for i, o in zip(dims[:-1], dims[1:])]
        bs = [(0.1 * torch.randn(o, generator=g)).to(dev) for o in dims[1:]]
        return ws, bs

    def misaligned(w):
        """The same matrix, contiguous, 4 bytes into a buffer of its own: no
        bulk copy can bring it, the kernel copies it with plain loads."""
        buf = torch.empty(w.numel() + 1, device=dev)
        buf[1:].copy_(w.reshape(-1))
        return buf[1:].view_as(w)

    max_err = shipped_err = 0.0
    # (dims, batch, what is special): the head at the path's batch sizes, odd
    # widths, layer 1 off the 16-byte grid, and a chain too wide to stay in
    # shared memory (16.8 MB of weights, streamed through it)
    cases = [(HEAD_DIMS, b, "") for b in (1, 37, 64, 128, 1024)] + [
        (SHIPPED_HEAD_DIMS, b, "") for b in (128, 1024)] + [
        ([100, 300, 7], 37, ""),
        (HEAD_DIMS, 128, "layer 1 a misaligned view"),
        ([2048, 2048, 10], 64, "weights streamed"),
    ]
    for dims, batch, special in cases:
        ws, bs = layers(dims)
        if "misaligned" in special:
            ws[0] = misaligned(ws[0])
            if bulk_copy_ok(ws[0]) or not bulk_copy_ok(ws[1]):
                raise AssertionError("the misaligned view is not what it should be")
        if "streamed" in special and chain_plan(batch, tuple(dims), num_sms).resident:
            raise AssertionError(f"fused_mlp {dims}: expected a streamed plan")
        x = torch.randn(batch, dims[0], generator=g).to(dev)
        got = fused_mlp(x, ws, bs)
        want = fused_mlp_reference(x, ws, bs)
        torch.cuda.synchronize()
        label = f"fused_mlp {dims} B={batch}" + (f" ({special})" if special else "")
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"{label}: bad output {got.shape}")
        err = (got - want).abs().max().item()
        say(f"[kernels] {label}: max |kernel - plain| = {err:.3e}")
        if err > KERNEL_TOL:
            raise AssertionError(f"{label}: error {err} > {KERNEL_TOL}")
        max_err = max(max_err, err)
        if dims == SHIPPED_HEAD_DIMS:
            shipped_err = max(shipped_err, err)

    timings = {}
    for dims in (HEAD_DIMS, SHIPPED_HEAD_DIMS):
        ws, bs = layers(dims)
        for batch in (128, 1024):
            x = torch.randn(batch, dims[0], generator=g).to(dev)
            # turns: plain, kernel, kernel, plain
            p1 = event_ms(lambda: fused_mlp_reference(x, ws, bs))
            k1 = event_ms(lambda: fused_mlp(x, ws, bs))
            k2 = event_ms(lambda: fused_mlp(x, ws, bs))
            p2 = event_ms(lambda: fused_mlp_reference(x, ws, bs))
            kh = host_ms(lambda: fused_mlp(x, ws, bs))
            kd = own_device_ms(lambda: fused_mlp(x, ws, bs), "fused_mlp")
            pd = device_breakdown(lambda: [fused_mlp_reference(x, ws, bs) for _ in range(100)])
            pd = pd["device_ms"] / 100
            bound, bound_by = mlp_bound_ms(batch, dims)
            timings[(dims[0], batch)] = {
                "ms": statistics.mean([k1, k2]), "plain_ms": statistics.mean([p1, p2]),
                "device_ms": kd, "plain_device_ms": pd, "host_ms": kh,
                "bound_ms": bound, "bound_by": bound_by,
            }
            say(f"[kernels] fused_mlp B={batch} {dims}: per call kernel "
                f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms (events); host per launch "
                f"{kh:.4f} ms (wall, no sync); device "
                f"time kernel {kd} ms, plain {pd} ms (profiler); bound {bound:.6f} ms "
                f"({bound_by})")
    return {"max_err": max_err, "shipped_err": shipped_err,
            "timings": {b: timings[(HEAD_DIMS[0], b)] for b in (128, 1024)},
            "shipped": {b: timings[(SHIPPED_HEAD_DIMS[0], b)] for b in (128, 1024)}}


# LSTM shapes: (G, B, T, H, lengths in [0, T], non-zero h0/c0, tolerance, timed)
LSTM_CASES = [
    (1, 32, 50, 64, False, False, KERNEL_TOL, True),
    (2, 32, 50, 64, False, False, KERNEL_TOL, True),   # the UttFusion forward
    (1, 128, 50, 32, False, False, KERNEL_TOL, True),
    (1, 32, 400, 64, True, False, LSTM_TOL_LONG, True),
    (1, 5, 7, 24, False, True, KERNEL_TOL, False),
    (1, 32, 50, 128, False, False, KERNEL_TOL, True),
    (2, 64, 50, 64, False, False, KERNEL_TOL, False),  # the server's largest micro-batch
    (1, 32, 50, 16, False, False, KERNEL_TOL, True),   # Self-MM's audio AuViSubNet
    (1, 32, 50, 32, False, False, KERNEL_TOL, True),   # Self-MM's video AuViSubNet
]
SELF_MM_LSTM = ((1, 32, 50, 16), (1, 32, 50, 32))
# the gradient checks: (G, B, T, H, lengths, non-zero h0/c0)
LSTM_GRAD_CASES = [(2, 9, 11, 24, True, True), (1, 32, 50, 16, False, False),
                   (1, 32, 50, 32, False, False)]
LSTM_MAIN = (2, 32, 50, 64)
LSTM_INPUT_SIZES = (5, 20)  # MOSI audio and video feature widths, by group
LSTM_LIBRARY_INPUT = {(1, 32, 50, 32): (20,)}  # Self-MM's video LSTM, 20→32


def _lstm_inputs(dev, G, B, T, H, with_len, with_state, seed):
    import torch

    g = np.random.default_rng(seed)
    xw = g.normal(size=(G, B, T, 4 * H)).astype(np.float32)
    wh = (g.normal(size=(G, H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    state = (0.5 * g.normal(size=(2, G, B, H))).astype(np.float32) * float(with_state)
    lengths = g.integers(0, T + 1, size=(G, B)).astype(np.int32) if with_len else None
    to = lambda a: None if a is None else torch.from_numpy(a).to(dev)  # noqa: E731
    return to(xw), to(wh), to(state[0]), to(state[1]), to(lengths)


def _lstm_library(dev, G, B, T, H, seed):
    """The library's call for the same function without lengths: per group a
    `torch.nn.LSTM` holding the weights of an `nn.Linear` projection and a
    recurrent matrix `wh`. Unlike the kernel it includes the projection
    x·Wi + b, so it is set against projection + kernel. Returns (library
    call, projection + kernel call, max |difference| of their outputs)."""
    import torch
    from torch import nn

    from mmtpu_torch.ops import lstm_sequence_stacked

    gen = torch.Generator().manual_seed(seed)
    xs, wis, whs, rnns = [], [], [], []
    sizes = LSTM_LIBRARY_INPUT.get((G, B, T, H), LSTM_INPUT_SIZES)
    for g in range(G):
        size = sizes[g % len(sizes)]
        wi = nn.Linear(size, 4 * H)
        wh = torch.randn(H, 4 * H, generator=gen) / H ** 0.5
        rnn = nn.LSTM(size, H, batch_first=True)
        with torch.no_grad():  # same gate order [i, f, g, o]; matrices transposed
            rnn.weight_ih_l0.copy_(wi.weight)
            rnn.bias_ih_l0.copy_(wi.bias)
            rnn.weight_hh_l0.copy_(wh.t())
            rnn.bias_hh_l0.zero_()
        xs.append(torch.randn(B, T, size, generator=gen).to(dev))
        wis.append(wi.to(dev))
        whs.append(wh.to(dev))
        rnns.append(rnn.to(dev).eval())
    @torch.no_grad()
    def library():
        return [rnn(x)[0] for rnn, x in zip(rnns, xs)]

    @torch.no_grad()
    def ours():
        return lstm_sequence_stacked([wi(x) for wi, x in zip(wis, xs)], whs)[0]

    diff = max((a - b).abs().max().item() for a, b in zip(library(), ours()))
    return library, ours, diff


def phase_kernels_lstm(dev) -> dict:
    """lstm kernel vs the plain scan on the card (outputs, hT, cT), its
    gradient vs autograd through the plain scan, and timings per call beside
    the plain scan and nn.LSTM."""
    import torch

    from mmtpu_torch.ops import lstm_sequence_stacked, lstm_stacked_reference

    torch.backends.cudnn.allow_tf32 = False  # nn.LSTM in fp32, as the kernel
    max_err = 0.0
    timings = {}
    for seed, (G, B, T, H, with_len, with_state, tol, timed) in enumerate(LSTM_CASES):
        xw, wh, h0, c0, lengths = _lstm_inputs(dev, G, B, T, H, with_len, with_state, seed)
        if not with_state:  # as the encoders call it: no state tensor at all
            h0 = c0 = None
        with torch.no_grad():
            out, (h, c) = lstm_sequence_stacked(list(xw), list(wh), h0, c0, lengths)
            want, (want_h, want_c) = lstm_stacked_reference(xw, wh, h0, c0, lengths)
        torch.cuda.synchronize()
        if out.shape != (G, B, T, H) or not all(torch.isfinite(t).all() for t in (out, h, c)):
            raise AssertionError(f"lstm G={G} B={B} T={T} H={H}: bad output {out.shape}")
        errs = [(a - b).abs().max().item() for a, b in ((out, want), (h, want_h), (c, want_c))]
        shape = f"G={G} B={B} T={T} H={H}" + (" lengths" if with_len else "") \
            + (" h0/c0≠0" if with_state else "")
        say(f"[kernels] lstm {shape}: max |kernel - plain| outputs {errs[0]:.3e}, "
            f"hT {errs[1]:.3e}, cT {errs[2]:.3e} (tolerance {tol})")
        if max(errs) > tol:
            raise AssertionError(f"lstm {shape}: error {max(errs)} > {tol}")
        max_err = max(max_err, *errs)
        if not timed:
            continue

        xws, whs = list(xw), list(wh)  # per-group tensors, as the encoders hand them over

        def kernel():
            return lstm_sequence_stacked(xws, whs, h0, c0, lengths)

        def plain():
            return lstm_stacked_reference(xw, wh, h0, c0, lengths)

        slow = dict(iters=10, repeats=3, warmup=2)  # the scan is ~10 launches per step
        with torch.no_grad():
            p1 = event_ms(plain, **slow)
            k1 = event_ms(kernel)
            k2 = event_ms(kernel)
            p2 = event_ms(plain, **slow)
            kh = host_ms(kernel)
            kd = own_device_ms(kernel, "lstm")
            pd = device_breakdown(lambda: [plain() for _ in range(3)])["device_ms"] / 3
        bound, bound_by = lstm_bound_ms(G, B, T, H, lengths)
        t = {"ms": statistics.mean([k1, k2]), "plain_ms": statistics.mean([p1, p2]),
             "device_ms": kd, "plain_device_ms": pd, "host_ms": kh, "bound_ms": bound,
             "bound_by": bound_by, "serial_steps": T}
        line = (f"[kernels] lstm {shape}: per call kernel {k1:.4f}/{k2:.4f} ms, plain "
                f"{p1:.4f}/{p2:.4f} ms (events); host per launch {kh:.4f} ms (wall, no sync); "
                f"device time kernel {kd} ms, plain {pd} ms "
                f"(profiler); bound {bound:.6f} ms ({bound_by}); serial chain {T} steps")
        if not with_len:  # nn.LSTM has no length freeze of this kind
            library, ours, diff = _lstm_library(dev, G, B, T, H, seed)
            if diff > LIBRARY_TOL:
                raise AssertionError(f"lstm {shape}: nn.LSTM differs by {diff}")
            l1 = event_ms(library)
            o1 = event_ms(ours)
            o2 = event_ms(ours)
            l2 = event_ms(library)
            ld = device_breakdown(lambda: [library() for _ in range(100)])["device_ms"] / 100
            t.update(library_ms=statistics.mean([l1, l2]), library_device_ms=ld,
                     with_projection_ms=statistics.mean([o1, o2]))
            line += (f"; nn.LSTM ×{G} (projection included) {l1:.4f}/{l2:.4f} ms, device "
                     f"{ld} ms, vs projection + kernel {o1:.4f}/{o2:.4f} ms, "
                     f"max |difference| {diff:.3e}")
        say(line)
        timings[(G, B, T, H)] = t

    # gradient: kernel forward + plain recompute vs autograd through the plain scan
    grad_err = 0.0
    for G, B, T, H, with_len, with_state in LSTM_GRAD_CASES:
        cots = None
        grads = []
        for fn in (lstm_sequence_stacked, lstm_stacked_reference):
            xw, wh, h0, c0, lengths = _lstm_inputs(dev, G, B, T, H, with_len, with_state, 99)
            leaves = [t.requires_grad_() for t in (xw, wh)]
            if with_state:
                leaves += [t.requires_grad_() for t in (h0, c0)]
            else:  # as the encoders call it: no state tensor at all
                h0 = c0 = None
            out, (h, c) = fn(*leaves[:2], h0, c0, lengths)
            if cots is None:
                gen = torch.Generator().manual_seed(SEED)
                cots = [torch.randn(t.shape, generator=gen).to(dev) for t in (out, h, c)]
            grads.append(torch.autograd.grad((out, h, c), leaves, cots))
        err = max((a - b).abs().max().item() for a, b in zip(*grads))
        grad_err = max(grad_err, err)
        shape = f"G={G} B={B} T={T} H={H}" + (", lengths, h0/c0≠0" if with_len else "")
        say(f"[kernels] lstm gradient ({shape}): max |autograd.Function - autograd through "
            f"the plain scan| = {err:.3e} (tolerance {LSTM_GRAD_TOL})")
        if err > LSTM_GRAD_TOL:
            raise AssertionError(f"lstm gradient at {shape} differs by {err}")
    return {"max_err": max_err, "grad_err": grad_err, "timings": timings}


# What the predict and serve phases need to know of each model's path.
AVMNIST_PATH = {
    "label": "AVMNIST", "kernel": "fused_mlp", "classes": 10,
    "patterns": {"ai", "a", "i"}, "keys": ["audio", "image"],
}
MOSI_PATH = {
    "label": "UttFusion", "kernel": "lstm", "classes": 3,
    "patterns": {"atv", "at", "av", "tv", "a", "t", "v"}, "keys": ["audio", "video", "text"],
}


def phase_predict(dev, work: Path, cfg_path: Path, path: dict) -> dict:
    import torch

    from mmtpu_torch.checkpoints import save_pth
    from mmtpu_torch.cli import common, predict
    from mmtpu_torch.models import seeded_init
    from mmtpu_torch.train.step import make_eval_step

    tag, kernel = f"[predict {path['label']}]", path["kernel"]
    cfg = common.load_config(argparse.Namespace(config=str(cfg_path), run_id=1, seed=None))
    model = seeded_init(common.build_model_from_config(cfg.model), SEED)
    ckpt = save_pth(model, common.checkpoint_path(cfg, "best"))
    n_params = sum(p.numel() for p in model.parameters())
    say(f"{tag} full-width model ({n_params} parameters), seeded weights → {ckpt}")

    out_json = work / f"predictions_{path['label']}.json"
    args = predict.arg_parser().parse_args(
        ["--config", str(cfg_path), "--run_id", "1", "--out", str(out_json)]
    )
    reset_counts()
    t0 = time.perf_counter()
    _, records, summary = predict.run(args)
    seconds = time.perf_counter() - t0
    counts = read_counts()
    data = json.loads(out_json.read_text())
    if set(data) != {"split", "checkpoint", "accuracy_per_pattern", "predictions"}:
        raise AssertionError(f"predictions JSON keys {sorted(data)}")
    test = cfg.data.datasets["test"]
    n_visits = len(path["patterns"]) * test.kwargs["num_samples"]
    n_batches = -(-n_visits // test.batch_size)
    if len(records) != n_visits or set(summary) != path["patterns"]:
        raise AssertionError(f"{len(records)} records, patterns {sorted(summary)}")
    # one launch per eval forward: none means the path went round the kernel,
    # more means a route launches it twice
    if counts[kernel] != n_batches:
        raise AssertionError(
            f"predict: {kernel} launched {counts[kernel]} times in {n_batches} batches")
    say(f"{tag} {len(records)} visits in {n_batches} batches, {seconds:.3f} s through "
        f"predict.run ({len(records) / seconds:.1f} visits/s, start-up included); "
        f"per-pattern accuracy {summary}; kernel launches {counts}")

    # steady state: the same pass with the model already built and loaded
    task, loader = predict.build_task_and_loader(cfg, args, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    records2, _ = predict.predict_split(task, loader, dev)
    steady = time.perf_counter() - t0
    say(f"{tag} steady pass: {len(records2)} visits in {steady:.3f} s "
        f"({len(records2) / steady:.1f} visits/s)")
    if [r["pred"] for r in records2] != [r["pred"] for r in records]:
        raise AssertionError("two predict passes disagree")
    brk = device_breakdown(lambda: predict.predict_split(task, loader, dev))
    say(f"{tag} profiled pass: device busy {brk['device_ms']:.3f} ms of "
        f"{brk['profiled_wall_ms']:.3f} ms wall ({brk['device_ms'] / (steady * 1e3):.3f} "
        f"of the unprofiled steady pass); {kernel} {brk['own_ms'][kernel]:.4f} ms; "
        f"top kernels (name, ms, count) {brk['top']}; top host ops by self CPU time "
        f"(name, ms, count) {brk['top_host']}")

    # the same batches on the CPU: first two and the padded tail
    cpu_task, _ = predict.build_task_and_loader(cfg, args, torch.device("cpu"))
    batches = list(loader)
    picks = [0, 1, len(batches) - 1]
    gpu_step = make_eval_step(task, dev)
    cpu_step = make_eval_step(cpu_task, torch.device("cpu"))
    worst = 0.0
    for i in picks:
        g_out = gpu_step(batches[i])
        c_out = cpu_step(batches[i])
        g_logits = g_out["logits"].cpu()
        c_logits = c_out["logits"]
        if (g_logits.shape != (loader.batch_size, path["classes"])
                or not torch.isfinite(g_logits).all()):
            raise AssertionError(f"batch {i}: logits {tuple(g_logits.shape)} not finite")
        err = (g_logits - c_logits).abs().max().item()
        worst = max(worst, err)
        top2 = c_logits.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * CPU_TOL
        if not torch.equal(g_out["preds"].cpu()[clear], c_out["preds"][clear]):
            raise AssertionError(f"batch {i}: GPU and CPU predictions differ")
    say(f"{tag} GPU vs CPU logits on batches {picks}: max |diff| = {worst:.3e} "
        f"(tolerance {CPU_TOL}, TF32 off)")
    if worst > CPU_TOL:
        raise AssertionError(f"GPU vs CPU logits differ by {worst}")
    return {"launches": counts[kernel], "visits_per_s": len(records) / seconds,
            "steady_visits_per_s": len(records2) / steady}


def _post(url: str, body: bytes) -> dict:
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _get(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def phase_serve(cfg_path: Path, path: dict, inputs: dict) -> dict:
    """`inputs`: input key → (n, ...) array, one row per request, in the
    model's key order; a missing modality is a zeroed row."""
    from mmtpu_torch.cli import serve

    tag, kernel, keys = f"[serve {path['label']}]", path["kernel"], path["keys"]
    args = serve.arg_parser().parse_args(["--config", str(cfg_path), "--run_id", "1"])
    predictor, meta = serve.load_model(args)
    n = len(inputs[keys[0]])
    bodies = [json.dumps({k: inputs[k][i].tolist() for k in keys}).encode() for i in range(n)]
    say(f"{tag} {n} requests of {len(bodies[0]) / 1e3:.1f} KB of JSON each")

    def round_trip(url):
        """n concurrent /predict requests (16 clients); (answers, seconds)."""
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=16) as pool:
            answers = list(pool.map(lambda b: _post(url, b), bodies))
        return answers, time.perf_counter() - t0

    classes = path["classes"]

    def null_model(*arrays):  # the HTTP/JSON path's ceiling: no model at all
        rows = len(arrays[0])
        return {"logits": np.zeros((rows, classes), np.float32),
                "preds": np.zeros(rows, np.int64),
                "probs": np.full((rows, classes), 1.0 / classes, np.float32)}

    with serve.ServerThread(null_model, meta, max_batch=64, max_wait_ms=5.0) as st:
        _, null_cold = round_trip(f"{st.url}/predict")
        _, null_s = round_trip(f"{st.url}/predict")
    say(f"{tag} the same {n} requests to a server with no model: {null_cold:.3f} s "
        f"first round, {null_s:.3f} s second round ({n / null_s:.1f} requests/s, "
        f"host HTTP/JSON only)")

    reset_counts()
    with serve.ServerThread(predictor, meta, max_batch=64, max_wait_ms=5.0) as st:
        health = _get(f"{st.url}/health")
        got_meta = _get(f"{st.url}/meta")
        _, cold = round_trip(f"{st.url}/predict")  # first use of each batch bucket
        answers, seconds = round_trip(f"{st.url}/predict")
        batch_answer = _post(f"{st.url}/predict_batch", json.dumps(
            {k: inputs[k][:8].tolist() for k in keys}).encode())
        try:  # a request that lacks an input key is refused, not filled in
            _post(f"{st.url}/predict", json.dumps(
                {k: inputs[k][0].tolist() for k in keys[:-1]}).encode())
            refused = None
        except urllib.error.HTTPError as e:
            refused = e.code
            e.close()
        stats = _get(f"{st.url}/stats")
        launches = read_counts()[kernel]
    if health.get("status") != "ok" or got_meta["input_keys"] != keys:
        raise AssertionError(f"/health {health}, /meta {got_meta}")
    if refused != 400:
        raise AssertionError(f"a request without {keys[-1]!r} got {refused}, expected 400")
    say(f"{tag} {n} concurrent /predict (16 clients): {cold:.3f} s first round, "
        f"{seconds:.3f} s second round ({n / seconds:.1f} requests/s); /stats {stats}; "
        f"{kernel} launches while serving {launches}; request without {keys[-1]!r} → 400")
    # one launch per micro-batch, and one for /predict_batch
    if launches != stats["batches"] + 1:
        raise AssertionError(
            f"serve: {kernel} launched {launches} times for {stats['batches']} batches + 1")
    if stats["requests"] != 2 * n:
        raise AssertionError(f"/stats counted {stats['requests']} requests, sent {2 * n}")

    direct = predictor(**inputs)
    worst = 0.0
    for i, ans in enumerate(answers):
        diff = float(np.abs(np.asarray(ans["logits"]) - direct["logits"][i]).max())
        worst = max(worst, diff)
        top2 = np.sort(direct["logits"][i])[-2:]
        if top2[1] - top2[0] > 2 * SERVE_TOL and ans["preds"] != int(direct["preds"][i]):
            raise AssertionError(f"/predict row {i}: pred {ans['preds']} != "
                                 f"{int(direct['preds'][i])}")
    for i in range(8):
        diff = float(np.abs(np.asarray(batch_answer["logits"][i]) - direct["logits"][i]).max())
        worst = max(worst, diff)
    say(f"{tag} answers vs Predictor called directly: max |logit diff| = {worst:.3e} "
        f"(tolerance {SERVE_TOL})")
    if worst > SERVE_TOL:
        raise AssertionError(f"served logits differ from the Predictor by {worst}")
    return {"launches": launches, "requests_per_s": n / seconds,
            "null_requests_per_s": n / null_s}


def avmnist_requests() -> dict:
    """48 samples: a third with the image zeroed, a third with the audio."""
    from mmtpu_torch.data import SyntheticAVMNIST
    from mmtpu_torch.modalities import Modality

    ds = SyntheticAVMNIST(split="test", num_samples=48, seed=SEED + 1)
    audio = ds.arrays[Modality.AUDIO].copy()
    image = ds.arrays[Modality.IMAGE].copy()
    image[0::3] = 0.0
    audio[1::3] = 0.0
    return {"audio": audio, "image": image}


def mosi_requests() -> dict:
    """36 samples: a third with the text zeroed, a third with audio and
    video zeroed, a third whole."""
    from mmtpu_torch.data import SyntheticMOSI
    from mmtpu_torch.modalities import Modality

    ds = SyntheticMOSI(split="test", num_samples=36, seed=SEED + 1)
    audio = ds.arrays[Modality.AUDIO].copy()
    video = ds.arrays[Modality.VIDEO].copy()
    text = ds.arrays[Modality.TEXT].copy()
    text[0::3] = 0.0
    audio[1::3] = 0.0
    video[1::3] = 0.0
    return {"audio": audio, "video": video, "text": text}


# The training phase: the synthetic configs' widths, models and optimizers;
# only the sample counts are this run's (the files have 256/96/96 in batches of 64).
TRAIN_SAMPLES = {"train": 2048, "validation": 512, "test": 512}
TRAIN_BATCH = 128
TRAIN_EPOCHS = 2
TRAIN_LOSS_RTOL = 1e-4  # step 1, GPU (TF32 off) vs CPU
TRAIN_GRAD_TOL = 1e-3  # of a gradient's norm: float32 parameters above it are counted
TRAIN_GRAD64_TOL = 1e-6  # of a gradient's norm, GPU vs CPU in float64 (phase_train_check)
TRAIN_LATER_RTOL = 1e-3  # steps 2-3: Adam's first steps amplify rounding near g = 0
MONO_NAME = "Synthetic_AVMNIST_Audio_Encoder"
SCRATCH_NAME = "Synthetic_AVMNIST_Multimodal_Scratch"


def train_configs(out_root: str) -> dict:
    """Plain-dict twins of configs/avmnist/synthetic_mono_audio.yaml ("mono")
    and synthetic_multimodal_pretrained.yaml ("pretrained"; its handoff named
    by the `.ckpt` spelling the file uses), and the same fine-tune from
    scratch ("scratch"), with this run's sample counts and batch."""
    import copy

    multi = smoke_config(out_root=out_root)
    multi["model"]["pretrained_encoders"]["audio"] = (
        f"{out_root}/{MONO_NAME}/models/{{run_id}}/encoder_audio_best.ckpt")
    multi["training"]["epochs"] = TRAIN_EPOCHS
    for split, n in TRAIN_SAMPLES.items():
        multi["data"]["datasets"][split]["batch_size"] = TRAIN_BATCH
        multi["data"]["datasets"][split]["kwargs"]["num_samples"] = n

    mono = copy.deepcopy(multi)
    mono["experiment"]["name"] = MONO_NAME
    mono["model"] = {"name": MONO_NAME, "model_type": "AVMNIST",
                     "audio_encoder": multi["model"]["audio_encoder"],
                     "output_dim": 64, "num_classes": 10}
    training = mono["training"]
    training["num_modalities"] = 1
    del training["encoder_optimizer"], training["modality_specific_params"]
    for split in mono["data"]["datasets"].values():
        split["missing_patterns"]["selected_patterns"] = ["a"]
    del mono["metrics"]["metrics"]["ConfusionMatrix"]
    mono["metrics"]["groups"]["classification"] = ["accuracy", "f1_weighted"]

    scratch = copy.deepcopy(multi)
    scratch["experiment"]["name"] = scratch["model"]["name"] = SCRATCH_NAME
    del scratch["model"]["pretrained_encoders"]
    return {"mono": mono, "pretrained": multi, "scratch": scratch}


def say_card(card: str, msg: str) -> None:
    """A line with a measured number, beside the card's name and power limit."""
    say(f"{msg} [{card}]")


def _run_cli(module, cfg_path: Path, tag: str, out_root: Path, name: str,
             train_samples: int = TRAIN_SAMPLES["train"], extra=()) -> dict:
    """`module.main` on the card through its normal flags (and `extra`);
    what it wrote."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = module.main(["--config", str(cfg_path), "--run_id", "1", *extra])
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{tag}: exit code {rc}")
    metrics = out_root / name / "metrics" / "1"
    epochs = [e for e in json.loads((metrics / "epoch_metrics.json").read_text()) if "epoch" in e]
    # train_monomodal writes its train/validation records to report/, as mmtpu's does
    records = metrics if (metrics / "validation_metrics.json").exists() else metrics / "report"
    validation = json.loads((records / "validation_metrics.json").read_text())
    test = json.loads((metrics / "test_metrics.json").read_text())
    if len(epochs) != TRAIN_EPOCHS or len(validation) != TRAIN_EPOCHS or len(test) != 1:
        raise AssertionError(f"{tag}: {len(epochs)} epochs, {len(validation)} validation "
                             f"records, {len(test)} test records")
    losses = [(e["train"]["loss"], e["validation"]["loss"]) for e in epochs]
    if not all(np.isfinite(v) for pair in losses for v in pair):
        raise AssertionError(f"{tag}: losses {losses}")
    train_s = epochs[-1]["train"]["timing"]["total_time"]
    return {"seconds": seconds, "peak_bytes": torch.cuda.max_memory_allocated(),
            "losses": losses, "validation": validation, "test": test[0],
            "samples_per_s": train_samples / train_s, "epoch_s": train_s,
            "models": out_root / name / "models" / "1"}


def _eval_batches(counts: dict, batch: int = TRAIN_BATCH, patterns: int = 3) -> dict:
    """Eval batches per split: samples × patterns (ai/a/i) in batches."""
    return {s: -(-counts[s] * patterns // batch) for s in ("validation", "test")}


def _accuracies(record: dict) -> dict:
    return {k: round(v, 4) for k, v in record.items() if k.startswith("accuracy")}


def _train_batches(cfg_path: Path, n: int):
    from mmtpu_torch.cli import common

    cfg = common.load_config(argparse.Namespace(config=str(cfg_path), run_id=1, seed=None))
    loader = cfg.data.build_loader("train", seed=cfg.experiment.seed)
    it = iter(loader)
    return cfg, [next(it) for _ in range(n)]


def _training_setup(cfg, dev):
    """Model, state and train step as `train_multimodal` builds them (the
    model's `clip`, where it has one, as the global-norm clip; the run's
    generator for a model that draws; MM-IMDb's multilabel task)."""
    from mmtpu_torch.cli import common
    from mmtpu_torch.train.step import ClassificationTask, make_train_step

    model = common.init_model(common.build_model_from_config(cfg.model), SEED, dev)
    state = common.make_state(model, cfg.training, clip=cfg.model.kwargs.get("clip"))
    state.generator = common.use_run_generator(model, SEED, dev)
    task = ClassificationTask(
        model=model, loss_group=cfg.training.loss_functions,
        input_keys=[str(m) for m in common.modalities_for_model(cfg.model.model_type)],
        multilabel=cfg.model.model_type.lower() == "mmimdb")
    return model, state, make_train_step(task, state, dev)


def phase_train_profile(dev, card: str, cfg_path: Path, steps: int = 8,
                        tag: str = "[train profile]", batch: int = TRAIN_BATCH) -> dict:
    """A window of fine-tune train steps under the profiler: the device's
    busy share, its kernels per step and the operations that take its time."""
    import torch

    cfg, batches = _train_batches(cfg_path, 3 + steps)
    _, _, step = _training_setup(cfg, dev)
    for b in batches[:3]:  # warm-up: cuDNN plans, allocator
        step(b)
    torch.cuda.synchronize()
    brk = device_breakdown(lambda: [step(b) for b in batches[3:]], top=8)
    busy = brk["device_ms"] / brk["profiled_wall_ms"]
    say_card(card, f"{tag} {steps} train steps (B={batch}): device "
             f"busy {brk['device_ms']:.3f} ms of {brk['profiled_wall_ms']:.3f} ms wall, busy "
             f"share {busy:.3f}; {brk['kernel_events'] / steps:.1f} device kernels and "
             f"{brk['launch_calls'] / steps:.1f} launch calls per step; top device operations "
             f"(name, ms, count) {brk['top']}; top host operations by self CPU time (name, "
             f"ms, count) {brk['top_host']}")
    return {"busy_share": busy, "kernels_per_step": brk["kernel_events"] / steps,
            "device_ms_per_step": brk["device_ms"] / steps}


def _grad_errors(grads: dict, ref: dict) -> dict:
    """Per parameter: max |g - ref| / ‖ref‖."""
    return {n: (grads[n].double() - w.double()).abs().max().item() / max(w.norm().item(), 1e-30)
            for n, w in ref.items()}


def _whole_error(grads: dict, ref: dict) -> float:
    """‖g - ref‖ / ‖ref‖ over all parameters together."""
    import torch

    def flat(t):
        return torch.cat([t[n].double().reshape(-1) for n in sorted(t)])

    return ((flat(grads) - flat(ref)).norm() / flat(ref).norm()).item()


def _worst(errs: dict, k: int = 4) -> list:
    return [(n, float(f"{e:.3e}")) for n, e in sorted(errs.items(), key=lambda t: -t[1])[:k]]


def phase_train_check(dev, cfg_path: Path) -> dict:
    """The fine-tune's first three train steps from the same initial weights
    (dropout 0) on the card and on the CPU, then a step on a batch with a
    zero-padded tail from the CPU's weights on both (the pad-aware
    BatchNorm at full width): the losses in float32. The gradients of
    step 1 and of the padded step are compared in float64 on both devices:
    in float32 either device misses the exact gradient by a few 1e-3 of its
    norm (BatchNorm's backward subtracts nearly equal terms), which would
    hide a fault; in float64 the same code must agree to rounding."""
    import torch

    cfg, batches = _train_batches(cfg_path, 3)
    pad_rows = 28
    padded = {k: v.copy() for k, v in batches[2].items()}
    for k in ("audio", "image", "labels", "audio_mask", "image_mask", "sample_mask"):
        padded[k][TRAIN_BATCH - pad_rows:] = 0
    cfg.model.kwargs["dropout"] = 0.0
    cpu = torch.device("cpu")

    def grads_of(model):
        return {n: p.grad.detach().cpu() for n, p in model.named_parameters()}

    def float64_step(device, batch, weights=None):
        model, _, step = _training_setup(cfg, device)
        model.double()
        if weights is not None:
            model.load_state_dict(weights)
        with _float64_losses():
            step(_as_float64(batch))
        return grads_of(model)

    models, losses, grads32 = {}, {}, {}
    for label, device in (("gpu", dev), ("cpu", cpu)):
        model, _, step = _training_setup(cfg, device)
        losses[label] = []
        for b in batches:
            losses[label].append(float(step(b)["loss"]))
            grads32.setdefault(label, grads_of(model))
        models[label] = (model, step)
    weights = models["cpu"][0].state_dict()  # after step 3
    models["gpu"][0].load_state_dict(weights)
    pad_loss = {label: float(step(padded)["loss"]) for label, (_, step) in models.items()}
    grads64 = {label: (float64_step(device, batches[0]), float64_step(device, padded, weights))
               for label, device in (("gpu", dev), ("cpu", cpu))}

    rel = [abs(a - b) / abs(b) for a, b in zip(losses["gpu"], losses["cpu"])]
    pad_rel = abs(pad_loss["gpu"] - pad_loss["cpu"]) / abs(pad_loss["cpu"])
    say(f"[train check] float32 losses of steps 1-3, GPU {losses['gpu']}, CPU {losses['cpu']}: "
        f"relative differences {rel} (tolerances {TRAIN_LOSS_RTOL}, then {TRAIN_LATER_RTOL}); "
        f"padded tail of {pad_rows} rows, one step from the same weights: GPU "
        f"{pad_loss['gpu']}, CPU {pad_loss['cpu']} (relative {pad_rel:.3e}, tolerance "
        f"{TRAIN_LOSS_RTOL}); TF32 off")
    err32 = _grad_errors(grads32["gpu"], grads32["cpu"])
    exact = grads64["cpu"][0]
    say(f"[train check] step-1 float32 gradients, {len(err32)} parameters: GPU vs CPU worst "
        f"parameter {max(err32.values()):.3e} of its norm "
        f"({sum(e > TRAIN_GRAD_TOL for e in err32.values())} above {TRAIN_GRAD_TOL}), worst "
        f"{_worst(err32)}; whole gradient against the CPU's float64 step: GPU "
        f"{_whole_error(grads32['gpu'], exact):.3e}, CPU {_whole_error(grads32['cpu'], exact):.3e}")
    worst = 0.0
    for i, tag in enumerate(("step 1", "padded step")):
        err64 = _grad_errors(grads64["gpu"][i], grads64["cpu"][i])
        worst = max(worst, max(err64.values()))
        say(f"[train check] {tag} float64 gradients, GPU vs CPU: worst parameter "
            f"{max(err64.values()):.3e} of its norm (tolerance {TRAIN_GRAD64_TOL}), whole "
            f"gradient {_whole_error(grads64['gpu'][i], grads64['cpu'][i]):.3e}; worst "
            f"{_worst(err64)}")
    if rel[0] > TRAIN_LOSS_RTOL or pad_rel > TRAIN_LOSS_RTOL or max(rel[1:]) > TRAIN_LATER_RTOL:
        raise AssertionError(f"train check: GPU and CPU losses differ: {rel}, padded {pad_rel}")
    if worst > TRAIN_GRAD64_TOL:
        raise AssertionError(f"train check: float64 gradients differ by {worst} of their norm")
    return {"loss_rel": rel, "pad_loss_rel": pad_rel, "grad64_err": worst}


@contextlib.contextmanager
def _float64_losses():
    """The criteria cast their inputs to float32, as mmtpu's do; the float64
    reference step keeps float64 through the loss."""
    import torch

    from mmtpu_torch.train import losses

    cast = losses._as_float
    losses._as_float = lambda x: torch.as_tensor(x).double()
    try:
        yield
    finally:
        losses._as_float = cast


def _as_float64(batch: dict) -> dict:
    return {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in batch.items()}


def phase_train(dev, card: str, work: Path) -> dict:
    """Monomodal audio pretraining, the pretrained fine-tune and the same
    fine-tune from scratch, each through its entry point's `main` on the
    card; then a profiled window of train steps and the GPU-vs-CPU check."""
    import torch

    from mmtpu_torch.cli import common, train_monomodal, train_multimodal

    out_root = work / "train"
    paths = {}
    for key, cfg in train_configs(str(out_root)).items():
        paths[key] = work / f"train_{key}.json"
        paths[key].write_text(json.dumps(cfg))

    mono = _run_cli(train_monomodal, paths["mono"], "[train mono]", out_root, MONO_NAME)
    handoff = mono["models"] / "encoder_audio_best.pth"
    if not handoff.exists():
        raise AssertionError(f"train_monomodal wrote no handoff {handoff}")

    loaded = []
    real_load = common.load_pretrained_encoders

    def spy(model, pretrained, logging_cfg):  # the fine-tune's audio encoder as loaded
        out = real_load(model, pretrained, logging_cfg)
        loaded.append({k: v.detach().cpu().clone()
                       for k, v in model.audio_encoder.state_dict().items()})
        return out

    common.load_pretrained_encoders = spy
    try:
        reset_counts()
        pre = _run_cli(train_multimodal, paths["pretrained"], "[train pretrained]", out_root,
                       "Synthetic_AVMNIST_Multimodal_Pretrained")
        launches = read_counts()["fused_mlp"]
        scratch = _run_cli(train_multimodal, paths["scratch"], "[train scratch]", out_root,
                           SCRATCH_NAME)
    finally:
        common.load_pretrained_encoders = real_load

    want = torch.load(handoff, map_location="cpu", weights_only=True)
    if len(loaded) != 2 or set(loaded[0]) != set(want) or not all(
            torch.equal(loaded[0][k], v) for k, v in want.items()):
        raise AssertionError("the fine-tune's audio encoder is not the handoff file's")
    if loaded[1] and all(torch.equal(loaded[1][k], v) for k, v in want.items()):
        raise AssertionError("the scratch fine-tune loaded the handoff")
    per_split = _eval_batches(TRAIN_SAMPLES, TRAIN_BATCH)
    expected = TRAIN_EPOCHS * per_split["validation"] + per_split["test"]
    say(f"[train pretrained] the audio encoder at epoch 0 equals {handoff.name} "
        f"({len(want)} tensors, statistics included)")
    if launches != expected:
        raise AssertionError(f"fused_mlp launched {launches} times in the fine-tune, expected "
                             f"{TRAIN_EPOCHS} × {per_split['validation']} validation + "
                             f"{per_split['test']} test batches = {expected}")
    for tag, run in (("mono", mono), ("pretrained", pre), ("scratch", scratch)):
        say_card(card, f"[train {tag}] {run['seconds']:.2f} s through main (start-up, data "
                 f"and checkpoints included); epoch {TRAIN_EPOCHS} train {run['epoch_s']:.3f} s "
                 f"= {run['samples_per_s']:.1f} samples/s (B={TRAIN_BATCH}); peak device "
                 f"memory {run['peak_bytes'] / 2**20:.1f} MiB (max_memory_allocated)")
        for epoch, ((tr, va), rec) in enumerate(zip(run["losses"], run["validation"]), 1):
            say(f"[train {tag}] epoch {epoch}: train loss {tr:.6f}, validation loss {va:.6f}, "
                f"validation accuracy {_accuracies(rec)}")
        say(f"[train {tag}] test {_accuracies(run['test'])}, loss {run['test']['loss']:.6f}")
    say(f"[train pretrained] fused_mlp launches in the fine-tune: {launches} = "
        f"{TRAIN_EPOCHS} × {per_split['validation']} validation + {per_split['test']} test "
        f"batches (none in a train forward)")
    say(f"[train] first-epoch train loss, pretrained vs scratch: "
        f"{pre['losses'][0][0]:.6f} vs {scratch['losses'][0][0]:.6f} (synthetic data; "
        f"no threshold)")

    profile = phase_train_profile(dev, card, paths["pretrained"])
    check = phase_train_check(dev, paths["pretrained"])
    return {"launches": launches, "mono": mono, "pretrained": pre, "scratch": scratch,
            "profile": profile, "check": check, "handoff": handoff}


# The UttFusion training phase: the published widths (mosi_smoke_config) on
# synthetic_mosi at CMU-MOSI's split sizes, the file's batch, epochs, train
# pattern and missing rates.
UTT_SAMPLES = {"train": 1284, "validation": 229, "test": 686}
UTT_BATCH = 32
UTT_PATTERNS = 7  # validation and test: every pattern over {a, t, v}
UTT_NAME = "Synthetic_MOSI_UttFusion"
UTT_LOSS_RTOL = 1e-5  # step 1 and the padded step, GPU (TF32 off) vs CPU
UTT_GRAD_TOL = 1e-4  # of each parameter's gradient norm, step 1, float32


def utt_train_config(out_root: str, dropout: bool = True) -> dict:
    """configs/mosi/synthetic_utt_fusion.yaml at the published widths and
    CMU-MOSI's split sizes; `dropout=False` sets TextCNN's and
    FcClassifier's dropout to 0 (the GPU-vs-CPU check)."""
    cfg = mosi_smoke_config(num_samples=UTT_SAMPLES["test"], batch_size=UTT_BATCH,
                            out_root=out_root, train_samples=UTT_SAMPLES["train"],
                            validation_samples=UTT_SAMPLES["validation"])
    cfg["training"]["epochs"] = TRAIN_EPOCHS
    if not dropout:
        for net in ("netT", "netC"):
            cfg["model"][net]["dropout"] = 0.0
    return cfg


def utt_expected_launches() -> dict:
    """`lstm` launches of the run: one per train, validation and test batch
    as the loader forms them (train one pattern, the others seven)."""
    train = -(-UTT_SAMPLES["train"] // UTT_BATCH)
    per = {s: -(-UTT_SAMPLES[s] * UTT_PATTERNS // UTT_BATCH) for s in ("validation", "test")}
    return {"train": train, **per,
            "total": TRAIN_EPOCHS * (train + per["validation"]) + per["test"]}


@contextlib.contextmanager
def _clip_norms(norms: list):
    """Record the global gradient norm each train step clips (before the
    clip), as the step computes it."""
    import torch

    from mmtpu_torch.train import step as step_mod

    real = step_mod.clip_by_global_norm

    def spy(params, max_norm):
        params = list(params)
        norms.append(torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(p.grad) for p in params if p.grad is not None])).item())
        return real(params, max_norm)

    step_mod.clip_by_global_norm = spy
    try:
        yield
    finally:
        step_mod.clip_by_global_norm = real


def phase_train_utt_profile(dev, card: str, cfg_path: Path, steps: int = 8) -> dict:
    """A window of UttFusion train steps under the profiler: launches per
    step, the device's busy share, and the `lstm` launches (one per step)."""
    import torch

    cfg, batches = _train_batches(cfg_path, 3 + steps)
    _, _, step = _training_setup(cfg, dev)
    for b in batches[:3]:
        step(b)
    torch.cuda.synchronize()
    reset_counts()
    brk = device_breakdown(lambda: [step(b) for b in batches[3:]], top=8)
    counts = read_counts()
    busy = brk["device_ms"] / brk["profiled_wall_ms"]
    say_card(card, f"[train utt profile] {steps} UttFusion train steps (B={UTT_BATCH}, T=50): "
             f"{brk['kernel_events'] / steps:.1f} device kernels and "
             f"{brk['launch_calls'] / steps:.1f} host launch calls per step; device busy "
             f"{brk['device_ms']:.3f} ms of "
             f"{brk['profiled_wall_ms']:.3f} ms wall, busy share {busy:.3f}; lstm launches "
             f"{counts['lstm']} (device time {brk['own_ms']['lstm']:.4f} ms, "
             f"{brk['own_calls']['lstm']} recorded); top device operations (name, ms, count) "
             f"{brk['top']}; top host operations by self CPU time (name, ms, count) "
             f"{brk['top_host']}")
    if counts["lstm"] != steps:
        raise AssertionError(f"lstm launched {counts['lstm']} times in {steps} train steps")
    return {"busy_share": busy, "kernels_per_step": brk["kernel_events"] / steps,
            "launch_calls_per_step": brk["launch_calls"] / steps}


def phase_train_utt_check(dev, cfg_path: Path) -> dict:
    """UttFusion's first three train steps from the same initial weights
    (dropout 0, TF32 off) on the card and on the CPU, where `clip` scales
    the gradients, then the epoch's padded tail (4 real rows of 32) from the
    CPU's weights after step 3 on both: losses, and the step-1 gradients of
    every parameter against its norm in float32 (no BatchNorm on this path;
    the kernel takes float32 only). Both devices' float32 gradients are also
    set against a float64 step on the CPU (plain scan)."""
    import torch

    cfg, batches = _train_batches(cfg_path, 3)
    loader = cfg.data.build_loader("train", seed=cfg.experiment.seed)
    padded = list(loader)[-1]
    real_rows = int(padded["sample_mask"].sum())
    if real_rows != UTT_SAMPLES["train"] % UTT_BATCH:
        raise AssertionError(f"the train split's last batch holds {real_rows} real rows")
    cpu = torch.device("cpu")
    clip = float(cfg.model.kwargs["clip"])

    def grads_of(model):
        return {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}

    models, losses, grads32, norms = {}, {}, {}, {}
    for label, device in (("gpu", dev), ("cpu", cpu)):
        norms[label] = []
        with _clip_norms(norms[label]):
            model, _, step = _training_setup(cfg, device)
            losses[label] = []
            for b in batches:
                losses[label].append(float(step(b)["loss"]))
                grads32.setdefault(label, grads_of(model))
            models[label] = (model, step)
    weights = models["cpu"][0].state_dict()  # after step 3
    models["gpu"][0].load_state_dict(weights)
    pad_loss, pad_grads = {}, {}
    for label, (model, step) in models.items():
        pad_loss[label] = float(step(padded)["loss"])
        pad_grads[label] = grads_of(model)

    model64, _, step64 = _training_setup(cfg, cpu)
    model64.double()
    with _float64_losses():
        loss64 = float(step64(_as_float64(batches[0]))["loss"])
    exact = grads_of(model64)

    rel = [abs(a - b) / abs(b) for a, b in zip(losses["gpu"], losses["cpu"])]
    pad_rel = abs(pad_loss["gpu"] - pad_loss["cpu"]) / abs(pad_loss["cpu"])
    say(f"[train utt check] float32 losses of steps 1-3, GPU {losses['gpu']}, CPU "
        f"{losses['cpu']}: relative differences {rel} (tolerances {UTT_LOSS_RTOL}, then "
        f"{TRAIN_LATER_RTOL}); float64 CPU step 1 {loss64}; global gradient norms before the "
        f"clip {clip}: GPU {norms['gpu'][:3]}, CPU {norms['cpu'][:3]}; padded tail of "
        f"{UTT_BATCH - real_rows} rows, one step from the same weights: GPU {pad_loss['gpu']}, "
        f"CPU {pad_loss['cpu']} (relative {pad_rel:.3e}, tolerance {UTT_LOSS_RTOL}); TF32 off")
    err32 = _grad_errors(grads32["gpu"], grads32["cpu"])
    pad_err = _grad_errors(pad_grads["gpu"], pad_grads["cpu"])
    against64 = {label: _grad_errors(grads32[label], exact) for label in ("gpu", "cpu")}
    say(f"[train utt check] step-1 float32 gradients after the clip, {len(err32)} parameters: "
        f"GPU vs CPU worst parameter {max(err32.values()):.3e} of its norm (tolerance "
        f"{UTT_GRAD_TOL}; {sum(e > UTT_GRAD_TOL for e in err32.values())} above), whole "
        f"gradient {_whole_error(grads32['gpu'], grads32['cpu']):.3e}, worst {_worst(err32)}; "
        f"against the CPU's float64 step: GPU worst parameter "
        f"{max(against64['gpu'].values()):.3e}, whole {_whole_error(grads32['gpu'], exact):.3e}"
        f"; CPU worst parameter {max(against64['cpu'].values()):.3e}, whole "
        f"{_whole_error(grads32['cpu'], exact):.3e}; padded step GPU vs CPU worst parameter "
        f"{max(pad_err.values()):.3e}, worst {_worst(pad_err)}")
    if not (norms["gpu"][0] > clip and norms["cpu"][0] > clip):
        raise AssertionError(f"step 1's gradient norms {norms['gpu'][0]}, {norms['cpu'][0]} do "
                             f"not exceed clip {clip}: the check would not exercise it")
    if rel[0] > UTT_LOSS_RTOL or pad_rel > UTT_LOSS_RTOL or max(rel[1:]) > TRAIN_LATER_RTOL:
        raise AssertionError(f"train utt check: GPU and CPU losses differ: {rel}, padded "
                             f"{pad_rel}")
    if max(err32.values()) > UTT_GRAD_TOL:
        raise AssertionError(f"train utt check: step-1 gradients differ by "
                             f"{max(err32.values())} of their norm ({_worst(err32)})")
    return {"loss_rel": rel, "pad_loss_rel": pad_rel, "grad_err": max(err32.values()),
            "pad_grad_err": max(pad_err.values()), "norm": norms["gpu"][0]}


def phase_train_utt(dev, card: str, work: Path) -> dict:
    """UttFusion training through `train_multimodal.main` on the card: the
    `lstm` kernel in every train and eval forward (counted against the
    loader's batches), the MSA keys of test_metrics.json, then a profiled
    window of train steps and the GPU-vs-CPU check."""
    from mmtpu_torch.cli import train_multimodal

    out_root = work / "train_utt"
    cfg_path = work / "train_utt.json"
    cfg_path.write_text(json.dumps(utt_train_config(str(out_root))))
    expected = utt_expected_launches()
    reset_counts()
    run = _run_cli(train_multimodal, cfg_path, "[train utt]", out_root, UTT_NAME,
                   train_samples=UTT_SAMPLES["train"])
    counts = read_counts()
    if counts["lstm"] != expected["total"] or counts["fused_mlp"]:
        raise AssertionError(
            f"UttFusion training launched {counts}; expected lstm {TRAIN_EPOCHS} × "
            f"({expected['train']} train + {expected['validation']} validation) + "
            f"{expected['test']} test batches = {expected['total']} and no fused_mlp")
    msa_keys = sorted(k for k in run["test"] if k.startswith("MSA_"))
    bad = [k for k in msa_keys if not np.isfinite(run["test"][k])]
    if len(msa_keys) != 20 * UTT_PATTERNS or bad:
        raise AssertionError(f"test_metrics.json: {len(msa_keys)} MSA keys, not finite {bad}")
    epochs = json.loads((out_root / UTT_NAME / "metrics/1/epoch_metrics.json").read_text())
    if "weighted" not in epochs[0]["validation"]:
        raise AssertionError("epoch_metrics.json: the MSA keys are not nested as mmtpu nests them")
    models = sorted(p.name for p in run["models"].iterdir())
    if not {"best.pth", "last.pth", "epoch_1.pth"} <= set(models):
        raise AssertionError(f"UttFusion run wrote {models}")
    say_card(card, f"[train utt] {run['seconds']:.2f} s through main (start-up, data and "
             f"checkpoints included); epoch {TRAIN_EPOCHS} train {run['epoch_s']:.3f} s = "
             f"{run['samples_per_s']:.1f} samples/s (B={UTT_BATCH}, T=50, "
             f"{UTT_SAMPLES['train']} samples); peak device memory "
             f"{run['peak_bytes'] / 2**20:.1f} MiB (max_memory_allocated)")
    say(f"[train utt] lstm launches {counts['lstm']} = {TRAIN_EPOCHS} × ({expected['train']} "
        f"train + {expected['validation']} validation) + {expected['test']} test batches; "
        f"fused_mlp {counts['fused_mlp']}; checkpoints {models}")
    for epoch, ((tr, va), rec) in enumerate(zip(run["losses"], run["validation"]), 1):
        say(f"[train utt] epoch {epoch}: train loss {tr:.6f}, validation loss {va:.6f}, "
            f"validation accuracy {_accuracies(rec)}")
    say(f"[train utt] test_metrics.json: {len(msa_keys)} MSA keys ({msa_keys[:3]} …); ATV "
        f"{ {k: run['test'][k] for k in msa_keys if k.endswith('_ATV')} }; test accuracy "
        f"{_accuracies(run['test'])}")
    profile = phase_train_utt_profile(dev, card, cfg_path)
    check_path = work / "train_utt_check.json"
    check_path.write_text(json.dumps(utt_train_config(str(out_root), dropout=False)))
    check = phase_train_utt_check(dev, check_path)
    return {"launches": counts["lstm"], "run": run, "profile": profile, "check": check}


# The reader phase: the paper's own fine-tune configs
# (configs/avmnist/multimodal_resnet_{pretrained,scratch}.yaml) fed by the
# real AVMNIST reader from `.pt` files this run writes at the train phase's
# sample counts; the cross-validation and --stacked-runs drivers on the
# scratch twin.
PAPER_NAMES = {"pretrained": "AVMNIST_Resnet_Pretrained", "scratch": "AVMNIST_Resnet_Scratch"}
READER_SPLITS = ("train", "validation", "test")
SWEEP_SAMPLES = {"train": 512, "validation": 128, "test": 128}
SPEC_SHAPES = ((32, 94), (32, 100), (28, 94), (36, 120))  # by sample index mod 4


def paper_configs(out_root: str, csvs: dict, handoff: Path) -> dict:
    """Plain-dict twins of multimodal_resnet_pretrained.yaml and
    multimodal_resnet_scratch.yaml: ResNet18 audio (hidden 64), ResNet34
    image (hidden 128), head 192→128→64→10 with dropout 0.5, Adam 5e-4 with
    L2 1e-4 (the pretrained file's encoder groups at 1e-4, L2 2e-4), the
    plateau scheduler, early stopping after 10, batch 128, the files'
    metrics. This run's: the CSVs, the audio handoff (the train phase's
    monomodal run; no image handoff), a TensorBoard path, the output root."""
    import copy

    patterns = {"modalities": {"audio": {"missing_rate": 0.0},
                               "image": {"missing_rate": 0.0}}}

    def split(name, selected, **extra):
        return {"dataset": "AVMNIST", "data_fp": str(csvs[name]),
                "split": {"validation": "valid"}.get(name, name),
                "target_modality": "MULTIMODAL", "batch_size": 128, **extra,
                "missing_patterns": {**patterns, "selected_patterns": selected}}

    metric_names = ("accuracy", "balanced_accuracy", "f1_macro", "f1_weighted",
                    "ConfusionMatrix")
    pretrained = {
        "experiment": {"name": PAPER_NAMES["pretrained"], "seed": SEED, "device": "tpu",
                       "is_train": True, "is_test": True},
        "model": {
            "name": "AVMNIST_Resnet", "model_type": "AVMNIST",
            "audio_encoder": {"__module_spec__": "resnet18", "in_channels": 1,
                              "hidden_dim": 64},
            "image_encoder": {"__module_spec__": "resnet34", "in_channels": 1,
                              "hidden_dim": 128},
            "hidden_dim": 128, "dropout": 0.5, "fusion_fn": "concat",
            "pretrained_encoders": {"audio": str(handoff)},
        },
        "training": {
            "epochs": 20, "early_stopping": True, "early_stopping_patience": 10,
            "num_modalities": 2,
            "optimizer": {"name": "Adam",
                          "default_kwargs": {"lr": 0.0005, "weight_decay": 0.0001}},
            "encoder_optimizer": {"name": "Adam",
                                  "default_kwargs": {"lr": 0.0001, "weight_decay": 0.0001}},
            "modality_specific_params": {
                "audio_encoder": {"lr": 0.0001, "weight_decay": 0.0002},
                "image_encoder": {"lr": 0.0001, "weight_decay": 0.0002},
            },
            "scheduler": "plateau",
            "scheduler_kwargs": {"mode": "min", "factor": 0.5, "patience": 5,
                                 "min_lr": 0.00001},
            "loss_functions": {"cross_entropy": {"loss_name": "cross_entropy",
                                                 "loss_args": {}, "weight": 1.0}},
        },
        "data": {"datasets": {
            "train": split("train", ["ai"], shuffle=True),
            "validation": split("validation", ["ai", "a", "i"]),
            "test": split("test", ["ai", "a", "i"]),
        }},
        "metrics": {
            "metrics": {
                "accuracy": {"function": "sklearn.metrics.accuracy_score", "kwargs": {}},
                "balanced_accuracy": {"function": "sklearn.metrics.balanced_accuracy_score",
                                      "kwargs": {}},
                "f1_macro": {"function": "sklearn.metrics.f1_score",
                             "kwargs": {"average": "macro", "zero_division": 0}},
                "f1_weighted": {"function": "sklearn.metrics.f1_score",
                                "kwargs": {"average": "weighted", "zero_division": 0}},
                "ConfusionMatrix": {"function": "sklearn.metrics.confusion_matrix",
                                    "kwargs": {"labels": list(range(10))}},
            },
            "groups": {"classification": list(metric_names)},
        },
        "logging": {
            "log_path": f"{out_root}/{{experiment_name}}/logs/{{run_id}}",
            "model_output_path": f"{out_root}/{{experiment_name}}/models/{{run_id}}",
            "metrics_path": f"{out_root}/{{experiment_name}}/metrics/{{run_id}}",
            "tensorboard_path": f"{out_root}/{{experiment_name}}/tensorboard/{{run_id}}",
            "save_metric": "loss",
        },
        "monitoring": {"enabled": False},
    }
    scratch = copy.deepcopy(pretrained)
    scratch["experiment"]["name"] = PAPER_NAMES["scratch"]
    del scratch["model"]["pretrained_encoders"]
    del scratch["training"]["encoder_optimizer"], scratch["training"]["modality_specific_params"]
    return {"pretrained": pretrained, "scratch": scratch}


def write_avmnist_files(root: Path, counts: dict, seed: int = SEED) -> dict:
    """One float32 spectrogram `.pt` (shapes by index: SPEC_SHAPES, so the
    reader crops and pads) and one uint8 (28, 28) image `.pt` per sample,
    both depending on the class, and one CSV per split (audio, image,
    label). Returns the CSV paths and, per split, the arrays the files
    define once the reader has cropped, padded and mapped them."""
    import torch

    from mmtpu_torch.data.avmnist import AUDIO_SHAPE, GIST_EARTH_LUMA, IMAGE_SHAPE

    rng = np.random.default_rng(seed)
    csvs, want = {}, {}
    for name in READER_SPLITS:
        n = counts[name]
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        labels = rng.integers(0, 10, size=n).astype(np.int64)
        audio = np.zeros((n, *AUDIO_SHAPE), np.float32)
        image = np.zeros((n, *IMAGE_SHAPE, 1), np.float32)
        rows = []
        for i, label in enumerate(labels):
            h, w = SPEC_SHAPES[i % len(SPEC_SHAPES)]
            spec = (rng.normal(size=(h, w)) + 0.3 * label).astype(np.float32)
            img = np.clip(rng.normal(20.0 * label + 30.0, 40.0, size=IMAGE_SHAPE),
                          0, 255).astype(np.uint8)
            sp, ip = d / f"spec_{i}.pt", d / f"img_{i}.pt"
            torch.save(torch.from_numpy(spec), sp)
            torch.save(img, ip)
            rows.append(f"{sp},{ip},{label}")
            hh, ww = min(h, AUDIO_SHAPE[0]), min(w, AUDIO_SHAPE[1])
            audio[i, :hh, :ww] = spec[:hh, :ww]
            image[i, :, :, 0] = GIST_EARTH_LUMA[img].astype(np.float32) / 255.0
        csvs[name] = root / f"{name}.csv"
        csvs[name].write_text("audio,image,label\n" + "\n".join(rows) + "\n")
        want[name] = (audio, image, labels)
    return {"csvs": csvs, "want": want}


def phase_reader_build(card: str, data: dict) -> dict:
    """Each split through the reader twice: first from the `.pt` files (the
    `.npy` sidecars written), then from the sidecars, both read in full;
    the arrays byte for byte against what the files define."""
    from mmtpu_torch.data import AVMNIST
    from mmtpu_torch.modalities import Modality

    times = {"files": 0.0, "sidecars": 0.0}
    for name in READER_SPLITS:
        for source in times:
            t0 = time.perf_counter()
            ds = AVMNIST(data["csvs"][name], {"validation": "valid"}.get(name, name))
            got = (np.array(ds.arrays[Modality.AUDIO]), np.array(ds.arrays[Modality.IMAGE]),
                   np.array(ds.labels))
            times[source] += time.perf_counter() - t0
            mapped = isinstance(ds.arrays[Modality.AUDIO], np.memmap)
            if source == "sidecars" and not mapped:
                raise AssertionError(f"[reader] {name}: not served from the .npy sidecars")
            for g, w, what in zip(got, data["want"][name], ("audio", "image", "labels")):
                if g.dtype != w.dtype or g.shape != w.shape or g.tobytes() != w.tobytes():
                    raise AssertionError(f"[reader] {name} {what} ({source}): not the bytes "
                                         f"the files define")
    n = sum(len(w[2]) for w in data["want"].values())
    sidecars = sorted(p.name for p in data["csvs"]["train"].parent.glob("train.*.npy"))
    say_card(card, f"[reader] {n} samples ({2 * n} .pt files): arrays from the files "
             f"{times['files']:.3f} s, from the .npy sidecars {times['sidecars']:.3f} s; "
             f"equal byte for byte to what the files define; sidecars {sidecars}")
    return {"files_s": times["files"], "sidecars_s": times["sidecars"], "samples": n}


def phase_train_reader(dev, card: str, work: Path, handoff: Path) -> dict:
    """The paper's pretrained fine-tune fed by the reader (train_avmnist,
    --epochs 2, --profile, TensorBoard on), the scratch twin as a two-fold
    cross-validation (train_multimodal), and the scratch twin as a
    --stacked-runs 2 sweep at SWEEP_SAMPLES; `fused_mlp` counted in each."""
    from mmtpu_torch.cli import common, train_avmnist, train_multimodal

    out_root = work / "reader"
    data = write_avmnist_files(work / "avmnist_data", TRAIN_SAMPLES)
    build = phase_reader_build(card, data)
    cfgs = paper_configs(str(out_root), data["csvs"], handoff)
    paths = {}
    for key, cfg in cfgs.items():
        paths[key] = work / f"paper_{key}.json"
        paths[key].write_text(json.dumps(cfg))
    per_split = _eval_batches(TRAIN_SAMPLES)
    one_run = TRAIN_EPOCHS * per_split["validation"] + per_split["test"]

    reset_counts()
    run = _run_cli(train_avmnist, paths["pretrained"], "[reader fine-tune]", out_root,
                   PAPER_NAMES["pretrained"], extra=("--epochs", str(TRAIN_EPOCHS), "--profile"))
    fine_tune = read_counts()["fused_mlp"]
    if fine_tune != one_run:
        raise AssertionError(f"[reader fine-tune] fused_mlp launched {fine_tune} times, expected "
                             f"{TRAIN_EPOCHS} × {per_split['validation']} validation + "
                             f"{per_split['test']} test batches = {one_run}")
    base = out_root / PAPER_NAMES["pretrained"]
    events = list((base / "tensorboard/1").glob("events.out.tfevents.*"))
    trace = base / "logs/1/profile/trace.json"
    if len(events) != 1 or events[0].stat().st_size == 0:
        raise AssertionError(f"[reader fine-tune] tfevents files {events}")
    if not trace.exists() or trace.stat().st_size == 0:
        raise AssertionError(f"[reader fine-tune] no profiler trace at {trace}")
    if not (base / "metrics/1/1/epoch_metrics.json").exists():
        raise AssertionError("[reader fine-tune] train_avmnist wrote no test entry under 1/")
    say_card(card, f"[reader fine-tune] {run['seconds']:.2f} s through main (under --profile; "
             f"start-up, data and checkpoints included); epoch {TRAIN_EPOCHS} train "
             f"{run['epoch_s']:.3f} s = {run['samples_per_s']:.1f} samples/s (B=128, "
             f"{TRAIN_SAMPLES['train']} samples, ResNet18/ResNet34 full width)")
    say(f"[reader fine-tune] fused_mlp launches {fine_tune} = {TRAIN_EPOCHS} × "
        f"{per_split['validation']} validation + {per_split['test']} test batches; tfevents "
        f"{events[0].stat().st_size} bytes; profiler trace {trace.stat().st_size} bytes; "
        f"losses {run['losses']}; test {_accuracies(run['test'])}")

    cv_cfg = dict(cfgs["scratch"])
    cv_cfg["experiment"] = {**cv_cfg["experiment"], "cross_validation": 2}
    paths["cv"] = work / "paper_scratch_cv.json"
    paths["cv"].write_text(json.dumps(cv_cfg))
    reset_counts()
    t0 = time.perf_counter()
    if train_multimodal.main(["--config", str(paths["cv"]), "--run_id", "1",
                              "--epochs", str(TRAIN_EPOCHS)]) != 0:
        raise AssertionError("[reader cv] non-zero exit")
    cv_s = time.perf_counter() - t0
    cv_launches = read_counts()["fused_mlp"]
    metrics = out_root / PAPER_NAMES["scratch"] / "metrics/1"
    agg = {s: json.loads((metrics / f"{s}_metrics_agg.json").read_text())
           for s in READER_SPLITS}
    folds = sorted(p.name for p in metrics.iterdir() if p.is_dir())
    if folds != ["fold_1", "fold_2"] or [len(agg[s]) for s in READER_SPLITS] != [2, 2, 1]:
        raise AssertionError(f"[reader cv] fold dirs {folds}, aggregate lengths "
                             f"{[len(agg[s]) for s in READER_SPLITS]}")
    if not all(np.isfinite(v) for rec in agg["validation"] for v in rec.values()):
        raise AssertionError(f"[reader cv] validation aggregate {agg['validation']}")
    if cv_launches != 2 * one_run:
        raise AssertionError(f"[reader cv] fused_mlp launched {cv_launches} times, expected "
                             f"2 folds × {one_run} = {2 * one_run}")
    say_card(card, f"[reader cv] 2 folds through train_multimodal.main in {cv_s:.2f} s; "
             f"{folds}; fused_mlp launches {cv_launches} = 2 × {one_run}; test aggregate "
             f"{_accuracies(agg['test'][0])}")

    sweep_data = write_avmnist_files(work / "avmnist_sweep", SWEEP_SAMPLES, seed=SEED + 1)
    sweep_cfg = paper_configs(str(out_root / "sweep"), sweep_data["csvs"], handoff)["scratch"]
    paths["sweep"] = work / "paper_scratch_sweep.json"
    paths["sweep"].write_text(json.dumps(sweep_cfg))
    sweep_batches = _eval_batches(SWEEP_SAMPLES)
    member = TRAIN_EPOCHS * sweep_batches["validation"] + sweep_batches["test"]
    seeds = []
    real_init = common.init_model

    def spy(model, seed, device):
        seeds.append(int(seed))
        return real_init(model, seed, device)

    common.init_model = spy
    reset_counts()
    t0 = time.perf_counter()
    try:
        rc = train_multimodal.main(["--config", str(paths["sweep"]), "--run_id", "1",
                                    "--epochs", str(TRAIN_EPOCHS), "--stacked-runs", "2"])
    finally:
        common.init_model = real_init
    sweep_s = time.perf_counter() - t0
    sweep_launches = read_counts()["fused_mlp"]
    base = out_root / "sweep" / PAPER_NAMES["scratch"]
    trees = {r: sorted(p.name for p in (base / "metrics" / r).iterdir()) for r in ("1", "2")}
    if rc != 0 or seeds != [SEED, SEED + 1] or trees["1"] != trees["2"] or \
            "test_metrics.json" not in trees["2"] or not (base / "models/2/best.pth").exists():
        raise AssertionError(f"[reader sweep] rc {rc}, seeds {seeds}, trees {trees}")
    if sweep_launches != 2 * member:
        raise AssertionError(f"[reader sweep] fused_mlp launched {sweep_launches} times, "
                             f"expected 2 members × ({TRAIN_EPOCHS} × "
                             f"{sweep_batches['validation']} + {sweep_batches['test']}) = "
                             f"{2 * member}")
    say_card(card, f"[reader sweep] --stacked-runs 2 at {SWEEP_SAMPLES} in {sweep_s:.2f} s; "
             f"members run 1 and 2 seeded {seeds}; outputs {trees['2']}; fused_mlp launches "
             f"{sweep_launches} = 2 × {member}")
    return {"csvs": data["csvs"], "build": build, "run": run, "launches": fine_tune,
            "cv_launches": cv_launches,
            "sweep_launches": sweep_launches, "cv_s": cv_s, "sweep_s": sweep_s}


# The shipped-weights phase: plain-dict twins of
# configs/avmnist/shipped_wheights_{finetune,finetune_audiofix,scratch}.yaml
# (MNISTAudio and MNISTImage, 32/64 channels, hidden 64; head 128→128→64→10,
# dropout 0.5; the files' Adam groups and plateau scheduler) fed by phase 7's
# `.pt` files, the image encoder of two of them from a reference-layout `.pth`
# this run writes from the seed.
SHIPPED_NAMES = {"finetune": "AVMNIST_ShippedWheights_Finetune",
                 "audiofix": "AVMNIST_ShippedWheights_Finetune_AudioFix",
                 "scratch": "AVMNIST_ShippedWheights_Scratch"}
SHIPPED_HEAD_DIMS = [128, 128, 64, 10]
SHIPPED_CONVS = ((1, 32), (32, 32), (32, 64), (64, 64))
SHIPPED_LOAD_TOL = 1e-4  # the loaded encoder vs a functional replay of the reference module
SHIPPED_OPTIMIZERS = {
    "rmsprop": {"alpha": 0.99, "eps": 1e-8},
    "rmsprop_momentum": {"alpha": 0.99, "eps": 1e-8, "momentum": 0.9},
    "adagrad": {},
    "adadelta": {"rho": 0.9, "eps": 1e-6},
    "adamax": {"betas": [0.9, 0.999]},
    "asgd": {},
    "sparse_adam": {},
}


def shipped_state(seed: int = SEED) -> dict:
    """A reference-layout MNISTImage state dict (the reference's Sequential
    net.0 … net.5: 30 tensors, net.5 3136→64), a plain dict of tensors from
    the seed, built without the port's module."""
    import torch

    g = np.random.default_rng(seed)
    sd = {}
    for slot, convs in ((0, SHIPPED_CONVS[:2]), (2, SHIPPED_CONVS[2:])):
        for which, (cin, cout) in zip(("one", "two"), convs):
            conv, bn = f"net.{slot}.conv_{which}", f"net.{slot}.batch_norm_{which}"
            sd[f"{conv}.weight"] = g.normal(size=(cout, cin, 3, 3)) / np.sqrt(9 * cin)
            sd[f"{conv}.bias"] = 0.1 * g.normal(size=cout)
            sd[f"{bn}.weight"] = 1 + 0.1 * g.normal(size=cout)
            sd[f"{bn}.bias"] = 0.1 * g.normal(size=cout)
            sd[f"{bn}.running_mean"] = 0.1 * g.normal(size=cout)
            sd[f"{bn}.running_var"] = g.uniform(0.5, 1.5, size=cout)
            sd[f"{bn}.num_batches_tracked"] = np.asarray(100)
    sd["net.5.weight"] = g.normal(size=(64, 3136)) / 56.0
    sd["net.5.bias"] = 0.1 * g.normal(size=64)
    return {k: torch.from_numpy(np.asarray(v, np.int64 if "num_batches" in k else np.float32))
            for k, v in sd.items()}


def shipped_replay(sd: dict, x_nchw):
    """The reference MNISTImage's eval forward, functionally, from its
    state dict."""
    import torch.nn.functional as F

    def conv_bn(x, conv, bn):
        x = F.conv2d(x, sd[f"{conv}.weight"], sd[f"{conv}.bias"], padding=1)
        x = F.batch_norm(x, sd[f"{bn}.running_mean"], sd[f"{bn}.running_var"],
                         sd[f"{bn}.weight"], sd[f"{bn}.bias"], training=False, eps=1e-5)
        return F.relu(x)

    x = conv_bn(x_nchw, "net.0.conv_one", "net.0.batch_norm_one")
    x = F.max_pool2d(conv_bn(x, "net.0.conv_two", "net.0.batch_norm_two"), 2)
    x = conv_bn(x, "net.2.conv_one", "net.2.batch_norm_one")
    x = F.max_pool2d(conv_bn(x, "net.2.conv_two", "net.2.batch_norm_two"), 2)
    return F.linear(x.flatten(1), sd["net.5.weight"], sd["net.5.bias"])


def shipped_configs(out_root: str, csvs: dict, pth: Path) -> dict:
    """Plain-dict twins of shipped_wheights_finetune.yaml ("finetune": the
    image encoder from `pth`, encoder groups at Adam 1e-4 with L2 1e-4),
    _audiofix ("audiofix": the same, the scratch audio encoder back at the
    base 5e-4) and _scratch ("scratch": one Adam group at 5e-4), with this
    run's CSVs and output root; the files' data, metrics and logging
    otherwise (batch 128, ai train, ai/a/i eval, no TensorBoard)."""
    import copy

    base = paper_configs(out_root, csvs, pth)["pretrained"]
    del base["logging"]["tensorboard_path"]
    convs = {name: {"__module_spec__": "conv_block_args", "conv_one_in": i, "conv_one_out": o}
             for name, (i, o) in zip(("conv_block_one_one_args", "conv_block_one_two_args",
                                      "conv_block_two_one_args", "conv_block_two_two_args"),
                                     SHIPPED_CONVS)}
    base["model"] = {
        "name": "AVMNIST_ShippedWheights", "model_type": "AVMNIST",
        "audio_encoder": {"__module_spec__": "mnist_audio", **convs, "hidden_dim": 64},
        "image_encoder": {"__module_spec__": "mnist_image", **copy.deepcopy(convs),
                          "hidden_dim": 64},
        "hidden_dim": 128, "dropout": 0.5, "fusion_fn": "concat",
        "pretrained_encoders": {"image": str(pth)},
    }
    del base["training"]["modality_specific_params"]
    out = {}
    for key, name in SHIPPED_NAMES.items():
        cfg = copy.deepcopy(base)
        cfg["experiment"]["name"] = name
        if key == "audiofix":
            cfg["training"]["modality_specific_params"] = {"audio_encoder": {"lr": 0.0005}}
        if key == "scratch":
            del cfg["model"]["pretrained_encoders"], cfg["training"]["encoder_optimizer"]
        out[key] = cfg
    return out


def phase_shipped_load(dev, pth: Path, sd: dict) -> dict:
    """The reference-layout file through the port's reader: the encoder's
    tensors byte for byte the file's, and its eval forward on the card
    within SHIPPED_LOAD_TOL of the reference module replayed from the file
    (TF32 off)."""
    import torch

    from mmtpu_torch.checkpoints import load_encoder_checkpoint
    from mmtpu_torch.config.spec import specs_from_dicts

    spec = shipped_configs("unused", {s: "unused" for s in READER_SPLITS}, pth)["finetune"]
    enc = specs_from_dicts(spec["model"]["image_encoder"]).build()
    report = load_encoder_checkpoint(pth, enc)
    got = enc.state_dict()
    if report.kept or report.fallback or set(got) != set(sd) or not all(
            got[k].dtype == v.dtype and torch.equal(got[k], v) for k, v in sd.items()):
        raise AssertionError(f"[shipped load] not the file's tensors: kept {report.kept}, "
                             f"fallback {report.fallback}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.from_numpy(np.random.default_rng(SEED).normal(size=(128, 28, 28, 1))
                         .astype(np.float32))
    enc = enc.to(dev).eval()
    with torch.no_grad():
        ours = enc(x.to(dev)).cpu()
        theirs = shipped_replay({k: v.to(dev) for k, v in sd.items()},
                                x.permute(0, 3, 1, 2).contiguous().to(dev)).cpu()
    err = (ours - theirs).abs().max().item()
    say(f"[shipped load] {pth.name} ({report.format}, model_state_dict with the module. "
        f"prefix): {len(sd)} tensors byte for byte; eval forward on the card vs the "
        f"reference replay, B=128: max |diff| = {err:.3e} (tolerance {SHIPPED_LOAD_TOL})")
    if not torch.isfinite(ours).all() or err > SHIPPED_LOAD_TOL:
        raise AssertionError(f"[shipped load] forward differs from the replay by {err}")
    return {"replay_err": err, "tensors": len(sd)}


def phase_shipped_optimizers(dev, cfg_path: Path) -> dict:
    """Three train steps of the shipped-weights model (image encoder from the
    file, dropout 0, TF32 off) with each optimizer mmtpu builds beyond Adam,
    AdamW and SGD, on the card and on the CPU from the same weights and
    batches: the losses, and no optimizer state left on the host. `lbfgs`
    must fail at its first step on both devices."""
    import torch

    from mmtpu_torch.cli import common
    from mmtpu_torch.config.optim import OptimizerConfig

    cfg, batches = _train_batches(cfg_path, 3)
    cfg.model.kwargs["dropout"] = 0.0
    cpu = torch.device("cpu")

    def setup(device, name, extra):
        training = cfg.training
        training.optimizer = OptimizerConfig.from_dict(
            {"name": name, "default_kwargs": {"lr": 5e-4, "weight_decay": 1e-4, **extra}})
        model, state, step = _training_setup(cfg, device)
        common.load_pretrained_encoders(model, cfg.model.pretrained_encoders, cfg.logging)
        return state, step

    out = {}
    for label, extra in SHIPPED_OPTIMIZERS.items():
        name = label.removesuffix("_momentum")
        losses, host_state = {}, []
        for tag, device in (("gpu", dev), ("cpu", cpu)):
            state, step = setup(device, name, extra)
            losses[tag] = [float(step(b)["loss"]) for b in batches]
            if tag == "gpu":
                host_state = [k for st in state.optimizer.state.values() for k, v in st.items()
                              if isinstance(v, torch.Tensor) and v.device.type != dev.type]
        rel = [abs(a - b) / abs(b) for a, b in zip(losses["gpu"], losses["cpu"])]
        say(f"[shipped optimizers] {label}: losses GPU {losses['gpu']}, CPU {losses['cpu']}: "
            f"relative {[float(f'{r:.3e}') for r in rel]} (tolerances {TRAIN_LOSS_RTOL}, then "
            f"{TRAIN_LATER_RTOL}); state tensors off the card {host_state}")
        if rel[0] > TRAIN_LOSS_RTOL or max(rel[1:]) > TRAIN_LATER_RTOL or host_state:
            raise AssertionError(f"[shipped optimizers] {label}: relative {rel}, state on the "
                                 f"host {host_state}")
        out[label] = rel
    for device in (dev, cpu):
        _, step = setup(device, "lbfgs", {})
        try:
            step(batches[0])
        except NotImplementedError as e:
            if "value function" not in str(e):
                raise
        else:
            raise AssertionError(f"[shipped optimizers] lbfgs took a step on {device}")
    say("[shipped optimizers] lbfgs builds and raises at its first step on the card and on "
        "the CPU, as mmtpu's optax.lbfgs does at its first update")
    return out


def phase_shipped(dev, card: str, work: Path, csvs: dict) -> dict:
    """The shipped-weights flow: the reference-layout `.pth` written and
    checked, the three twins through `train_multimodal.main` on the card
    (2 epochs), predict on the fine-tune's best.pth against the CPU, and the
    optimizers' three train steps against the CPU."""
    import torch

    from mmtpu_torch.cli import common, predict, train_multimodal
    from mmtpu_torch.train.step import make_eval_step

    out_root = work / "shipped"
    out_root.mkdir(parents=True, exist_ok=True)
    sd = shipped_state()
    pth = work / "lenet_image_best.pth"
    torch.save({"model_state_dict": {f"module.{k}": v for k, v in sd.items()}}, pth)
    load = phase_shipped_load(dev, pth, sd)

    paths = {}
    for key, cfg in shipped_configs(str(out_root), csvs, pth).items():
        paths[key] = work / f"shipped_{key}.json"
        paths[key].write_text(json.dumps(cfg))
    per_split = _eval_batches(TRAIN_SAMPLES)
    one_run = TRAIN_EPOCHS * per_split["validation"] + per_split["test"]
    # mmtpu's test record: the scalar metrics per pattern (the confusion
    # matrices go to their own files), the loss, the split and the index
    metrics = ("accuracy", "balanced_accuracy", "f1_macro", "f1_weighted")
    want_keys = {"index", "split", "loss", *(f"{m}_{p}" for m in metrics for p in ("AI", "A", "I"))}
    real_load, real_state = common.load_pretrained_encoders, common.make_state
    runs, launches = {}, {}
    for key in SHIPPED_NAMES:
        loaded, groups = [], []

        def spy_load(model, pretrained, logging_cfg):
            mods = real_load(model, pretrained, logging_cfg)
            loaded.append({k: v.detach().cpu().clone()
                           for k, v in model.image_encoder.state_dict().items()})
            return mods

        def spy_state(model, training, clip=None):
            state = real_state(model, training, clip=clip)
            groups.extend((g["label"], g["lr"]) for g in state.optimizer.param_groups)
            return state

        common.load_pretrained_encoders, common.make_state = spy_load, spy_state
        reset_counts()
        try:
            run = _run_cli(train_multimodal, paths[key], f"[shipped {key}]", out_root,
                           SHIPPED_NAMES[key], extra=("--epochs", str(TRAIN_EPOCHS)))
        finally:
            common.load_pretrained_encoders, common.make_state = real_load, real_state
        launches[key] = read_counts()["fused_mlp"]
        from_file = len(loaded) == 1 and all(torch.equal(loaded[0][k], v) for k, v in sd.items())
        if from_file != (key != "scratch"):
            raise AssertionError(f"[shipped {key}] image encoder at epoch 0 from the file: "
                                 f"{from_file}")
        want_groups = {"finetune": [("group_0", 1e-4), ("group_1", 1e-4), ("default", 5e-4)],
                       "audiofix": [("group_0", 5e-4), ("group_1", 1e-4), ("default", 5e-4)],
                       "scratch": [("default", 5e-4)]}[key]
        if groups != want_groups:
            raise AssertionError(f"[shipped {key}] optimizer groups {groups}, expected "
                                 f"{want_groups} (group_0 ^audio_encoder/, group_1 "
                                 "^image_encoder/)")
        if launches[key] != one_run:
            raise AssertionError(f"[shipped {key}] fused_mlp launched {launches[key]} times, "
                                 f"expected {TRAIN_EPOCHS} × {per_split['validation']} "
                                 f"validation + {per_split['test']} test batches = {one_run}")
        if set(run["test"]) != want_keys:
            raise AssertionError(f"[shipped {key}] test_metrics.json keys {sorted(run['test'])}")
        say_card(card, f"[shipped {key}] {run['seconds']:.2f} s through main; epoch "
                 f"{TRAIN_EPOCHS} train {run['epoch_s']:.3f} s = {run['samples_per_s']:.1f} "
                 f"samples/s (B={TRAIN_BATCH}); peak device memory "
                 f"{run['peak_bytes'] / 2**20:.1f} MiB")
        say(f"[shipped {key}] image encoder at epoch 0 from the file: {from_file}; groups "
            f"(label, lr) {groups}; fused_mlp launches {launches[key]} = {TRAIN_EPOCHS} × "
            f"{per_split['validation']} + {per_split['test']}; losses {run['losses']}; test "
            f"{_accuracies(run['test'])}")
        runs[key] = run

    # predict on the fine-tune's best.pth, the card against the CPU
    args = predict.arg_parser().parse_args(
        ["--config", str(paths["finetune"]), "--run_id", "1", "--checkpoint", "best"])
    cfg = common.load_config(args)
    reset_counts()
    task, loader = predict.build_task_and_loader(cfg, args, dev)
    cpu_task, _ = predict.build_task_and_loader(cfg, args, torch.device("cpu"))
    batches = list(loader)
    gpu_step, cpu_step = make_eval_step(task, dev), make_eval_step(cpu_task, torch.device("cpu"))
    worst = 0.0
    for i in (0, 1, len(batches) - 1):
        g_logits, c_logits = gpu_step(batches[i])["logits"].cpu(), cpu_step(batches[i])["logits"]
        if g_logits.shape != (TRAIN_BATCH, 10) or not torch.isfinite(g_logits).all():
            raise AssertionError(f"[shipped predict] batch {i}: logits {tuple(g_logits.shape)}")
        worst = max(worst, (g_logits - c_logits).abs().max().item())
    predict_launches = read_counts()["fused_mlp"]
    say(f"[shipped predict] {SHIPPED_NAMES['finetune']} best.pth: GPU vs CPU logits on 3 of "
        f"{len(batches)} batches, max |diff| = {worst:.3e} (tolerance {CPU_TOL}, TF32 off); "
        f"fused_mlp launches {predict_launches}")
    if worst > CPU_TOL or predict_launches != 3:
        raise AssertionError(f"[shipped predict] logits differ by {worst}; "
                             f"{predict_launches} launches")
    profile = phase_train_profile(dev, card, paths["finetune"], tag="[shipped profile]")
    optimizers = phase_shipped_optimizers(dev, paths["finetune"])
    return {"load": load, "runs": runs, "launches": launches, "predict_err": worst,
            "profile": profile, "optimizers": optimizers}


# Phase 9, C-MAM: plain-dict twins of configs/avmnist/cmam_audio_to_image.yaml
# (its teacher phase 5's scratch fine-tune, its data phase 7's `.pt` files
# through the AVMNIST reader) and of configs/mosi/synthetic_dual_cmam.yaml at
# the published UttFusion widths (its teacher phase 6's model, CMU-MOSI's
# split sizes), each through `train_cmam.main`.
CMAM_NAMES = {"cmam": "AVMNIST_CMAM_A_to_I", "dual": "Synthetic_MOSI_DualCMAM"}
CMAM_SAMPLES = {"cmam": TRAIN_SAMPLES, "dual": UTT_SAMPLES}
CMAM_BATCH = {"cmam": TRAIN_BATCH, "dual": UTT_BATCH}
CMAM_LOSS_RTOL = {"cmam": TRAIN_LOSS_RTOL, "dual": UTT_LOSS_RTOL}  # step 1 and the padded step
CMAM_GRAD_TOL = {"cmam": TRAIN_GRAD64_TOL, "dual": UTT_GRAD_TOL}  # float64 / float32, step 1
CMAM_TERMS = {"cmam": ["cls_loss", "cosine", "mae", "mse"], "dual": []}


def cmam_configs(out_root: str, csvs: dict, bases: dict, dropout: bool = True) -> dict:
    """The two twins. `bases` names each teacher's best.pth; the config
    names it as the file does, `.../models/{run_id}/best.ckpt`.
    `dropout=False` sets the C-MAMs' dropout to 0 (the GPU-vs-CPU check)."""
    def pretrained(path: Path) -> str:
        return str(path.parent.parent / "{run_id}" / "best.ckpt")

    def logging_(name):
        return {"log_path": f"{out_root}/{{experiment_name}}/logs/{{run_id}}",
                "model_output_path": f"{out_root}/{{experiment_name}}/models/{{run_id}}",
                "metrics_path": f"{out_root}/{{experiment_name}}/metrics/{{run_id}}",
                "save_metric": "loss"}

    audio = {"__module_spec__": "resnet18", "in_channels": 1, "hidden_dim": 64}
    av_patterns = {"modalities": {"audio": {"missing_rate": 0.0},
                                  "image": {"missing_rate": 0.0}},
                   "selected_patterns": ["ai"]}

    def av_split(name, **extra):
        return {"dataset": "AVMNIST", "data_fp": str(csvs[name]),
                "split": {"validation": "valid"}.get(name, name),
                "target_modality": "MULTIMODAL", "batch_size": CMAM_BATCH["cmam"], **extra,
                "missing_patterns": av_patterns}

    cmam = {
        "experiment": {"name": CMAM_NAMES["cmam"], "seed": SEED, "device": "tpu",
                       "is_train": True, "is_test": True},
        "model": {"name": "AVMNIST", "model_type": "AVMNIST", "audio_encoder": audio,
                  "image_encoder": {"__module_spec__": "resnet34", "in_channels": 1,
                                    "hidden_dim": 128},
                  "hidden_dim": 128, "dropout": 0.5, "fusion_fn": "concat",
                  "pretrained_path": pretrained(bases["cmam"])},
        "cmam": {"name": "CMAM", "model_type": "CMAM", "target_modality": "image",
                 "load_pretrained_encoder_state_for": ["audio"],
                 "input_encoders": {"__module_spec__": "input_encoders", "audio": audio},
                 "association_network": {"__module_spec__": "association_network",
                                         "input_size": 64, "hidden_size": 256,
                                         "output_size": 128, "batch_norm": True,
                                         "dropout": 0.25 if dropout else 0.0}},
        "target_modality": "image",
        "training": {"epochs": TRAIN_EPOCHS, "early_stopping": False, "num_modalities": 2,
                     "optimizer": {"name": "Adam",
                                   "default_kwargs": {"lr": 0.001, "weight_decay": 0.0001}},
                     "loss_functions": {"cmam": {
                         "loss_name": "cmam", "weight": 1.0,
                         "loss_kwargs": {"cosine_weight": 1.0, "mae_weight": 1.0,
                                         "mse_weight": 1.0, "cls_weight": 0.005}}}},
        "data": {"datasets": {"train": av_split("train", shuffle=True),
                              "validation": av_split("validation"), "test": av_split("test")}},
        "metrics": {"metrics": {
            "accuracy": {"function": "sklearn.metrics.accuracy_score", "kwargs": {}},
            "cosine_sim": {"function": "metrics.cosine_similarity", "kwargs": {}},
            "mse": {"function": "sklearn.metrics.mean_squared_error", "kwargs": {}}},
            "groups": {"classification": ["accuracy"],
                       "reconstruction": ["cosine_sim", "mse"]}},
        "logging": logging_(CMAM_NAMES["cmam"]),
        "monitoring": {"enabled": False},
    }

    def mosi_split(name, n, **extra):
        return {"dataset": "synthetic_mosi", "data_fp": "unused", "split": name,
                "target_modality": "MULTIMODAL", "batch_size": CMAM_BATCH["dual"], **extra,
                "kwargs": {"num_samples": n},
                "missing_patterns": {"modalities": {m: {"missing_rate": 0.0}
                                                    for m in ("audio", "video", "text")},
                                     "selected_patterns": ["atv"]}}

    base = mosi_smoke_config()["model"]
    dual = {
        "experiment": {"name": CMAM_NAMES["dual"], "seed": SEED, "device": "tpu",
                       "is_train": True, "is_test": True},
        "model": {**base, "pretrained_path": pretrained(bases["dual"])},
        "cmam": {"name": "DualCMAM", "model_type": "dual_cmam", "input_modality": "audio",
                 "target_modality_one": "video", "target_modality_two": "text",
                 "load_pretrained_encoder_state_for": [],
                 "input_encoder": dict(base["netA"]),
                 "shared_encoder_output_size": 64, "decoder_hidden_size": 64,
                 "target_modality_one_embd_size": 64, "target_modality_two_embd_size": 64,
                 "dropout": 0.1 if dropout else 0.0},
        "target_modality": "video",
        "training": {"epochs": TRAIN_EPOCHS, "early_stopping": False, "num_modalities": 3,
                     "optimizer": {"name": "Adam", "default_kwargs": {"lr": 0.001}},
                     "loss_functions": {"cmam": {
                         "loss_name": "cmam", "weight": 1.0,
                         "loss_kwargs": {"cosine_weight": 1.0, "mse_weight": 1.0,
                                         "cls_weight": 0.0}}}},
        "data": {"datasets": {
            "train": mosi_split("train", UTT_SAMPLES["train"], shuffle=True),
            "validation": mosi_split("valid", UTT_SAMPLES["validation"]),
            "test": mosi_split("test", UTT_SAMPLES["test"])}},
        "metrics": {"metrics": {"accuracy": {"function": "sklearn.metrics.accuracy_score",
                                             "kwargs": {}}},
                    "groups": {"classification": ["accuracy"], "reconstruction": []}},
        "logging": logging_(CMAM_NAMES["dual"]),
        "monitoring": {"enabled": False},
    }
    return {"cmam": cmam, "dual": dual}


def cmam_batches(kind: str) -> dict:
    """Batches per split as the loaders form them (one pattern each)."""
    n, b = CMAM_SAMPLES[kind], CMAM_BATCH[kind]
    return {s: -(-n[s] // b) for s in ("train", "validation", "test")}


def cmam_expected_lstm(kind: str) -> int:
    """`lstm` launches of a run: none over the AVMNIST teacher; per DualCMAM
    batch three (the teacher's netV for the video target, the student's
    encoder, the teacher's netA under the two reconstructions)."""
    if kind == "cmam":
        return 0
    n = cmam_batches(kind)
    return 3 * (TRAIN_EPOCHS * (n["train"] + n["validation"]) + n["test"])


def _state_hash(state: dict) -> str:
    import hashlib

    h = hashlib.sha256()
    for k, v in state.items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _cmam_config(cfg_path: Path):
    from mmtpu_torch.cli import common
    from mmtpu_torch.config.cmam import CMAMConfig

    return common.finalize_config(CMAMConfig.load(cfg_path, run_id=1),
                                  argparse.Namespace(run_id=1))


def _cmam_setup(cfg_path: Path, device):
    """The config, the run as `train_cmam` assembles it, its train step."""
    from mmtpu_torch.cli import train_cmam

    cfg = _cmam_config(cfg_path)
    built = train_cmam.assemble(cfg, device)
    return cfg, built, built.step_builders[0](built.task, built.state, device)


def phase_cmam_profile(dev, card: str, kind: str, cfg_path: Path, steps: int = 8,
                       warmup: int = 3) -> dict:
    """A window of C-MAM train steps under the profiler."""
    import torch

    cfg, built, step = _cmam_setup(cfg_path, dev)
    it = iter(cfg.data.build_loader("train", seed=cfg.experiment.seed))
    batches = [next(it) for _ in range(warmup + steps)]
    for b in batches[:warmup]:
        step(b)
    torch.cuda.synchronize()
    reset_counts()
    brk = device_breakdown(lambda: [step(b) for b in batches[warmup:]], top=8)
    counts = read_counts()
    busy = brk["device_ms"] / brk["profiled_wall_ms"]
    say_card(card, f"[cmam {kind} profile] {steps} train steps (B={CMAM_BATCH[kind]}): "
             f"device {brk['device_ms'] / steps:.3f} ms per step, busy share {busy:.3f}; "
             f"{brk['kernel_events'] / steps:.1f} device kernels and "
             f"{brk['launch_calls'] / steps:.1f} launch calls per step; launches {counts}; "
             f"top device operations (name, ms, count) {brk['top']}; top host operations "
             f"(name, ms, count) {brk['top_host']}")
    want = {"fused_mlp": 0, "lstm": steps * (3 if kind == "dual" else 0)}
    if counts != want:
        raise AssertionError(f"[cmam {kind} profile] launches {counts}, expected {want}")
    return {"busy_share": busy, "device_ms_per_step": brk["device_ms"] / steps,
            "kernels_per_step": brk["kernel_events"] / steps,
            "launch_calls_per_step": brk["launch_calls"] / steps}


def phase_cmam_check(dev, kind: str, cfg_path: Path) -> dict:
    """The first three train steps from the same weights (dropout 0, TF32
    off) on the card and on the CPU, then a padded-tail step from the CPU's
    weights after step 3 on both: the losses; the step-1 gradients of every
    C-MAM parameter against its norm, in float64 over the AVMNIST teacher
    (BatchNorm's backward in float32 misses the exact gradient by ~1e-3 of
    its norm on either device) and in float32 over UttFusion (the kernel
    takes float32 only)."""
    import torch

    cpu = torch.device("cpu")
    cfg = _cmam_config(cfg_path)
    batches = list(cfg.data.build_loader("train", seed=cfg.experiment.seed))
    if kind == "cmam":
        padded = {k: v.copy() for k, v in batches[2].items()}
        for k in ("audio", "image", "labels", "audio_mask", "image_mask", "sample_mask"):
            padded[k][CMAM_BATCH[kind] - 28:] = 0
    else:
        padded = batches[-1]
    real = int(padded["sample_mask"].sum())

    def grads_of(model):
        return {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}

    runs, losses, grads = {}, {}, {}
    for label, device in (("gpu", dev), ("cpu", cpu)):
        _, built, step = _cmam_setup(cfg_path, device)
        losses[label] = []
        for b in batches[:3]:
            losses[label].append(float(step(b)["loss"]))
            grads.setdefault(label, grads_of(built.cmam))
        runs[label] = (built, step)
    weights = runs["cpu"][0].cmam.state_dict()
    runs["gpu"][0].cmam.load_state_dict(weights)
    pad_loss = {label: float(step(padded)["loss"]) for label, (_, step) in runs.items()}
    if kind == "cmam":
        for label, device in (("gpu", dev), ("cpu", cpu)):
            _, built, step = _cmam_setup(cfg_path, device)
            built.base.double()
            built.cmam.double()
            with _float64_losses():
                step(_as_float64(batches[0]))
            grads[label] = grads_of(built.cmam)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["gpu"], losses["cpu"])]
    pad_rel = abs(pad_loss["gpu"] - pad_loss["cpu"]) / abs(pad_loss["cpu"])
    # a bias that feeds a BatchNorm (the student's fc.bias through fc_0,
    # fc_0.bias) has an exact gradient of 0: its rule is the absolute 1e-12
    zero = {n for n, w in grads["cpu"].items() if w.double().norm().item() < 1e-9}
    err = _grad_errors({n: g for n, g in grads["gpu"].items() if n not in zero},
                       {n: g for n, g in grads["cpu"].items() if n not in zero})
    zero_err = max([(grads["gpu"][n].double() - grads["cpu"][n].double()).abs().max().item()
                    for n in zero], default=0.0)
    precision = "float64" if kind == "cmam" else "float32"
    say(f"[cmam {kind} check] float32 losses of steps 1-3, GPU {losses['gpu']}, CPU "
        f"{losses['cpu']}: relative {rel} (tolerances {CMAM_LOSS_RTOL[kind]}, then "
        f"{TRAIN_LATER_RTOL}); padded tail ({real} real rows of {CMAM_BATCH[kind]}) from the "
        f"same weights: GPU {pad_loss['gpu']}, CPU {pad_loss['cpu']} (relative "
        f"{pad_rel:.3e}); step-1 {precision} gradients, {len(err)} parameters: worst "
        f"{max(err.values()):.3e} of its norm (tolerance {CMAM_GRAD_TOL[kind]}), whole "
        f"{_whole_error(grads['gpu'], grads['cpu']):.3e}, worst {_worst(err)}; "
        f"{len(zero)} with an exact gradient of 0 {sorted(zero)}: largest |GPU - CPU| "
        f"{zero_err:.3e} (tolerance 1e-12); TF32 off")
    if (rel[0] > CMAM_LOSS_RTOL[kind] or pad_rel > CMAM_LOSS_RTOL[kind]
            or max(rel[1:]) > TRAIN_LATER_RTOL):
        raise AssertionError(f"[cmam {kind} check] GPU and CPU losses differ: {rel}, padded "
                             f"{pad_rel}")
    if max(err.values()) > CMAM_GRAD_TOL[kind] or zero_err > 1e-12:
        raise AssertionError(f"[cmam {kind} check] step-1 gradients differ by "
                             f"{max(err.values())} of their norm ({_worst(err)}), "
                             f"{zero_err} where the exact gradient is 0")
    return {"loss_rel": rel, "pad_loss_rel": pad_rel, "grad_err": max(err.values())}


def _check_cmam_records(kind: str, metrics: Path) -> dict:
    """mmtpu's record keys: the nested groups, loss, and the term columns
    (null on train records) where the step gives terms."""
    base = ["index", "classification", "reconstruction", "loss"]
    recon = {"cmam": ["loss", "cosine_sim_AI", "mse_AI"], "dual": ["loss"]}[kind]
    records = {}
    for split in ("train", "validation", "test"):
        records[split] = json.loads((metrics / f"{split}_metrics.json").read_text())
        tail = ["split"] + (["Epoch"] if split != "test" else [])
        for r in records[split]:
            if list(r) != base + CMAM_TERMS[kind] + tail or list(r["reconstruction"]) != recon:
                raise AssertionError(f"[cmam {kind}] {split} record keys {list(r)}, "
                                     f"reconstruction {list(r['reconstruction'])}")
            terms = [r[k] for k in CMAM_TERMS[kind]]
            if split == "train" and any(t is not None for t in terms):
                raise AssertionError(f"[cmam {kind}] train record carries term means {terms}")
            values = [r["loss"], *r["reconstruction"].values(),
                      *r["classification"].values(), *(terms if split != "train" else [])]
            if not all(np.isfinite(v) for v in values):
                raise AssertionError(f"[cmam {kind}] {split} record {r}")
    return records


def phase_cmam(dev, card: str, work: Path, csvs: dict, bases: dict) -> dict:
    """Both C-MAM kinds through `train_cmam.main` on the card: the teacher
    restored from its file and bitwise unchanged by the run, `fused_mlp` never
    launched, `lstm` three times per DualCMAM batch, mmtpu's record keys;
    then a profiled window and the GPU-vs-CPU check of each."""
    import torch

    from mmtpu_torch.cli import train_cmam
    from mmtpu_torch.train import cmam_step

    out_root = work / "cmam"
    paths, check_paths = {}, {}
    for key, cfg in cmam_configs(str(out_root), csvs, bases).items():
        paths[key] = work / f"cmam_{key}.json"
        paths[key].write_text(json.dumps(cfg))
    for key, cfg in cmam_configs(str(out_root), csvs, bases, dropout=False).items():
        check_paths[key] = work / f"cmam_{key}_check.json"
        check_paths[key].write_text(json.dumps(cfg))

    teachers = []
    real_post = cmam_step.CMAMTask.__post_init__

    def spy(task):  # the teacher as restored, before any step
        real_post(task)
        teachers.append((task.base_model, _state_hash(task.base_model.state_dict())))

    results = {}
    for kind in ("cmam", "dual"):
        teachers.clear()
        cmam_step.CMAMTask.__post_init__ = spy
        reset_counts()
        try:
            run = _run_cli(train_cmam, paths[kind], f"[cmam {kind}]", out_root,
                           CMAM_NAMES[kind], train_samples=CMAM_SAMPLES[kind]["train"])
        finally:
            cmam_step.CMAMTask.__post_init__ = real_post
        counts = read_counts()
        want = {"fused_mlp": 0, "lstm": cmam_expected_lstm(kind)}
        if counts != want:
            raise AssertionError(f"[cmam {kind}] launches {counts}, expected {want}")
        (teacher, before), = teachers
        after = _state_hash(teacher.state_dict())
        in_file = _state_hash(torch.load(bases[kind], map_location="cpu",
                                         weights_only=True)["model"])
        if not before == after == in_file:
            raise AssertionError(f"[cmam {kind}] teacher hash: file {in_file}, restored "
                                 f"{before}, after the run {after}")
        records = _check_cmam_records(kind, out_root / CMAM_NAMES[kind] / "metrics/1")
        n = cmam_batches(kind)
        say_card(card, f"[cmam {kind}] {run['seconds']:.2f} s through train_cmam.main "
                 f"(start-up, data and checkpoints included); epoch {TRAIN_EPOCHS} train "
                 f"{run['epoch_s']:.3f} s = {run['samples_per_s']:.1f} samples/s "
                 f"(B={CMAM_BATCH[kind]}, {CMAM_SAMPLES[kind]['train']} samples); peak device "
                 f"memory {run['peak_bytes'] / 2**20:.1f} MiB")
        say(f"[cmam {kind}] launches {counts} (lstm: 3 × ({TRAIN_EPOCHS} × ({n['train']} "
            f"train + {n['validation']} validation) + {n['test']} test batches) for a "
            f"DualCMAM, none over the AVMNIST teacher); teacher state sha256 {after[:16]} "
            f"= its file's, unchanged by the run; losses {run['losses']}; test record "
            f"{ {k: v for k, v in records['test'][0].items() if k != 'index'} }")
        profile = phase_cmam_profile(dev, card, kind, paths[kind])
        check = phase_cmam_check(dev, kind, check_paths[kind])
        results[kind] = {"run": run, "launches": counts, "profile": profile, "check": check}
    return results


def cmam_bases(work: Path) -> dict:
    """Teachers for `--cmam-only`: phase 5's scratch fine-tune and phase 6's
    UttFusion model with seeded weights, each saved as a training
    checkpoint's `best.pth` (the layout those phases write)."""
    import torch

    from mmtpu_torch.cli import common
    from mmtpu_torch.config import ModelConfig

    bases = {}
    for kind, model_cfg, name, root in (
            ("cmam", train_configs(str(work / "train"))["scratch"]["model"], SCRATCH_NAME,
             work / "train"),
            ("dual", mosi_smoke_config()["model"], UTT_NAME, work / "train_utt")):
        model = common.init_model(common.build_model_from_config(
            ModelConfig.from_dict(model_cfg)), SEED, torch.device("cpu"))
        bases[kind] = root / name / "models/1/best.pth"
        bases[kind].parent.mkdir(parents=True, exist_ok=True)
        torch.save({"model": model.state_dict()}, bases[kind])
    return bases


def say_cmam(card: str, cmam: dict, seconds: float) -> None:
    say_card(card, "[summary] C-MAM: " + "; ".join(
        f"{kind} {r['run']['samples_per_s']:.1f} train samples/s (epoch {TRAIN_EPOCHS}), "
        f"{r['run']['seconds']:.2f} s through main, launches {r['launches']}, "
        f"{r['profile']['device_ms_per_step']:.3f} ms of device work per step at busy share "
        f"{r['profile']['busy_share']:.3f}" for kind, r in cmam.items())
        + f"; phase {seconds:.1f} s")


# Phase 10: the MSA families with their own train steps, MMIN and RedCore,
# through `train_multimodal.main` at the published UttFusion widths on
# CMU-MOSI's split sizes.
MSA_NAMES = {"mmin": "Synthetic_MOSI_MMIN_Teacher", "redcore": "Synthetic_MOSI_RedCore"}
MSA_EVAL_PATTERNS = ["atv", "at", "tv"]  # synthetic_mmin_teacher.yaml's evaluation patterns
MSA_LOSS_RTOL = 1e-5  # step 1 and the padded tail, GPU (TF32 off) vs CPU, float32
MSA_GRAD_TOL = 1e-4  # of each parameter's gradient norm, step 1
MSA_SCHED_TOL = 1e-6  # RedCore's beta, eta after three steps, GPU vs CPU


def msa_configs(out_root: str, teacher: Path, check: bool = False) -> dict:
    """The two twins. MMIN: configs/mosi/synthetic_mmin_teacher.yaml with the
    student at the published UttFusion widths and the AE of the MMIN
    authors' training script (AE_layers 256,128,64, n_blocks 5: latent 320;
    classifier 320→[128,128]→3), the teacher phase 6's UttFusion from its
    best.pth (named by the file's `{run_id}` template), and one departure:
    training on `atv` with audio and video missing at 0.2 (the file's train
    split has no missingness, so the teacher's complement inputs would be
    zeros). RedCore (no config in the repo): Transformer encoders over
    5 / 20 / 768 features, embedding 64, 1 block, 2 heads; the MMIN twin's
    AE; ResidualXE generators 128→64; classifiers 192→[128,128]→3 and
    64→[128]→3 with dropout 0.3. `check=True` sets the classifiers' dropout
    to 0 (the GPU-vs-CPU check, which also neutralises the Transformers'
    dropouts and the VAE sample)."""
    utt = mosi_smoke_config(num_samples=UTT_SAMPLES["test"], batch_size=UTT_BATCH,
                            out_root=out_root, train_samples=UTT_SAMPLES["train"],
                            validation_samples=UTT_SAMPLES["validation"])
    for name in ("validation", "test"):
        utt["data"]["datasets"][name]["missing_patterns"]["selected_patterns"] = (
            MSA_EVAL_PATTERNS)
    base = utt["model"]
    teacher_model = {"__module_spec__": "utt_fusion", **{k: base[k] for k in (
        "netA", "netV", "netT", "netC")},
        "pretrained_path": str(teacher.parent.parent / "{run_id}" / "best.pth")}
    ae = {"__module_spec__": "residual_ae", "layers": [256, 128, 64], "n_blocks": 5,
          "input_dim": 192, "dropout": 0.0}
    common_ = {
        "training": {"epochs": TRAIN_EPOCHS, "early_stopping": False, "num_modalities": 3,
                     "optimizer": {"name": "Adam", "default_kwargs": {"lr": 0.001}},
                     "loss_functions": {
                         "cross_entropy": {"loss_name": "cross_entropy", "weight": 1.0},
                         "mse": {"loss_name": "mse", "weight": 0.5},
                         "cycle": {"loss_name": "cycle", "weight": 0.5}}},
        "data": utt["data"],
        "metrics": {"metrics": {"accuracy": {"function": "sklearn.metrics.accuracy_score",
                                             "kwargs": {}}},
                    "groups": {"classification": ["accuracy"]}},
        "logging": utt["logging"], "monitoring": {"enabled": False},
    }

    def fc(width, layers):
        return {"__module_spec__": "fcclassifier", "input_dim": width, "layers": layers,
                "output_dim": 3, "dropout": 0.0 if check else 0.3}

    mmin = {
        "experiment": {"name": MSA_NAMES["mmin"], "seed": SEED, "device": "tpu",
                       "is_train": True, "is_test": True},
        "model": {"name": "MMIN", "model_type": "mmin",
                  "netA": base["netA"], "netV": base["netV"],
                  "netT": {**base["netT"], "dropout": 0.0}, "netAE": ae,
                  "netC": {**fc(320, [128, 128]), "dropout": 0.0},
                  "pretrained_model": teacher_model},
        **common_,
    }

    def tr(width):
        return {"__module_spec__": "transformer", "width": width, "layers": 1, "heads": 2,
                "embd_width": 64}

    def xe():
        return {"__module_spec__": "residual_xe", "layers": [128, 64], "n_blocks": 3,
                "input_dim": 128, "output_dim": 64, "dropout": 0.0}

    redcore = {
        "experiment": {"name": MSA_NAMES["redcore"], "seed": SEED, "device": "tpu",
                       "is_train": True, "is_test": True},
        "model": {"name": "RedCore", "model_type": "redcore",
                  "netA": tr(5), "netV": tr(20), "netT": tr(768), "netAE": ae,
                  "netC": fc(192, [128, 128]), "netC_A": fc(64, [128]),
                  "netC_V": fc(64, [128]), "netC_T": fc(64, [128]),
                  "netAT_V": xe(), "netAV_T": xe(), "netVT_A": xe()},
        **common_,
    }
    redcore["training"] = {**common_["training"], "loss_functions": {
        k: v for k, v in common_["training"]["loss_functions"].items() if k != "cycle"}}
    return {"mmin": mmin, "redcore": redcore}


def msa_batches() -> dict:
    """Batches per split as the loaders form them: train one pattern, the
    evaluation splits the three patterns' visits."""
    n = len(MSA_EVAL_PATTERNS)
    return {"train": -(-UTT_SAMPLES["train"] // UTT_BATCH),
            **{s: -(-UTT_SAMPLES[s] * n // UTT_BATCH) for s in ("validation", "test")}}


def msa_expected_lstm(kind: str) -> int:
    """`lstm` launches of a run: MMIN's student pair once per forward (G=2)
    and its teacher's netA and netV once each per train batch (G=1): 3 per
    train batch, 1 per evaluation batch; RedCore none."""
    if kind == "redcore":
        return 0
    n = msa_batches()
    return TRAIN_EPOCHS * (3 * n["train"] + n["validation"]) + n["test"]


def _msa_config(cfg_path: Path):
    from mmtpu_torch.cli import common

    return common.load_config(argparse.Namespace(config=str(cfg_path), run_id=1, seed=None))


def _msa_setup(cfg_path: Path, device):
    """The config, the run as `msa_runners` assembles it, its train step."""
    from mmtpu_torch.cli import msa_runners

    cfg = _msa_config(cfg_path)
    built = msa_runners.assemble(cfg, argparse.Namespace(run_id=1), device)
    return cfg, built, built.step_builders[0](built.task, built.state, device)


@contextlib.contextmanager
def _msa_neutralised():
    """The RedCore check's train forward without randomness: the
    Transformers' dropouts pass their input and the VAE sample's ε is 0
    (the two devices' generators draw different numbers)."""
    import torch

    from mmtpu_torch.models import rng

    saved = rng.GeneratorDropout.forward, rng.GeneratorNormal.forward
    rng.GeneratorDropout.forward = lambda self, x: x
    rng.GeneratorNormal.forward = lambda self, like: torch.zeros_like(like)
    try:
        yield
    finally:
        rng.GeneratorDropout.forward, rng.GeneratorNormal.forward = saved


def phase_msa_profile(dev, card: str, kind: str, cfg_path: Path, steps: int = 8,
                      warmup: int = 3) -> dict:
    """A window of train steps under the profiler."""
    import torch

    cfg, _, step = _msa_setup(cfg_path, dev)
    it = iter(cfg.data.build_loader("train", seed=cfg.experiment.seed))
    batches = [next(it) for _ in range(warmup + steps)]
    for b in batches[:warmup]:
        step(b)
    torch.cuda.synchronize()
    reset_counts()
    brk = device_breakdown(lambda: [step(b) for b in batches[warmup:]], top=8)
    counts = read_counts()
    busy = brk["device_ms"] / brk["profiled_wall_ms"]
    say_card(card, f"[msa {kind} profile] {steps} train steps (B={UTT_BATCH}, T=50): device "
             f"{brk['device_ms'] / steps:.3f} ms per step, wall "
             f"{brk['profiled_wall_ms'] / steps:.3f} ms per step, busy share {busy:.3f}; "
             f"{brk['kernel_events'] / steps:.1f} device kernels and "
             f"{brk['launch_calls'] / steps:.1f} launch calls per step; launches {counts}; "
             f"top device operations (name, ms, count) {brk['top']}; top host operations "
             f"(name, ms, count) {brk['top_host']}")
    want = {"fused_mlp": 0, "lstm": steps * (3 if kind == "mmin" else 0)}
    if counts != want:
        raise AssertionError(f"[msa {kind} profile] launches {counts}, expected {want}")
    return {"busy_share": busy, "device_ms_per_step": brk["device_ms"] / steps,
            "wall_ms_per_step": brk["profiled_wall_ms"] / steps,
            "kernels_per_step": brk["kernel_events"] / steps,
            "launch_calls_per_step": brk["launch_calls"] / steps}


def phase_msa_check(dev, kind: str, cfg_path: Path) -> dict:
    """The first three train steps from the same initial weights (dropout 0,
    RedCore's randomness neutralised, TF32 off, float32) on the card and on
    the CPU, then the train split's padded tail (4 real rows of 32) from the
    CPU's weights after step 3 on both: the losses, the step-1 gradients of
    every parameter against its norm (a parameter whose exact gradient is 0
    — RedCore's AEs, which no term reads, and its attention key biases —
    within the tolerance of the whole gradient's norm), and RedCore's β and
    η after the three steps."""
    import torch

    cpu = torch.device("cpu")
    cfg = _msa_config(cfg_path)
    batches = list(cfg.data.build_loader("train", seed=cfg.experiment.seed))
    padded = batches[-1]
    real_rows = int(padded["sample_mask"].sum())
    if real_rows != UTT_SAMPLES["train"] % UTT_BATCH:
        raise AssertionError(f"the train split's last batch holds {real_rows} real rows")

    def grads_of(model):
        return {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}

    runs, losses, grads, scheds = {}, {}, {}, {}
    with _msa_neutralised():
        for label, device in (("gpu", dev), ("cpu", cpu)):
            _, built, step = _msa_setup(cfg_path, device)
            losses[label] = []
            for b in batches[:3]:
                losses[label].append(float(step(b)["loss"]))
                grads.setdefault(label, grads_of(built.model))
            if kind == "redcore":
                scheds[label] = {k: getattr(step.sched, k).detach().cpu().double()
                                 for k in ("beta", "eta", "loss_ema", "iter_count")}
            runs[label] = (built, step)
        runs["gpu"][0].model.load_state_dict(runs["cpu"][0].model.state_dict())
        pad_loss = {label: float(step(padded)["loss"]) for label, (_, step) in runs.items()}
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["gpu"], losses["cpu"])]
    pad_rel = abs(pad_loss["gpu"] - pad_loss["cpu"]) / abs(pad_loss["cpu"])
    whole = _whole_error(grads["gpu"], grads["cpu"])
    norm_all = float(np.sqrt(sum(float(g.double().square().sum())
                                 for g in grads["cpu"].values())))
    zero = {n for n, w in grads["cpu"].items()
            if n.endswith("attn.key.bias") or w.double().norm().item() <= 1e-9 * norm_all}
    err = _grad_errors({n: g for n, g in grads["gpu"].items() if n not in zero},
                       {n: g for n, g in grads["cpu"].items() if n not in zero})
    zero_err = max([max(grads["gpu"][n].double().abs().max().item(),
                        grads["cpu"][n].double().abs().max().item()) / norm_all
                    for n in zero], default=0.0)
    sched_err = max([((scheds["gpu"][k] - scheds["cpu"][k]).abs().max()
                      / scheds["cpu"][k].abs().max().clamp(min=1e-30)).item()
                     for k in ("beta", "eta") if scheds], default=0.0)
    say(f"[msa {kind} check] float32 losses of steps 1-3, GPU {losses['gpu']}, CPU "
        f"{losses['cpu']}: relative {rel} (tolerances {MSA_LOSS_RTOL}, then "
        f"{TRAIN_LATER_RTOL}); padded tail ({real_rows} real rows of {UTT_BATCH}) from the "
        f"same weights: GPU {pad_loss['gpu']}, CPU {pad_loss['cpu']} (relative "
        f"{pad_rel:.3e}); step-1 gradients, {len(err)} parameters: worst "
        f"{max(err.values()):.3e} of its norm (tolerance {MSA_GRAD_TOL}), whole {whole:.3e}, "
        f"worst {_worst(err)}; {len(zero)} with an exact gradient of 0: largest "
        f"{zero_err:.3e} of the whole gradient's norm"
        + (f"; schedule after 3 steps GPU { {k: v.tolist() for k, v in scheds['gpu'].items()} }"
           f", CPU { {k: v.tolist() for k, v in scheds['cpu'].items()} } (beta, eta relative "
           f"{sched_err:.3e}, tolerance {MSA_SCHED_TOL})" if kind == "redcore" else "")
        + "; TF32 off")
    if rel[0] > MSA_LOSS_RTOL or pad_rel > MSA_LOSS_RTOL or max(rel[1:]) > TRAIN_LATER_RTOL:
        raise AssertionError(f"[msa {kind} check] GPU and CPU losses differ: {rel}, padded "
                             f"{pad_rel}")
    if max(err.values()) > MSA_GRAD_TOL or zero_err > MSA_GRAD_TOL:
        raise AssertionError(f"[msa {kind} check] step-1 gradients differ by "
                             f"{max(err.values())} of their norm ({_worst(err)}); exact "
                             f"zeros {zero_err}")
    if kind == "redcore" and (sched_err > MSA_SCHED_TOL
                              or int(scheds["gpu"]["iter_count"]) != 3
                              or int(scheds["cpu"]["iter_count"]) != 3):
        raise AssertionError(f"[msa redcore check] schedules differ: {scheds}")
    return {"loss_rel": rel, "pad_loss_rel": pad_rel, "grad_err": max(err.values()),
            "zero_grad_err": zero_err, "sched_err": sched_err}


def _run_msa_cli(cfg_path: Path, tag: str, out_root: Path, name: str) -> dict:
    """`train_multimodal.main` on the card; what the MSA driver writes (the
    epoch records and test_metrics.json: mmtpu's driver writes no report)."""
    import torch

    from mmtpu_torch.cli import train_multimodal

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = train_multimodal.main(["--config", str(cfg_path), "--run_id", "1"])
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{tag}: exit code {rc}")
    metrics = out_root / name / "metrics" / "1"
    records = json.loads((metrics / "epoch_metrics.json").read_text())
    epochs = [e for e in records if "epoch" in e]
    test = json.loads((metrics / "test_metrics.json").read_text())
    if len(epochs) != TRAIN_EPOCHS or "test" not in records[-1] or len(test) != 1:
        raise AssertionError(f"{tag}: {len(epochs)} epochs, test entry "
                             f"{'test' in records[-1]}, {len(test)} test records")
    losses = [(e["train"]["loss"], e["validation"]["loss"]) for e in epochs]
    accs = [e["validation"]["metrics"] for e in epochs]
    want = {f"accuracy_{p.upper()}" for p in MSA_EVAL_PATTERNS}
    if set(accs[-1]) != want or not all(np.isfinite(v) for pair in losses for v in pair):
        raise AssertionError(f"{tag}: losses {losses}, validation metrics {accs}")
    train_s = epochs[-1]["train"]["timing"]["total_time"]
    models = sorted(p.name for p in (out_root / name / "models" / "1").iterdir())
    if not {"best.pth", "last.pth", "epoch_1.pth"} <= set(models):
        raise AssertionError(f"{tag}: checkpoints {models}")
    return {"seconds": seconds, "peak_bytes": torch.cuda.max_memory_allocated(),
            "losses": losses, "validation": accs, "test": test[0], "models": models,
            "samples_per_s": UTT_SAMPLES["train"] / train_s, "epoch_s": train_s}


def phase_msa(dev, card: str, work: Path, teacher: Path) -> dict:
    """MMIN (with phase 6's UttFusion as its frozen teacher) and RedCore
    through `train_multimodal.main` on the card: `lstm` counted against the
    loader's batches (MMIN 3 per train batch, 1 per evaluation batch; RedCore
    none), `fused_mlp` never; the teacher's state hash equal to its file's
    before and after the run; then a profiled window and the GPU-vs-CPU
    check of each."""
    import torch

    from mmtpu_torch.train import mmin_step

    out_root = work / "msa"
    paths, check_paths = {}, {}
    for check, target in ((False, paths), (True, check_paths)):
        for kind, cfg in msa_configs(str(out_root), teacher, check=check).items():
            target[kind] = work / f"msa_{kind}{'_check' if check else ''}.json"
            target[kind].write_text(json.dumps(cfg))
    in_file = _state_hash(torch.load(teacher, map_location="cpu", weights_only=True)["model"])

    teachers = []
    real_post = mmin_step.MMINTask.__post_init__

    def spy(task):  # the teacher as restored, before any step
        real_post(task)
        teachers.append((task.teacher_model, _state_hash(task.teacher_model.state_dict())))

    results = {}
    n = msa_batches()
    for kind in ("mmin", "redcore"):
        teachers.clear()
        mmin_step.MMINTask.__post_init__ = spy
        reset_counts()
        try:
            run = _run_msa_cli(paths[kind], f"[msa {kind}]", out_root, MSA_NAMES[kind])
        finally:
            mmin_step.MMINTask.__post_init__ = real_post
        counts = read_counts()
        want = {"fused_mlp": 0, "lstm": msa_expected_lstm(kind)}
        if counts != want:
            raise AssertionError(f"[msa {kind}] launches {counts}, expected {want} "
                                 f"(batches {n})")
        hashes = ""
        if kind == "mmin":
            (teacher_model, before), = teachers
            after = _state_hash(teacher_model.state_dict())
            if not before == after == in_file:
                raise AssertionError(f"[msa mmin] teacher hash: file {in_file}, restored "
                                     f"{before}, after the run {after}")
            hashes = f"; teacher state sha256 {after[:16]} = its file's, unchanged by the run"
        say_card(card, f"[msa {kind}] {run['seconds']:.2f} s through train_multimodal.main "
                 f"(start-up, data and checkpoints included); epoch {TRAIN_EPOCHS} train "
                 f"{run['epoch_s']:.3f} s = {run['samples_per_s']:.1f} samples/s (B={UTT_BATCH}, "
                 f"T=50, {UTT_SAMPLES['train']} samples); peak device memory "
                 f"{run['peak_bytes'] / 2**20:.1f} MiB")
        say(f"[msa {kind}] launches {counts} (lstm expected {want['lstm']}: {TRAIN_EPOCHS} × "
            f"(3 × {n['train']} train + {n['validation']} validation) + {n['test']} test "
            f"batches for MMIN, none for RedCore){hashes}; losses {run['losses']}; "
            f"validation {run['validation']}; test {run['test']}; checkpoints {run['models']}")
        profile = phase_msa_profile(dev, card, kind, paths[kind])
        check = phase_msa_check(dev, kind, check_paths[kind])
        results[kind] = {"run": run, "launches": counts, "profile": profile, "check": check}
    return results


def msa_teacher(work: Path) -> Path:
    """The teacher for `--msa-only`: phase 6's UttFusion model with seeded
    weights, saved as its training checkpoint's best.pth would be."""
    import torch

    from mmtpu_torch.cli import common
    from mmtpu_torch.config import ModelConfig

    model = common.init_model(common.build_model_from_config(
        ModelConfig.from_dict(mosi_smoke_config()["model"])), SEED, torch.device("cpu"))
    path = work / "train_utt" / UTT_NAME / "models/1/best.pth"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"model": model.state_dict(), "optimizer": {}, "step": 0}, path)
    return path


def say_msa(card: str, msa: dict, seconds: float) -> None:
    say_card(card, "[summary] MSA: " + "; ".join(
        f"{kind} {r['run']['samples_per_s']:.1f} train samples/s (epoch {TRAIN_EPOCHS}), "
        f"{r['run']['seconds']:.2f} s through main, launches {r['launches']}, "
        f"{r['profile']['device_ms_per_step']:.3f} ms of device work and "
        f"{r['profile']['wall_ms_per_step']:.3f} ms of wall per step, "
        f"{r['profile']['kernels_per_step']:.1f} device kernels per step, busy share "
        f"{r['profile']['busy_share']:.3f}" for kind, r in msa.items())
        + f"; phase {seconds:.1f} s")


# -- phase 11: Self-MM and MM-IMDb -------------------------------------------------------

SELF_MM_NAMES = {"frozen": "Synthetic_MOSI_SelfMM_Frozen",
                 "finetune": "Synthetic_MOSI_SelfMM_Finetune"}
# BERT-base (MMSA config_regression.json, self_mm on mosi: text_out 768)
BERT_SIZES = {"hidden_size": 768, "num_hidden_layers": 12, "num_attention_heads": 12}
SELF_MM_LSTM_PER_BATCH = 2  # the audio and the video AuViSubNet, one launch each
SELF_MM_LOSS_RTOL = 1e-5  # step 1 and the padded tail, GPU (TF32 off) vs CPU, float32
SELF_MM_GRAD_TOL = 1e-4  # of each parameter's gradient norm, step 1
SELF_MM_BANK_TOL = 1e-5  # the banks after an epoch-2 step from the same banks and weights
MMIMDB_NAME = "Synthetic_MMIMDb_GMU"
MMIMDB_SAMPLES = {"train": 15552, "validation": 2608, "test": 7799}  # MM-IMDb's splits
MMIMDB_BATCH = 64
MMIMDB_PATTERNS = ["it", "i", "t"]
MMIMDB_PAD_ROWS = 48  # the check's padded tail: 16 real rows of 64
MMIMDB_LOSS_RTOL = 1e-5
MMIMDB_GRAD64_TOL = 1e-6  # float64 gradients, GPU vs CPU, of each parameter's norm
MMIMDB_REQUESTS = 24


def self_mm_config(out_root: str, kind: str, bert_dir: Optional[Path] = None,
                   check: bool = False) -> dict:
    """A plain-dict twin of configs/mosi/synthetic_self_mm.yaml at the widths
    of MMSA's config_regression.json for self_mm on mosi: BERT-base text
    (768 wide, 12 layers, 12 heads), AuViSubNet audio 5→16 and video 20→32
    (1 layer, unidirectional, dropout 0), post dims 128 / 32 / 16 / 32 and
    dropouts 0.1 / 0.0 / 0.1 / 0.0 (fusion / text / audio / video), H 3;
    `need_data_aligned: false`. `frozen`: the file's fresh BERT
    (`pretrained_path: ""`), frozen; `finetune`: `use_finetune: true` from
    the HF directory `bert_dir`. synthetic_mosi in `text_mode: bert` at
    CMU-MOSI's split sizes (the file's 64 / 32 / 32), T = 50, batch 32, 2
    epochs, the file's `atv` evaluation, Adam 1e-3 and `l1`. `check=True`
    sets the post dropouts to 0 (the GPU-vs-CPU check)."""
    def split(name, n, evaluated):
        out = {"dataset": "synthetic_mosi", "data_fp": "unused", "split": name,
               "target_modality": "MULTIMODAL", "batch_size": UTT_BATCH,
               "kwargs": {"num_samples": n, "labels_key": "regression_labels",
                          "text_mode": "bert"}}
        if evaluated:
            out["missing_patterns"] = {
                "modalities": {m: {"missing_rate": 0.0} for m in ("audio", "video", "text")},
                "selected_patterns": ["atv"]}
        else:
            out["shuffle"] = True
        return out

    drop = 0.0 if check else 0.1
    name = SELF_MM_NAMES[kind]
    return {
        "experiment": {"name": name, "seed": SEED, "device": "tpu", "is_train": True,
                       "is_test": True},
        "model": {
            "name": "Self_MM", "model_type": "self-mm",
            "audio_encoder": {"__module_spec__": "auvi_subnet", "in_size": 5,
                              "hidden_size": 16, "out_size": 16, "dropout": 0.0},
            "video_encoder": {"__module_spec__": "auvi_subnet", "in_size": 20,
                              "hidden_size": 32, "out_size": 32, "dropout": 0.0},
            "text_encoder": {"__module_spec__": "bert_text_encoder",
                             "pretrained_path": str(bert_dir) if bert_dir else "",
                             "use_finetune": kind == "finetune", **BERT_SIZES},
            "need_data_aligned": False, "audio_out": 16, "video_out": 32, "text_out": 768,
            "post_fusion_dropout": drop, "post_fusion_dim": 128,
            "post_text_dropout": 0.0, "post_text_dim": 32,
            "post_audio_dropout": drop, "post_audio_dim": 16,
            "post_video_dropout": 0.0, "post_video_dim": 32, "H": 3.0,
        },
        "training": {"epochs": TRAIN_EPOCHS, "early_stopping": False, "num_modalities": 3,
                     "optimizer": {"name": "Adam", "default_kwargs": {"lr": 0.001}},
                     "loss_functions": {"l1": {"loss_name": "l1", "weight": 1.0}}},
        "data": {"datasets": {"train": split("train", UTT_SAMPLES["train"], False),
                              "validation": split("valid", UTT_SAMPLES["validation"], True),
                              "test": split("test", UTT_SAMPLES["test"], True)}},
        "metrics": {"metrics": {"mosei": {"function": "metrics.mosei_regression",
                                          "kwargs": {}}},
                    "groups": {"regression": ["mosei"]}},
        "logging": {
            "log_path": f"{out_root}/{{experiment_name}}/logs/{{run_id}}",
            "model_output_path": f"{out_root}/{{experiment_name}}/models/{{run_id}}",
            "metrics_path": f"{out_root}/{{experiment_name}}/metrics/{{run_id}}",
            "save_metric": "loss",
        },
        "monitoring": {"enabled": False},
    }


def write_bert_dir(root: Path, dropout: float, weights: Optional[Path] = None) -> Path:
    """An HF-style BERT-base directory: `config.json` (the given dropouts)
    and `pytorch_model.bin` under HF's `BertModel` key names, drawn from the
    seed as flax's BERT draws a fresh one; `weights` links an existing
    `.bin` instead of writing it again."""
    import dataclasses

    import torch

    from mmtpu_torch.models import seeded_init
    from mmtpu_torch.models.bert_text import BertConfig, BertModel

    cfg = BertConfig(**BERT_SIZES, hidden_dropout_prob=dropout,
                     attention_probs_dropout_prob=dropout)
    root.mkdir(parents=True, exist_ok=True)
    (root / "config.json").write_text(json.dumps(
        {"architectures": ["BertModel"], "model_type": "bert", **dataclasses.asdict(cfg)}))
    if weights is not None:
        (root / "pytorch_model.bin").symlink_to(weights)
    else:
        torch.save(seeded_init(BertModel(cfg), SEED).state_dict(), root / "pytorch_model.bin")
    return root / "pytorch_model.bin"


def self_mm_batches() -> dict:
    return {s: -(-UTT_SAMPLES[s] // UTT_BATCH) for s in ("train", "validation", "test")}


def self_mm_expected_lstm() -> int:
    """Two launches per train, validation and test batch: 2 × (2 × (41 + 8) + 22)."""
    n = self_mm_batches()
    return SELF_MM_LSTM_PER_BATCH * (TRAIN_EPOCHS * (n["train"] + n["validation"]) + n["test"])


def _self_mm_setup(cfg_path: Path, device):
    """The config, Self-MM's train state as its driver assembles it, banks
    prefilled from the train loader, and the train step."""
    from mmtpu_torch.cli import train_self_mm
    from mmtpu_torch.train.managers import ManagerState
    from mmtpu_torch.train.self_mm_step import init_manager_labels, make_self_mm_train_step

    cfg = _msa_config(cfg_path)
    model, task, state = train_self_mm.assemble(cfg, device)
    banks = ManagerState.create(UTT_SAMPLES["train"], train_self_mm.bank_dims(cfg),
                                device=device)
    init_manager_labels(banks, cfg.data.build_loader("train", seed=cfg.experiment.seed))
    return cfg, model, banks, make_self_mm_train_step(task, state, device)


@contextlib.contextmanager
def _captured_banks():
    """The banks `train_self_mm.run` creates, kept for inspection."""
    from mmtpu_torch.train import managers

    made = []
    real = managers.ManagerState.create.__func__

    def spy(cls, *args, **kwargs):
        made.append(real(cls, *args, **kwargs))
        return made[-1]

    managers.ManagerState.create = classmethod(spy)
    try:
        yield made
    finally:
        managers.ManagerState.create = classmethod(real)


def _bank_tensors(banks) -> dict:
    return {f"{field}/{m}": t for field in ("features", "labels", "centers_pos", "centers_neg")
            for m, t in getattr(banks, field).items()}


def phase_self_mm_profile(dev, card: str, kind: str, cfg_path: Path, steps: int = 8,
                          warmup: int = 3) -> dict:
    """A window of epoch-2 train steps (the refinement included) under the profiler."""
    import torch

    cfg, _, banks, step = _self_mm_setup(cfg_path, dev)
    it = iter(cfg.data.build_loader("train", seed=cfg.experiment.seed))
    batches = [next(it) for _ in range(warmup + steps)]
    for b in batches[:warmup]:
        step(banks, b, 1)
    torch.cuda.synchronize()
    reset_counts()
    brk = device_breakdown(lambda: [step(banks, b, 2) for b in batches[warmup:]], top=8)
    counts = read_counts()
    busy = brk["device_ms"] / brk["profiled_wall_ms"]
    say_card(card, f"[self-mm {kind} profile] {steps} epoch-2 train steps (B={UTT_BATCH}, "
             f"T=50, BERT-base): device {brk['device_ms'] / steps:.3f} ms per step, wall "
             f"{brk['profiled_wall_ms'] / steps:.3f} ms per step, busy share {busy:.3f}; "
             f"{brk['kernel_events'] / steps:.1f} device kernels and "
             f"{brk['launch_calls'] / steps:.1f} launch calls per step; launches {counts}; "
             f"top device operations (name, ms, count) {brk['top']}; top host operations "
             f"(name, ms, count) {brk['top_host']}")
    want = {"fused_mlp": 0, "lstm": SELF_MM_LSTM_PER_BATCH * steps}
    if counts != want:
        raise AssertionError(f"[self-mm {kind} profile] launches {counts}, expected {want}")
    return {"busy_share": busy, "device_ms_per_step": brk["device_ms"] / steps,
            "wall_ms_per_step": brk["profiled_wall_ms"] / steps,
            "kernels_per_step": brk["kernel_events"] / steps,
            "launch_calls_per_step": brk["launch_calls"] / steps}


def _copy_banks(src, dst) -> None:
    source = _bank_tensors(src)
    for key, t in _bank_tensors(dst).items():
        t.copy_(source[key])


def phase_self_mm_check(dev, kind: str, cfg_path: Path) -> dict:
    """From the same initial weights and banks (post dropouts 0; the
    fine-tuned BERT's dropouts 0 from its check directory; TF32 off;
    float32) on the card and on the CPU: the first three train steps' losses
    and the step-1 gradients of every parameter against its norm (those
    whose exact gradient is 0 — a frozen BERT, the pooler, the attention key
    biases — against the whole gradient's norm); then from the CPU's weights
    and banks after step 3 the train split's padded tail (4 real rows of 32)
    on both; then, again from the same weights and banks, one step at epoch
    2 (the label refinement) and the banks after it."""
    import torch

    cpu = torch.device("cpu")
    cfg = _msa_config(cfg_path)
    batches = list(cfg.data.build_loader("train", seed=cfg.experiment.seed))
    padded = batches[-1]
    real_rows = int(padded["sample_mask"].sum())
    if real_rows != UTT_SAMPLES["train"] % UTT_BATCH:
        raise AssertionError(f"the train split's last batch holds {real_rows} real rows")

    def grads_of(model):
        return {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}

    runs, losses, grads = {}, {}, {}
    for label, device in (("gpu", dev), ("cpu", cpu)):
        _, model, banks, step = _self_mm_setup(cfg_path, device)
        losses[label] = []
        for b in batches[:3]:
            losses[label].append(float(step(banks, b, 1)["loss"]))
            grads.setdefault(label, grads_of(model))
        runs[label] = (model, banks, step)

    def sync_gpu_to_cpu():
        runs["gpu"][0].load_state_dict(runs["cpu"][0].state_dict())
        _copy_banks(runs["cpu"][1], runs["gpu"][1])

    sync_gpu_to_cpu()
    pad_loss = {label: float(step(banks, padded, 1)["loss"])
                for label, (_, banks, step) in runs.items()}
    sync_gpu_to_cpu()
    for label, (_, banks, step) in runs.items():
        step(banks, batches[3], 2)
    bank_err = {key: (t.cpu() - ref).abs().max().item() / max(1.0, ref.abs().max().item())
                for (key, t), ref in zip(_bank_tensors(runs["gpu"][1]).items(),
                                         _bank_tensors(runs["cpu"][1]).values())}
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["gpu"], losses["cpu"])]
    pad_rel = abs(pad_loss["gpu"] - pad_loss["cpu"]) / abs(pad_loss["cpu"])
    norm_all = float(np.sqrt(sum(float(g.double().square().sum()) for g in grads["cpu"].values())))
    zero = {n for n, w in grads["cpu"].items()
            if n.endswith("attention.self.key.bias") or w.double().norm().item() <= 1e-9 * norm_all}
    err = _grad_errors({n: g for n, g in grads["gpu"].items() if n not in zero},
                       {n: g for n, g in grads["cpu"].items() if n not in zero})
    zero_err = max([max(grads["gpu"][n].double().abs().max().item(),
                        grads["cpu"][n].double().abs().max().item()) / norm_all
                    for n in zero], default=0.0)
    bert = [n for n in err if ".bert." in n]
    say(f"[self-mm {kind} check] float32 losses of steps 1-3, GPU {losses['gpu']}, CPU "
        f"{losses['cpu']}: relative {rel} (tolerances {SELF_MM_LOSS_RTOL}, then "
        f"{TRAIN_LATER_RTOL}); padded tail ({real_rows} real rows of {UTT_BATCH}) from the "
        f"same weights and banks: GPU {pad_loss['gpu']}, CPU {pad_loss['cpu']} (relative "
        f"{pad_rel:.3e}); step-1 gradients, {len(err)} parameters ({len(bert)} of BERT): "
        f"worst {max(err.values()):.3e} of its norm (tolerance {SELF_MM_GRAD_TOL}), BERT's "
        f"worst {max([err[n] for n in bert], default=0.0):.3e}, worst {_worst(err)}; "
        f"{len(zero)} with an exact gradient of 0: largest {zero_err:.3e} of the whole "
        f"gradient's norm; banks after an epoch-2 step from the same banks and weights: "
        f"worst {max(bank_err.values()):.3e} (tolerance {SELF_MM_BANK_TOL}), worst "
        f"{_worst(bank_err)}; TF32 off")
    if rel[0] > SELF_MM_LOSS_RTOL or pad_rel > SELF_MM_LOSS_RTOL or max(rel[1:]) > TRAIN_LATER_RTOL:
        raise AssertionError(f"[self-mm {kind} check] GPU and CPU losses differ: {rel}, "
                             f"padded {pad_rel}")
    if max(err.values()) > SELF_MM_GRAD_TOL or zero_err > SELF_MM_GRAD_TOL:
        raise AssertionError(f"[self-mm {kind} check] step-1 gradients differ by "
                             f"{max(err.values())} of their norm ({_worst(err)}); exact zeros "
                             f"{zero_err}")
    if kind == "finetune" and not bert:
        raise AssertionError("[self-mm finetune check] BERT took no gradient")
    if max(bank_err.values()) > SELF_MM_BANK_TOL:
        raise AssertionError(f"[self-mm {kind} check] banks differ: {_worst(bank_err)}")
    return {"loss_rel": rel, "pad_loss_rel": pad_rel, "grad_err": max(err.values()),
            "zero_grad_err": zero_err, "bank_err": max(bank_err.values())}


def phase_self_mm(dev, card: str, work: Path) -> dict:
    """Both Self-MM twins through `train_multimodal.main` on the card: `lstm`
    counted against the loader's batches (2 per train, validation and test
    batch), `fused_mlp` never; the banks after the run finite, on the card,
    the labels within ±H; the checkpoints' size; then a profiled window and
    the GPU-vs-CPU check of each."""
    import torch

    out_root = work / "self_mm"
    weights = write_bert_dir(work / "bert_run", 0.1)
    bert_dirs = {"run": weights.parent,
                 "check": write_bert_dir(work / "bert_check", 0.0, weights).parent}
    n = self_mm_batches()
    results = {}
    for kind in ("frozen", "finetune"):
        paths = {}
        for check in (False, True):
            bert = bert_dirs["check" if check else "run"] if kind == "finetune" else None
            paths[check] = work / f"self_mm_{kind}{'_check' if check else ''}.json"
            paths[check].write_text(json.dumps(self_mm_config(str(out_root), kind, bert,
                                                              check=check)))
        from mmtpu_torch.cli import train_multimodal

        reset_counts()
        with _captured_banks() as made:
            run = _run_cli(train_multimodal, paths[False], f"[self-mm {kind}]", out_root,
                           SELF_MM_NAMES[kind], train_samples=UTT_SAMPLES["train"])
        counts = read_counts()
        want = {"fused_mlp": 0, "lstm": self_mm_expected_lstm()}
        if counts != want:
            raise AssertionError(f"[self-mm {kind}] launches {counts}, expected {want} "
                                 f"(batches {n})")
        (banks,) = made
        tensors = _bank_tensors(banks)
        labels = torch.stack([banks.labels[m] for m in ("audio", "video", "text")])
        if (not all(t.device.type == dev.type and torch.isfinite(t).all()
                    for t in tensors.values())
                or labels.abs().max().item() > 3.0
                or torch.equal(banks.labels["audio"], banks.labels["multimodal"])):
            raise AssertionError(f"[self-mm {kind}] banks after the run: "
                                 f"{ {k: (t.device.type, bool(torch.isfinite(t).all())) for k, t in tensors.items()} }, "
                                 f"largest unimodal label {labels.abs().max().item()}")
        sizes = {p.name: p.stat().st_size for p in run["models"].glob("*.pth")}
        test_atv = {k: round(v, 4) for k, v in sorted(run["test"].items()) if k.endswith("_ATV")}
        say_card(card, f"[self-mm {kind}] {run['seconds']:.2f} s through train_multimodal.main "
                 f"(start-up, BERT, data and checkpoints included); epoch {TRAIN_EPOCHS} train "
                 f"{run['epoch_s']:.3f} s = {run['samples_per_s']:.1f} samples/s (B={UTT_BATCH}, "
                 f"T=50, {UTT_SAMPLES['train']} samples); peak device memory "
                 f"{run['peak_bytes'] / 2**20:.1f} MiB; checkpoints "
                 f"{ {k: round(v / 2**20, 1) for k, v in sorted(sizes.items())} } MiB")
        say(f"[self-mm {kind}] launches {counts} (lstm expected {want['lstm']}: "
            f"{SELF_MM_LSTM_PER_BATCH} × ({TRAIN_EPOCHS} × ({n['train']} train + "
            f"{n['validation']} validation) + {n['test']} test batches)); banks finite on "
            f"the card, unimodal labels within ±3 (largest {labels.abs().max().item():.4f}), "
            f"refined away from the fusion labels; losses {run['losses']}; test {test_atv}")
        shutil.rmtree(out_root / SELF_MM_NAMES[kind], ignore_errors=True)  # ~1.3 GB each
        profile = phase_self_mm_profile(dev, card, kind, paths[False])
        check = phase_self_mm_check(dev, kind, paths[True])
        results[kind] = {"run": run, "launches": counts, "profile": profile, "check": check,
                         "checkpoint_bytes": sizes}
    return results


def mmimdb_config(out_root: str) -> dict:
    """configs/mmimdb/synthetic_gmu.yaml as it is (4096-wide VGG image and
    300-wide word2vec text features, encoders to 512, GMU 512, MaxOut genre
    classifier 512→512→23, Adam 1e-4 with L2 1e-3, `bce_with_logits`, the
    F1 metrics, batch 64, 2 epochs), at MM-IMDb's split sizes (the file's
    256 / 64 / 64)."""
    def split(name, n, patterns, **extra):
        return {"dataset": "synthetic_mmimdb", "data_fp": "unused", "split": name,
                "target_modality": "MULTIMODAL", "batch_size": MMIMDB_BATCH, **extra,
                "kwargs": {"num_samples": n},
                "missing_patterns": {
                    "modalities": {m: {"missing_rate": 0.0} for m in ("text", "image")},
                    "selected_patterns": patterns}}

    f1 = {f"f1_{avg}": {"function": "sklearn.metrics.f1_score",
                        "kwargs": {"average": avg, "zero_division": 0}}
          for avg in ("samples", "macro", "micro")}
    return {
        "experiment": {"name": MMIMDB_NAME, "seed": SEED, "device": "tpu", "is_train": True,
                       "is_test": True},
        "model": {
            "name": "MMIMDb", "model_type": "MMIMDb",
            "image_encoder": {"__module_spec__": "mmimdb_modality_encoder", "input_dim": 4096,
                              "output_dim": 512},
            "text_encoder": {"__module_spec__": "mmimdb_modality_encoder", "input_dim": 300,
                             "output_dim": 512},
            "gated_bimodal_network": {"__module_spec__": "gated_bimodal", "input_one_dim": 512,
                                      "output_one_dim": 512, "input_two_dim": 512,
                                      "output_two_dim": 512},
            "classifier": {"__module_spec__": "mlp_genre_classifier", "input_size": 512,
                           "hidden_size": 512, "output_size": 23},
        },
        "training": {"epochs": TRAIN_EPOCHS, "early_stopping": False,
                     "early_stopping_patience": 5, "num_modalities": 2,
                     "optimizer": {"name": "Adam", "default_kwargs": {"lr": 0.0001,
                                                                      "weight_decay": 0.001}},
                     "loss_functions": {"bce": {"loss_name": "bce_with_logits", "loss_args": {},
                                                "weight": 1.0}}},
        "data": {"datasets": {
            "train": split("train", MMIMDB_SAMPLES["train"], ["it"], shuffle=True),
            "validation": split("valid", MMIMDB_SAMPLES["validation"], MMIMDB_PATTERNS),
            "test": split("test", MMIMDB_SAMPLES["test"], MMIMDB_PATTERNS)}},
        "metrics": {"metrics": f1, "groups": {"classification": list(f1)}},
        "logging": {
            "log_path": f"{out_root}/{{experiment_name}}/logs/{{run_id}}",
            "model_output_path": f"{out_root}/{{experiment_name}}/models/{{run_id}}",
            "metrics_path": f"{out_root}/{{experiment_name}}/metrics/{{run_id}}",
            "save_metric": "loss",
        },
        "monitoring": {"enabled": False},
    }


def mmimdb_batches() -> dict:
    n = len(MMIMDB_PATTERNS)
    return {"train": -(-MMIMDB_SAMPLES["train"] // MMIMDB_BATCH),
            **{s: -(-MMIMDB_SAMPLES[s] * n // MMIMDB_BATCH) for s in ("validation", "test")}}


def phase_mmimdb_check(dev, cfg_path: Path) -> dict:
    """The first three train steps from the same initial weights (the
    classifier's dropout neutralised, TF32 off) on the card and on the CPU,
    then a step on a batch with a zero-padded tail from the CPU's weights:
    float32 losses; the gradients of step 1 and of the padded step in
    float64 on both devices (BatchNorm is on the path: in float32 its
    backward's cancellation would hide a fault, as in the AVMNIST check)."""
    import torch

    cfg, batches = _train_batches(cfg_path, 3)
    padded = {k: v.copy() for k, v in batches[2].items()}
    for k in ("image", "text", "labels", "image_mask", "text_mask", "sample_mask"):
        padded[k][MMIMDB_BATCH - MMIMDB_PAD_ROWS:] = 0
    cpu = torch.device("cpu")

    def grads_of(model):
        return {n: p.grad.detach().cpu() for n, p in model.named_parameters()}

    def float64_step(device, batch, weights=None):
        model, _, step = _training_setup(cfg, device)
        model.double()
        if weights is not None:
            model.load_state_dict(weights)
        with _float64_losses():
            step(_as_float64(batch))
        return grads_of(model)

    with _msa_neutralised():
        models, losses = {}, {}
        for label, device in (("gpu", dev), ("cpu", cpu)):
            model, _, step = _training_setup(cfg, device)
            losses[label] = [float(step(b)["loss"]) for b in batches]
            models[label] = (model, step)
        weights = models["cpu"][0].state_dict()
        models["gpu"][0].load_state_dict(weights)
        pad_loss = {label: float(step(padded)["loss"]) for label, (_, step) in models.items()}
        grads64 = {label: (float64_step(device, batches[0]),
                           float64_step(device, padded, weights))
                   for label, device in (("gpu", dev), ("cpu", cpu))}
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["gpu"], losses["cpu"])]
    pad_rel = abs(pad_loss["gpu"] - pad_loss["cpu"]) / abs(pad_loss["cpu"])
    worst = 0.0
    for i, tag in enumerate(("step 1", "padded step")):
        err64 = _grad_errors(grads64["gpu"][i], grads64["cpu"][i])
        worst = max(worst, max(err64.values()))
        say(f"[mmimdb check] {tag} float64 gradients, GPU vs CPU: worst parameter "
            f"{max(err64.values()):.3e} of its norm (tolerance {MMIMDB_GRAD64_TOL}), whole "
            f"{_whole_error(grads64['gpu'][i], grads64['cpu'][i]):.3e}; worst {_worst(err64)}")
    say(f"[mmimdb check] float32 losses of steps 1-3, GPU {losses['gpu']}, CPU {losses['cpu']}: "
        f"relative {rel} (tolerances {MMIMDB_LOSS_RTOL}, then {TRAIN_LATER_RTOL}); padded tail "
        f"({MMIMDB_BATCH - MMIMDB_PAD_ROWS} real rows of {MMIMDB_BATCH}) from the same weights: "
        f"GPU {pad_loss['gpu']}, CPU {pad_loss['cpu']} (relative {pad_rel:.3e}); TF32 off")
    if rel[0] > MMIMDB_LOSS_RTOL or pad_rel > MMIMDB_LOSS_RTOL or max(rel[1:]) > TRAIN_LATER_RTOL:
        raise AssertionError(f"[mmimdb check] GPU and CPU losses differ: {rel}, padded {pad_rel}")
    if worst > MMIMDB_GRAD64_TOL:
        raise AssertionError(f"[mmimdb check] float64 gradients differ by {worst} of their norm")
    return {"loss_rel": rel, "pad_loss_rel": pad_rel, "grad64_err": worst}


def phase_mmimdb_predict(dev, card: str, cfg_path: Path, work: Path) -> dict:
    """`predict` on the run's best checkpoint on the card; the same test
    batches' logits on the CPU (1e-3 absolute, TF32 off) and predictions
    equal wherever |sigmoid − 0.5| is clear of the difference; then the
    server: multilabel answers against the Predictor, a request without
    `text` refused with 400."""
    import torch

    from mmtpu_torch.cli import predict, serve
    from mmtpu_torch.train.step import make_eval_step

    out_json = work / "predictions_mmimdb.json"
    args = predict.arg_parser().parse_args(["--config", str(cfg_path), "--run_id", "1",
                                            "--out", str(out_json)])
    reset_counts()
    t0 = time.perf_counter()
    _, records, summary = predict.run(args)
    seconds = time.perf_counter() - t0
    counts = read_counts()
    visits = MMIMDB_SAMPLES["test"] * len(MMIMDB_PATTERNS)
    if (len(records) != visits or set(summary) != set(MMIMDB_PATTERNS)
            or len(records[0]["pred"]) != 23 or counts != {"fused_mlp": 0, "lstm": 0}):
        raise AssertionError(f"[mmimdb predict] {len(records)} records, patterns {summary}, "
                             f"launches {counts}")
    cfg = _msa_config(cfg_path)
    tasks = {label: predict.build_task_and_loader(cfg, args, device)
             for label, device in (("gpu", dev), ("cpu", torch.device("cpu")))}
    gpu_step = make_eval_step(tasks["gpu"][0], dev)
    cpu_step = make_eval_step(tasks["cpu"][0], torch.device("cpu"))
    worst, checked, clear_rows = 0.0, 0, 0
    for batch in tasks["gpu"][1]:
        g, c = gpu_step(batch), cpu_step(batch)
        gl, cl = g["logits"].cpu(), c["logits"]
        if gl.shape != (MMIMDB_BATCH, 23) or not torch.isfinite(gl).all():
            raise AssertionError(f"[mmimdb predict] logits {tuple(gl.shape)} not finite")
        worst = max(worst, (gl - cl).abs().max().item())
        clear = (torch.sigmoid(cl) - 0.5).abs() > 2 * CPU_TOL
        if not torch.equal(g["preds"].cpu()[clear], c["preds"][clear]):
            raise AssertionError("[mmimdb predict] GPU and CPU predictions differ")
        checked += 1
        clear_rows += int(clear.sum())
    say_card(card, f"[mmimdb predict] {len(records)} visits ({len(MMIMDB_PATTERNS)} patterns "
             f"× {MMIMDB_SAMPLES['test']}) in {seconds:.3f} s through predict.run "
             f"({len(records) / seconds:.1f} visits/s, start-up included); per-pattern exact "
             f"match {summary}; launches {counts}; GPU vs CPU logits over {checked} batches: "
             f"max |diff| {worst:.3e} (tolerance {CPU_TOL}), {clear_rows} clear flags equal")
    if worst > CPU_TOL:
        raise AssertionError(f"[mmimdb predict] GPU vs CPU logits differ by {worst}")

    predictor, meta = serve.load_model(serve.arg_parser().parse_args(
        ["--config", str(cfg_path), "--run_id", "1"]))
    g = np.random.default_rng(SEED)
    inputs = {"image": g.normal(size=(MMIMDB_REQUESTS, 4096)).astype(np.float32),
              "text": g.normal(size=(MMIMDB_REQUESTS, 300)).astype(np.float32)}
    inputs["text"][::3] = 0.0  # text missing
    inputs["image"][1::3] = 0.0  # image missing
    direct = predictor(**inputs)
    with serve.ServerThread(predictor, meta, max_batch=64, max_wait_ms=5.0) as st:
        got_meta = _get(f"{st.url}/meta")
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=8) as pool:
            answers = list(pool.map(lambda i: _post(f"{st.url}/predict", json.dumps(
                {k: inputs[k][i].tolist() for k in ("image", "text")}).encode()),
                range(MMIMDB_REQUESTS)))
        serve_s = time.perf_counter() - t0
        try:
            _post(f"{st.url}/predict", json.dumps({"image": inputs["image"][0].tolist()}).encode())
            refused = None
        except urllib.error.HTTPError as e:
            refused = e.code
            e.close()
    if not got_meta.get("multilabel") or refused != 400:
        raise AssertionError(f"[mmimdb serve] /meta {got_meta}, request without text → {refused}")
    serve_err = 0.0
    for i, ans in enumerate(answers):
        serve_err = max(serve_err, float(np.abs(np.asarray(ans["logits"])
                                                - direct["logits"][i]).max()))
        clear = np.abs(direct["probs"][i] - 0.5) > 2 * SERVE_TOL
        if len(ans["preds"]) != 23 or not np.array_equal(np.asarray(ans["preds"])[clear],
                                                         direct["preds"][i][clear]):
            raise AssertionError(f"[mmimdb serve] row {i}: preds {ans['preds']}")
    say_card(card, f"[mmimdb serve] {MMIMDB_REQUESTS} concurrent /predict (8 clients) in "
             f"{serve_s:.3f} s; multilabel answers vs the Predictor: max |logit diff| "
             f"{serve_err:.3e} (tolerance {SERVE_TOL}); /meta multilabel "
             f"{got_meta['multilabel']}; request without 'text' → 400")
    if serve_err > SERVE_TOL:
        raise AssertionError(f"[mmimdb serve] answers differ from the Predictor by {serve_err}")
    return {"visits_per_s": len(records) / seconds, "logit_err": worst,
            "serve_err": serve_err, "launches": counts}


def phase_mmimdb(dev, card: str, work: Path) -> dict:
    """MM-IMDb through `train_multimodal.main` at the published GMU widths:
    no launch of either kernel; mmtpu's test keys; the loaders' batch counts;
    predict and serve; a profiled window; the GPU-vs-CPU check."""
    from mmtpu_torch.cli import train_multimodal

    out_root = work / "mmimdb"
    cfg_path = work / "mmimdb.json"
    cfg_path.write_text(json.dumps(mmimdb_config(str(out_root))))
    cfg = _msa_config(cfg_path)
    n = mmimdb_batches()
    got = {s: len(cfg.data.build_loader(s, seed=SEED)) for s in n}
    if got != n:
        raise AssertionError(f"[mmimdb] batches {got}, expected {n}")
    reset_counts()
    run = _run_cli(train_multimodal, cfg_path, "[mmimdb]", out_root, MMIMDB_NAME,
                   train_samples=MMIMDB_SAMPLES["train"])
    counts = read_counts()
    want_keys = {f"f1_{avg}_{p.upper()}" for avg in ("samples", "macro", "micro")
                 for p in MMIMDB_PATTERNS}
    if counts != {"fused_mlp": 0, "lstm": 0} or not want_keys <= set(run["test"]):
        raise AssertionError(f"[mmimdb] launches {counts}, test keys {sorted(run['test'])}")
    say_card(card, f"[mmimdb] {run['seconds']:.2f} s through train_multimodal.main (start-up, "
             f"data and checkpoints included); epoch {TRAIN_EPOCHS} train {run['epoch_s']:.3f} s "
             f"= {run['samples_per_s']:.1f} samples/s (B={MMIMDB_BATCH}, "
             f"{MMIMDB_SAMPLES['train']} samples); peak device memory "
             f"{run['peak_bytes'] / 2**20:.1f} MiB")
    say(f"[mmimdb] batches {got}; launches {counts}; losses {run['losses']}; test "
        f"{ {k: round(v, 4) for k, v in sorted(run['test'].items()) if k.startswith('f1_')} }")
    pred = phase_mmimdb_predict(dev, card, cfg_path, work)
    profile = phase_train_profile(dev, card, cfg_path, tag="[mmimdb profile]",
                                  batch=MMIMDB_BATCH)
    check = phase_mmimdb_check(dev, cfg_path)
    return {"run": run, "launches": counts, "predict": pred, "profile": profile,
            "check": check}


def say_phase11(card: str, self_mm: Optional[dict], mmimdb: Optional[dict],
                seconds: float) -> None:
    parts = []
    for kind, r in (self_mm or {}).items():
        parts.append(f"Self-MM {kind} {r['run']['samples_per_s']:.1f} train samples/s (epoch "
                     f"{TRAIN_EPOCHS}), {r['run']['seconds']:.2f} s through main, launches "
                     f"{r['launches']}, {r['profile']['device_ms_per_step']:.3f} ms of device "
                     f"work and {r['profile']['wall_ms_per_step']:.3f} ms of wall per step, busy "
                     f"share {r['profile']['busy_share']:.3f}")
    if mmimdb:
        parts.append(f"MM-IMDb {mmimdb['run']['samples_per_s']:.1f} train samples/s (epoch "
                     f"{TRAIN_EPOCHS}), {mmimdb['run']['seconds']:.2f} s through main, launches "
                     f"{mmimdb['launches']}, predict {mmimdb['predict']['visits_per_s']:.1f} "
                     f"visits/s, {mmimdb['profile']['device_ms_per_step']:.3f} ms of device "
                     f"work per step, busy share {mmimdb['profile']['busy_share']:.3f}")
    say_card(card, "[summary] phase 11: " + "; ".join(parts) + f"; phase {seconds:.1f} s")


def kernel_record(name: str, source: str, replaces: str, shape: str, kern: dict, t: dict,
                  pred: dict, srv: dict) -> dict:
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": pred["launches"],
        "serve_launches": srv["launches"],
        "max_abs_err": kern["max_err"],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "device_ms": t["device_ms"],
        "plain_device_ms": t["plain_device_ms"],
        "host_ms": t["host_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t.get("library_ms"),
        "shape": shape,
    }


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description="Smoke run of mmtpu_torch on one GPU")
    parser.add_argument("--train-only", action="store_true",
                        help="build the kernels and run the training phases alone (no "
                             "kernels or ok line)")
    parser.add_argument("--reader-only", action="store_true",
                        help="build the kernels, pretrain the audio encoder and run the "
                             "reader phase alone (no kernels or ok line)")
    parser.add_argument("--shipped-only", action="store_true",
                        help="build the kernels, write the reader phase's .pt files and run "
                             "the shipped-weights phase alone (no kernels or ok line)")
    parser.add_argument("--cmam-only", action="store_true",
                        help="build the kernels, write the reader phase's .pt files and "
                             "seeded teachers, and run the C-MAM phase alone (no kernels or "
                             "ok line)")
    parser.add_argument("--msa-only", action="store_true",
                        help="build the kernels, save a seeded UttFusion teacher and run the "
                             "MMIN and RedCore phase alone (no kernels or ok line)")
    parser.add_argument("--self-mm-only", action="store_true",
                        help="build the kernels and run phase 11's Self-MM half alone (no "
                             "kernels or ok line)")
    parser.add_argument("--mmimdb-only", action="store_true",
                        help="build the kernels and run phase 11's MM-IMDb half alone (no "
                             "kernels or ok line)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say(f"[device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    phase_build()
    cache = ROOT / ".cache"
    cache.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=cache))
    if args.train_only:
        try:
            t0 = time.perf_counter()
            phase_train(dev, smi, work)
            t1 = time.perf_counter()
            phase_train_utt(dev, smi, work)
            say(f"[summary] training phases: AVMNIST {t1 - t0:.1f} s, UttFusion "
                f"{time.perf_counter() - t1:.1f} s")
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return 0
    if args.reader_only:
        from mmtpu_torch.cli import train_monomodal

        try:
            out_root = work / "train"
            mono_path = work / "train_mono.json"
            mono_path.write_text(json.dumps(train_configs(str(out_root))["mono"]))
            mono = _run_cli(train_monomodal, mono_path, "[train mono]", out_root, MONO_NAME)
            t0 = time.perf_counter()
            phase_train_reader(dev, smi, work, mono["models"] / "encoder_audio_best.pth")
            say(f"[summary] reader phase {time.perf_counter() - t0:.1f} s")
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return 0

    if args.shipped_only:
        try:
            data = write_avmnist_files(work / "avmnist_data", TRAIN_SAMPLES)
            t0 = time.perf_counter()
            phase_shipped(dev, smi, work, data["csvs"])
            say(f"[summary] shipped-weights phase {time.perf_counter() - t0:.1f} s")
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return 0

    if args.cmam_only:
        try:
            data = write_avmnist_files(work / "avmnist_data", TRAIN_SAMPLES)
            t0 = time.perf_counter()
            cmam = phase_cmam(dev, smi, work, data["csvs"], cmam_bases(work))
            say_cmam(smi, cmam, time.perf_counter() - t0)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return 0

    if args.msa_only:
        try:
            t0 = time.perf_counter()
            msa = phase_msa(dev, smi, work, msa_teacher(work))
            say_msa(smi, msa, time.perf_counter() - t0)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return 0

    if args.self_mm_only or args.mmimdb_only:
        try:
            t0 = time.perf_counter()
            self_mm = phase_self_mm(dev, smi, work) if args.self_mm_only else None
            mmimdb = phase_mmimdb(dev, smi, work) if args.mmimdb_only else None
            say_phase11(smi, self_mm, mmimdb, time.perf_counter() - t0)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return 0

    mlp = phase_kernels_mlp(dev)
    lstm = phase_kernels_lstm(dev)
    try:
        av_cfg = work / "avmnist.json"
        av_cfg.write_text(json.dumps(smoke_config(out_root=str(work / "out"))))
        av_pred = phase_predict(dev, work, av_cfg, AVMNIST_PATH)
        av_srv = phase_serve(av_cfg, AVMNIST_PATH, avmnist_requests())
        mosi_cfg = work / "mosi.json"
        mosi_cfg.write_text(json.dumps(mosi_smoke_config(out_root=str(work / "out"))))
        mosi_pred = phase_predict(dev, work, mosi_cfg, MOSI_PATH)
        mosi_srv = phase_serve(mosi_cfg, MOSI_PATH, mosi_requests())
        t_train = time.perf_counter()
        train = phase_train(dev, smi, work)
        t_utt = time.perf_counter()
        utt = phase_train_utt(dev, smi, work)
        t_reader = time.perf_counter()
        reader = phase_train_reader(dev, smi, work, train["handoff"])
        t_shipped = time.perf_counter()
        shipped = phase_shipped(dev, smi, work, reader["csvs"])
        t_cmam = time.perf_counter()
        cmam = phase_cmam(dev, smi, work, reader["csvs"],
                          {"cmam": train["scratch"]["models"] / "best.pth",
                           "dual": utt["run"]["models"] / "best.pth"})
        t_msa = time.perf_counter()
        msa = phase_msa(dev, smi, work, utt["run"]["models"] / "best.pth")
        t_11 = time.perf_counter()
        self_mm = phase_self_mm(dev, smi, work)
        mmimdb = phase_mmimdb(dev, smi, work)
        t_train, t_utt, t_reader, t_shipped, t_cmam, t_msa, t_11 = (
            t_utt - t_train, t_reader - t_utt, t_shipped - t_reader, t_cmam - t_shipped,
            t_msa - t_cmam, t_11 - t_msa, time.perf_counter() - t_11)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    for label, pred, srv in (("AVMNIST", av_pred, av_srv), ("UttFusion", mosi_pred, mosi_srv)):
        say(f"[summary] {label}: predict {pred['steady_visits_per_s']:.1f} visits/s steady; "
            f"serve {srv['requests_per_s']:.1f} requests/s (no-model ceiling "
            f"{srv['null_requests_per_s']:.1f})")
    say_card(smi, f"[summary] training: mono {train['mono']['samples_per_s']:.1f}, pretrained "
          f"fine-tune {train['pretrained']['samples_per_s']:.1f}, scratch "
          f"{train['scratch']['samples_per_s']:.1f} train samples/s (epoch {TRAIN_EPOCHS}); "
          f"busy share {train['profile']['busy_share']:.3f}; phase {t_train:.1f} s")
    say_card(smi, f"[summary] UttFusion training: {utt['run']['samples_per_s']:.1f} train "
             f"samples/s (epoch {TRAIN_EPOCHS}); {utt['profile']['kernels_per_step']:.1f} device "
             f"kernels per train step, busy share {utt['profile']['busy_share']:.3f}; lstm "
             f"launches {utt['launches']}; peak {utt['run']['peak_bytes'] / 2**20:.1f} MiB; "
             f"phase {t_utt:.1f} s")
    say_card(smi, f"[summary] reader: {reader['build']['samples']} samples from the files "
             f"{reader['build']['files_s']:.3f} s, from the sidecars "
             f"{reader['build']['sidecars_s']:.3f} s; reader-fed fine-tune "
             f"{reader['run']['samples_per_s']:.1f} train samples/s (epoch {TRAIN_EPOCHS}, "
             f"under --profile); fused_mlp launches fine-tune {reader['launches']}, cv "
             f"{reader['cv_launches']}, sweep {reader['sweep_launches']}; cv {reader['cv_s']:.1f} "
             f"s, sweep {reader['sweep_s']:.1f} s; phase {t_reader:.1f} s")
    say_card(smi, "[summary] shipped weights: " + ", ".join(
        f"{key} {run['samples_per_s']:.1f}" for key, run in shipped["runs"].items())
        + f" train samples/s (epoch {TRAIN_EPOCHS}); fused_mlp launches "
        f"{shipped['launches']}; busy share {shipped['profile']['busy_share']:.3f}; replay "
        f"{shipped['load']['replay_err']:.3e}, predict GPU vs CPU "
        f"{shipped['predict_err']:.3e}; phase {t_shipped:.1f} s")
    say_cmam(smi, cmam, t_cmam)
    say_msa(smi, msa, t_msa)
    say_phase11(smi, self_mm, mmimdb, t_11)
    say(f"[summary] fused_mlp B=1024 {json.dumps(mlp['timings'][1024])}")
    for batch, t in mlp["shipped"].items():
        say(f"[summary] fused_mlp {SHIPPED_HEAD_DIMS} B={batch} {json.dumps(t)}")
    say(f"[summary] fused_mlp {SHIPPED_HEAD_DIMS} max |kernel - plain| "
        f"{mlp['shipped_err']:.3e} at B=128 and 1024 (tolerance {KERNEL_TOL})")
    for shape, t in lstm["timings"].items():
        say_card(smi, f"[summary] lstm G,B,T,H={shape} {json.dumps(t)}")
    say(f"[summary] {time.perf_counter() - t_start:.1f} s in all")
    G, B, T, H = LSTM_MAIN
    print(json.dumps({"kernels": [
        {**kernel_record("fused_mlp", "mmtpu_torch/ops/csrc/fused_mlp.cu",
                         "mmtpu/ops/fused_mlp.py:63", "B=128, 192-128-64-10, float32",
                         mlp, mlp["timings"][128], av_pred, av_srv),
         "train_launches": train["launches"], "reader_launches": reader["launches"],
         "cv_launches": reader["cv_launches"], "sweep_launches": reader["sweep_launches"],
         "shipped_launches": shipped["launches"],
         "msa_launches": {kind: r["launches"]["fused_mlp"] for kind, r in msa.items()},
         "self_mm_launches": {kind: r["launches"]["fused_mlp"] for kind, r in self_mm.items()},
         "mmimdb_launches": mmimdb["launches"]["fused_mlp"],
         "shipped_head": {"dims": SHIPPED_HEAD_DIMS, "max_abs_err": mlp["shipped_err"],
                          **{f"B={b}": t for b, t in mlp["shipped"].items()}}},
        {**kernel_record("lstm", "mmtpu_torch/ops/csrc/lstm.cu", "mmtpu/ops/lstm.py:61",
                         f"G={G}, B={B}, T={T}, H={H}, float32; library_ms is {G} nn.LSTM "
                         "calls, projection included (with_projection_ms is ours with it)",
                         lstm, lstm["timings"][LSTM_MAIN], mosi_pred, mosi_srv),
         "train_launches": utt["launches"],
         "mmin_launches": msa["mmin"]["launches"]["lstm"],
         "self_mm_launches": {kind: r["launches"]["lstm"] for kind, r in self_mm.items()},
         "mmimdb_launches": mmimdb["launches"]["lstm"],
         "self_mm_shapes": {"G={}, B={}, T={}, H={}".format(*k): lstm["timings"][k]
                            for k in SELF_MM_LSTM},
         "with_projection_ms": lstm["timings"][LSTM_MAIN]["with_projection_ms"],
         "grad_max_abs_err": lstm["grad_err"],
         "serial_steps": T},
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
