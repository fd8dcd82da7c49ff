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
             with a padded tail) on the card against the CPU.

    python3 chip_smoke.py --train-only    # build, then phase 5 alone

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
                      out_root: str = "./experiments_output") -> dict:
    """The plain-dict twin of configs/mosi/synthetic_utt_fusion.yaml with the
    model at its published widths (LSTM hidden 64 and pooling 'last', TextCNN
    with 128 channels, FcClassifier 192→[192, 64, 32]→3); the test split's
    size is this run's (686 is the size of the real MOSI test split), the
    rest is the file's."""
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
    train = split("train", 128, dropped, shuffle=True)
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
                "validation": split("valid", 64, present),
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

    max_err = 0.0
    # (dims, batch, what is special): the head at the path's batch sizes, odd
    # widths, layer 1 off the 16-byte grid, and a chain too wide to stay in
    # shared memory (16.8 MB of weights, streamed through it)
    cases = [(HEAD_DIMS, b, "") for b in (1, 37, 64, 128, 1024)] + [
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

    timings = {}
    ws, bs = layers(HEAD_DIMS)
    for batch in (128, 1024):
        x = torch.randn(batch, HEAD_DIMS[0], generator=g).to(dev)
        # turns: plain, kernel, kernel, plain
        p1 = event_ms(lambda: fused_mlp_reference(x, ws, bs))
        k1 = event_ms(lambda: fused_mlp(x, ws, bs))
        k2 = event_ms(lambda: fused_mlp(x, ws, bs))
        p2 = event_ms(lambda: fused_mlp_reference(x, ws, bs))
        kh = host_ms(lambda: fused_mlp(x, ws, bs))
        kd = own_device_ms(lambda: fused_mlp(x, ws, bs), "fused_mlp")
        pd = device_breakdown(lambda: [fused_mlp_reference(x, ws, bs) for _ in range(100)])
        pd = pd["device_ms"] / 100
        bound, bound_by = mlp_bound_ms(batch, HEAD_DIMS)
        timings[batch] = {
            "ms": statistics.mean([k1, k2]), "plain_ms": statistics.mean([p1, p2]),
            "device_ms": kd, "plain_device_ms": pd, "host_ms": kh,
            "bound_ms": bound, "bound_by": bound_by,
        }
        say(f"[kernels] fused_mlp B={batch} {HEAD_DIMS}: per call kernel "
            f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms (events); host per launch "
            f"{kh:.4f} ms (wall, no sync); device "
            f"time kernel {kd} ms, plain {pd} ms (profiler); bound {bound:.6f} ms "
            f"({bound_by})")
    return {"max_err": max_err, "timings": timings}


# LSTM shapes: (G, B, T, H, lengths in [0, T], non-zero h0/c0, tolerance, timed)
LSTM_CASES = [
    (1, 32, 50, 64, False, False, KERNEL_TOL, True),
    (2, 32, 50, 64, False, False, KERNEL_TOL, True),   # the UttFusion forward
    (1, 128, 50, 32, False, False, KERNEL_TOL, True),
    (1, 32, 400, 64, True, False, LSTM_TOL_LONG, True),
    (1, 5, 7, 24, False, True, KERNEL_TOL, False),
    (1, 32, 50, 128, False, False, KERNEL_TOL, True),
    (2, 64, 50, 64, False, False, KERNEL_TOL, False),  # the server's largest micro-batch
]
LSTM_MAIN = (2, 32, 50, 64)
LSTM_INPUT_SIZES = (5, 20)  # MOSI audio and video feature widths, by group


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
    for g in range(G):
        size = LSTM_INPUT_SIZES[g % len(LSTM_INPUT_SIZES)]
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
    cots = None
    grads = []
    for fn in (lstm_sequence_stacked, lstm_stacked_reference):
        xw, wh, h0, c0, lengths = _lstm_inputs(dev, 2, 9, 11, 24, True, True, 99)
        leaves = [t.requires_grad_() for t in (xw, wh, h0, c0)]
        out, (h, c) = fn(*leaves, lengths)
        if cots is None:
            gen = torch.Generator().manual_seed(SEED)
            cots = [torch.randn(t.shape, generator=gen).to(dev) for t in (out, h, c)]
        grads.append(torch.autograd.grad((out, h, c), leaves, cots))
    grad_err = max((a - b).abs().max().item() for a, b in zip(*grads))
    say(f"[kernels] lstm gradient (G=2 B=9 T=11 H=24, lengths, h0/c0≠0): max |autograd.Function "
        f"- autograd through the plain scan| = {grad_err:.3e} (tolerance {LSTM_GRAD_TOL})")
    if grad_err > LSTM_GRAD_TOL:
        raise AssertionError(f"lstm gradient differs by {grad_err}")
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


def _run_cli(module, cfg_path: Path, tag: str, out_root: Path, name: str) -> dict:
    """`module.main` on the card through its normal flags; what it wrote."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = module.main(["--config", str(cfg_path), "--run_id", "1"])
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
            "samples_per_s": TRAIN_SAMPLES["train"] / train_s, "epoch_s": train_s,
            "models": out_root / name / "models" / "1"}


def _accuracies(record: dict) -> dict:
    return {k: round(v, 4) for k, v in record.items() if k.startswith("accuracy")}


def _train_batches(cfg_path: Path, n: int):
    from mmtpu_torch.cli import common

    cfg = common.load_config(argparse.Namespace(config=str(cfg_path), run_id=1, seed=None))
    loader = cfg.data.build_loader("train", seed=cfg.experiment.seed)
    it = iter(loader)
    return cfg, [next(it) for _ in range(n)]


def _training_setup(cfg, dev):
    """Model, state and train step as `train_multimodal` builds them."""
    from mmtpu_torch.cli import common
    from mmtpu_torch.train.step import ClassificationTask, make_train_step

    model = common.init_model(common.build_model_from_config(cfg.model), SEED, dev)
    state = common.make_state(model, cfg.training)
    task = ClassificationTask(model=model, loss_group=cfg.training.loss_functions,
                              input_keys=["audio", "image"])
    return model, state, make_train_step(task, state, dev)


def phase_train_profile(dev, card: str, cfg_path: Path, steps: int = 8) -> dict:
    """A window of fine-tune train steps under the profiler: the device's
    busy share and the operations that take its time."""
    import torch

    cfg, batches = _train_batches(cfg_path, 3 + steps)
    _, _, step = _training_setup(cfg, dev)
    for b in batches[:3]:  # warm-up: cuDNN plans, allocator
        step(b)
    torch.cuda.synchronize()
    brk = device_breakdown(lambda: [step(b) for b in batches[3:]], top=8)
    busy = brk["device_ms"] / brk["profiled_wall_ms"]
    say_card(card, f"[train profile] {steps} fine-tune train steps (B={TRAIN_BATCH}): device "
             f"busy {brk['device_ms']:.3f} ms of {brk['profiled_wall_ms']:.3f} ms wall, busy "
             f"share {busy:.3f}; top device operations (name, ms, count) {brk['top']}; top "
             f"host operations by self CPU time (name, ms, count) {brk['top_host']}")
    return {"busy_share": busy}


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
    patterns = 3
    per_split = {s: -(-TRAIN_SAMPLES[s] * patterns // TRAIN_BATCH)
                 for s in ("validation", "test")}
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
            "profile": profile, "check": check}


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
                        help="build the kernels and run the training phase alone (no "
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
            say(f"[summary] training phase {time.perf_counter() - t0:.1f} s")
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
        t_train = time.perf_counter() - t_train
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
    say(f"[summary] fused_mlp B=1024 {json.dumps(mlp['timings'][1024])}")
    for shape, t in lstm["timings"].items():
        say(f"[summary] lstm G,B,T,H={shape} {json.dumps(t)}")
    say(f"[summary] {time.perf_counter() - t_start:.1f} s in all")
    G, B, T, H = LSTM_MAIN
    print(json.dumps({"kernels": [
        {**kernel_record("fused_mlp", "mmtpu_torch/ops/csrc/fused_mlp.cu",
                         "mmtpu/ops/fused_mlp.py:63", "B=128, 192-128-64-10, float32",
                         mlp, mlp["timings"][128], av_pred, av_srv),
         "train_launches": train["launches"]},
        {**kernel_record("lstm", "mmtpu_torch/ops/csrc/lstm.cu", "mmtpu/ops/lstm.py:61",
                         f"G={G}, B={B}, T={T}, H={H}, float32; library_ms is {G} nn.LSTM "
                         "calls, projection included (with_projection_ms is ours with it)",
                         lstm, lstm["timings"][LSTM_MAIN], mosi_pred, mosi_srv),
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
