#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (`mmtpu_torch`) on one GPU.

    python3 chip_smoke.py

Drives the port's serving path at the full width of the AVMNIST late-fusion
model (ResNet18 audio encoder, hidden 64; ResNet34 image encoder, hidden
128; head 192→128→64→10), from seeded random weights:

1. build   — compiles every kernel of the path from `mmtpu_torch/ops/csrc`;
2. kernels — each kernel against its plain PyTorch version on the card, at
             the shapes the path gives it, with timings (CUDA events);
3. predict — the `predict` entry over a synthetic test split (1000 samples ×
             patterns ai/a/i, batch 128); logits checked against the port on
             the CPU; the kernel's launch count must grow;
4. serve   — the HTTP server in process: concurrent /predict requests (some
             with the image or the audio zeroed) and one /predict_batch,
             each answer checked against the Predictor; the kernel's launch
             count must grow again.

Prints a `kernels` JSON line, the card's name and power limit, and as the
last line `{"ok": true, "device": {...}}`. Any failure exits non-zero
without that line. There is no CPU path: without a GPU it fails. Imports
nothing of JAX or of the `mmtpu` package.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 42
HEAD_DIMS = [192, 128, 64, 10]
KERNEL_TOL = 1e-5  # fp32; kernel and cuBLAS sum in different orders
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


def say(msg: str) -> None:
    print(msg, flush=True)


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


def device_breakdown(fn, top: int = 6) -> dict:
    """Run `fn` once under torch.profiler: device time summed over every
    kernel, the host wall time of the profiled run, and the kernels that
    took the most device time."""
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
        "fused_mlp_device_ms": sum(v for k, v in dev_us.items() if "fused_mlp" in k) / 1e3,
        "top": [(e.key[:70], round(dev_us[e.key] / 1e3, 4), e.count) for e in ranked],
        "top_host": [(e.key[:50], round(e.self_cpu_time_total / 1e3, 3), e.count)
                     for e in host_ops],
    }


def mlp_bound_ms(batch: int, dims) -> tuple:
    """Least time for the chain on an H100: bytes moved (x, weights, biases
    read once, logits written once) over HBM rate, FLOPs over the float32
    rate; the larger of the two, and which one it is."""
    params = sum(i * o + o for i, o in zip(dims[:-1], dims[1:]))
    nbytes = 4 * (batch * dims[0] + params + batch * dims[-1])
    flops = 2 * batch * sum(i * o for i, o in zip(dims[:-1], dims[1:]))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def phase_build() -> None:
    from mmtpu_torch.ops import KERNELS, _build

    t0 = time.perf_counter()
    logs = _build.build(KERNELS)
    say(f"[build] {list(KERNELS)} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc, sm_90a) → {_build.BUILD_DIR}")
    for name, log in logs.items():
        for line in log.strip().splitlines():
            say(f"[build] {name}: {line.strip()}")


def phase_kernels(dev) -> dict:
    """fused_mlp vs fused_mlp_reference on the card; timings at the batch
    sizes the path uses (predict batch 128, and 1024)."""
    import torch

    from mmtpu_torch.ops import fused_mlp, fused_mlp_reference

    g = torch.Generator().manual_seed(SEED)

    def layers(dims):
        ws = [(torch.randn(o, i, generator=g) / i ** 0.5).to(dev)
              for i, o in zip(dims[:-1], dims[1:])]
        bs = [(0.1 * torch.randn(o, generator=g)).to(dev) for o in dims[1:]]
        return ws, bs

    max_err = 0.0
    cases = [(HEAD_DIMS, b) for b in (1, 37, 64, 128, 1024)] + [([100, 300, 7], 37)]
    for dims, batch in cases:
        ws, bs = layers(dims)
        x = torch.randn(batch, dims[0], generator=g).to(dev)
        got = fused_mlp(x, ws, bs)
        want = fused_mlp_reference(x, ws, bs)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"fused_mlp {dims} B={batch}: bad output {got.shape}")
        err = (got - want).abs().max().item()
        say(f"[kernels] fused_mlp {dims} B={batch}: max |kernel - plain| = {err:.3e}")
        if err > KERNEL_TOL:
            raise AssertionError(f"fused_mlp {dims} B={batch}: error {err} > {KERNEL_TOL}")
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
        kd = device_breakdown(lambda: [fused_mlp(x, ws, bs) for _ in range(100)])
        pd = device_breakdown(lambda: [fused_mlp_reference(x, ws, bs) for _ in range(100)])
        kd, pd = kd["device_ms"] / 100, pd["device_ms"] / 100
        bound, bound_by = mlp_bound_ms(batch, HEAD_DIMS)
        timings[batch] = {
            "ms": statistics.mean([k1, k2]), "plain_ms": statistics.mean([p1, p2]),
            "device_ms": kd, "plain_device_ms": pd,
            "bound_ms": bound, "bound_by": bound_by,
        }
        say(f"[kernels] fused_mlp B={batch} {HEAD_DIMS}: per call kernel "
            f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms (events); device "
            f"time kernel {kd} ms, plain {pd} ms (profiler); bound {bound:.6f} ms "
            f"({bound_by})")
    return {"max_err": max_err, "timings": timings}


def phase_predict(dev, work: Path, cfg_path: Path) -> dict:
    import torch

    from mmtpu_torch.checkpoints import save_pth
    from mmtpu_torch.cli import common, predict
    from mmtpu_torch.models import seeded_init
    from mmtpu_torch.ops import fused_mlp
    from mmtpu_torch.train.step import make_eval_step

    cfg = common.load_config(argparse.Namespace(config=str(cfg_path), run_id=1, seed=None))
    model = seeded_init(common.build_model_from_config(cfg.model), SEED)
    ckpt = save_pth(model, common.checkpoint_path(cfg, "best"))
    n_params = sum(p.numel() for p in model.parameters())
    say(f"[predict] full-width AVMNIST ({n_params} parameters), seeded weights → {ckpt}")

    out_json = work / "predictions_test.json"
    args = predict.arg_parser().parse_args(
        ["--config", str(cfg_path), "--run_id", "1", "--out", str(out_json)]
    )
    fused_mlp.launches = 0
    t0 = time.perf_counter()
    _, records, summary = predict.run(args)
    seconds = time.perf_counter() - t0
    launches = fused_mlp.launches
    data = json.loads(out_json.read_text())
    if set(data) != {"split", "checkpoint", "accuracy_per_pattern", "predictions"}:
        raise AssertionError(f"predictions JSON keys {sorted(data)}")
    n_test = cfg.data.datasets["test"].kwargs["num_samples"]
    if len(records) != 3 * n_test or set(summary) != {"ai", "a", "i"}:
        raise AssertionError(f"{len(records)} records, patterns {sorted(summary)}")
    if launches < 1:
        raise AssertionError("predict: fused_mlp kernel was never launched")
    say(f"[predict] {len(records)} visits in {seconds:.3f} s through predict.run "
        f"({len(records) / seconds:.1f} samples/s, start-up included); "
        f"per-pattern accuracy {summary}; fused_mlp launches {launches}")

    # steady state: the same pass with the model already built and loaded
    task, loader = predict.build_task_and_loader(cfg, args, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    records2, _ = predict.predict_split(task, loader, dev)
    steady = time.perf_counter() - t0
    say(f"[predict] steady pass: {len(records2)} visits in {steady:.3f} s "
        f"({len(records2) / steady:.1f} samples/s)")
    if [r["pred"] for r in records2] != [r["pred"] for r in records]:
        raise AssertionError("two predict passes disagree")
    brk = device_breakdown(lambda: predict.predict_split(task, loader, dev))
    say(f"[predict] profiled pass: device busy {brk['device_ms']:.3f} ms of "
        f"{brk['profiled_wall_ms']:.3f} ms wall ({brk['device_ms'] / (steady * 1e3):.3f} "
        f"of the unprofiled steady pass); fused_mlp {brk['fused_mlp_device_ms']:.4f} ms; "
        f"top kernels (name, ms, count) {brk['top']}; top host ops by self CPU time "
        f"(name, ms, count) {brk['top_host']}")

    # the same batches on the CPU: first two and the padded tail
    cpu_task, cpu_loader = predict.build_task_and_loader(
        cfg, args, torch.device("cpu")
    )
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
        if g_logits.shape != (loader.batch_size, 10) or not torch.isfinite(g_logits).all():
            raise AssertionError(f"batch {i}: logits {tuple(g_logits.shape)} not finite")
        err = (g_logits - c_logits).abs().max().item()
        worst = max(worst, err)
        top2 = c_logits.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * CPU_TOL
        if not torch.equal(g_out["preds"].cpu()[clear], c_out["preds"][clear]):
            raise AssertionError(f"batch {i}: GPU and CPU predictions differ")
    say(f"[predict] GPU vs CPU logits on batches {picks}: max |diff| = {worst:.3e} "
        f"(tolerance {CPU_TOL}, TF32 off)")
    if worst > CPU_TOL:
        raise AssertionError(f"GPU vs CPU logits differ by {worst}")
    return {"launches": launches, "samples_per_s": len(records) / seconds,
            "steady_samples_per_s": len(records2) / steady}


def _post(url: str, body: bytes) -> dict:
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _get(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def phase_serve(cfg_path: Path) -> dict:
    from mmtpu_torch.cli import serve
    from mmtpu_torch.data import SyntheticAVMNIST
    from mmtpu_torch.modalities import Modality
    from mmtpu_torch.ops import fused_mlp

    args = serve.arg_parser().parse_args(["--config", str(cfg_path), "--run_id", "1"])
    predictor, meta = serve.load_model(args)
    ds = SyntheticAVMNIST(split="test", num_samples=48, seed=SEED + 1)
    audio = ds.arrays[Modality.AUDIO].copy()
    image = ds.arrays[Modality.IMAGE].copy()
    image[0::3] = 0.0  # image missing
    audio[1::3] = 0.0  # audio missing
    n = len(audio)

    bodies = [json.dumps({"audio": audio[i].tolist(), "image": image[i].tolist()}).encode()
              for i in range(n)]

    def round_trip(url):
        """n concurrent /predict requests (16 clients); (answers, seconds)."""
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=16) as pool:
            answers = list(pool.map(lambda b: _post(url, b), bodies))
        return answers, time.perf_counter() - t0

    def null_model(a, i):  # the HTTP/JSON path's ceiling: no model at all
        return {"logits": np.zeros((len(a), 10), np.float32),
                "preds": np.zeros(len(a), np.int64),
                "probs": np.full((len(a), 10), 0.1, np.float32)}

    with serve.ServerThread(null_model, meta, max_batch=64, max_wait_ms=5.0) as st:
        _, null_cold = round_trip(f"{st.url}/predict")
        _, null_s = round_trip(f"{st.url}/predict")
    say(f"[serve] the same {n} requests to a server with no model: {null_cold:.3f} s "
        f"first round, {null_s:.3f} s second round ({n / null_s:.1f} requests/s, "
        f"host HTTP/JSON only)")

    fused_mlp.launches = 0
    with serve.ServerThread(predictor, meta, max_batch=64, max_wait_ms=5.0) as st:
        health = _get(f"{st.url}/health")
        got_meta = _get(f"{st.url}/meta")
        _, cold = round_trip(f"{st.url}/predict")  # first use of each batch bucket
        answers, seconds = round_trip(f"{st.url}/predict")
        batch_answer = _post(f"{st.url}/predict_batch", json.dumps(
            {"audio": audio[:8].tolist(), "image": image[:8].tolist()}).encode())
        stats = _get(f"{st.url}/stats")
        launches = fused_mlp.launches
    if health.get("status") != "ok" or got_meta["input_keys"] != ["audio", "image"]:
        raise AssertionError(f"/health {health}, /meta {got_meta}")
    say(f"[serve] {n} concurrent /predict (16 clients): {cold:.3f} s first round, "
        f"{seconds:.3f} s second round ({n / seconds:.1f} requests/s); /stats {stats}; "
        f"fused_mlp launches while serving {launches}")
    if launches < 1:
        raise AssertionError("serve: fused_mlp kernel was never launched")
    if stats["requests"] != 2 * n:
        raise AssertionError(f"/stats counted {stats['requests']} requests, sent {2 * n}")

    direct = predictor(audio=audio, image=image)
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
    say(f"[serve] answers vs Predictor called directly: max |logit diff| = {worst:.3e} "
        f"(tolerance {SERVE_TOL})")
    if worst > SERVE_TOL:
        raise AssertionError(f"served logits differ from the Predictor by {worst}")
    return {"launches": launches, "requests_per_s": n / seconds,
            "null_requests_per_s": n / null_s}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say(f"[device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    phase_build()
    kern = phase_kernels(dev)

    cache = ROOT / ".cache"
    cache.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=cache))
    try:
        cfg_path = work / "config.json"
        cfg_path.write_text(json.dumps(smoke_config(out_root=str(work / "out"))))
        pred = phase_predict(dev, work, cfg_path)
        srv = phase_serve(cfg_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    t128 = kern["timings"][128]
    say(f"[summary] predict {pred['steady_samples_per_s']:.1f} samples/s steady; "
        f"serve {srv['requests_per_s']:.1f} requests/s (no-model ceiling "
        f"{srv['null_requests_per_s']:.1f}); fused_mlp B=1024 "
        f"{json.dumps(kern['timings'][1024])}")
    print(json.dumps({"kernels": [{
        "name": "fused_mlp",
        "route": "cuda",
        "source": "mmtpu_torch/ops/csrc/fused_mlp.cu",
        "replaces": "mmtpu/ops/fused_mlp.py:63",
        "launches": pred["launches"],
        "serve_launches": srv["launches"],
        "max_abs_err": kern["max_err"],
        "max_err": kern["max_err"],
        "ms": t128["ms"],
        "kernel_ms": t128["ms"],
        "plain_ms": t128["plain_ms"],
        "device_ms": t128["device_ms"],
        "plain_device_ms": t128["plain_device_ms"],
        "bound_ms": t128["bound_ms"],
        "bound_by": t128["bound_by"],
        "library_ms": None,
        "shape": "B=128, 192-128-64-10, float32",
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
