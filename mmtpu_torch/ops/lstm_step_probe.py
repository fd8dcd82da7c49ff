"""Where one step of the LSTM recurrence spends its cycles on the card.

    python3 -m mmtpu_torch.ops.lstm_step_probe

Builds `csrc/lstm_step_probe.cu` (measuring copies of the first one-row step
design and of the K-split design with a quad per unit, with `clock64()`
stamps around the parts of a step; at 32 < H ≤ 64 the shipped kernel goes one
step further and serves two units per quad), runs each at H = 32 (B = 128)
and H = 64 (B = 64) over T = 50 steps with zero state, holds the outputs
against the plain scan, and prints the cycles per step of each part as seen
by lane 0 of warp 0 of block 0, beside the launch's time from CUDA events.
Needs an sm_90 GPU and nvcc; it is a
measuring tool and no model's path runs it.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from mmtpu_torch.ops import _build
from mmtpu_torch.ops.lstm import lstm_reference

PARTS = ("product", "quad_reduce", "activation", "gate_exchange", "update", "barrier")
DESIGNS = {0: "first (column per thread)", 1: "k-split (quad per unit)"}
SHAPES = ((128, 50, 32), (64, 50, 64))  # (B, T, H)
TOL = 1e-5


def main() -> int:
    if not torch.cuda.is_available():
        print("lstm_step_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    fn = _build.load("lstm_step_probe").mmtpu_lstm_step_probe
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[probe] {smi}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    for B, T, H in SHAPES:
        g = np.random.default_rng(H)
        xw = torch.from_numpy(g.normal(size=(B, T, 4 * H)).astype(np.float32)).to(dev)
        wh = torch.from_numpy((g.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(np.float32)).to(dev)
        zeros = torch.zeros(B, H, device=dev)
        want, _ = lstm_reference(xw, wh, zeros, zeros)
        for design, label in DESIGNS.items():
            out = torch.empty(B, T, H, device=dev)
            cycles = torch.zeros(7, dtype=torch.int64, device=dev)

            def launch():
                rc = fn(xw.data_ptr(), wh.data_ptr(), out.data_ptr(), cycles.data_ptr(),
                        B, T, H, design, stream)
                if rc != 0:
                    raise RuntimeError(f"probe launch failed with CUDA error {rc}")

            for _ in range(10):
                launch()
            torch.cuda.synchronize()
            err = (out - want).abs().max().item()
            if err > TOL:
                raise AssertionError(f"probe design {design} B={B} H={H}: error {err} > {TOL}")
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(100):
                launch()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / 100
            c = cycles.cpu().numpy() / T
            print(f"[probe] B={B} T={T} H={H} {label}: {ms:.5f} ms per launch (events), "
                  f"max |probe - plain| {err:.2e}; cycles per step "
                  + json.dumps({**{p: round(float(v), 1) for p, v in zip(PARTS, c)},
                                "whole_step": round(float(c[6]), 1)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
