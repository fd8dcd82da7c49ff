"""How the fused-MLP kernel's time depends on rows per tile and blocks.

    python3 -m mmtpu_torch.ops.fused_mlp_sweep

Launches `csrc/fused_mlp.cu` through its C entry point, past the wrapper's
own plan, for the AVMNIST head 192→128→64→10 at B = 128 and B = 1024 with every
tile size the kernel is built for and one, a half and a quarter of a block
per SM, holds each result against the plain chain, and prints the time per
launch of a CUDA graph of 50 launches (device time with the launch gaps the
device itself leaves, no host in between). `chain_plan`'s rule for rows per
tile was chosen from this table. Needs an sm_90 GPU and nvcc; it is a
measuring tool and no model's path runs it.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from mmtpu_torch.ops import _build
from mmtpu_torch.ops.fused_mlp import (
    HEADER_BYTES,
    ROW_TILES,
    _kernel_fn,
    bias_floats,
    fused_mlp_reference,
    weight_stride,
)

DIMS = (192, 128, 64, 10)
BATCHES = (128, 1024)
LAUNCHES = 50  # per graph
TOL = 1e-5


def main() -> int:
    if not torch.cuda.is_available():
        print("fused_mlp_sweep: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    _, num_sms = _build.sm90_device(dev, "fused_mlp")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[sweep] {smi}; {num_sms} SMs")
    g = torch.Generator().manual_seed(0)
    ws = [(torch.randn(o, i, generator=g) / i ** 0.5).to(dev) for i, o in zip(DIMS, DIMS[1:])]
    bs = [(0.1 * torch.randn(o, generator=g)).to(dev) for o in DIMS[1:]]
    n = len(ws)
    fn = _kernel_fn()
    c_dims = (ctypes.c_int * (n + 1))(*DIMS)
    c_w = (ctypes.c_void_p * n)(*[w.data_ptr() for w in ws])
    c_b = (ctypes.c_void_p * n)(*[b.data_ptr() for b in bs])
    c_zero = (ctypes.c_longlong * n)()  # one member: no member strides
    weights = 4 * sum(o * weight_stride(i) for i, o in zip(DIMS, DIMS[1:]))
    side = torch.cuda.Stream()
    for batch in BATCHES:
        x = torch.randn(batch, DIMS[0], generator=g).to(dev)
        want = fused_mlp_reference(x, ws, bs)
        for rows in ROW_TILES:
            tiles = -(-batch // rows)
            smem = HEADER_BYTES + 4 * bias_floats(DIMS) + 2 * rows * DIMS[0] * 4 + weights
            for grid in sorted({min(tiles, num_sms // d) for d in (1, 2, 4)}):
                out = torch.empty(batch, DIMS[-1], device=dev)

                def launch():
                    rc = fn(x.data_ptr(), out.data_ptr(), batch, n, c_dims, c_w, c_b, rows,
                            grid, DIMS[0], 2 ** n - 1, True, smem, 1, 0, 0, c_zero, c_zero,
                            side.cuda_stream)
                    if rc != 0:
                        raise RuntimeError(f"launch failed with CUDA error {rc}")

                graph = torch.cuda.CUDAGraph()
                with torch.cuda.stream(side):
                    launch()
                    side.synchronize()
                    err = (out - want).abs().max().item()
                    with torch.cuda.graph(graph, stream=side):
                        for _ in range(LAUNCHES):
                            launch()
                if err > TOL:
                    raise AssertionError(f"B={batch} rows={rows} grid={grid}: error {err}")
                times = []
                for _ in range(5):
                    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    start.record()
                    graph.replay()
                    end.record()
                    end.synchronize()
                    times.append(start.elapsed_time(end) / LAUNCHES)
                print(f"[sweep] B={batch} rows={rows} blocks={grid}: {min(times) * 1e3:.2f} µs "
                      f"per launch (best of 5 graphs of {LAUNCHES}), max |kernel - plain| "
                      f"{err:.1e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
