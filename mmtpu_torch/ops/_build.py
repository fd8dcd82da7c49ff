"""Build and load the port's CUDA kernels.

Each source `csrc/<name>.cu` has a plain C interface. At first use it is
compiled with nvcc for sm_90a into a shared library under
`<repo>/.cache/mmtpu_torch/kernels/` and loaded with ctypes. The library's
file name carries a hash of its source, so an edited kernel is rebuilt and
a stale one is never loaded. `build(names)` starts one nvcc per source, all
at once, and waits for them together.

Nothing here runs at import time: a CPU-only host imports the port without
nvcc, and only a launch on a CUDA tensor needs the build. Also here: what
every launch asks of its device (`sm90_device`, `on_device`), kept cheap,
whether an eager call goes round the operator (`direct_launch`), and
whether a call is under a `torch.func` transform (`transformed`).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / ".cache" / "mmtpu_torch" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_sm_counts: Dict[int, int] = {}  # device index → SMs, for the sm_90 devices seen
_CURRENT = contextlib.nullcontext()


def sm90_device(device: torch.device, kernel: str) -> Tuple[int, int]:
    """(index, number of SMs) of a CUDA device the kernels are built for;
    raises on any other architecture. The properties are read once per device."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    sms = _sm_counts.get(index)
    if sms is None:
        props = torch.cuda.get_device_properties(index)
        if (props.major, props.minor) != (9, 0):
            raise RuntimeError(
                f"{kernel}: the kernel is built for sm_90a, device is "
                f"sm_{props.major}{props.minor} ({props.name})"
            )
        sms = _sm_counts[index] = props.multi_processor_count
    return index, sms


def current_stream(index: int) -> int:
    """The raw handle of PyTorch's current stream on device `index`."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)  # no Stream object built
    return raw(index) if raw is not None else torch.cuda.current_stream(index).cuda_stream


def on_device(index: int):
    """A context in which device `index` is current: nothing to enter when it
    already is, which is the usual case and costs no device switch."""
    return _CURRENT if torch.cuda.current_device() == index else torch.cuda.device(index)


def direct_launch(device: torch.device) -> bool:
    """Whether a wrapper's call on `device` launches without the operator:
    an eager call on the card does, since through the dispatcher the
    `torch.library` operator costs the host 8–38 µs more per launch than
    `_launch` alone (phase 2 of chip_smoke.py on an H100 80GB HBM3 at
    700 W, PERF.md §6); a traced call (torch.export,
    torch.compile) takes the operator, so the graph holds it."""
    return device.type == "cuda" and not torch.compiler.is_compiling()


def transformed(*tensors) -> bool:
    """Whether any of `tensors` is wrapped by a `torch.func` transform
    (`vmap`'s batched tensor, `grad`'s tracked one). Such a tensor has no
    storage a kernel could read: the wrappers then take the operator or
    their autograd Function, whose vmap rules hand the kernel plain
    tensors. None entries are skipped."""
    wrapped = torch._C._functorch.is_functorch_wrapped_tensor
    return any(t is not None and wrapped(t) for t in tensors)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA kernels are "
        "built from source at first use"
    )


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}.{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile the named kernels that are not built yet, in parallel.
    Returns nvcc's output (ptxas register and shared-memory use) for each
    kernel it compiled; raises with that output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        # unique temp name, then an atomic rename: concurrent builders in
        # other processes never load a half-written library
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    errors, logs = [], {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name} (rc {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, building it on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib
