"""HTTP model server over a serving artifact or a trained run (counterpart of
`mmtpu/cli/serve.py`).

    python -m mmtpu_torch.cli.serve --artifact model.mmx [--port 8900] \
        [--max-batch 64] [--max-wait-ms 5] [--cpu]
    python -m mmtpu_torch.cli.serve --config X.yaml --run_id N \
        [--checkpoint best] [--port 8900] [--max-batch 64] [--max-wait-ms 5] [--cpu]

Endpoints (JSON over stdlib http.server), the same as mmtpu's:

    GET  /health   {"status": "ok", ...}
    GET  /meta     the artifact's meta, or the task's (input keys, shapes, dtypes)
    GET  /stats    micro-batcher counters (requests, batches, padded rows)
    POST /predict  one sample, one array per input key of the model
                   ({"audio": [...], "image": [...]} for AVMNIST,
                   {"audio": [...], "video": [...], "text": [...]} for
                   UttFusion, {"image": [...], "text": [...]} for MM-IMDb; a
                   missing modality is sent as zeros, a request that lacks a
                   key is refused with 400)
                   → {"preds": ..., "probs": [...], "logits": [...]} (MM-IMDb:
                   23 genre flags and their sigmoids; /meta says "multilabel")
    POST /predict_batch  pre-batched arrays, bypasses the batcher

Concurrent /predict requests are grouped by `MicroBatcher` into padded
power-of-two batches; a request whose arrays do not have the artifact's (or
the task's) trailing shape is refused with 400. The model runs on the GPU
(AVMNIST's fusion head and UttFusion's LSTM recurrences each as one kernel,
also inside an artifact) unless `--cpu`, in both modes. An artifact is the
port's own (`predict --export`, `train_cmam --export-serving`); mmtpu's
StableHLO artifact is refused with its name.
"""

from __future__ import annotations

import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np


def arg_parser():
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--artifact", help="Serving artifact from predict --export or "
                                        "train_cmam --export-serving")
    src.add_argument("--config", help="YAML (or .json plain-dict) config of a trained run")
    p.add_argument("--run_id", type=int, default=1)
    p.add_argument("--checkpoint", default="best")
    p.add_argument("--split", default="test",
                   help="config mode: split used to infer input shapes")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8900)
    p.add_argument("--max-batch", dest="max_batch", type=int, default=64)
    p.add_argument("--max-wait-ms", dest="max_wait_ms", type=float, default=5.0)
    p.add_argument("--cpu", action="store_true", help="Run on the CPU instead of CUDA")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--dry-run", dest="dry_run", action="store_true",
                   help="Build everything, bind the socket, exit")
    # no training here: the monitor setting is not read (as mmtpu's)
    p.set_defaults(disable_monitoring=True)
    return p


def load_model(args):
    """Returns (predict, meta): a Predictor or a ServedModel, and the meta
    that carries input_keys/shapes/dtypes for request decoding (an
    artifact's own meta)."""
    from mmtpu_torch.cli import common

    device = common.resolve_device(args.cpu)
    if args.artifact:
        from mmtpu_torch.serving import load_artifact

        served = load_artifact(args.artifact, device)
        return served, dict(served.meta)
    from mmtpu_torch.cli.predict import build_task_and_loader
    from mmtpu_torch.serving import Predictor

    cfg = common.load_config(args)
    task, loader = build_task_and_loader(cfg, args, device)
    example = next(iter(loader))
    meta = {
        "input_keys": [str(k) for k in task.input_keys],
        "input_shapes": [["b", *example[k].shape[1:]] for k in task.input_keys],
        "input_dtypes": [str(example[k].dtype) for k in task.input_keys],
        "outputs": ["logits", "preds", "probs"],
        "multilabel": bool(task.multilabel),
        "model": type(task.model).__name__,
        "checkpoint": args.checkpoint,
        "device": str(device),
    }
    return Predictor(task, device), meta


class _Handler(BaseHTTPRequestHandler):
    # injected by make_server:
    batcher = None
    predict = None
    meta: Dict[str, Any] = {}
    quiet = True

    def log_message(self, fmt, *a):  # stdlib default spams stderr per request
        if not self.quiet:
            super().log_message(fmt, *a)

    def _send(self, code: int, payload: Dict[str, Any]) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_json(self) -> Dict[str, Any]:
        length = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(length) or b"{}")

    def do_GET(self) -> None:  # noqa: N802 (stdlib API)
        if self.path == "/health":
            self._send(200, {"status": "ok", "model": self.meta.get("model", "")})
        elif self.path == "/meta":
            self._send(200, self.meta)
        elif self.path == "/stats":
            self._send(200, dict(self.batcher.stats))
        else:
            self._send(404, {"error": f"unknown path {self.path}"})

    def do_POST(self) -> None:  # noqa: N802
        try:
            body = self._read_json()
        except ValueError as e:  # json.JSONDecodeError is a ValueError
            self._send(400, {"error": f"bad JSON: {e}"})
            return
        keys = self.meta["input_keys"]
        dtypes = self.meta.get("input_dtypes", ["float32"] * len(keys))
        try:
            if self.path == "/predict":
                sample = {
                    k: np.asarray(body[k], dtype=np.dtype(d))
                    for k, d in zip(keys, dtypes)
                }
                row = self.batcher.submit(sample).result(timeout=60)
                self._send(200, {k: v.tolist() for k, v in row.items()})
            elif self.path == "/predict_batch":
                arrays = [
                    np.asarray(body[k], dtype=np.dtype(d))
                    for k, d in zip(keys, dtypes)
                ]
                out = self.predict(*arrays)
                self._send(200, {k: np.asarray(v).tolist() for k, v in out.items()})
            else:
                self._send(404, {"error": f"unknown path {self.path}"})
        except KeyError as e:
            self._send(400, {"error": f"missing input {e}; expected {keys}"})
        except ValueError as e:  # shape contract violations → client error
            self._send(400, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 — surface, keep serving
            self._send(500, {"error": str(e)})


class _Server(ThreadingHTTPServer):
    # listen backlog: with the default of 5, a burst of more concurrent
    # clients than that overflows the accept queue and the kernel resets
    # some of their connections
    request_queue_size = 128


def make_server(
    predict,
    meta: Dict[str, Any],
    host: str = "127.0.0.1",
    port: int = 0,
    max_batch: int = 64,
    max_wait_ms: float = 5.0,
    quiet: bool = True,
):
    """Build (ThreadingHTTPServer, MicroBatcher); caller runs serve_forever.
    port=0 binds an ephemeral port; server.server_address has it."""
    from mmtpu_torch.serving import MicroBatcher

    shapes = None
    if meta.get("input_shapes"):
        shapes = {
            k: list(dims[1:])
            for k, dims in zip(meta["input_keys"], meta["input_shapes"])
        }
    batcher = MicroBatcher(
        predict, meta["input_keys"], max_batch=max_batch,
        max_wait_ms=max_wait_ms, input_shapes=shapes,
    )
    handler = type(
        "BoundHandler", (_Handler,),
        {"batcher": batcher, "predict": staticmethod(predict), "meta": meta,
         "quiet": quiet},
    )
    server = _Server((host, port), handler)
    return server, batcher


def main(argv=None) -> int:
    args = arg_parser().parse_args(argv)
    predict, meta = load_model(args)
    server, batcher = make_server(
        predict, meta, host=args.host, port=args.port,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
    )
    host, port = server.server_address[:2]
    print(f"serving {meta.get('model', 'model')} on http://{host}:{port} "
          f"({predict.device}, max_batch={args.max_batch}, "
          f"max_wait_ms={args.max_wait_ms})", flush=True)
    if args.dry_run:
        server.server_close()
        batcher.close()
        return 0
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        batcher.close()
    return 0


class ServerThread:
    """Run the server on a thread (tests, in-process smoke runs); the
    context exit shuts it down and drains the batcher."""

    def __init__(self, predict, meta, **kw):
        self.server, self.batcher = make_server(predict, meta, **kw)
        host, port = self.server.server_address[:2]
        self.url = f"http://{host}:{port}"
        self._t: Optional[threading.Thread] = None

    def __enter__(self) -> "ServerThread":
        self._t = threading.Thread(target=self.server.serve_forever, daemon=True)
        self._t.start()
        return self

    def __exit__(self, *exc) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.batcher.close()
        if self._t is not None:
            self._t.join()


if __name__ == "__main__":
    sys.exit(main())
