"""HTTP serving front-end (standard library only), the counterpart of
``si_mamba_tpu/serve_http.py``.

A ``Predictor`` (``serving.py``) behind a ``MicroBatcher`` (deadline-driven
request coalescing) behind a threaded HTTP server: concurrent clients'
single-cloud requests coalesce into one batched forward on the card, which
launches the conv and scan kernels once a block for the whole batch.

Endpoints:

- ``POST /predict``: the body is one point cloud, either an ``.npy`` payload
  (``np.save`` of a float32 (N, 3) array, Content-Type
  ``application/octet-stream``) or JSON ``{"points": [[x, y, z], ...]}``.
  Response: ``{"label": int, "probs": [...]}``, probabilities rounded to 6
  places.
- ``GET /healthz``: liveness and batching statistics
  (``{"ok": true, "n_requests": ..., "n_batches": ..., "mean_batch_size": ...}``).

A malformed cloud or a bad ``Content-Length`` answers 400, an unknown route
404, and a failure of the batch function 500 with the exception's name.

Run against a checkpoint (a reference-format ``.pth``, this package's
``ckpt-*.pth`` among them; an orbax directory raises)::

    python -m si_mamba_tpu_torch.serve_http --ckpt experiments/.../ckpt-best.pth \\
        --cls_dim 40 --port 8410 --max_delay_ms 5

Library use::

    server = make_server(fn, port=0)           # fn: (b, N, 3) -> (b, C)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    ...
    shutdown_server(server)
"""

from __future__ import annotations

import io
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from si_mamba_tpu_torch.serving import MicroBatcher

MAX_BODY = 64 * 1024 * 1024  # one cloud is ~24 KB at N=2048


def _parse_cloud(body: bytes, content_type: str) -> np.ndarray:
    if content_type.startswith("application/octet-stream"):
        arr = np.load(io.BytesIO(body), allow_pickle=False)
    else:
        arr = np.asarray(json.loads(body.decode())["points"], np.float32)
    arr = np.asarray(arr, np.float32)
    if arr.ndim != 2 or arr.shape[-1] != 3 or arr.shape[0] < 1:
        raise ValueError(f"expected one (N, 3) cloud, got shape {arr.shape}")
    return arr


class _Handler(BaseHTTPRequestHandler):
    # set by make_server on the handler subclass:
    batcher: MicroBatcher = None  # type: ignore[assignment]
    timeout_s: float = 120.0

    def _reply(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (http.server API)
        if self.path != "/healthz":
            return self._reply(404, {"error": f"no route {self.path}"})
        b = self.batcher
        self._reply(200, {"ok": True, "n_requests": b.n_requests, "n_batches": b.n_batches,
                          "mean_batch_size": round(b.mean_batch_size, 2)})

    def do_POST(self):  # noqa: N802
        if self.path != "/predict":
            return self._reply(404, {"error": f"no route {self.path}"})
        try:
            length = int(self.headers.get("Content-Length", "0"))
            if not 0 < length <= MAX_BODY:
                raise ValueError(f"bad Content-Length {length}")
            cloud = _parse_cloud(self.rfile.read(length), self.headers.get("Content-Type", ""))
        except Exception as e:
            return self._reply(400, {"error": str(e)})
        try:
            probs = self.batcher.submit(cloud).result(timeout=self.timeout_s)
        except Exception as e:
            return self._reply(500, {"error": f"{type(e).__name__}: {e}"})
        probs = np.asarray(probs, np.float64)
        self._reply(200, {"label": int(probs.argmax()),
                          "probs": [round(float(p), 6) for p in probs]})

    def log_message(self, fmt, *args):  # quiet: the caller owns the logs
        pass


class _Server(ThreadingHTTPServer):
    # a listen backlog for bursts of concurrent clients (the default, 5, drops
    # connection attempts beyond it, which then retry a second later)
    request_queue_size = 128


def make_server(fn, *, host: str = "127.0.0.1", port: int = 8410, max_batch: int = 64,
                max_delay_ms: float = 5.0, timeout_s: float = 120.0) -> ThreadingHTTPServer:
    """Build (not start) the server. ``fn``: (b, N, 3) -> (b, n_classes)
    probabilities, e.g. ``Predictor.predict_proba``. ``port=0`` binds a free
    port (read it from ``server.server_address``). Call
    ``server.serve_forever()`` (usually on a thread) and stop with
    :func:`shutdown_server`, which drains the batcher."""
    handler = type("Handler", (_Handler,), {
        "batcher": MicroBatcher(fn, max_batch=max_batch, max_delay_ms=max_delay_ms),
        "timeout_s": float(timeout_s),
    })
    return _Server((host, port), handler)


def shutdown_server(server: ThreadingHTTPServer) -> None:
    server.shutdown()
    server.server_close()
    server.RequestHandlerClass.batcher.stop()


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt", required=True,
                    help="a reference-format .pth (this package's ckpt-*.pth among them)")
    ap.add_argument("--cls_dim", type=int, default=40)
    ap.add_argument("--npoints", type=int, default=1024)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8410)
    ap.add_argument("--max_batch", type=int, default=64)
    ap.add_argument("--max_delay_ms", type=float, default=5.0)
    ap.add_argument("--perf", action="store_true",
                    help="bf16 activations + the subspace eigensolver")
    ap.add_argument("--device", default="cuda",
                    help="the device to run on: 'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    from si_mamba_tpu_torch.serving import Predictor

    pred = Predictor.from_checkpoint(args.ckpt, model_cfg={"cls_dim": args.cls_dim},
                                     npoints=args.npoints, max_batch=args.max_batch,
                                     perf=args.perf, device=args.device)
    print("warming up (building the kernels)...", flush=True)
    pred.warmup()
    server = make_server(pred.predict_proba, host=args.host, port=args.port,
                         max_batch=args.max_batch, max_delay_ms=args.max_delay_ms)
    print(f"serving on http://{args.host}:{server.server_address[1]} "
          f"(POST /predict, GET /healthz)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        shutdown_server(server)


if __name__ == "__main__":
    main()
