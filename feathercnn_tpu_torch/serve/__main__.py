"""Serving CLI — counterpart of ``feathercnn_tpu/serve/__main__.py``: load a
model, start the continuous-batching server and its HTTP front-end.

    python -m feathercnn_tpu_torch.serve --model out.ftpu --port 8000
    python -m feathercnn_tpu_torch.serve --zoo resnet50 --quant w8a8
    python -m feathercnn_tpu_torch.serve --model out.ftpu --device cpu

One process owning the card, callers over HTTP (POST /infer with .npy or
JSON; GET /healthz, /metrics).  A ``--model`` file loads through the C++
mmap loader (``Engine.from_path``), and the server batches on the C++
queue.  Like every entry point of the port it runs on the GPU unless
``--device cpu`` asks for the CPU, and raises on a host without one.
Multi-process: with the FEATHERCNN_* env triple set
(``FEATHERCNN_COORDINATOR=tcp://host:port``, ``FEATHERCNN_NUM_PROCESSES``,
``FEATHERCNN_PROCESS_ID``) each process joins the group first
(``parallel.maybe_initialize_distributed``) and prints ``distributed:
process i/n`` on stderr; every batch then runs on rank 0's plan
(``broadcast_plan``).  ``--dist-backend`` is NCCL on the GPU, gloo on the
CPU; processes that share one GPU must ask for gloo.  Float32 convolutions
and products on the card compute in float32 (TF32 off, as the port's
tests and ``chip_smoke.py`` hold them), so an answer equals the engine's
direct run.  SIGINT or SIGTERM stops the server.
"""

from __future__ import annotations

import argparse
import signal
import sys

import numpy as np


def _interrupt(signum, frame):
    raise KeyboardInterrupt


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m feathercnn_tpu_torch.serve")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--model", help="path to a .ftpu artifact")
    src.add_argument("--zoo", help="zoo model name (random weights)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--batch-slots", default=None,
                    help="comma list of extra batch sizes run at start")
    ap.add_argument("--batch-timeout-us", type=int, default=2000)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--backend", default="cuda",
                    help="cuda (the hand-written kernels) or torch")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--quant", default=None, help="w8|w8a8")
    ap.add_argument("--im-info", default=None, metavar="H,W,SCALE",
                    help="fixed im_info row for two-stage detectors "
                    "(default: derived from the input spec)")
    ap.add_argument("--extra-input", action="append", default=[],
                    metavar="NAME=V1,V2,...",
                    help="fixed flat value for an extra graph input "
                    "(reshaped to its spec); repeatable")
    ap.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                    help="process group backend under the FEATHERCNN_* env "
                    "triple (default: nccl on cuda, gloo on cpu)")
    args = ap.parse_args(argv)

    import torch

    # Multi-process start before the first use of the device: env-gated,
    # a no-op for one process.
    from ..parallel import maybe_initialize_distributed
    backend = args.dist_backend or (
        "gloo" if args.device == "cpu" else "nccl")
    if maybe_initialize_distributed(backend):
        import torch.distributed as dist
        print(f"distributed: process {dist.get_rank()}/"
              f"{dist.get_world_size()}", file=sys.stderr, flush=True)

    from .. import Engine, EngineConfig
    from ..utils.timing import default_extra_inputs
    from . import HttpFrontend, InferenceServer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = EngineConfig(compute_dtype=args.dtype, backend=args.backend,
                       quant=args.quant or None)
    if args.model:
        eng = Engine.from_path(args.model, cfg, device=args.device)
    else:
        from ..models import MODEL_BUILDERS
        eng = Engine(MODEL_BUILDERS[args.zoo](batch=args.batch_size), cfg,
                     device=args.device)

    # Fixed values for graph inputs beyond the image (two-stage
    # detectors need im_info): start from the spec-derived defaults,
    # then apply CLI overrides.
    extra = default_extra_inputs(eng.graph)
    if args.im_info is not None:
        row = np.asarray([float(v) for v in args.im_info.split(",")],
                         np.float32)
        spec = eng.graph.inputs.get("im_info")
        if spec is None:
            ap.error("--im-info given but the graph has no im_info input")
        extra["im_info"] = np.tile(row[None], (spec.shape[0], 1))
    for kv in args.extra_input:
        name, _, vals = kv.partition("=")
        spec = eng.graph.inputs.get(name)
        if spec is None:
            ap.error(f"--extra-input {name!r}: no such graph input")
        flat = np.asarray([float(v) for v in vals.split(",")], np.float32)
        extra[name] = flat.reshape(spec.shape)

    slots = ([int(s) for s in args.batch_slots.split(",")]
             if args.batch_slots else None)
    srv = InferenceServer(eng, batch_size=args.batch_size,
                          batch_timeout_us=args.batch_timeout_us,
                          batch_slots=slots,
                          extra_inputs=extra or None)
    print("running the batch slots once...", file=sys.stderr, flush=True)
    srv.start()
    front = HttpFrontend(srv, host=args.host, port=args.port)
    signal.signal(signal.SIGTERM, _interrupt)
    try:
        # inside the try: a SIGTERM right after this line still stops the
        # server cleanly
        print(f"serving on {args.host}:{front.port} "
              f"(POST /infer, GET /healthz, GET /metrics)",
              file=sys.stderr, flush=True)
        front.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        front.stop()
        srv.stop()
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
