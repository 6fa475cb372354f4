"""Detection serving CLI: the dynamic-batching HTTP server on the port.

Usage:
    python -m yolov4_tpu_torch.serve [--cfg configs/yolov4_Tianxiaomo.cfg] \
        [--ckpt model_best.ckpt] [--port 8000] [--sizes 608,416] \
        [--batch-size 16] [--max-wait-ms 8] [--conf-thre 0.25] \
        [--nms-thre 0.45] [--quant int8_static] [--device cuda | --mesh]
    python -m yolov4_tpu_torch.serve --artifact m608.y4t,m416.y4t

    curl -s -X POST --data-binary @bus.jpg \
        'http://127.0.0.1:8000/v1/detect?size=608'

The port's counterpart of the JAX package's serve.py, with its flags and
defaults. Checkpoints are a JAX package ``.ckpt``, a reference
``.pth``/``.pth.tar``/``.pt`` or an ``.npz`` state dict; ``--artifact``
serves exported files (``python -m yolov4_tpu_torch.tools.export_serving``)
with their baked weights and thresholds. Runs on CUDA unless ``--device``
names another device; a missing card is an error. ``--quant`` sets
``MODEL.QUANT``: with int8_static each size bucket calibrates its own
scales on its own first batch, as in the JAX package. ``--mesh`` shards
each serving batch over every local card (``parallel/mesh.create_mesh``),
one replica per card in a host thread and CUDA stream of its own, with the
batch-global maxima (the NMS's class-offset span, the dynamic int8
abs-max) taken over the whole mesh; ``--batch-size`` is then rounded up to
a whole number of rows per card. It takes no ``--device``.
"""

from __future__ import annotations

import argparse
import signal
from typing import Optional, Sequence

from yolov4_tpu_torch.config import load_config
from yolov4_tpu_torch.parallel.mesh import create_mesh
from yolov4_tpu_torch.serve import ServingRuntime, make_server
from yolov4_tpu_torch.utils.convert import load_weights
from yolov4_tpu_torch.utils.logging import get_logger, setup_logging


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(
        description="YOLOv4 serving (PyTorch/CUDA).")
    parser.add_argument("--cfg", type=str, default=None,
                        help="YAML config (default: built-in defaults)")
    parser.add_argument("--ckpt", type=str, default=None,
                        help="weights (.ckpt / .pth / .pth.tar / .pt / .npz)")
    parser.add_argument("--artifact", type=str, default=None,
                        help="comma-separated exported serving artifacts "
                             "(tools/export_serving.py): serve straight "
                             "from the files; overrides --cfg/--ckpt")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--sizes", type=str, default=None,
                        help="comma-separated input-size buckets, first is "
                             "the default (default: cfg TEST.IMGSIZE)")
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--max-wait-ms", type=float, default=8.0,
                        help="max time a request waits for batchmates")
    parser.add_argument("--inflight", type=int, default=3,
                        help="dispatched-but-unfetched batch window")
    parser.add_argument("--request-timeout-s", type=float, default=120.0,
                        help="per-request server-side completion deadline")
    parser.add_argument("--mesh", action="store_true",
                        help="shard each serving batch over every local "
                             "card (one replica per card, batch-global "
                             "maxima over the mesh; batch-size rounded up "
                             "to a whole number of rows per card)")
    parser.add_argument("--conf-thre", type=float, default=0.25,
                        help="bucket detection threshold (requests may "
                             "raise it per call via ?conf=); default 0.25, "
                             "a serving cut, not the cfg TEST.CONFTHRE "
                             "AP-sweep threshold; any negative value takes "
                             "the cfg's (val's output exactly)")
    parser.add_argument("--nms-thre", type=float, default=-0.1)
    parser.add_argument("--quant", choices=("none", "int8", "int8_static"),
                        default=None,
                        help="serving quantization (default cfg "
                             "MODEL.QUANT; int8* are not reference-exact; "
                             "int8_static calibrates each bucket on its "
                             "first batch)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="the device to serve on (not with --mesh)")
    return parser.parse_args(argv)


def build_runtime(args) -> ServingRuntime:
    """The runtime the flags describe (not started)."""
    logger = get_logger(__name__)
    if args.artifact:
        ignored = [name for name, val, default in (
            ("--ckpt", args.ckpt, None), ("--sizes", args.sizes, None),
            ("--quant", args.quant, None), ("--mesh", args.mesh, False),
            ("--batch-size", args.batch_size, 16),
            ("--conf-thre", args.conf_thre, 0.25),
            ("--nms-thre", args.nms_thre, -0.1),
        ) if val != default]
        if ignored:
            logger.warning(
                f"--artifact serves the baked program: {', '.join(ignored)} "
                f"have no effect (batch/size/thresholds are fixed at export "
                f"time; re-export to change them)")
        paths = [p for p in args.artifact.split(",") if p]
        runtime = ServingRuntime.from_artifacts(
            paths, max_wait_ms=args.max_wait_ms, inflight=args.inflight,
            request_timeout_s=args.request_timeout_s, device=args.device)
        logger.info(f"serving {len(paths)} artifact bucket(s) "
                    f"{runtime.sizes} (baked weights + thresholds)")
        return runtime
    mesh = None
    if args.mesh:
        if args.device != "cuda":
            raise SystemExit(f"error: --mesh shards over every local card; "
                             f"it takes no --device ({args.device})")
        mesh = create_mesh()
    cfg = load_config(args.cfg)
    if args.quant is not None:
        cfg["MODEL"]["QUANT"] = args.quant
    # conf defaults to a serving cut (0.25); a NEGATIVE value takes the cfg
    # TEST.CONFTHRE eval threshold; nms falls back to cfg TEST.NMSTHRE
    conf_thre = (cfg["TEST"]["CONFTHRE"] if args.conf_thre < 0
                 else args.conf_thre)
    nms_thre = (cfg["TEST"]["NMSTHRE"] if args.nms_thre < 0
                else args.nms_thre)
    sizes = ([int(s) for s in args.sizes.split(",")] if args.sizes
             else [cfg["TEST"]["IMGSIZE"]])
    state_dict = None
    if args.ckpt:
        state_dict = load_weights(args.ckpt)
        logger.info(f"loaded checkpoint {args.ckpt}")
    else:
        logger.warning("no --ckpt given: serving the seed-0 random init")
    runtime = ServingRuntime(
        cfg, state_dict=state_dict, sizes=sizes,
        batch_size=args.batch_size, max_wait_ms=args.max_wait_ms,
        inflight=args.inflight, conf_thre=conf_thre, nms_thre=nms_thre,
        request_timeout_s=args.request_timeout_s,
        device=None if mesh else args.device, mesh=mesh)
    where = (f"mesh {[str(d) for d in mesh.devices]}" if mesh
             else f"device {args.device}")
    batch = runtime.buckets[sizes[0]].batch_size
    logger.info(f"warming {len(sizes)} bucket(s) {sizes} at batch "
                f"{batch}, conf {conf_thre}, nms {nms_thre}, "
                f"quant {cfg['MODEL']['QUANT']}, {where}")
    return runtime


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    setup_logging(0)
    logger = get_logger(__name__)
    runtime = build_runtime(args)

    def _term(signum, frame):  # containers stop with SIGTERM
        raise KeyboardInterrupt

    # installed before the warmup: a SIGTERM while the kernels build must
    # take the graceful path too
    signal.signal(signal.SIGTERM, _term)
    srv = None
    try:
        runtime.start(warmup=True)
        srv = make_server(runtime, host=args.host, port=args.port)
        logger.info(f"serving on http://{args.host}:"
                    f"{srv.server_address[1]} — "
                    f"POST /v1/detect /v1/detect_raw, "
                    f"GET /healthz /metrics /stats /v1/config")
        srv.serve_forever()
    except KeyboardInterrupt:
        logger.info("shutting down")
    finally:
        if srv is not None:
            srv.shutdown()
        runtime.close()


if __name__ == "__main__":
    main()
