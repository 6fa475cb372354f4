"""Detection (``"driver": "detect"``): uint8 batches from a pool made in
set-up, kept ``in_flight`` deep through ``Predictor.dispatch`` /
``fetch_local`` (the port's validation loop, engine/evaluator.py). The
rate is the images whose detections reached the host, over the time from
the first dispatch to the last of those fetches.

Traffic keys: ``batch``, ``img_size``, ``in_flight``, ``pool`` (batches
made in set-up and cycled), ``cfg`` (overrides of the configuration's
program settings).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import check, reference, weights
from portbench.drivers import Driver as Base
from portbench.drivers import program_cfg
from portbench.reference.detect import postprocess as ref_postprocess
from portbench.reference.train import tf32_off
from portbench.trace import Tracer

# images of the first pool batch that calibrate the BN statistics, and the
# reference's rows per forward
BLOCK = 16


class Driver(Base):
    RATE = "detect_img_per_s"
    FAULTS = ("half_batch", "altered")
    SMALL = dict(batch=4, img_size=64, pool=2)

    def setup(self) -> None:
        from yolov4_tpu_torch.engine.predictor import Predictor
        t = time.perf_counter()
        if self.device.type == "cuda":
            from yolov4_tpu_torch.ops import csp_cuda, nms_cuda
            nms_cuda.load()
            csp_cuda._load()
            t = self._part("kernels", t)
        tr, cf = self.traffic, self.config
        self.batch, self.size = int(tr["batch"]), int(tr["img_size"])
        self.n_classes = int(cf["n_classes"])
        state = weights.make_weights(cf, self.seed, self.device)
        pool = weights.detect_pool(self.seed, int(tr["pool"]), self.batch,
                                   self.size, self.device)
        weights.calibrate(cf, state, pool[0, :min(BLOCK, self.batch)])
        self.host_pool = [b.numpy() for b in pool.cpu()]
        self.state = {k: v.cpu() for k, v in state.items()}
        del pool, state
        t = self._part("weights", t)
        cfg = program_cfg(cf, tr)
        self.settings = dict(conf=cfg["TEST"]["CONFTHRE"],
                             nms=cfg["TEST"]["NMSTHRE"],
                             topk=cfg["TEST"]["PRE_NMS_TOPK"],
                             max_dets=cfg["TEST"]["MAX_DETS"])
        self.pred = Predictor(cfg, state_dict=self.state,
                              img_size=self.size, batch_size=self.batch,
                              device=self.device)
        self.dispatch = self.wrap(self.pred.dispatch)
        t = self._part("program", t)
        # warm-up: every pool batch once, as deep in flight as the window
        self._loop(len(self.host_pool), None, keep=False)
        self._part("warmup", t)

    def _loop(self, limit, tracer, keep: bool, seconds: float = 0.0):
        """Dispatch pool batches ``in_flight`` deep until ``limit``
        batches or ``seconds`` have passed; returns the (index, seconds
        from the start to its fetch (inf once past the window), outputs)
        of each fetch."""
        depth = int(self.traffic["in_flight"])
        n_pool = len(self.host_pool)
        span = tracer.span if tracer else (
            lambda name: contextlib.nullcontext())
        flight, done = [], []
        t0 = time.perf_counter()
        i = 0
        while True:
            more = (i < limit if limit is not None
                    else time.perf_counter() - t0 < seconds)
            while more and len(flight) < depth:
                with span("portbench.dispatch"):
                    out = self.dispatch(self.host_pool[i % n_pool])
                flight.append((i, out))
                i += 1
                more = (i < limit if limit is not None
                        else time.perf_counter() - t0 < seconds)
            if not flight:
                break
            j, out = flight.pop(0)
            with span("portbench.fetch"):
                host = self.pred.fetch_local(out)
            at = time.perf_counter()
            done.append((j, at - t0, tuple(np.copy(h) for h in host[:2])
                         if keep else None))
            if limit is None and not more:
                # past the window: what is still in flight only drains
                for j, out in flight:
                    host = self.pred.fetch_local(out)
                    done.append((j, float("inf"),
                                 tuple(np.copy(h) for h in host[:2])))
                break
        return done

    def window(self, seconds: float, tracer) -> None:
        with tracer.window():
            done = self._loop(None, tracer, keep=True, seconds=seconds)
        inside = [d for d in done if d[1] <= seconds]
        self.attempted = len(done) * self.batch
        self.work = len(inside) * self.batch
        self.window_s = max((d[1] for d in inside), default=seconds)
        # every dispatched batch's kernels ran inside the (traced) window
        self.forwards = len(done)
        self.traced_images = len(done) * self.batch
        self.done = done

    def release(self) -> None:
        del self.pred, self.dispatch
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, List[float]]:
        """The numbers of check.detection_gaps over one fetch of each pool
        batch, drawn from the seed."""
        rng = np.random.default_rng(self.seed)
        n_pool = len(self.host_pool)
        per_image = {}
        with torch.device("meta"):
            model = reference.build(self.config)
        model = model.to_empty(device=self.device)
        model.load_state_dict(self.state)
        model.eval()
        block = min(BLOCK, self.batch)
        for slot in range(n_pool):
            fetched = [d for d in self.done if d[0] % n_pool == slot]
            if not fetched:
                continue
            _, _, (det, valid) = fetched[int(rng.integers(len(fetched)))]
            images = torch.from_numpy(self.host_pool[slot]).to(self.device)
            with torch.no_grad(), tf32_off():
                pred = torch.cat([
                    model(images[r:r + block].permute(0, 3, 1, 2).float()
                          / 255.0)
                    for r in range(0, self.batch, block)])
                s = self.settings
                ref_det, ref_valid = ref_postprocess(
                    pred, self.n_classes, s["conf"], s["nms"], s["topk"],
                    s["max_dets"])
            gaps = check.detection_gaps(
                torch.from_numpy(det).to(self.device),
                torch.from_numpy(valid).to(self.device), pred, ref_det,
                ref_valid, self.n_classes)
            for k, v in gaps.items():
                per_image.setdefault(k, []).extend(v)
            del pred
        return check.pooled(per_image)

    def readings(self, seconds: float) -> Dict:
        self.setup()
        self.window(seconds, Tracer(False))
        self.release()
        return {k: max(v) for k, v in self.check().items()}

    def control(self, seconds: float) -> Dict:
        """The program with its own int8 path switched on
        (``MODEL.QUANT`` int8), below the configuration's bfloat16."""
        cfg = self.traffic.get("cfg", {})
        traffic = dict(self.traffic, cfg={
            **cfg, "MODEL": {**cfg.get("MODEL", {}), "QUANT": "int8"}})
        return Driver(self.config, traffic, self.seed, self.device,
                      self.wrap).readings(seconds)
