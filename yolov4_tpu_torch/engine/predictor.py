"""Batched inference: forward + decode + NMS on the device.

The device program takes a flat planar wire batch ``[B, 3*S*S]`` (uint8,
or float32 in [0, 1]) padded to a static batch size to fixed-shape
detections; the host only unmaps coordinates back to the source images.
Port of the JAX package's engine/predictor.py, planar wire only (its s2d
wire is a TPU lowering). ``detection_program`` is that program, shared by
the live ``Predictor`` and the exported serving artifact
(utils/export.py), so that the two compute the same function op for op.

``dispatch`` uploads a uint8 NHWC host batch as it is, runs the program
on its channels-last NCHW view (``detection_forward``, the program after
the wire's reshape) and enqueues the copies of its outputs into pinned
host memory behind a CUDA event; ``fetch_local`` waits on that event
alone, so a fetch never waits behind batches dispatched after it (the
serving batcher keeps several in flight). Both bind the predictor's card,
so they may run in any host thread.

With ``MODEL.QUANT`` "int8_static" the predictor owns its calibrated
scales (the JAX package's "quant" collection): ``calibrate`` records them
from a batch (they only grow), the first ``dispatch`` calibrates on its
own batch when nobody did, a change to the weights the scales were
recorded from (a reload) calibrates again, ``warmup`` runs on seed scales
it never publishes, and ``quant_state`` publishes the calibrated scales
for another predictor (or an export) to keep. Predictors sharing one
model (the serving runtime's buckets) keep scales of their own.

With a ``mesh`` of several replicas (parallel/mesh.py) ``dispatch`` shards
each batch over them, as the JAX package's mesh predictor does, with the
batch-global maxima taken over the whole mesh (``Predictor``). With a
``group`` of ranks (torch.distributed, one process a rank) each rank runs
its own batch and the maxima are taken over the group's ranks, as the JAX
package's predictor over a mesh of several processes does.
"""

from __future__ import annotations

import copy
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from yolov4_tpu_torch.models import build_model
from yolov4_tpu_torch.models.layers import (ConvBNAct, prefold_stages,
                                            quant_entries, quant_scope)
from yolov4_tpu_torch.models.yolov4 import quant_mode
from yolov4_tpu_torch.ops.postprocess import postprocess
from yolov4_tpu_torch.ops.replica import group_scope
from yolov4_tpu_torch.parallel.mesh import Mesh, ReplicaRunner
# the entry points import the device rule from here
from yolov4_tpu_torch.utils.device import device_scope, resolve_device

QuantState = Dict[str, Dict[str, torch.Tensor]]


def pad_batch(images: np.ndarray, batch_size: int) -> np.ndarray:
    """Zero-pad an NHWC host batch to ``batch_size`` rows (one static
    device shape per predictor)."""
    n = images.shape[0]
    if n > batch_size:
        raise ValueError(f"batch {n} exceeds the predictor's size {batch_size}")
    if n < batch_size:
        pad = np.zeros((batch_size - n, *images.shape[1:]), images.dtype)
        images = np.concatenate([images, pad])
    return np.ascontiguousarray(images)


def pack_wire(images: np.ndarray, batch_size: int) -> np.ndarray:
    """An NHWC host batch as the flat planar wire: padded to
    ``batch_size``, channels first, flattened to [batch_size, 3*S*S] (the
    JAX package's ``pack_wire`` without its s2d layout)."""
    padded = pad_batch(images, batch_size)
    return np.ascontiguousarray(padded.transpose(0, 3, 1, 2)).reshape(
        batch_size, -1)


def nhwc_to_wire(images: torch.Tensor) -> torch.Tensor:
    """A uint8 (or float32) NHWC device batch as the flat planar wire."""
    return images.permute(0, 3, 1, 2).reshape(images.shape[0], -1)


def model_input(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The model's input from an NCHW batch (uint8, or float32 in [0, 1];
    any strides), channels-last: uint8 normalized by 1/255 unless the
    model's direct-u8 stem takes it as it is."""
    takes_uint8 = getattr(model, "takes_uint8", None)
    if not (takes_uint8 is not None and takes_uint8(x)):
        x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
    return x.contiguous(memory_format=torch.channels_last)


def detection_forward(model: nn.Module, x: torch.Tensor,
                      settings: Dict) -> Tuple[torch.Tensor, ...]:
    """An NCHW batch -> ``model_input`` -> forward -> decode ->
    postprocess (K1). Returns (detections, valid[, relevant_count]).
    ``settings``: the keyword arguments of ops/postprocess.postprocess
    after its first two."""
    return postprocess(model(model_input(model, x)), **settings)


def detection_program(model: nn.Module, flat: torch.Tensor, img_size: int,
                      settings: Dict) -> Tuple[torch.Tensor, ...]:
    """The serving program on the planar wire [B, 3*S*S]: reshaped to
    NCHW, then ``detection_forward``."""
    return detection_forward(
        model, flat.reshape(flat.shape[0], 3, img_size, img_size), settings)


class DetectionProgram(nn.Module):
    """``detection_program`` with its model, settings and int8_static
    scales bound: what utils/export.py traces (the scales become constants
    of the program)."""

    def __init__(self, model: nn.Module, img_size: int, settings: Dict,
                 quant_state: Optional[QuantState] = None):
        super().__init__()
        self.model = model
        self.img_size = img_size
        self.settings = dict(settings)
        self.quant_state = quant_state

    def forward(self, flat: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        with quant_scope(self.quant_state):
            return detection_program(self.model, flat, self.img_size,
                                     self.settings)


@dataclass(frozen=True)
class Dispatched:
    """One dispatched batch: ``host``, its outputs (detections, valid[,
    relevant_count]) as copies in pinned host memory (the outputs
    themselves on the CPU), and ``event``, recorded after those copies
    (None on the CPU)."""

    host: Tuple[torch.Tensor, ...]
    event: Optional["torch.cuda.Event"]


def _check_uint8(images: np.ndarray) -> None:
    if images.dtype != np.uint8:
        raise TypeError(f"images must be uint8 NHWC, got {images.dtype}")


def upload_nhwc(images: np.ndarray, batch_size: int,
                device: torch.device) -> torch.Tensor:
    """Pad an NHWC host batch and copy it to ``device`` (through pinned
    memory, without waiting, to a card)."""
    host = torch.from_numpy(pad_batch(images, batch_size))
    if device.type == "cuda":
        host = host.pin_memory()
    return host.to(device, non_blocking=True)


def start_fetch(outs: Tuple[torch.Tensor, ...],
                device: torch.device) -> Dispatched:
    """Enqueue the copies of ``outs`` into fresh pinned host tensors on the
    current stream and record an event after them. PyTorch's caching host
    allocator hands a pinned block out again only once the copy that used
    it has completed, so the buffers of batches in flight never alias."""
    if device.type != "cuda":
        return Dispatched(tuple(outs), None)
    host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
            for o in outs]
    for h, o in zip(host, outs):
        h.copy_(o, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return Dispatched(tuple(host), event)


def fetch_local(out: Dispatched) -> Tuple[np.ndarray, ...]:
    """The outputs of one dispatched batch as numpy arrays (all rows,
    padding included), after waiting for its own copies only."""
    if out.event is not None:
        out.event.synchronize()
    return tuple(h.numpy() for h in out.host)


class Predictor:
    """Static-batch detector on one device, or sharded over a mesh.

    ``state_dict``: weights in the port's (= the reference's) key layout;
    None keeps the reference init drawn from seed 0 (``build_model``).
    ``model``: an already built and loaded model to share (the serving
    runtime's buckets share one set of weights on the card), or another
    mesh predictor's ``replicas``; ``cfg`` and ``state_dict`` then do not
    build it again. ``device``: None means CUDA. ``quant_state``:
    int8_static scales a calibrated predictor published (``quant_state``),
    kept for these weights instead of calibrating on the first batch.

    ``mesh`` (parallel/mesh.create_mesh) of more than one replica: the JAX
    package's mesh predictor in one process. ``batch_size`` is rounded up
    to a whole number of rows per replica. Each distinct device of the
    mesh holds one copy of the weights (``replicas``; the others are
    copied from the first when the predictor is built, so later changes to
    ``model``'s weights do not reach them). ``dispatch`` gives each replica
    its rows, on its device, in a host thread and a CUDA stream of its
    own (parallel/mesh.ReplicaRunner), and the batch-global maxima (the
    NMS's class-offset span, the dynamic int8 abs-max) are taken over the
    whole mesh, so that the rows equal the unsharded predictor's on the
    same batch. The predictor's ``device`` is the mesh's first
    (``device`` must not be given as well); a mesh of one replica is that
    device alone. ``run``, ``run_wire`` and ``program`` stay the program
    on ``device`` alone.

    ``group`` (a ``torch.distributed`` process group; not with ``mesh``):
    the JAX package's predictor over a mesh of several processes, one rank
    here being one process there. Each rank calls ``dispatch`` (or
    ``run``, ``run_wire``, ``calibrate``, ``warmup``) on its own batch of
    ``batch_size`` rows, every rank as often as the others, and the
    batch-global maxima are taken over the group's ranks
    (ops/replica.group_scope), so that each rank's rows equal those of
    the unsharded predictor on the ranks' batches side by side.
    int8_static calibration records the same scales on every rank. A
    group of one rank gives the plain predictor's rows. ``program`` stays
    the program of this rank alone, which export refuses.
    """

    def __init__(self, cfg: Dict, state_dict: Optional[Dict] = None,
                 img_size: Optional[int] = None, batch_size: int = 8,
                 conf_thre: Optional[float] = None,
                 nms_thre: Optional[float] = None,
                 device=None,
                 model: Union[nn.Module, Dict[torch.device, nn.Module],
                              None] = None,
                 quant_state: Optional[QuantState] = None,
                 mesh: Optional[Mesh] = None, group=None):
        if mesh is not None and group is not None:
            raise ValueError("pass mesh or group, not both")
        if mesh is not None:
            if device is not None:
                raise ValueError("pass device or mesh, not both")
            device = mesh.devices[0]
            batch_size = mesh.round_batch(batch_size)
            mesh = mesh if mesh.size > 1 else None
        self.device = resolve_device(device)
        self.mesh = mesh
        self.group = group
        self.cfg = cfg
        if model is not None and state_dict is not None:
            raise ValueError("pass state_dict or model, not both")
        devices = (self.device,) if mesh is None else mesh.distinct_devices
        if isinstance(model, dict):
            if set(model) != set(devices):
                raise ValueError(f"replicas on {sorted(map(str, model))} "
                                 f"for devices {[str(d) for d in devices]}")
            replicas = model
        else:
            if model is None:
                model = build_model(cfg, device=self.device)
                if state_dict is not None:
                    model.load_state_dict(state_dict)
                model.eval()
                if self.device.type == "cuda":
                    model = model.to(memory_format=torch.channels_last)
            replicas = {self.device: model}
            for d in devices[1:]:
                replicas[d] = copy.deepcopy(model).to(d)
        self.replicas: Dict[torch.device, nn.Module] = {
            d: replicas[d] for d in devices}
        self.model = self.replicas[self.device]
        self._runner = None if mesh is None else ReplicaRunner(mesh)
        self.img_size = img_size or cfg["TEST"]["IMGSIZE"]
        self.batch_size = batch_size
        test = cfg["TEST"]
        self.conf_thre = test["CONFTHRE"] if conf_thre is None else conf_thre
        self.nms_thre = test["NMSTHRE"] if nms_thre is None else nms_thre
        self.num_classes = cfg["MODEL"]["N_CLASSES"]
        self.pre_nms_topk = test.get("PRE_NMS_TOPK", 2048)
        self.max_dets = test.get("MAX_DETS", 100)
        self.topk_approx = bool(test.get("APPROX_TOPK", False))
        # pycocotools-style per-(image, category) cap; when the fixed-size
        # output is deeper than it, also count scoring-relevant rows
        self.cat_cap = int(test.get("CAT_CAP", 100))
        self.count_relevant = bool(self.cat_cap
                                   and self.max_dets > self.cat_cap)
        self.quant = quant_mode(cfg["MODEL"])
        # int8_static: the calibrated scales of each replica's device with
        # the key of the weights they were recorded from, and warmup's
        # seed scales (never published)
        self._quant: Optional[Dict[torch.device, QuantState]] = None
        self._quant_key = None
        self._quant_seed: Optional[Dict[torch.device, QuantState]] = None
        self._site_tensors = None
        if quant_state is not None:
            self.quant_state = quant_state

    # ------------------------------------------------------------------
    # int8_static scales
    def _weights_key(self) -> tuple:
        """Identifies the weights of the int8 sites: a reload (or any
        in-place change) gives another key."""
        if self._site_tensors is None:
            self._site_tensors = [
                t for m in self.model.modules()
                if isinstance(m, ConvBNAct) and m.quant != "none"
                for t in (m.conv.weight, m.norm.weight, m.norm.bias,
                          m.norm.running_mean, m.norm.running_var)]
        return tuple((t.data_ptr(), t._version) for t in self._site_tensors)

    def _entries(self, raw: QuantState) -> Dict[torch.device, QuantState]:
        """An int8_static state for each replica's device from the same
        calibrated {amax, wq, sw}."""
        return {d: quant_entries(m, raw) for d, m in self.replicas.items()}

    @property
    def quant_ready(self) -> bool:
        """Whether the program can run: True unless int8_static scales are
        missing or were recorded from other weights."""
        return (self.quant != "int8_static"
                or (self._quant is not None
                    and self._quant_key == self._weights_key()))

    @property
    def quant_state(self) -> Optional[QuantState]:
        """The calibrated int8_static scales ({site: {amax, wq, sw}}), or
        None before calibration or after the weights changed; warmup's
        seed scales are never published here."""
        if self.quant != "int8_static" or not self.quant_ready:
            return None
        return {name: {k: e[k] for k in ("amax", "wq", "sw")}
                for name, e in self._quant[self.device].items()}

    @quant_state.setter
    def quant_state(self, raw: QuantState) -> None:
        """Keep a calibrated state (what ``quant_state`` published, or
        utils/convert.quant_state_from_jax) for the current weights."""
        if self.quant != "int8_static":
            raise ValueError(f"MODEL.QUANT {self.quant!r} takes no "
                             "calibrated state")
        self._quant = self._entries(raw)
        self._quant_key = self._weights_key()

    @torch.inference_mode()
    def calibrate(self, images: np.ndarray, mark_ready: bool = True) -> None:
        """Record int8_static activation scales (each site's running
        abs-max, and its quantized weights) from a uint8 NHWC batch
        [B <= batch_size, S, S, 3], padded to batch_size as served. Call it
        again to take in more batches: the scales only grow. Beyond them
        values clip to +-127 when served. ``mark_ready=False`` records
        warmup's seed scales instead. A no-op unless int8_static. A mesh
        predictor records on its first replica's device from the whole
        batch (the max over the shards is the max over the batch) and
        gives every replica those scales; a group predictor records each
        site's max over the ranks' batches on every rank."""
        if self.quant != "int8_static":
            return
        base = (self._quant[self.device]
                if (mark_ready and self.quant_ready) else None)
        raw = {} if base is None else {
            name: {k: e[k] for k in ("amax", "wq", "sw")}
            for name, e in base.items()}
        with device_scope(self.device), self._ranks():
            x = self.upload(images).permute(0, 3, 1, 2)
            with quant_scope(raw, recording=True):
                self.model(model_input(self.model, x))
            state = self._entries(raw)
        if mark_ready:
            self._quant, self._quant_key = state, self._weights_key()
        else:
            self._quant_seed = state

    def _require_calibrated(self) -> None:
        if not self.quant_ready:
            raise RuntimeError(
                "int8_static predictor without calibrated scales for its "
                "weights: call calibrate() (dispatch() does on its first "
                "batch)")

    def _ranks(self):
        """The maxima over the group's ranks (a group predictor)."""
        return nullcontext() if self.group is None else group_scope(
            self.group)

    @contextmanager
    def _scope(self, device: torch.device,
               state: Optional[QuantState] = None) -> Iterator[None]:
        """The scopes of a forward of the replica on ``device``: the
        group's maxima, and the int8_static scales (the calibrated ones,
        or ``state``)."""
        if self.quant == "int8_static" and state is None:
            self._require_calibrated()
            state = self._quant[device]
        with self._ranks(), (quant_scope(state)
                             if self.quant == "int8_static"
                             else nullcontext()):
            yield

    @property
    def outputs(self) -> list:
        return (["detections", "valid", "relevant_count"]
                if self.count_relevant else ["detections", "valid"])

    def settings(self) -> Dict:
        """postprocess's settings at the current thresholds."""
        return dict(num_classes=self.num_classes, conf_thre=self.conf_thre,
                    nms_thre=self.nms_thre, pre_nms_topk=self.pre_nms_topk,
                    max_dets=self.max_dets, topk_approx=self.topk_approx,
                    cat_cap=self.cat_cap,
                    return_relevant_count=self.count_relevant)

    def program(self) -> DetectionProgram:
        """The device program at the current thresholds (and int8_static
        scales), as a module."""
        self._require_calibrated()
        return DetectionProgram(self.model, self.img_size, self.settings(),
                                self._quant[self.device]
                                if self.quant == "int8_static" else None)

    @torch.inference_mode()
    def run_wire(self, flat: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The device program on a planar wire device batch [B, 3*S*S].
        Returns device tensors (detections, valid[, relevant_count])."""
        with self._scope(self.device):
            return detection_program(self.model, flat, self.img_size,
                                     self.settings())

    @torch.inference_mode()
    def run(self, images: torch.Tensor,
            quant_state: Optional[QuantState] = None
            ) -> Tuple[torch.Tensor, ...]:
        """The device program on a uint8 NHWC device batch, through its
        NCHW view (channels-last already, so no layout copy): normalize,
        forward, decode, postprocess. The same function as ``run_wire``
        on the batch's planar wire. int8_static runs on the calibrated
        scales, or on ``quant_state`` when given."""
        with self._scope(self.device, quant_state):
            return detection_forward(self.model, images.permute(0, 3, 1, 2),
                                     self.settings())

    def upload(self, images: np.ndarray) -> torch.Tensor:
        """Pad a uint8 NHWC host batch and copy it to the device."""
        _check_uint8(images)
        return upload_nhwc(images, self.batch_size, self.device)

    def dispatch(self, images: np.ndarray) -> Dispatched:
        """Upload and run without waiting, and enqueue the outputs' copies
        to the host: returns the ``Dispatched`` record for
        ``fetch_local``. An int8_static predictor without scales for its
        weights calibrates on this batch first."""
        if not self.quant_ready:
            self.calibrate(images)
        if self.mesh is not None:
            return self._dispatch_mesh(images)
        with device_scope(self.device):
            return start_fetch(self.run(self.upload(images)), self.device)

    @torch.inference_mode()
    def _dispatch_mesh(self, images: np.ndarray,
                       seed: Optional[Dict[torch.device, QuantState]] = None
                       ) -> Dispatched:
        """``dispatch`` over the mesh: the padded batch is pinned once;
        each replica uploads its rows to its device, runs the program on
        them and copies its outputs to the first device, where they are
        joined in mesh order. int8_static runs on the calibrated scales,
        or on ``seed``'s."""
        _check_uint8(images)
        host = torch.from_numpy(pad_batch(images, self.batch_size))
        if self.device.type == "cuda":
            host = host.pin_memory()
        shards = self.mesh.shards(self.batch_size)
        settings = self.settings()
        for model in self.replicas.values():
            # replicas sharing a card share its model: fold K2's weights
            # here, on this thread's stream, which every replica stream
            # waits for, and never in two replica threads at once
            prefold_stages(model)

        def replica(rank: int) -> Tuple[torch.Tensor, ...]:
            device = self.mesh.devices[rank]
            with torch.inference_mode(), self._scope(
                    device, None if seed is None else seed[device]):
                x = host[shards[rank]].to(device, non_blocking=True)
                outs = detection_forward(self.replicas[device],
                                         x.permute(0, 3, 1, 2), settings)
            return tuple(o.to(self.device, non_blocking=True) for o in outs)

        parts = self._runner.run(replica)
        with device_scope(self.device):
            if self.device.type == "cuda":
                # made on the replicas' streams, read on this one: their
                # blocks are not reused before it has read them
                stream = torch.cuda.current_stream(self.device)
                for o in (o for part in parts for o in part):
                    o.record_stream(stream)
            outs = tuple(torch.cat(group) for group in zip(*parts))
            return start_fetch(outs, self.device)

    fetch_local = staticmethod(fetch_local)

    def warmup(self, dtype=np.uint8) -> None:
        """Run the program once on a zero batch (cuDNN picks its
        algorithms and the kernels are built); ``dtype``, the batcher's
        wire dtype, must be uint8. An int8_static predictor not calibrated
        yet runs on seed scales from that zero batch, kept out of
        ``quant_state``: its first real batch still calibrates."""
        zeros = np.zeros((self.batch_size, self.img_size, self.img_size, 3),
                         dtype)
        seed = None
        if not self.quant_ready:
            if self._quant_seed is None:
                self.calibrate(zeros, mark_ready=False)
            seed = self._quant_seed
        if self.mesh is not None:
            self.fetch_local(self._dispatch_mesh(zeros, seed))
            return
        with device_scope(self.device):
            out = self.run(self.upload(zeros),
                           None if seed is None else seed[self.device])
            self.fetch_local(start_fetch(out, self.device))

    def __call__(self, images: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Synchronous predict. images: [B, S, S, 3] uint8, B <= batch_size.

        Returns (detections [B, max_dets, 7], valid [B, max_dets]) numpy,
        rows = x1, y1, x2, y2, obj, cls_conf, cls_idx in input pixels.
        """
        n = images.shape[0]
        dets, valid = self.fetch_local(self.dispatch(images))[:2]
        return dets[:n], valid[:n]
