"""Single-file serving export: the whole detection program — flat planar
wire bytes -> normalized input -> forward -> anchor decode -> class-wise
NMS -> fixed-shape detections — captured with ``torch.export`` and saved
with ``torch.export.save``, the weights and the thresholds baked in.

The port's counterpart of the JAX package's utils/export.py (a StableHLO
artifact there). The program is engine/predictor.py's
``detection_program``, the function the live ``Predictor`` runs, so a
reloaded artifact computes what the live predictor computes, op for op.
K1 and, with ``MODEL.PALLAS_CSP``, K2 are custom ops
(``torch.ops.yolov4_tpu_torch.greedy_nms_mask`` / ``fused_csp_stage``):
the program calls their CUDA implementations on the card and their plain
versions on the CPU. K2's folded and packed weights are computed once
before the trace (models/layers.frozen_stage_weights) and become
constants of the program. Under ``MODEL.QUANT`` the int8 product traces
as ``aten::_int_mm`` (ops/int8.py; its plain float64 conv on the CPU),
and an int8_static predictor's calibrated scales become constants too:
one that has not calibrated is refused, as in the JAX package.

File format (version 1)::

    8 bytes  magic  b"Y4TCHEXP"  (the JAX package's is b"Y4TPUEXP": each
                                  package refuses the other's file)
    1 byte   version (1)
    4 bytes  little-endian header length H
    H bytes  JSON header: the JAX package's keys (img_size, batch_size,
             s2d_wire (always false: a TPU layout), wire_dtype,
             num_classes, max_dets, conf_thre, nms_thre, outputs, quant,
             platforms) plus torch_version and device
    rest     torch.export.save's archive

An artifact runs on the device type it was exported for (header
``device``): its weights and constants live there.
"""

from __future__ import annotations

import io
import json
import struct
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# registers the custom ops the program calls, before any load
import yolov4_tpu_torch.ops  # noqa: F401
from yolov4_tpu_torch.engine.predictor import pack_wire, resolve_device
from yolov4_tpu_torch.models.layers import frozen_stage_weights

MAGIC = b"Y4TCHEXP"
VERSION = 1
WIRE_DTYPES = {"uint8": torch.uint8, "float32": torch.float32}


def export_serving(predictor, path: str, wire_dtype=np.uint8) -> Dict:
    """Export ``predictor``'s serving program to ``path``; returns the
    header. The predictor's weights are baked into the program and the
    conf / NMS thresholds frozen at their current values. ``wire_dtype``:
    np.uint8 (the standard wire) or np.float32 (images in [0, 1])."""
    name = np.dtype(wire_dtype).name
    if name not in WIRE_DTYPES:
        raise ValueError(f"wire dtype must be uint8 or float32, got {name}")
    if predictor.mesh is not None or predictor.group is not None:
        # the artifact is one device's program: it would carry neither the
        # replicas (or ranks) nor the maxima taken across them
        raise ValueError(
            "export requires a single-device predictor: this one is "
            "sharded over a mesh of several replicas or over the ranks of a "
            "process group (build a Predictor without mesh= or group= for "
            "export)")
    if not predictor.quant_ready:
        raise ValueError(
            "int8_static predictor exported before calibration: call "
            "predictor.calibrate(representative_batch) first so the baked "
            "scales describe real activations")
    b, s = predictor.batch_size, predictor.img_size
    example = torch.zeros((b, 3 * s * s), dtype=WIRE_DTYPES[name],
                          device=predictor.device)
    program = predictor.program()
    with torch.no_grad(), frozen_stage_weights(predictor.model):
        exported = torch.export.export(program, (example,), strict=False)
    blob = io.BytesIO()
    torch.export.save(exported, blob)
    header = {
        "img_size": int(s),
        "batch_size": int(b),
        "s2d_wire": False,
        "wire_dtype": name,
        "num_classes": int(predictor.num_classes),
        "max_dets": int(predictor.max_dets),
        "conf_thre": float(predictor.conf_thre),
        "nms_thre": float(predictor.nms_thre),
        "outputs": predictor.outputs,
        "quant": predictor.quant,
        "platforms": [predictor.device.type],
        "torch_version": torch.__version__,
        "device": predictor.device.type,
    }
    hdr = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<B", VERSION))
        f.write(struct.pack("<I", len(hdr)))
        f.write(hdr)
        f.write(blob.getbuffer())
    return header


class ServingArtifact:
    """A loaded export: ``meta`` (the header) and the program.

    ``call(flat)`` runs the program on packed wire tensors on
    ``device``; ``predict(images)`` packs an NHWC host batch ([n, S, S, 3],
    n <= batch_size) like the live predictor and unpads the result.
    ``device``: None means CUDA; it must be of the type the artifact was
    exported for.
    """

    def __init__(self, path: str, device=None):
        with open(path, "rb") as f:
            data = f.read()
        if data[:8] != MAGIC:
            raise ValueError(f"{path}: not a yolov4_tpu_torch serving export")
        version = data[8]
        if version != VERSION:
            raise ValueError(f"{path}: unsupported export version {version}")
        (hlen,) = struct.unpack("<I", data[9:13])
        self.meta = json.loads(data[13:13 + hlen].decode())
        self.device = resolve_device(device)
        if self.device.type != self.meta["device"]:
            raise ValueError(
                f"{path} was exported for {self.meta['device']}, not "
                f"{self.device.type}: export it again on that device")
        self._wire_dtype = np.dtype(self.meta["wire_dtype"])
        exported = torch.export.load(io.BytesIO(data[13 + hlen:]))
        self._program = exported.module()

    def call(self, flat: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The program on packed wire bytes [batch_size, 3*S*S]
        (meta['wire_dtype']) on the artifact's device."""
        with torch.inference_mode():
            return tuple(self._program(flat))

    def predict(self, images: np.ndarray) -> Tuple[np.ndarray, ...]:
        """NHWC batch in, per-image outputs out (numpy, unpadded).

        images: [n, S, S, 3] of meta['wire_dtype'] (uint8, or float32 in
        [0, 1]); n <= meta['batch_size'].
        """
        if images.dtype != self._wire_dtype:
            raise ValueError(
                f"expected {self._wire_dtype} images (exported wire dtype), "
                f"got {images.dtype}")
        n = images.shape[0]
        flat = torch.from_numpy(pack_wire(images, self.meta["batch_size"]))
        out = self.call(flat.to(self.device))
        return tuple(o.cpu().numpy()[:n] for o in out)


def load_serving(path: str, device: Optional[str] = None) -> ServingArtifact:
    return ServingArtifact(path, device=device)
