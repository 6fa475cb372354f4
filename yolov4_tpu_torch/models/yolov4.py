"""YOLOv4 detector (reference yolo/model/yolov4.py:271-324).

The model consumes NCHW float images in [0, 1] and returns:
  * in eval mode: [B, N, 5+C] decoded float32 predictions in input pixels,
    N = sum over scales of 3*f^2 (22743 at 608x608);
  * in train mode: list of 3 per-scale dicts {layer_no, output, pred} for
    the loss (see models/decode.py).

``build_model(cfg, device=...)`` builds the module, draws the reference
init from an explicit ``torch.Generator`` (on the CPU, so a seed gives the
same weights on every device), and moves it to the device and its
convolutions to ``MODEL.COMPUTE_DTYPE``. BatchNorm's parameters and
running statistics stay float32, as the JAX package's ``param_dtype``:
a bfloat16 activation is normalized with float32 statistics and comes
out in bfloat16 (flax's ``dtype=bfloat16, param_dtype=float32``). With
``train=True`` every parameter stays float32 and a bfloat16 compute
dtype comes from ``torch.autocast`` in the train step. ``MODEL.PALLAS_CSP``
sends the eval forward of CSP stages 1-3 through K2 (see
darknet.Backbone).

``MODEL.QUANT`` int8 / int8_static marks the int8 sites of the eval
forward (layers.apply_quant, with ``MODEL.QUANT_SPAN`` and the direct-u8
stem under the JAX package's ``QUANT_STEM`` predicate); ``train=True``
ignores it, as the JAX package's train path does. ``QUANT_CHAIN`` needs
nothing: the JAX package's chained program gives the unchained one's
outputs bit for bit.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch
from torch import nn

from yolov4_tpu_torch.models.darknet import Backbone
from yolov4_tpu_torch.models.decode import decode_all, masked_anchors
from yolov4_tpu_torch.models.head import Head
from yolov4_tpu_torch.models.layers import apply_quant, init_weights
from yolov4_tpu_torch.models.neck import Neck
from yolov4_tpu_torch.utils.profiling import span

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class YOLOv4(nn.Module):
    def __init__(self, n_classes: int = 80,
                 anchors: Sequence[Sequence[float]] = (
                     (12, 16), (19, 36), (40, 28),
                     (36, 75), (76, 55), (72, 146),
                     (142, 110), (192, 243), (459, 401)),
                 anchor_mask: Sequence[Sequence[int]] = (
                     (0, 1, 2), (3, 4, 5), (6, 7, 8)),
                 legacy_spp_pools: bool = True,
                 exact_pool_grad: bool = False,
                 width: float = 1.0, depth: float = 1.0,
                 pallas_csp: Union[bool, str] = False):
        super().__init__()
        # per-scale grid-unit anchors, on the model's device so that decode
        # copies nothing from the host; float32 whatever the layers' dtype
        # (build_model casts only the layers), and not in the state_dict
        for layer_no in range(3):
            self.register_buffer(
                f"anchors_grid{layer_no}",
                torch.from_numpy(masked_anchors(anchors, anchor_mask,
                                                layer_no)),
                persistent=False)
        self.backbone = Backbone(width=width, depth=depth,
                                 pallas_csp=pallas_csp)
        c3, c4, c5 = (self.backbone.stage3.transition.out_ch,
                      self.backbone.stage4.transition.out_ch,
                      self.backbone.stage5.transition.out_ch)
        self.neck = Neck(c3, c4, c5, width=width,
                         legacy_pools=legacy_spp_pools,
                         exact_pool_grad=exact_pool_grad)
        self.head = Head(self.neck.fpn.module3[-1].out_ch,
                         self.neck.pan.module1[-1].out_ch,
                         self.neck.pan.module2[-1].out_ch,
                         n_classes=n_classes, width=width)

    def takes_uint8(self, x: torch.Tensor) -> bool:
        """Whether the stem takes uint8 ``x`` as it is (the direct-u8
        stem: the JAX package's even-size s2d stem in an eval forward)."""
        return (self.backbone.stem.quant_u8 and not self.training
                and x.dtype == torch.uint8
                and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0)

    def forward(self, x: torch.Tensor, decode: bool = True):
        """x: [B, 3, H, W] float in [0, 1] or uint8 (normalized by 1/255
        here unless the direct-u8 stem takes it), H and W multiples of 32;
        cast to the parameters' dtype. decode=False returns the three raw
        NCHW head maps."""
        if not self.takes_uint8(x):
            if x.dtype == torch.uint8:
                x = x.float() / 255.0
            x = x.to(self.backbone.stem.conv.weight.dtype)
        with span("model.backbone"):
            feats = self.backbone(x)
        with span("model.neck"):
            feats = self.neck(*feats)
        with span("model.head"):
            raws = self.head(*feats)
            if not decode:
                return raws
            grids = [getattr(self, f"anchors_grid{i}") for i in range(3)]
            return decode_all(raws, grids, training=self.training)


def quant_mode(model_cfg: Dict) -> str:
    """MODEL.QUANT as a mode: config booleans map onto "none"/"int8" (the
    JAX package's ``_qmode``)."""
    quant = model_cfg.get("QUANT", "none")
    return {False: "none", True: "int8"}.get(quant, quant)


def u8_stem(model_cfg: Dict) -> bool:
    """The JAX package's direct-u8 stem predicate (engine/predictor.py),
    less the even size and uint8 input the forward checks: QUANT int8 or
    int8_static, QUANT_STEM, QUANT_SPAN "full" and the s2d stem
    (S2D_STEM true or "fused")."""
    return (quant_mode(model_cfg) != "none"
            and bool(model_cfg.get("QUANT_STEM", False))
            and model_cfg.get("QUANT_SPAN", "late") == "full"
            and model_cfg.get("S2D_STEM", True) in (True, "fused"))


def build_model(cfg: Dict, device=None,
                generator: Optional[torch.Generator] = None,
                train: bool = False) -> YOLOv4:
    """Construct the detector from a config dict (reference
    model/build.py:19), initialise it from ``generator`` (a CPU
    ``torch.Generator``; seed 0 when None) and move it to ``device``, its
    convolutions in ``MODEL.COMPUTE_DTYPE`` (float32 with ``train``) and
    its BatchNorms in float32."""
    model_cfg = cfg["MODEL"]
    if model_cfg["TYPE"] != "YOLOv4":
        raise ValueError(f"unsupported MODEL.TYPE {model_cfg['TYPE']!r}")
    model = YOLOv4(
        n_classes=model_cfg["N_CLASSES"],
        anchors=model_cfg["ANCHORS"],
        anchor_mask=model_cfg["ANCHOR_MASK"],
        legacy_spp_pools=model_cfg.get("SPP_LEGACY_POOLS", True),
        exact_pool_grad=bool(model_cfg.get("EXACT_POOL_GRAD", False)),
        width=float(model_cfg.get("WIDTH", 1.0)),
        depth=float(model_cfg.get("DEPTH", 1.0)),
        pallas_csp=model_cfg.get("PALLAS_CSP", False),
    )
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_weights(model, generator)
    quant = quant_mode(model_cfg)
    if not train and quant != "none":
        apply_quant(model, quant, model_cfg.get("QUANT_SPAN", "late"),
                    u8_stem=u8_stem(model_cfg))
    dtype = (torch.float32 if train
             else DTYPES[model_cfg.get("COMPUTE_DTYPE", "bfloat16")])
    model.to(device=device)
    for layers in (model.backbone, model.neck, model.head):
        for m in layers.modules():
            if isinstance(m, nn.BatchNorm2d):
                continue
            for p in m.parameters(recurse=False):
                p.data = p.data.to(dtype)
    return model
