"""Building-block layers (NCHW), ported from the JAX package's
models/layers.py: Mish, ConvBNAct, ResBlock, CSPDownSample0, CSPDownSample,
and BatchNorm with its statistics over the ranks of a process group
(``SyncBatchNorm2d``, flax's ``BatchNorm(axis_name=...)``).

A ConvBNAct given a ``quant`` mode (``apply_quant``, ``MODEL.QUANT``) runs
its eval forward as the JAX package's int8 conv (``_quant_conv``): BN
folded in float32, per-output-channel int8 weights, a per-tensor int8
activation, the s8 x s8 -> s32 product of ops/int8.py, then the
dequantize and the activation. "int8" takes the activation's abs-max on
the fly; "int8_static" reads calibrated scales from the state of the
caller's ``quant_scope`` (a Predictor's own), never from the module, so
that several predictors can share one model with scales of their own.

A CSP stage built with ``fused`` runs its eval forward's body (everything
after the base conv) through the K2 wrapper (ops/csp_cuda.py) with BN
folded into the convs, as the JAX package's ``MODEL.PALLAS_CSP`` path
does: the Hopper kernel on a CUDA tensor, its plain version on a CPU one.

Every other ConvBNAct with BN and Mish or leaky ReLU runs BN and the
activation of an eval forward without autograd on a CUDA tensor as one
pass of the ``batch_norm_act`` kernel (ops/bn_act_cuda.py) after cuDNN's
conv; training, autograd, int8 sites, the CPU, float16 and other layouts
keep the layer-by-layer chain.

Module attribute names follow the reference torch tree (darknet/darknet.py:
14-138), so ``state_dict()`` keys are the reference's keys
(``part2_1_2.0.conv.weight``, ``part2.1.module_list.0.1.norm.running_var``)
and reference checkpoints load with plain ``load_state_dict``.

Initialisation (``init_weights``) matches reference yolov4.py:283-294:
conv kernels kaiming-normal (fan_out, relu gain), conv biases zero,
BatchNorm scale ~ N(0, 0.01^2), BatchNorm bias zero.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable, Dict, Iterator, List, Optional, Union

import torch
import torch.distributed as tdist
import torch.nn.functional as F
from torch import nn

from yolov4_tpu_torch.ops.bn_act import mish
from yolov4_tpu_torch.ops.bn_act_cuda import (batch_norm_act_cuda,
                                              batch_norm_act_supported)
from yolov4_tpu_torch.ops.csp import (fold_conv_bn, pack_weights,
                                      packed_dtype)
from yolov4_tpu_torch.ops.csp_cuda import (fused_csp_stage_cuda,
                                           fused_csp_supported)
from yolov4_tpu_torch.ops.int8 import (activation_scale, int8_conv,
                                       quantize_activation,
                                       quantize_weights)
from yolov4_tpu_torch.ops.replica import replica_max
from yolov4_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.1)


ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": F.relu,
    "leaky_relu": leaky_relu,
    "mish": mish,
    "linear": lambda x: x,
}
# the activations the batch_norm_act kernel computes, by function: a site
# whose ``act`` was swapped (tools/act_bound.py) takes the swapped one
FUSED_ACTIVATIONS: Dict[Callable, str] = {mish: "mish",
                                          leaky_relu: "leaky_relu"}


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode running-variance update uses the
    BIASED batch variance, as flax's BatchNorm does (the JAX package's
    models/layers.py:728-739): ra = 0.9 ra + 0.1 batch. Torch's own update
    blends in the unbiased variance, n / (n - 1) times larger, which
    drifts the running statistics at every step. The normalization, eps,
    state_dict keys and the eval path are torch's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        self._check_input_dim(x)
        self.num_batches_tracked.add_(1)
        n = x.numel() // x.shape[1]
        # torch's update goes into a copy (autograd keeps the running
        # buffers it was given, so the one it saw must not change), which
        # then holds (1 - m) var_old + m var n / (n - 1): scale the second
        # term back to m var
        blended = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, blended, self.weight,
                         self.bias, True, self.momentum, self.eps)
        with torch.no_grad():
            kept = self.running_var * (1.0 - self.momentum)
            self.running_var.copy_(torch.lerp(kept, blended, (n - 1) / n))
        return y


def _group_size(group: Optional[tdist.ProcessGroup]) -> int:
    """The number of ranks in ``group`` (the default group when None); 1
    without one."""
    if not (tdist.is_available() and tdist.is_initialized()):
        return 1
    return tdist.get_world_size(group)


class _AllReduceSum(torch.autograd.Function):
    """A sum over the ranks whose backward sums the gradients over them too:
    the transpose of JAX's ``psum``, so that each rank's gradient takes in
    what its batch did to every rank's loss through the shared
    statistics."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        tdist.all_reduce(x, op=tdist.ReduceOp.SUM, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        tdist.all_reduce(grad, op=tdist.ReduceOp.SUM, group=ctx.group)
        return grad, None


class SyncBatchNorm2d(BatchNorm2d):
    """BatchNorm whose train-mode statistics are those of the batch of all
    ranks of ``group`` (the default group when None): flax's
    ``BatchNorm(axis_name=...)`` with its fast variance (flax 0.12
    ``_compute_stats``). In at least float32, each rank's per-channel mean
    and mean of squares are averaged over the ranks in one all-reduce of
    the two stacked, var = max(0, E[x^2] - E[x]^2) (biased), the input is
    normalized with eps, and the running statistics become 0.9 ra + 0.1
    batch. The gradient flows through the all-reduce. For equal shards the
    mean of the ranks' means is the global batch's.

    The output has the input's dtype, as BatchNorm2d's under autocast; the
    state_dict keys and the eval path are BatchNorm2d's. In a group of one
    rank (or with no group) it warns when built and is BatchNorm2d, as the
    JAX package's trainer on a one-device mesh.

    ``torch.nn.SyncBatchNorm`` is another function: its running variance
    is the unbiased one, and it refuses CPU tensors."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1,
                 group: Optional[tdist.ProcessGroup] = None):
        super().__init__(num_features, eps=eps, momentum=momentum)
        self.group = group
        self.world = _group_size(group)
        if self.world <= 1:
            logger.warning("SyncBatchNorm2d in a group of one rank: "
                           "per-replica BatchNorm")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.world > 1):
            return super().forward(x)
        self._check_input_dim(x)
        self.num_batches_tracked.add_(1)
        with torch.autocast(x.device.type, enabled=False):
            xc = x.to(torch.promote_types(x.dtype, torch.float32))
            dims = (0, 2, 3)
            stats = torch.stack([xc.mean(dims), xc.square().mean(dims)])
            stats = _AllReduceSum.apply(stats, self.group) / self.world
            mean, meansq = stats[0], stats[1]
            var = torch.clamp(meansq - mean.square(), min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(
                    mean.to(self.running_mean.dtype), alpha=m)
                self.running_var.mul_(1.0 - m).add_(
                    var.to(self.running_var.dtype), alpha=m)
            mul = torch.rsqrt(var + self.eps) * self.weight
            y = ((xc - mean[:, None, None]) * mul[:, None, None]
                 + self.bias[:, None, None])
        return y.to(x.dtype)


def convert_sync_bn(module: nn.Module,
                    group: Optional[tdist.ProcessGroup] = None) -> nn.Module:
    """Every BatchNorm2d of ``module`` replaced in place by a
    SyncBatchNorm2d over ``group`` holding the same parameters and
    statistics, on its device in its dtype; returns ``module``. In a group of
    one rank it warns and changes nothing."""
    if _group_size(group) <= 1:
        logger.warning("convert_sync_bn with one rank: no-op (per-replica "
                       "BatchNorm)")
        return module
    for parent in list(module.modules()):
        for name, child in list(parent.named_children()):
            if type(child) is not BatchNorm2d:
                continue
            sync = SyncBatchNorm2d(child.num_features, child.eps,
                                   child.momentum, group)
            sync.to(device=child.weight.device, dtype=child.weight.dtype)
            sync.load_state_dict(child.state_dict())
            sync.train(child.training)
            setattr(parent, name, sync)
    return module


QUANT_MODES = ("none", "int8", "int8_static")

# the int8_static state of the forward running in this thread: (state,
# recording) of the innermost quant_scope
_scope = threading.local()


@contextmanager
def quant_scope(state: Optional[Dict[str, Dict[str, torch.Tensor]]],
                recording: bool = False) -> Iterator[None]:
    """Inside the block, int8 ConvBNActs of this thread read their
    int8_static scales from ``state`` (site name -> entry, see
    ``ConvBNAct.quant_entry``). With ``recording`` every int8 site runs
    dynamically and writes into ``state`` its running activation abs-max
    (the larger of the entry's and this input's) and its quantized
    weights: the JAX package's calibration pass (``mutable=["quant"]``)."""
    prev = getattr(_scope, "ctx", None)
    _scope.ctx = (state, recording)
    try:
        yield
    finally:
        _scope.ctx = prev


class ConvBNAct(nn.Module):
    """Conv2d (symmetric ``(k-1)//2`` padding) + optional BatchNorm
    (eps 1e-5, momentum 0.1, flax's running-variance update) + activation
    (reference darknet.py:23-58).

    ``quant`` ("none", "int8", "int8_static"; set by ``apply_quant`` on a
    bias-free conv with BN) makes the eval forward the JAX package's int8
    conv; a training forward ignores it. ``quant_site`` names the layer's
    entry in a quant state. ``quant_u8`` (the stem under
    ``MODEL.QUANT_STEM``) takes a uint8 image as shifted int8 with its
    /255 folded into the dequantize (the JAX package's direct-u8 stem);
    a float input then runs the float conv."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1, bias: bool = False, bn: bool = True,
                 act: str = "leaky_relu"):
        super().__init__()
        if act not in ACTIVATIONS:
            raise ValueError(f"{act} does not support.")
        self.conv = nn.Conv2d(in_ch, out_ch, kernel_size, stride,
                              padding=(kernel_size - 1) // 2, bias=bias)
        self.norm = (BatchNorm2d(out_ch, eps=1e-5, momentum=0.1)
                     if bn else None)
        self.act = ACTIVATIONS[act]
        self.quant = "none"
        self.quant_site = ""
        self.quant_u8 = False

    @property
    def out_ch(self) -> int:
        return self.conv.out_channels

    @property
    def quantizable(self) -> bool:
        return self.norm is not None and self.conv.bias is None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant != "none" and not self.training:
            if self.quant_u8 and x.dtype == torch.uint8:
                return self._forward_u8(x)
            if not self.quant_u8:
                return self._forward_int8(x)
        x = self.conv(x)
        if self._fuses_bn_act(x):
            return batch_norm_act_cuda(x, self.norm,
                                       FUSED_ACTIVATIONS[self.act])
        if self.norm is not None:
            x = self.norm(x)
        return self.act(x)

    def _fuses_bn_act(self, x: torch.Tensor) -> bool:
        """Whether BN and the activation after the conv run as one pass of
        the batch_norm_act kernel: an eval forward without autograd (K2's
        predicate, ``_CSPStage._use_fused``) of a float site with BN and
        Mish or leaky ReLU, on a CUDA tensor the kernel takes."""
        return (not self.training and not torch.is_grad_enabled()
                and self.quant == "none" and self.norm is not None
                and self.act in FUSED_ACTIVATIONS and x.is_cuda
                and batch_norm_act_supported(x, self.norm))

    @torch.no_grad()
    def quantized_weights(self):
        """(wq int8 OHWI, sw float32 [Co], bias float32 [Co]): BN folded
        into the kernel in float32 (ops/csp.fold_conv_bn's arithmetic),
        then quantized per output channel."""
        norm = self.norm
        s = norm.weight.float() * torch.rsqrt(norm.running_var.float()
                                              + norm.eps)
        wq, sw = quantize_weights(self.conv.weight.float()
                                  * s[:, None, None, None])
        return wq, sw, norm.bias.float() - norm.running_mean.float() * s

    @torch.no_grad()
    def quant_entry(self, amax: torch.Tensor, wq: torch.Tensor,
                    sw: torch.Tensor) -> Dict[str, torch.Tensor]:
        """A site's int8_static entry: the calibrated ``amax``, ``wq``,
        ``sw``, and what the forward derives from them and the current
        BN (the activation scale ``sx``, ``scale`` = sx * sw, the folded
        ``bias``; for the direct-u8 stem sw / 255 and 128 * sum(wq))."""
        dev = self.conv.weight.device
        amax, wq, sw = (t.to(dev) for t in (amax, wq, sw))
        bias = self.quantized_weights()[2]
        entry = dict(amax=amax, wq=wq, sw=sw, bias=bias)
        if self.quant_u8:
            entry.update(scale=sw / 255.0,
                         shift=128 * wq.to(torch.int32).sum(dim=(1, 2, 3)))
        else:
            sx = activation_scale(amax)
            entry.update(sx=sx, scale=sx * sw)
        return entry

    def _state(self):
        """(entry or None, recording) for this forward; an int8_static
        forward outside a calibrated scope raises."""
        state, recording = getattr(_scope, "ctx", None) or (None, False)
        if recording:
            return None, state
        if self.quant == "int8":
            return None, None
        entry = None if state is None else state.get(self.quant_site)
        if entry is None:
            raise RuntimeError(
                f"int8_static layer {self.quant_site!r} has no calibrated "
                "scales: run it inside quant_scope with a calibrated state "
                "(Predictor.calibrate, or the first Predictor.dispatch)")
        return entry, None

    def _record(self, record, amax: torch.Tensor, wq, sw) -> None:
        old = record.get(self.quant_site)
        if old is not None:
            amax = torch.maximum(old["amax"], amax)
        record[self.quant_site] = dict(amax=amax, wq=wq, sw=sw)

    def _forward_int8(self, x: torch.Tensor) -> torch.Tensor:
        """_quant_conv: NHWC int8 activation, s8 x s8 -> s32, then
        (y * (sx * sw) + bias) in float32, cast to x's dtype, activation.
        Returns the NCHW view of an NHWC tensor (channels-last)."""
        conv = self.conv
        xf = x.permute(0, 2, 3, 1).float()
        entry, record = self._state()
        if entry is None:
            wq, sw, bias = self.quantized_weights()
            # the whole batch's abs-max, over a mesh's replicas too
            amax = replica_max(xf.abs().amax())
            if record is not None:
                self._record(record, amax, wq, sw)
            sx = activation_scale(amax)
            scale = sx * sw
        else:
            wq, sx, scale, bias = (entry["wq"], entry["sx"], entry["scale"],
                                   entry["bias"])
        y = int8_conv(quantize_activation(xf, sx), wq, conv.stride[0],
                      conv.padding[0])
        out = (y.float() * scale + bias).to(x.dtype)
        return self.act(out).permute(0, 3, 1, 2)

    def _forward_u8(self, x: torch.Tensor) -> torch.Tensor:
        """The direct-u8 stem: x_s8 = x_u8 - 128 with -128 borders, and
        conv(x_u8 / 255, wq sw) = (sw / 255) (conv(x_s8, wq) + 128 sum(wq)),
        an exact integer identity, plus the folded bias. The output takes
        the conv weights' dtype."""
        conv = self.conv
        xn = x.permute(0, 2, 3, 1)
        entry, record = self._state()
        if entry is None:
            wq, sw, bias = self.quantized_weights()
            if record is not None:
                # the batch's (over the ranks too), as at every site;
                # recorded only, the forward's scale does not use it
                self._record(record, replica_max(xn.float().abs().amax()),
                             wq, sw)
            scale = sw / 255.0
            shift = 128 * wq.to(torch.int32).sum(dim=(1, 2, 3))
        else:
            wq, scale, shift, bias = (entry["wq"], entry["scale"],
                                      entry["shift"], entry["bias"])
        xs = (xn.to(torch.int16) - 128).to(torch.int8)
        y = int8_conv(xs, wq, conv.stride[0], conv.padding[0],
                      pad_value=-128)
        out = ((y + shift).float() * scale + bias).to(conv.weight.dtype)
        return self.act(out).permute(0, 3, 1, 2)


class ResBlock(nn.Module):
    """num_blocks x [1x1 conv, 3x3 conv] with residual adds
    (reference darknet.py:61-81)."""

    def __init__(self, ch: int, num_blocks: int = 1, shortcut: bool = True,
                 act: str = "mish"):
        super().__init__()
        self.shortcut = shortcut
        self.module_list = nn.ModuleList(
            nn.Sequential(ConvBNAct(ch, ch, 1, act=act),
                          ConvBNAct(ch, ch, 3, act=act))
            for _ in range(num_blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.module_list:
            h = block(x)
            x = x + h if self.shortcut else h
        return x


class _CSPStage(nn.Module):
    """A CSP stage: strided base conv, then the stage body. ``fused``
    (False, True, or "auto" = on for CUDA tensors) sends the body of an
    eval forward without autograd through K2, with the BN-folded weights
    cached until one of the stage's parameters or buffers changes
    (``load_state_dict``, a training step's BN statistics, ``.to``); inside
    :func:`frozen_stage_weights` they are folded once and held fixed, for a
    trace whose tensors have no storage to key the cache by. The
    state_dict is the same either way."""

    num_blocks: int

    def __init__(self, fused: Union[bool, str], act: str, shortcut: bool):
        super().__init__()
        if fused not in (False, True, "auto"):
            raise ValueError(f"fused must be False, True or 'auto': {fused!r}")
        self.fused = fused
        self.fusable = act == "mish" and shortcut
        # the body's convs run int8 (apply_quant): the JAX package then
        # never fuses the stage
        self.quantized = False
        self._fold_cache = None
        self._frozen = None

    def foldable(self) -> Dict[str, "ConvBNAct"]:
        """The body's ConvBNActs under their folded-dict names
        (ops/csp.stage_names)."""
        raise NotImplementedError

    def body(self, x: torch.Tensor) -> torch.Tensor:
        """The stage body on the base conv's output, layer by layer."""
        raise NotImplementedError

    def folded_weights(self, x: torch.Tensor):
        """(folded, packed) for x's device and dtype: the BN-folded weights
        and the same packed (ops/csp.pack_weights, in the kernel's layout
        on a card)."""
        if self._frozen is not None:
            return self._frozen
        key = (x.device, x.dtype) + tuple(
            (t.data_ptr(), t._version)
            for t in (*self.parameters(), *self.buffers()))
        if self._fold_cache is None or self._fold_cache[0] != key:
            folded = {name: fold_conv_bn(m)
                      for name, m in self.foldable().items()}
            packed = pack_weights(folded, self.num_blocks, packed_dtype(x))
            self._fold_cache = (key, folded, packed)
        return self._fold_cache[1:]

    def _probe(self) -> torch.Tensor:
        """An empty tensor in the dtype and on the device of the base
        conv's weights: those of the body's input."""
        w = self.base.conv.weight
        return w.new_empty((1, w.shape[0], 1, 1))

    def fuses(self) -> bool:
        """Whether the body of an eval forward without autograd goes
        through K2, for an input on the weights' device and dtype."""
        return self._fuses(self._probe())

    def prefold(self) -> None:
        """Fold and pack into the cache now, for the body's input, if the
        body would go through K2."""
        if self.fuses():
            self.folded_weights(self._probe())

    def freeze(self) -> None:
        """Fold and pack now, for the body's input, and hold the result
        until :meth:`thaw`; a stage whose body would not go through K2
        holds nothing."""
        self._frozen = None
        if self.fuses():
            self._frozen = self.folded_weights(self._probe())

    def thaw(self) -> None:
        self._frozen = None

    def _fuses(self, x: torch.Tensor) -> bool:
        """Whether the body on NCHW ``x`` goes through K2 in an eval
        forward without autograd."""
        on = self.fused is True or (self.fused == "auto" and x.is_cuda)
        return (on and self.fusable and not self.quantized
                and fused_csp_supported((x.shape[0], x.shape[2], x.shape[3],
                                         x.shape[1]), self.num_blocks,
                                        x.dtype))

    def _use_fused(self, x: torch.Tensor) -> bool:
        return (not self.training and not torch.is_grad_enabled()
                and self._fuses(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.base(x)
        if not self._use_fused(x):
            return self.body(x)
        # a channels-last NCHW tensor is already NHWC in memory: no copy
        nhwc = x.permute(0, 2, 3, 1).contiguous()
        folded, packed = self.folded_weights(x)
        out = fused_csp_stage_cuda(nhwc, folded, self.num_blocks, packed)
        return out.permute(0, 3, 1, 2)


def prefold_stages(model: nn.Module) -> None:
    """Fill every fusing CSP stage's fold cache now, on the calling
    thread's stream: replicas that share ``model`` on one card, each on a
    stream of its own, then read the cache and never fold it
    concurrently."""
    for m in model.modules():
        if isinstance(m, _CSPStage):
            m.prefold()


@contextmanager
def frozen_stage_weights(model: nn.Module) -> Iterator[None]:
    """Inside the block every CSP stage of ``model`` computes its folded and
    packed weights once, from the current parameters, and hands those same
    tensors to K2 on every call: ``torch.export`` traces with tensors that
    have no storage, so the cache's key cannot be read there, and the
    packed weights become constants of the exported program."""
    stages = [m for m in model.modules() if isinstance(m, _CSPStage)]
    try:
        for stage in stages:
            stage.freeze()
        yield
    finally:
        for stage in stages:
            stage.thaw()


class CSPDownSample0(_CSPStage):
    """First CSP stage with its non-standard split (reference
    darknet.py:84-113)."""

    num_blocks = 0

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 2, act: str = "mish",
                 fused: Union[bool, str] = False):
        super().__init__(fused, act, shortcut=True)
        c = out_ch
        self.base = ConvBNAct(in_ch, c, kernel_size, stride, act=act)
        self.part1 = ConvBNAct(c, c, 1, act=act)
        self.part2_1_1 = ConvBNAct(c, c, 1, act=act)
        self.part2_1_2 = nn.Sequential(ConvBNAct(c, c // 2, 1, act=act),
                                       ConvBNAct(c // 2, c, 3, act=act))
        self.part2_2 = ConvBNAct(c, c, 1, act=act)
        self.transition = ConvBNAct(2 * c, c, 1, act=act)

    def foldable(self) -> Dict[str, ConvBNAct]:
        return {"part1": self.part1, "part2_1_1": self.part2_1_1,
                "part2_1_2_0": self.part2_1_2[0],
                "part2_1_2_1": self.part2_1_2[1],
                "part2_2": self.part2_2, "transition": self.transition}

    def body(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.part1(x)
        x2_1_1 = self.part2_1_1(x)
        x2 = self.part2_2(x2_1_1 + self.part2_1_2(x2_1_1))
        return self.transition(torch.cat([x2, x1], dim=1))


class CSPDownSample(_CSPStage):
    """Generic CSP downsampling stage (reference darknet.py:116-138)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 2, num_blocks: int = 1, shortcut: bool = True,
                 act: str = "mish", fused: Union[bool, str] = False):
        super().__init__(fused, act, shortcut)
        self.num_blocks = num_blocks
        c, c2 = out_ch, out_ch // 2
        self.base = ConvBNAct(in_ch, c, kernel_size, stride, act=act)
        self.part1 = ConvBNAct(c, c2, 1, act=act)
        self.part2 = nn.Sequential(
            ConvBNAct(c, c2, 1, act=act),
            ResBlock(c2, num_blocks=num_blocks, shortcut=shortcut, act=act),
            ConvBNAct(c2, c2, 1, act=act))
        self.transition = ConvBNAct(2 * c2, c, 1, act=act)

    def foldable(self) -> Dict[str, ConvBNAct]:
        out = {"part1": self.part1, "part2_0": self.part2[0]}
        for i, pair in enumerate(self.part2[1].module_list):
            out[f"block{i}_0"], out[f"block{i}_1"] = pair[0], pair[1]
        out.update(part2_2=self.part2[2], transition=self.transition)
        return out

    def body(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.part1(x)
        x2 = self.part2(x)
        return self.transition(torch.cat([x2, x1], dim=1))


def quant_sites(model: nn.Module) -> List[str]:
    """The names of ``model``'s ConvBNActs that run int8 in an eval
    forward (the stem's only on a uint8 input)."""
    return [m.quant_site for m in model.modules()
            if isinstance(m, ConvBNAct) and m.quant != "none"]


def quant_entries(model: nn.Module, raw: Dict[str, Dict[str, torch.Tensor]]
                  ) -> Dict[str, Dict[str, torch.Tensor]]:
    """An int8_static state for ``model``'s int8 sites from their
    calibrated {amax, wq, sw} (``ConvBNAct.quant_entry``); every site must
    be in ``raw``."""
    sites = {m.quant_site: m for m in model.modules()
             if isinstance(m, ConvBNAct) and m.quant != "none"}
    missing = set(sites) - set(raw)
    if missing:
        raise ValueError(f"quant state lacks {len(missing)} int8 site(s), "
                         f"e.g. {sorted(missing)[:3]}")
    return {name: m.quant_entry(raw[name]["amax"], raw[name]["wq"],
                                raw[name]["sw"])
            for name, m in sites.items()}


def apply_quant(model: nn.Module, quant: str, span: str = "late",
                u8_stem: bool = False) -> nn.Module:
    """Mark the int8 sites of a detector or backbone as the JAX package
    quantizes them (models/darknet.py, neck.py, head.py): every bias-free
    conv with BN of backbone stages 3-5, the neck and the head's hidden
    convs; stages 1-2 too with ``span`` "full"; the stem only with
    ``u8_stem`` (the direct-u8 stem). A stage whose body runs int8 is not
    fused. ``quant`` "none" clears every mark. Returns ``model``."""
    if quant not in QUANT_MODES:
        raise ValueError(f"quant must be one of {QUANT_MODES}: {quant!r}")
    if span not in ("late", "full"):
        raise ValueError(f"quant span must be 'late' or 'full': {span!r}")
    for name, m in model.named_modules():
        if isinstance(m, ConvBNAct):
            local = name.split("backbone.")[-1]
            if local == "stem":
                on = u8_stem
            elif local.startswith(("stage1.", "stage2.")):
                on = span == "full"
            else:
                on = True
            on = on and quant != "none" and m.quantizable
            m.quant = quant if on else "none"
            m.quant_site = name if on else ""
            m.quant_u8 = on and local == "stem"
    for m in model.modules():
        if isinstance(m, _CSPStage):
            m.quantized = any(c.quant != "none" for c in m.modules()
                              if isinstance(c, ConvBNAct))
    return model


@torch.no_grad()
def init_weights(module: nn.Module,
                 generator: Optional[torch.Generator] = None) -> None:
    """Reference init (yolov4.py:283-294), drawn from ``generator``: conv
    kernels kaiming-normal with fan_out and the relu gain, conv biases 0,
    BN scale ~ N(0, 0.01), BN bias 0, running stats mean 0 / var 1."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                    nonlinearity="relu", generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.BatchNorm2d):
            nn.init.normal_(m.weight, 0.0, 0.01, generator=generator)
            nn.init.zeros_(m.bias)
            m.reset_running_stats()
