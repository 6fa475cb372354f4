"""Building-block layers (NCHW), ported from the JAX package's
models/layers.py: Mish, ConvBNAct, ResBlock, CSPDownSample0, CSPDownSample.

A CSP stage built with ``fused`` runs its eval forward's body (everything
after the base conv) through the K2 wrapper (ops/csp_cuda.py) with BN
folded into the convs, as the JAX package's ``MODEL.PALLAS_CSP`` path
does: the Hopper kernel on a CUDA tensor, its plain version on a CPU one.

Module attribute names follow the reference torch tree (darknet/darknet.py:
14-138), so ``state_dict()`` keys are the reference's keys
(``part2_1_2.0.conv.weight``, ``part2.1.module_list.0.1.norm.running_var``)
and reference checkpoints load with plain ``load_state_dict``.

Initialisation (``init_weights``) matches reference yolov4.py:283-294:
conv kernels kaiming-normal (fan_out, relu gain), conv biases zero,
BatchNorm scale ~ N(0, 0.01^2), BatchNorm bias zero.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Dict, Iterator, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from yolov4_tpu_torch.ops.csp import (fold_conv_bn, pack_weights,
                                      packed_dtype)
from yolov4_tpu_torch.ops.csp_cuda import (fused_csp_stage_cuda,
                                           fused_csp_supported)


def mish(x: torch.Tensor) -> torch.Tensor:
    """Mish, x * tanh(softplus(x)), through the exact algebraic identity
    tanh(ln(u)) = (u^2 - 1) / (u^2 + 1) with u = 1 + e^x:

        mish(x) = x * a / (a + 2),  a = e^x (e^x + 2)

    the same formula as the JAX package (one exp instead of three
    transcendentals). For x > 20, a / (a + 2) == 1 to ~1e-17: clamp to
    avoid exp overflow and return x, mish's exact asymptote.
    """
    e = torch.exp(torch.clamp(x, max=20.0))
    a = e * (e + 2.0)
    return torch.where(x > 20.0, x, x * a / (a + 2.0))


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.1)


ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": F.relu,
    "leaky_relu": leaky_relu,
    "mish": mish,
    "linear": lambda x: x,
}


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


class ConvBNAct(nn.Module):
    """Conv2d (symmetric ``(k-1)//2`` padding) + optional BatchNorm
    (eps 1e-5, momentum 0.1, flax's running-variance update) + activation
    (reference darknet.py:23-58)."""

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

    @property
    def out_ch(self) -> int:
        return self.conv.out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        return self.act(x)


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

    def freeze(self) -> None:
        """Fold and pack now, in the dtype and on the device of the base
        conv's weights (the body's input), and hold the result until
        :meth:`thaw`; a stage whose body would not go through K2 holds
        nothing."""
        w = self.base.conv.weight
        probe = w.new_empty((1, w.shape[0], 1, 1))
        self._frozen = None
        if self._fuses(probe):
            self._frozen = self.folded_weights(probe)

    def thaw(self) -> None:
        self._frozen = None

    def _fuses(self, x: torch.Tensor) -> bool:
        """Whether the body on NCHW ``x`` goes through K2 in an eval
        forward without autograd."""
        on = self.fused is True or (self.fused == "auto" and x.is_cuda)
        return (on and self.fusable
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
