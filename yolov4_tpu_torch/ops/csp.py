"""Eval-time CSP stage body with BatchNorm folded: the plain PyTorch version
of the kernel ``csrc/csp.cu`` and the weight folding both paths share.

The stage body is everything a CSP stage computes after its strided base
conv (reference darknet.py:84-138), with each ConvBNAct's BatchNorm folded
into its conv as a per-output-channel bias. ``cba`` is a conv + bias +
algebraic Mish:

  csp0 (stage 1, ``num_blocks`` = 0):
      a  = cba(x, part2_1_1)              1x1 C -> C
      t  = cba(a, part2_1_2_0)            1x1 C -> C/2
      s  = a + cba3(t, part2_1_2_1)       3x3 C/2 -> C
      x2 = cba(s, part2_2)                1x1 C -> C
      x1 = cba(x, part1)                  1x1 C -> C
      out = cba(concat(x2, x1), transition)    1x1 2C -> C

  csp (stages 2+, ``num_blocks`` >= 1):
      h  = cba(x, part2_0)                1x1 C -> C/2
      num_blocks x [h = h + cba3(cba(h, block{i}_0), block{i}_1)]
      x2 = cba(h, part2_2)                1x1 C/2 -> C/2
      x1 = cba(x, part1)                  1x1 C -> C/2
      out = cba(concat(x2, x1), transition)    1x1 C -> C

The function and its rounding points are those of the TPU kernel
``fused_csp_stage`` (yolov4_tpu/ops/csp_pallas.py:344): conv kernels in
x's dtype, sums, bias and Mish in float32; every ``cba`` output stored in
x's dtype except csp0's ``u`` (added to ``a`` in float32 before ``s`` is
cast) and ``x2``/``x1`` (concatenated in float32, then cast); csp's
residual add in x's dtype; the 3x3 convs zero-padded at image borders.

Layouts are the JAX package's: x is NHWC, a folded kernel is HWIO
``[k, k, ci, co]`` float32 and its bias ``[co]`` float32.

:func:`launch_plan` is the bfloat16 kernel's schedule: which GEMMs each
launch runs, where each operand comes from, and what it stores. Each 1x1
conv after the first runs chained in the epilogue of the conv before it,
on that conv's output held in registers; :func:`run_launch_plan` executes
the plan with the plain version's arithmetic, so that the tests hold the
schedule to :func:`fused_csp_stage_plain`.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

Folded = Dict[str, Tuple[torch.Tensor, torch.Tensor]]

# channel widths the bfloat16 kernel is compiled for (csrc/csp.cu): a stage
# with C channels runs the smallest one >= C, its widths zero-padded
KERNEL_WIDTHS = {0: (32, 64, 128), 1: (32, 64, 128, 256)}


@torch.no_grad()
def fold_conv_bn(convbnact) -> Tuple[torch.Tensor, torch.Tensor]:
    """A bias-free ConvBNAct's eval-time (kernel [k, k, ci, co], bias [co]),
    float32: ``s = gamma * rsqrt(running_var + eps)``, kernel ``w * s``,
    bias ``beta - running_mean * s`` (the JAX package's ``FoldedConvBN``,
    models/layers.py:833-871). Folded in float32 whatever the module's
    parameter dtype."""
    conv, norm = convbnact.conv, convbnact.norm
    if norm is None or conv.bias is not None:
        raise ValueError("fold_conv_bn takes a bias-free conv followed by "
                         "BatchNorm")
    s = norm.weight.float() * torch.rsqrt(norm.running_var.float() + norm.eps)
    kernel = conv.weight.float().permute(2, 3, 1, 0) * s
    bias = norm.bias.float() - norm.running_mean.float() * s
    return kernel.contiguous(), bias


def stage_names(num_blocks: int) -> List[str]:
    """The folded-dict names of a stage body (csp_pallas.py:353-356)."""
    if num_blocks == 0:
        return ["part1", "part2_1_1", "part2_1_2_0", "part2_1_2_1",
                "part2_2", "transition"]
    names = ["part1", "part2_0"]
    for i in range(num_blocks):
        names += [f"block{i}_0", f"block{i}_1"]
    return names + ["part2_2", "transition"]


def _mish(x: torch.Tensor) -> torch.Tensor:
    e = torch.exp(torch.clamp(x, max=20.0))
    a = e * (e + 2.0)
    return torch.where(x > 20.0, x, x * a / (a + 2.0))


def _cba_f32(src: torch.Tensor, folded: Folded, name: str) -> torch.Tensor:
    """mish(conv(src) + bias) in float32 on an NHWC ``src``; the kernel is
    rounded to src's dtype first, as the TPU kernel feeds its dots."""
    kernel, bias = folded[name]
    w = kernel.to(src.dtype).float().permute(3, 2, 0, 1)     # OIHW
    y = F.conv2d(src.float().permute(0, 3, 1, 2), w,
                 padding=kernel.shape[0] // 2)
    return _mish(y.permute(0, 2, 3, 1) + bias.float())


def fused_csp_stage_plain(x: torch.Tensor, folded: Folded,
                          num_blocks: int) -> torch.Tensor:
    """The stage body on NHWC ``x`` [B, H, W, C] (float32 or bfloat16) ->
    [B, H, W, C] in x's dtype. ``folded``: name -> (kernel, bias) as
    :func:`fold_conv_bn` returns them, names from :func:`stage_names`."""
    dt = x.dtype

    def cba(src, name):
        return _cba_f32(src, folded, name).to(dt)

    if num_blocks == 0:
        a = cba(x, "part2_1_1")
        t = cba(a, "part2_1_2_0")
        s = (a.float() + _cba_f32(t, folded, "part2_1_2_1")).to(dt)
        x2 = _cba_f32(s, folded, "part2_2")
    else:
        h = cba(x, "part2_0")
        for i in range(num_blocks):
            p = cba(h, f"block{i}_0")
            h = h + cba(p, f"block{i}_1")
        x2 = _cba_f32(h, folded, "part2_2")
    x1 = _cba_f32(x, folded, "part1")
    return cba(torch.cat([x2, x1], dim=-1).to(dt), "transition")



class Gemm(NamedTuple):
    """One GEMM of a launch. ``convs`` (folded names) sit side by side
    along N and write the values ``outs``, one each; ``srcs`` are the
    values it reads, one K range each (a 3x3 reads one, gathered with zero
    padding at image borders). ``epilogue`` after bias + Mish: "mish"
    (none), "sum" (csp0's ``s = dtype(f32(res) + u)``) or "residual"
    (csp's ``h = res + dtype(q)``)."""
    convs: Tuple[str, ...]
    outs: Tuple[str, ...]
    srcs: Tuple[str, ...]
    ksize: int = 1
    epilogue: str = "mish"
    res: str = ""


class Launch(NamedTuple):
    """One kernel launch: its GEMMs in order, each after the first chained
    on values the launch computed (held in registers) or reading values
    an earlier launch stored; ``stores`` are the values it writes to
    memory."""
    gemms: Tuple[Gemm, ...]
    stores: Tuple[str, ...]


def launch_plan(c: int, num_blocks: int) -> List[Launch]:
    """The bfloat16 kernel's launches for a stage body with ``c`` channels
    and ``num_blocks`` residual blocks (0 = csp0): 2 for csp0, nb + 1
    otherwise. Every folded conv of :func:`stage_names` runs once; the
    packed weights (:func:`pack_weights`) follow the GEMMs' order. A 3x3
    reads its source at neighbouring pixels, which other tiles compute, so
    it reads a value stored by an earlier launch; csp's ``p`` alternates
    between two buffers for the same reason (``p{i}`` in buffer i % 2)."""
    if c < 2 or c % 2:
        raise ValueError(f"a stage body needs an even C >= 2, got {c}")
    if num_blocks == 0:
        return [
            Launch((Gemm(("part2_1_1", "part1"), ("a", "x1"), ("x",)),
                    Gemm(("part2_1_2_0",), ("t",), ("a",))),
                   ("a", "x1", "t")),
            Launch((Gemm(("part2_1_2_1",), ("s",), ("t",), 3, "sum", "a"),
                    Gemm(("part2_2",), ("x2",), ("s",)),
                    Gemm(("transition",), ("out",), ("x2", "x1"))),
                   ("out",)),
        ]
    plan = [Launch((Gemm(("part2_0", "part1"), ("h", "x1"), ("x",)),
                    Gemm(("block0_0",), ("p0",), ("h",))),
                   ("h", "x1", "p0"))]
    for i in range(1, num_blocks + 1):
        resid = Gemm((f"block{i - 1}_1",), ("h",), (f"p{i - 1}",), 3,
                     "residual", "h")
        if i < num_blocks:
            plan.append(Launch((resid, Gemm((f"block{i}_0",), (f"p{i}",),
                                            ("h",))), ("h", f"p{i}")))
        else:
            plan.append(Launch((resid, Gemm(("part2_2",), ("x2",), ("h",)),
                                Gemm(("transition",), ("out",),
                                     ("x2", "x1"))), ("out",)))
    return plan


def run_launch_plan(x: torch.Tensor, folded: Folded,
                    num_blocks: int) -> torch.Tensor:
    """:func:`fused_csp_stage_plain`'s function computed launch by launch
    as :func:`launch_plan` schedules it, with the same arithmetic: a launch
    reads only values stored by earlier launches and its own chained
    values, and only what it stores outlives it. Used by the tests and
    chip_smoke.py to hold the plan to the plain version."""
    dt = x.dtype
    memory = {"x": x}
    for launch in launch_plan(x.shape[-1], num_blocks):
        regs = {}

        def read(name, regs=regs):
            return regs[name] if name in regs else memory[name]

        for g in launch.gemms:
            if g.ksize != 1 and any(s in regs for s in g.srcs):
                raise ValueError(f"a {g.ksize}x{g.ksize} conv reads "
                                 f"{g.srcs} at other tiles' pixels: they "
                                 "must come from memory")
            srcs = [read(s) for s in g.srcs]
            src = srcs[0] if len(srcs) == 1 else torch.cat(srcs, dim=-1)
            for conv, out in zip(g.convs, g.outs):
                y = _cba_f32(src, folded, conv)
                if g.epilogue == "sum":
                    y = read(g.res).float() + y
                elif g.epilogue == "residual":
                    y = read(g.res) + y.to(dt)
                regs[out] = y.to(dt)
        memory.update({name: regs[name] for name in launch.stores})
    return memory["out"]


def kernel_widths(c: int, num_blocks: int) -> Tuple[int, int]:
    """(CP, CP/2): the bfloat16 kernel's padded widths of C and C/2 for a
    stage body with ``c`` channels; ValueError past the widest instance."""
    for cp in KERNEL_WIDTHS[min(num_blocks, 1)]:
        if cp >= c:
            return cp, cp // 2
    raise ValueError(f"the bfloat16 CSP kernel takes C <= "
                     f"{KERNEL_WIDTHS[min(num_blocks, 1)][-1]} for "
                     f"num_blocks={num_blocks}, got {c}")


def _round_up(n: int, k: int) -> int:
    return -(-n // k) * k


def _value_widths(c: int, num_blocks: int) -> Dict[str, int]:
    """Channels of each value :func:`launch_plan` names."""
    if num_blocks == 0:
        return dict(x=c, a=c, x1=c, t=c // 2, s=c, x2=c, out=c)
    widths = dict(x=c, h=c // 2, x1=c // 2, x2=c // 2, out=c)
    widths.update({f"p{i}": c // 2 for i in range(num_blocks)})
    return widths


def kernel_gemm_shapes(c: int, num_blocks: int) -> List[Tuple[int, int]]:
    """(N, K chunks) of each GEMM of the bfloat16 kernel in launch order:
    N the padded output width, K cut into 64-wide chunks, each source's K
    range padded to whole chunks (csrc/csp.cu derives the same)."""
    cp, c2p = kernel_widths(c, num_blocks)
    pad = {c: cp, c // 2: c2p}
    widths = _value_widths(c, num_blocks)
    return [(sum(pad[widths[o]] for o in g.outs),
             sum(_round_up(g.ksize ** 2 * pad[widths[s]], 64) // 64
                 for s in g.srcs))
            for launch in launch_plan(c, num_blocks) for g in launch.gemms]


def _swizzled_chunks(wt: torch.Tensor) -> torch.Tensor:
    """[N, K] (K a multiple of 64) -> flat [K/64, N, 64]: each 64-wide K
    chunk of every row is one 128-byte bfloat16 row, its eight 16-byte
    groups placed at group ^ (row % 8): the 128-byte swizzle that the
    kernel's wgmma descriptors read, so that one bulk copy brings a chunk
    to shared memory as it is."""
    n, k = wt.shape
    t = wt.reshape(n, k // 64, 8, 8)
    g = torch.arange(8, device=wt.device)
    perm = g[None, :] ^ (torch.arange(n, device=wt.device) % 8)[:, None]
    idx = perm[:, None, :, None].expand(n, k // 64, 8, 8)
    return t.gather(2, idx).permute(1, 0, 2, 3).reshape(-1)


def pack_weights(folded: Folded, num_blocks: int,
                 dtype: torch.dtype) -> List[torch.Tensor]:
    """The kernel's weight list: for each GEMM of :func:`launch_plan`, in
    order, a weight in ``dtype`` and a float32 bias. The two 1x1 convs
    that read x share one GEMM, their columns side by side: csp0
    [part2_1_1 | part1], csp [part2_0 | part1].

    float32 (the scalar kernel): a [K, N] matrix, K = k*k*ci rows tap-major
    as HWIO flattens, and a [N] bias. bfloat16 (the wgmma kernel): every
    width padded to :func:`kernel_widths` with zeros, the weight transposed
    to [N, K] (K tap-major, each source's range padded to whole 64-wide
    chunks) and laid out by :func:`_swizzled_chunks`; the bias [N]."""
    c = folded["transition"][0].shape[-1]
    out = []
    if dtype != torch.bfloat16:
        for launch in launch_plan(c, num_blocks):
            for g in launch.gemms:
                mats = [folded[n][0].reshape(-1, folded[n][0].shape[-1])
                        for n in g.convs]
                out += [torch.cat(mats, dim=1).to(dtype).contiguous(),
                        torch.cat([folded[n][1] for n in g.convs]).float()
                        .contiguous()]
        return out
    cp, c2p = kernel_widths(c, num_blocks)
    pad = {c: cp, c // 2: c2p}
    widths = _value_widths(c, num_blocks)
    shapes = iter(kernel_gemm_shapes(c, num_blocks))
    for launch in launch_plan(c, num_blocks):
        for g in launch.gemms:
            n_pad, chunks = next(shapes)
            dev = folded[g.convs[0]][0].device
            wt = torch.zeros(n_pad, chunks * 64, device=dev)
            bias = torch.zeros(n_pad, device=dev)
            col = 0
            for name, out_name in zip(g.convs, g.outs):
                kernel, b = folded[name]
                k, _, ci, co = kernel.shape
                src = kernel.float().reshape(k * k, ci, co).permute(2, 0, 1)
                row = at = 0
                for s in g.srcs:                 # one K range per source
                    w = widths[s]
                    block = torch.zeros(co, k * k, pad[w], device=dev)
                    block[:, :, :w] = src[:, :, at:at + w]
                    wt[col:col + co, row:row + k * k * pad[w]] = \
                        block.reshape(co, -1)
                    row += _round_up(k * k * pad[w], 64)
                    at += w
                bias[col:col + co] = b.float()
                col += pad[widths[out_name]]
            out += [_swizzled_chunks(wt.to(torch.bfloat16)).contiguous(),
                    bias]
    return out


def packed_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype of :func:`pack_weights`' list for the stage input ``x``:
    x's own on a card, in the layout of the kernel for that dtype; float32
    on the CPU, where the op's plain version reads the [K, N] layout back
    by a reshape (:func:`unpack_weights`) and rounds the kernels to x's
    dtype itself."""
    return x.dtype if x.is_cuda else torch.float32


def unpack_weights(packed, c: int, num_blocks: int) -> Folded:
    """:func:`pack_weights`' inverse for its float32 layout: the folded
    kernels ([k, k, ci, co] float32) and biases of a stage body with ``c``
    channels (the custom op's CPU implementation, ops/csp_cuda.py)."""
    widths = _value_widths(c, num_blocks)
    gemms = [g for launch in launch_plan(c, num_blocks) for g in launch.gemms]
    if len(packed) != 2 * len(gemms):
        raise ValueError(f"expected {2 * len(gemms)} packed tensors, got "
                         f"{len(packed)}")
    if packed[0].dtype != torch.float32:
        raise ValueError(f"the CPU reads float32 packed weights, got "
                         f"{packed[0].dtype} (the card's layout)")
    out: Folded = {}
    for i, g in enumerate(gemms):
        w, bias = packed[2 * i], packed[2 * i + 1]
        col = 0
        for name, out_name in zip(g.convs, g.outs):
            co = widths[out_name]
            kernel = w[:, col:col + co].reshape(g.ksize, g.ksize, -1, co)
            out[name] = (kernel.contiguous(), bias[col:col + co].contiguous())
            col += co
    return out
