"""K2, the fused CSP stage, in the port: the plain version of the kernel and
the BN folding against the JAX package (its Pallas kernel in interpret
mode), and the model's ``MODEL.PALLAS_CSP`` eval path against the JAX
package's and against the port's own default path. The CUDA kernel itself
is held against the plain version on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_helpers import nchw, small_cfgs, small_model_pair
from yolov4_tpu.config import Config as JaxConfig
from yolov4_tpu.models import build_model as jax_build_model
from yolov4_tpu.models.layers import FoldedConvBN
from yolov4_tpu.ops.csp_pallas import fused_csp_stage
from yolov4_tpu_torch.config import Config
from yolov4_tpu_torch.models import build_model, layers
from yolov4_tpu_torch.models.layers import ConvBNAct
from yolov4_tpu_torch.ops import csp_cuda
from yolov4_tpu_torch.ops.csp import (_mish, fold_conv_bn,
                                      fused_csp_stage_plain,
                                      kernel_gemm_shapes, kernel_widths,
                                      launch_plan, pack_weights,
                                      run_launch_plan, stage_names)

torch.set_num_threads(1)


def _folded_case(seed, c, num_blocks, h=16, w=16, b=2):
    """x [B, H, W, C] and folded weights drawn with numpy, scaled so that
    activations stay O(1) through the stage."""
    rng = np.random.default_rng(seed)
    c2 = c // 2
    if num_blocks == 0:
        shapes = {"part1": (c, c, 1), "part2_1_1": (c, c, 1),
                  "part2_1_2_0": (c, c2, 1), "part2_1_2_1": (c2, c, 3),
                  "part2_2": (c, c, 1), "transition": (2 * c, c, 1)}
    else:
        shapes = {"part1": (c, c2, 1), "part2_0": (c, c2, 1),
                  "part2_2": (c2, c2, 1), "transition": (c, c, 1)}
        for i in range(num_blocks):
            shapes[f"block{i}_0"] = (c2, c2, 1)
            shapes[f"block{i}_1"] = (c2, c2, 3)
    assert set(shapes) == set(stage_names(num_blocks))
    folded = {
        name: (rng.normal(0, 1 / np.sqrt(k * k * ci), (k, k, ci, co))
               .astype(np.float32),
               rng.uniform(-0.5, 0.5, co).astype(np.float32))
        for name, (ci, co, k) in shapes.items()}
    x = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    return x, folded


def _torch_folded(folded):
    return {k: (torch.from_numpy(a), torch.from_numpy(b))
            for k, (a, b) in folded.items()}


@pytest.mark.parametrize("num_blocks,dtype", [(0, "float32"), (2, "float32"),
                                              (4, "float32"),
                                              (2, "bfloat16")])
def test_plain_stage_matches_jax_kernel(num_blocks, dtype):
    x, folded = _folded_case(num_blocks, 16, num_blocks)
    want = fused_csp_stage(jnp.asarray(x, dtype),
                           {k: (jnp.asarray(a), jnp.asarray(b))
                            for k, (a, b) in folded.items()},
                           num_blocks=num_blocks, interpret=True)
    got = fused_csp_stage_plain(torch.from_numpy(x).to(getattr(torch, dtype)),
                                _torch_folded(folded), num_blocks)
    assert str(got.dtype) == f"torch.{dtype}" and got.shape == x.shape
    # oneDNN and XLA sum the convolutions in different orders; in bfloat16
    # both round at the same points, so a sum that straddles a rounding
    # boundary may differ by one ulp (2**-8 relative) and carry on
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("ksize", [1, 3])
def test_fold_conv_bn_matches_jax(ksize):
    rng = np.random.default_rng(10 + ksize)
    cin, cout = 8, 12
    kernel = rng.normal(0, 0.3, (ksize, ksize, cin, cout)).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, (2, cout)).astype(np.float32)
    mean = rng.normal(0, 0.2, cout).astype(np.float32)
    var = rng.uniform(0.3, 1.2, cout).astype(np.float32)
    variables = {"params": {"conv": {"kernel": kernel},
                            "norm": {"scale": scale, "bias": bias}},
                 "batch_stats": {"norm": {"mean": mean, "var": var}}}
    want_k, want_b = FoldedConvBN(cin, cout, ksize).apply(variables)

    mod = ConvBNAct(cin, cout, ksize, act="mish")
    with torch.no_grad():
        mod.conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        mod.norm.weight.copy_(torch.from_numpy(scale))
        mod.norm.bias.copy_(torch.from_numpy(bias))
        mod.norm.running_mean.copy_(torch.from_numpy(mean))
        mod.norm.running_var.copy_(torch.from_numpy(var))
    # folded in float32 even where the module's parameters are bfloat16
    for m in (mod, ConvBNAct(cin, cout, ksize, act="mish")):
        if m is not mod:
            m.load_state_dict(mod.state_dict())
            m.to(torch.bfloat16)
        got_k, got_b = fold_conv_bn(m)
        assert got_k.dtype == got_b.dtype == torch.float32
        assert got_k.shape == (ksize, ksize, cin, cout)
        tol = 1e-6 if m is mod else 1e-2
        np.testing.assert_allclose(got_k.numpy(), np.asarray(want_k),
                                   rtol=tol, atol=tol)
        np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b),
                                   rtol=tol, atol=tol)


def _unswizzle(flat, n, chunks):
    """pack_weights' bfloat16 layout back to the [N, K] matrix: chunk kc of
    row r holds K [64 kc, 64 kc + 64), its 16-byte group g at g ^ (r % 8)."""
    t = flat.float().reshape(chunks, n, 8, 8)
    perm = torch.arange(8)[None, :] ^ (torch.arange(n) % 8)[:, None]
    t = t.gather(2, perm[None, :, :, None].expand(chunks, n, 8, 8))
    return t.permute(1, 0, 2, 3).reshape(n, chunks * 64)


@pytest.mark.parametrize("num_blocks", [0, 3])
def test_packed_layout_is_what_the_kernel_checks(num_blocks):
    """pack_weights' shapes and dtypes pass the CUDA wrapper's own check,
    and the shared first GEMM holds both convs' columns: float32 as [K, N],
    bfloat16 transposed, padded to the kernel's widths and swizzled."""
    c = 24
    _, folded = _folded_case(3, c, num_blocks, h=4, w=4)
    folded = _torch_folded(folded)
    first = "part2_1_1" if num_blocks == 0 else "part2_0"
    n = folded[first][0].shape[-1]
    for dtype in (torch.float32, torch.bfloat16):
        packed = pack_weights(folded, num_blocks, dtype)
        x = torch.empty((1, 4, 4, c), dtype=dtype)
        csp_cuda._check_packed(packed, c, num_blocks, x)
        with pytest.raises(ValueError):
            csp_cuda._check_packed(packed[:-2], c, num_blocks, x)
        want = folded[first][0][0, 0].to(dtype).float()           # [C, n]
        if dtype == torch.float32:
            torch.testing.assert_close(packed[0][:, :n], want)
            torch.testing.assert_close(packed[1][n:], folded["part1"][1])
            continue
        cp, c2p = kernel_widths(c, num_blocks)
        n_pad, chunks = kernel_gemm_shapes(c, num_blocks)[0]
        wt = _unswizzle(packed[0], n_pad, chunks)
        half = n_pad // 2                    # part1's columns start here
        torch.testing.assert_close(wt[:n, :c], want.t())
        assert not wt[n:half].any() and not wt[:, c:].any()
        torch.testing.assert_close(wt[half:half + n, :c],
                                   folded["part1"][0][0, 0].to(dtype)
                                   .float().t())
        torch.testing.assert_close(packed[1][half:half + n],
                                   folded["part1"][1])
        assert not packed[1][n:half].any()


def _emulate_packed(x, folded, num_blocks):
    """The bfloat16 kernel's arithmetic on pack_weights' layout, on the
    CPU: each GEMM of the launch plan as a float32 product of its padded
    sources (a 3x3 gathered tap-major with zero padding) with the
    unswizzled [N, K] weight, then bias, Mish, the epilogue and rounding;
    a chained GEMM reads the previous one's rounded output."""
    dt = torch.bfloat16
    b, h, w, c = x.shape
    cp, c2p = kernel_widths(c, num_blocks)
    pad = {c: cp, c // 2: c2p}
    packed = pack_weights(folded, num_blocks, dt)
    shapes = iter(kernel_gemm_shapes(c, num_blocks))
    memory = {"x": torch.nn.functional.pad(x.to(dt), (0, cp - c))}
    gi = 0
    for launch in launch_plan(c, num_blocks):
        regs = {}
        for g in launch.gemms:
            n_pad, chunks = next(shapes)
            wt = _unswizzle(packed[2 * gi], n_pad, chunks)
            bias = packed[2 * gi + 1]
            gi += 1
            ranges = []
            for src in g.srcs:
                v = (regs.get(src, memory.get(src))).float()
                if g.ksize == 3:
                    vp = torch.nn.functional.pad(v, (0, 0, 1, 1, 1, 1))
                    v = torch.cat([vp[:, dy:dy + h, dx:dx + w]
                                   for dy in range(3) for dx in range(3)], -1)
                k = v.shape[-1]
                ranges.append(torch.nn.functional.pad(
                    v, (0, -(-k // 64) * 64 - k)))
            y = _mish(torch.cat(ranges, -1) @ wt.t() + bias)
            col = 0
            for conv, out in zip(g.convs, g.outs):
                width = folded[conv][0].shape[-1]
                part = y[..., col:col + pad[width]]
                col += pad[width]
                if g.epilogue == "sum":
                    part = regs.get(g.res, memory.get(g.res)).float() + part
                elif g.epilogue == "residual":
                    part = regs.get(g.res, memory.get(g.res)) + part.to(dt)
                regs[out] = part.to(dt)
        memory.update({k: regs[k] for k in launch.stores})
    return memory["out"][..., :c]


@pytest.mark.parametrize("num_blocks", [0, 1, 3])
def test_launch_plan_runs_every_conv_once(num_blocks):
    plan = launch_plan(24, num_blocks)
    assert len(plan) == (2 if num_blocks == 0 else num_blocks + 1)
    convs = [n for launch in plan for g in launch.gemms for n in g.convs]
    assert sorted(convs) == sorted(stage_names(num_blocks))
    # the GEMMs' order is pack_weights' order
    assert len(kernel_gemm_shapes(24, num_blocks)) == sum(
        len(launch.gemms) for launch in plan)
    # every launch after the first chains each 1x1 on its first GEMM, and a
    # 3x3 reads only what an earlier launch stored
    stored = {"x"}
    for launch in plan:
        for i, g in enumerate(launch.gemms):
            if g.ksize == 3:
                assert set(g.srcs) <= stored
            elif i > 0:
                assert g.srcs[0] in {o for h in launch.gemms[:i]
                                     for o in h.outs}
        stored |= set(launch.stores)
    assert "out" in plan[-1].stores


@pytest.mark.parametrize("num_blocks", [0, 1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [16, 24])
def test_launch_plan_executor_equals_plain(num_blocks, dtype, c):
    """The plan computed launch by launch, with only stored values
    crossing launches, is the plain version bit for bit."""
    x, folded = _folded_case(20 + num_blocks, c, num_blocks)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    folded = _torch_folded(folded)
    assert torch.equal(run_launch_plan(xt, folded, num_blocks),
                       fused_csp_stage_plain(xt, folded, num_blocks))


@pytest.mark.parametrize("num_blocks,dtype", [(0, "float32"), (1, "float32"),
                                              (3, "bfloat16")])
def test_launch_plan_executor_matches_jax_kernel(num_blocks, dtype):
    x, folded = _folded_case(30 + num_blocks, 16, num_blocks)
    want = fused_csp_stage(jnp.asarray(x, dtype),
                           {k: (jnp.asarray(a), jnp.asarray(b))
                            for k, (a, b) in folded.items()},
                           num_blocks=num_blocks, interpret=True)
    got = run_launch_plan(torch.from_numpy(x).to(getattr(torch, dtype)),
                          _torch_folded(folded), num_blocks)
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("num_blocks,c", [(0, 16), (0, 24), (1, 24),
                                          (3, 18), (2, 64)])
def test_packed_weights_compute_the_stage(num_blocks, c):
    """The kernel's padded, transposed, swizzled weights (read back as the
    kernel reads them) compute the plain version's function: a packing
    fault moves whole channels and would exceed this by far."""
    x, folded = _folded_case(40 + c, c, num_blocks, h=6, w=5)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    folded = _torch_folded(folded)
    got = _emulate_packed(xt, folded, num_blocks).float()
    want = fused_csp_stage_plain(xt, folded, num_blocks).float()
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-2,
                               rtol=2e-2)


def test_supported_gate_is_shape_logic():
    ok = csp_cuda.fused_csp_supported
    assert ok((16, 76, 76, 256), 8, torch.bfloat16)
    assert ok((2, 5, 7, 24), 0, torch.float32)
    assert not ok((2, 5, 7, 25), 0, torch.float32)      # odd C
    assert not ok((0, 5, 7, 24), 2, torch.float32)      # empty
    assert not ok((2, 5, 7, 24), 2, torch.float16)
    assert not ok((2, 5, 24), 2, torch.float32)
    # bfloat16 up to the widest compiled width (ops/csp.KERNEL_WIDTHS)
    assert ok((1, 8, 8, 256), 2, torch.bfloat16)
    assert ok((1, 8, 8, 128), 0, torch.bfloat16)
    assert not ok((1, 8, 8, 264), 2, torch.bfloat16)
    assert not ok((1, 8, 8, 136), 0, torch.bfloat16)
    assert ok((1, 8, 8, 264), 2, torch.float32)


@pytest.fixture(scope="module")
def fused_pair():
    """The WIDTH = DEPTH = 0.25 f32 model with PALLAS_CSP on, in both
    packages, on the same spread weights; and the port's default model."""
    _, cfg, jmodel, jvars, sd = small_model_pair(seed=2)
    raw = {"MODEL": {"WIDTH": 0.25, "DEPTH": 0.25, "COMPUTE_DTYPE": "float32",
                     "PALLAS_CSP": True}, "TEST": {"IMGSIZE": 64}}
    jfused = jax_build_model(JaxConfig.from_dict(raw))
    fused = build_model(Config.from_dict(raw), device="cpu")
    fused.load_state_dict(sd)
    fused.eval()
    plain = build_model(cfg, device="cpu")
    plain.load_state_dict(sd)
    plain.eval()
    x = np.random.default_rng(3).random((2, 64, 64, 3), dtype=np.float32)
    return dict(jfused=jfused, jvars=jvars, fused=fused, plain=plain, sd=sd,
                x=x)


def test_pallas_csp_model_matches_jax_and_default_path(fused_pair, monkeypatch):
    p = fused_pair
    want = np.asarray(jax.jit(lambda v, x: p["jfused"].apply(v, x, train=False))(
        p["jvars"], jnp.asarray(p["x"])))
    calls = []

    def spy(x, folded, num_blocks, packed=None):
        calls.append((tuple(x.shape), num_blocks))
        return csp_cuda.fused_csp_stage_cuda(x, folded, num_blocks, packed)

    monkeypatch.setattr(layers, "fused_csp_stage_cuda", spy)
    with torch.no_grad():
        got = p["fused"](nchw(p["x"])).numpy()
        default = p["plain"](nchw(p["x"])).numpy()
    # stages 1-3 through the K2 wrapper, 4 and 5 layer by layer
    assert [nb for _, nb in calls] == [0, 1, 2]
    assert calls[0][0] == (2, 32, 32, 16)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, default, atol=1e-4, rtol=1e-4)


def test_fused_path_needs_eval_without_autograd(fused_pair, monkeypatch):
    calls = []
    monkeypatch.setattr(layers, "fused_csp_stage_cuda",
                        lambda *a: calls.append(1) or
                        csp_cuda.fused_csp_stage_cuda(*a))
    model, x = fused_pair["fused"], nchw(fused_pair["x"])
    model(x)                       # autograd records: layer by layer
    assert calls == []
    with torch.no_grad():
        model(x)
    assert len(calls) == 3


def test_fold_cache_follows_load_state_dict_and_train(fused_pair):
    """Folded weights are cached for eval; a later load_state_dict, a
    training step's BN statistics, or train() must take effect."""
    p = fused_pair
    _, cfg = small_cfgs()
    raw = {"MODEL": {"WIDTH": 0.25, "DEPTH": 0.25, "COMPUTE_DTYPE": "float32",
                     "PALLAS_CSP": True}, "TEST": {"IMGSIZE": 64}}
    model = build_model(Config.from_dict(raw), device="cpu")
    model.load_state_dict(p["sd"])
    model.eval()
    x = nchw(p["x"])
    with torch.no_grad():
        model(x)                                   # fills the cache
        stage1 = model.backbone.stage1
        assert stage1._fold_cache is not None
        other = {k: (v * 0.9 if k.endswith(("norm.weight", "running_mean"))
                     else v) for k, v in p["sd"].items()}
        model.load_state_dict(other)
        p["plain"].load_state_dict(other)
        try:
            np.testing.assert_allclose(model(x).numpy(),
                                       p["plain"](x).numpy(),
                                       atol=1e-4, rtol=1e-4)
        finally:
            p["plain"].load_state_dict(p["sd"])
    model.train()
    with torch.no_grad():
        model(x)                                   # BN running stats move
    model.eval()
    ref = build_model(cfg, device="cpu")
    ref.load_state_dict(model.state_dict())
    ref.eval()
    with torch.no_grad():
        np.testing.assert_allclose(model(x).numpy(), ref(x).numpy(),
                                   atol=1e-4, rtol=1e-4)


def test_state_dict_keys_unchanged_by_the_flag(fused_pair):
    assert (list(fused_pair["fused"].state_dict())
            == list(fused_pair["plain"].state_dict()))


@pytest.mark.parametrize("num_blocks", [0, 1, 2, 8])
def test_plan_kinds_follow_the_launch_plan(num_blocks):
    kinds = csp_cuda.plan_kinds(num_blocks)
    assert len(kinds) == len(launch_plan(64, num_blocks))
    assert set(kinds) <= set(csp_cuda.KINDS)


def test_kernel_report_reads_the_ptxas_log(tmp_path, monkeypatch):
    """kernel_report pairs each wgmma instance of the build log with its
    registers, spills, ptxas notes and dynamic shared memory."""
    kernel = "_ZN3_GLOBAL__N_12wg16csp_wgmma_kernelILi{}ELi{}EEEvNS0_6ParamsE"
    log = [
        f"ptxas info    : (C7520) Potential Performance Loss: wgmma in the "
        f"function '{kernel.format(3, 64)}'",
        f"ptxas info    : Compiling entry function '{kernel.format(4, 256)}'"
        " for 'sm_90a'",
        "ptxas info    : Function properties for x",
        "    16 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{kernel.format(3, 64)}'"
        " for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 154 registers, used 1 barriers",
        "ptxas info    : Compiling entry function 'csp_conv_kernel' for "
        "'sm_90a'",
        "ptxas info    : Used 99 registers, used 1 barriers, 34816 bytes smem",
    ]
    (tmp_path / "lib.log").write_text("\n".join(log))

    class Lib:
        @staticmethod
        def csp_wgmma_smem(kind, cp):
            return 1000 * kind + cp

    monkeypatch.setattr(csp_cuda, "build", lambda: tmp_path / "lib.so")
    monkeypatch.setattr(csp_cuda, "_load", lambda: Lib)
    rows = csp_cuda.kernel_report()
    assert rows == [
        dict(kind="csp_last", cp=256, dynamic_smem=4256, notes=[], stack=16,
             spill_stores=12, spill_loads=8, registers=168),
        dict(kind="csp_mid", cp=64, dynamic_smem=3064, notes=["C7520"],
             stack=0, spill_stores=0, spill_loads=0, registers=154)]
