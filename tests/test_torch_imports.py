"""Import hygiene of the port: it imports neither JAX nor the JAX package,
not even the JAX package's modules that are free of JAX."""

import json
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import yolov4_tpu_torch

PKG_DIR = Path(yolov4_tpu_torch.__file__).parent
ROOT = PKG_DIR.parent

_PROBE = r"""
import importlib, json, pkgutil, sys
import yolov4_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    yolov4_tpu_torch.__path__, "yolov4_tpu_torch."))
for name in names:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules
                if m in ("jax", "flax", "yolov4_tpu")
                or m.startswith(("jax.", "flax.", "yolov4_tpu.")))
print(json.dumps({"modules": names, "forbidden": loaded}))
"""


def test_importing_every_module_loads_no_jax_and_no_jax_package():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("ops.nms_cuda", "detect", "ops.csp", "ops.csp_cuda",
                 "ops.cuda_build", "eval.cocoeval", "data.coco",
                 "data.pipeline", "engine.evaluator", "utils.logging",
                 "utils.metrics", "val", "ops.loss", "optim.optimizers",
                 "optim.schedules", "parallel.train_step", "parallel.dist",
                 "parallel.mesh",
                 "utils.checkpoint", "utils.profiling", "engine.trainer",
                 "train", "utils.msgpack", "utils.export", "serve",
                 "serve.metrics", "serve.batcher", "serve.server",
                 "serve.artifact", "serve.__main__",
                 "tools.export_serving", "classify", "classify.data",
                 "classify.trainer", "models.darknet", "models.layers",
                 "ops.int8",
                 "darknet_pretrain", "native", "data.synthetic",
                 "tools.overfit_smoke", "tools.generalization_smoke",
                 "tools.run_coco_gate", "tools.export_torch",
                 "ops.replica", "utils.device", "tools.attr_trace",
                 "tools.check_csp_fused", "tools.act_bound"):
        assert f"yolov4_tpu_torch.{name}" in result["modules"]
    assert len(result["modules"]) >= 30
    assert result["forbidden"] == []


_FORBIDDEN = re.compile(
    r"^\s*(import jax\b|from jax\b|import flax\b|from flax\b"
    r"|from yolov4_tpu\.|from yolov4_tpu import|import yolov4_tpu\b(?!_))",
    re.MULTILINE)


def test_no_source_file_imports_jax_or_the_jax_package():
    sources = sorted(PKG_DIR.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(sources) > 30
    for path in sources:
        text = path.read_text()
        assert not _FORBIDDEN.search(text), path
        for needle in ("import jax", "from jax", "from yolov4_tpu.",
                       "from yolov4_tpu import"):
            assert needle not in text, (path, needle)


def test_every_module_is_importable_in_process():
    names = [m.name for m in pkgutil.walk_packages(
        yolov4_tpu_torch.__path__, "yolov4_tpu_torch.")]
    for name in names:
        __import__(name)
