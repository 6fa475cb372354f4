"""``Predictor(group=...)`` on the CPU, WIDTH = DEPTH = 0.25, 64x64,
float32: the ranks of a torch.distributed group (one process a rank, as
torchrun starts them) each run their own block of a batch, with the
batch-global maxima (the NMS's class-offset span, the dynamic int8
abs-max, int8_static's calibrated scales) taken over the ranks, as the JAX
package's predictor over a mesh of several processes takes them.

Two gloo ranks are spawned once for the module (``ranks``;
tests/test_torch_parallel_worker.py::ranks_task runs every case in them).
Their rows side by side are held bit for bit against the port's unsharded
predictor on the whole batch (on the CPU a row's arithmetic does not
depend on how many rows share the call), against the JAX package's
predictor over a two-device mesh at the same global batch, and on batches
built so that a rank's own maximum gives other rows (tests/
test_torch_mesh.py's span case and bright/dark images). Then the
Trainer's validation over the ranks, a group of one rank, and the
refusals."""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from tests.fixtures import make_fake_coco
from tests.test_torch_mesh import (SIZE, TEST_KEYS, _cfg, _cpu_mesh, _images,
                                   _span_case, pair)  # noqa: F401 (fixture)
from tests.test_torch_parallel import Spawned
from yolov4_tpu.engine.predictor import Predictor as JaxPredictor
from yolov4_tpu.parallel.mesh import create_mesh as jax_create_mesh
from yolov4_tpu_torch.config import Config
from yolov4_tpu_torch.data.pipeline import build_val_loader
from yolov4_tpu_torch.engine.evaluator import validate
from yolov4_tpu_torch.engine.predictor import Predictor
from yolov4_tpu_torch.ops.replica import group_scope, replica_scope
from yolov4_tpu_torch.utils.export import export_serving

torch.set_num_threads(1)

WORLD = 2
VAL_IMAGES = 8      # two batches of 2 a rank: no wrap padding


def _bright_dark(seed):
    """Bright noise in the first rank's rows, dark images (values 0-7) in
    the second's: the second rank's own activation abs-max is far below
    the batch's (tests/test_torch_mesh.py's int8 case)."""
    images = _images(seed)
    images[4:] //= 32
    return images


_SPAN_MODEL, _SPAN_IMAGES = _span_case()
# case: (MODEL overrides, the global batch, whether the LookupModel of the
# span case stands in for the weights)
CASES = {
    "float32": ({}, _images(1), False),
    "pallas_csp": ({"PALLAS_CSP": True}, _images(1), False),
    "span": ({}, _SPAN_IMAGES, True),
    "int8-late": ({"QUANT": "int8", "QUANT_SPAN": "late"}, _bright_dark(3),
                  False),
    "int8-full": ({"QUANT": "int8", "QUANT_SPAN": "full"}, _bright_dark(3),
                  False),
    "int8_static": ({"QUANT": "int8_static"}, _bright_dark(4), False),
}


def _trainer_raw(out_dir):
    return {"MODEL": {"WIDTH": 0.25, "DEPTH": 0.25,
                      "COMPUTE_DTYPE": "float32"},
            "TEST": {"IMGSIZE": SIZE, "BATCH_SIZE": 2, **TEST_KEYS},
            "DATA": {"WORKERS": 0}, "TRAIN": {"OUTPUT_DIR": out_dir}}


@pytest.fixture(scope="module")
def ranks(pair, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    np.savez(tmp / "sd.npz", **{k: v.numpy() for k, v in pair["sd"].items()})
    root = str(tmp / "coco")
    make_fake_coco(root, "val2017", n_images=VAL_IMAGES, seed=3)
    trainer_raw = _trainer_raw(str(tmp / "out"))
    results = Spawned(
        tmp, "ranks", cfg_raw={k: dict(v) for k, v in pair["cfg"].items()},
        sd_path=str(tmp / "sd.npz"), cases=CASES,
        span_preds=_SPAN_MODEL.preds.numpy(), val_root=root,
        trainer_raw=trainer_raw).results()
    return dict(results=results, root=root, trainer_raw=trainer_raw)


def _side_by_side(results, name):
    """The ranks' rows of a case, in rank order (the global batch's)."""
    return tuple(torch.cat([r[name][i] for r in results]).numpy()
                 for i in range(2))


def _unsharded(pair, over, images, lookup):
    weights = (dict(model=_SPAN_MODEL) if lookup
               else dict(state_dict=pair["sd"]))
    return Predictor(_cfg(pair["cfg"], **over), batch_size=len(images),
                     device="cpu", **weights)


def _assert_same_rows(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _assert_jax_rows(det, valid, jdet, jvalid):
    """tests/test_torch_mesh.py::test_mesh_matches_jax_mesh's tolerances."""
    np.testing.assert_array_equal(valid, jvalid)
    np.testing.assert_allclose(det[..., :4], jdet[..., :4], rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(det[..., 4:6], jdet[..., 4:6], atol=1e-5)
    np.testing.assert_array_equal(det[..., 6], jdet[..., 6])


def _jax_mesh_predictor(pair, batch):
    """The JAX package's predictor over a two-device mesh: global batch
    ``batch``, each device a block of batch / 2 rows, as two processes of
    one device each would hold it."""
    return JaxPredictor(pair["jcfg"], variables=pair["jvars"], img_size=SIZE,
                        batch_size=batch,
                        mesh=jax_create_mesh(jax.devices()[:WORLD]))


# --------------------------------------------------------------------------
# (a) the ranks against the unsharded predictor and JAX's mesh

@pytest.mark.parametrize("case", ("float32", "pallas_csp"))
def test_ranks_match_unsharded(pair, ranks, case):
    over, images, lookup = CASES[case]
    got = _side_by_side(ranks["results"], case)
    assert got[0].shape == (8, 50, 7) and 0 < got[1].sum() < got[1].size
    _assert_same_rows(got, _unsharded(pair, over, images, lookup)(images))


def test_ranks_match_jax_mesh(pair, ranks):
    _, images, _ = CASES["float32"]
    jpred = _jax_mesh_predictor(pair, len(images))
    assert jpred.batch_size == len(images)
    _assert_jax_rows(*_side_by_side(ranks["results"], "float32"),
                     *jpred(images))


# --------------------------------------------------------------------------
# (b) blocks whose own maxima would give other rows

@pytest.mark.parametrize("case", ("span", "int8-late", "int8-full"))
def test_rank_maxima_are_the_groups(pair, ranks, case):
    """The second rank's rows equal the whole batch's, where its own
    maximum (its block alone, no group) gives other rows."""
    over, images, lookup = CASES[case]
    full = _unsharded(pair, over, images, lookup)(images)
    own = _unsharded(pair, over, images[4:], lookup)(images[4:])
    assert any(not np.array_equal(o, f[4:]) for o, f in zip(own, full))
    _assert_same_rows(_side_by_side(ranks["results"], case), full)


# --------------------------------------------------------------------------
# (c) int8_static calibration over the ranks

def test_int8_static_calibration_over_ranks(pair, ranks):
    over, images, lookup = CASES["int8_static"]
    plain = _unsharded(pair, over, images, lookup)
    plain.calibrate(images)
    want = plain.quant_state
    assert len(want) > 10
    for r in ranks["results"]:
        got = r["int8_static/scales"]
        assert set(got) == set(want)
        for site, entry in want.items():
            for key in ("amax", "wq", "sw"):
                assert torch.equal(got[site][key], entry[key]), (site, key)
    _assert_same_rows(_side_by_side(ranks["results"], "int8_static"),
                      plain(images))


# --------------------------------------------------------------------------
# (d) Trainer.evaluate over the ranks

class SideBySide:
    """The ranks' val loaders with each batch joined in rank order: the
    global batch of the JAX package's two-process validation."""

    def __init__(self, loaders):
        self.loaders = loaders
        self.dataset = loaders[0].dataset

    def __len__(self):
        return len(self.loaders[0])

    def __iter__(self):
        for parts in zip(*self.loaders):
            yield (np.concatenate([p[0] for p in parts]),
                   {k: np.concatenate([p[1][k] for p in parts])
                    for k in parts[0][1]})


class JaxRows:
    """The JAX predictor behind the port's validate(), every fetched batch
    kept in ``batches``."""

    def __init__(self, jpred):
        self.jpred = jpred
        self.max_dets = jpred.max_dets
        self.batches = []

    conf_thre = property(lambda self: self.jpred.conf_thre,
                         lambda self, v: setattr(self.jpred, "conf_thre", v))
    nms_thre = property(lambda self: self.jpred.nms_thre,
                        lambda self, v: setattr(self.jpred, "nms_thre", v))

    def dispatch(self, imgs):
        return self.jpred.dispatch(imgs)

    def fetch_local(self, out):
        rows = tuple(self.jpred.fetch_local(o) for o in out)
        self.batches.append(rows)
        return rows


def test_trainer_evaluate_over_ranks(pair, ranks):
    """Both ranks' Trainer.evaluate give one AP, that of the JAX package's
    two-device mesh predictor fed the ranks' batches side by side and
    scored by the same validate(); the rows of each global batch within
    tests/test_torch_mesh.py's tolerances of JAX's."""
    r0, r1 = ranks["results"]
    assert r0["evaluate_group"] and r1["evaluate_group"]
    assert r0["evaluate"] == r1["evaluate"]
    cfg = Config.from_dict(ranks["trainer_raw"])
    loaders = [build_val_loader(cfg, ranks["root"], process_index=r,
                                process_count=WORLD) for r in range(WORLD)]
    jax_rows = JaxRows(_jax_mesh_predictor(pair, 2 * cfg["TEST"]["BATCH_SIZE"]))
    want = validate(SideBySide(loaders), jax_rows,
                    conf_threshold=cfg["TEST"]["CONFTHRE"],
                    nms_threshold=cfg["TEST"]["NMSTHRE"], verbose=False)
    assert len(r0["evaluate_rows"]) == len(jax_rows.batches) == 2
    for b, jrows in enumerate(jax_rows.batches):
        det, valid = (torch.cat([r0["evaluate_rows"][b][i],
                                 r1["evaluate_rows"][b][i]]).numpy()
                      for i in range(2))
        assert valid.any()
        _assert_jax_rows(det, valid, *jrows[:2])
    assert r0["evaluate"] == pytest.approx(want, abs=1e-12)


# --------------------------------------------------------------------------
# (e) a group of one rank, and the refusals

@pytest.mark.parametrize("rank", range(WORLD))
def test_group_of_one_rank_is_the_plain_predictor(ranks, rank):
    r = ranks["results"][rank]
    assert r["plain"][1].any()
    _assert_same_rows(r["alone"], r["plain"])


def test_group_with_mesh_raises_and_scopes_do_not_nest(pair):
    with pytest.raises(ValueError, match="mesh or group"):
        Predictor(pair["cfg"], batch_size=2, mesh=_cpu_mesh(2),
                  group=object())
    with group_scope(object()):
        with pytest.raises(RuntimeError, match="do not nest"):
            with replica_scope(SimpleNamespace(all_max=max), 0):
                pass


def test_export_refuses_a_group_predictor(pair, tmp_path):
    pred = Predictor(pair["cfg"], state_dict=pair["sd"], batch_size=2,
                     device="cpu", group=object())
    with pytest.raises(ValueError, match="single-device"):
        export_serving(pred, str(tmp_path / "m.y4t"))
    assert not (tmp_path / "m.y4t").exists()
