"""The port's detect on a video source (yolov4_tpu_torch/detect.py), on the
CPU: the cases of tests/test_detect_video.py, plus each frame's detections
against the JAX package's ``process_video`` on the same weights and the
CLI's video mode."""

import os

import cv2
import numpy as np
import pytest
import torch
import yaml

import detect as jax_detect_cli
from tests.test_torch_helpers import small_model_pair
from yolov4_tpu.data.transforms import Transform as JaxTransform
from yolov4_tpu.engine.predictor import Predictor as JaxPredictor
from yolov4_tpu_torch import detect
from yolov4_tpu_torch.data.transforms import Transform
from yolov4_tpu_torch.engine.predictor import Predictor

torch.set_num_threads(1)

N_FRAMES = 10


def _write_video(path: str, n=N_FRAMES, hw=(80, 100)):
    for fourcc, ext in (("mp4v", ".mp4"), ("MJPG", ".avi")):
        p = os.path.splitext(path)[0] + ext
        w = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*fourcc), 10.0,
                            (hw[1], hw[0]))
        if not w.isOpened():
            continue
        rng = np.random.default_rng(0)
        for i in range(n):
            frame = rng.integers(0, 255, (*hw, 3), np.uint8)
            cv2.rectangle(frame, (10 + i, 20), (60 + i, 60), (0, 0, 255), -1)
            w.write(frame)
        w.release()
        return p
    pytest.skip("no usable cv2 video codec in this image")


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg, _, jvars, sd = small_model_pair(seed=9, head_scale=0.5)
    for c in (jcfg, cfg):
        c["TEST"].update(PRE_NMS_TOPK=64, MAX_DETS=10)
    return dict(jcfg=jcfg, cfg=cfg, jvars=jvars, sd=sd)


def _frames(path):
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return frames


class _Recorder:
    """Wraps a predictor (either package's) and keeps every array it
    fetches, in order."""

    def __init__(self, predictor):
        self.predictor, self.fetched = predictor, []
        self.batch_size = predictor.batch_size

    def dispatch(self, images):
        return self.predictor.dispatch(images)

    def fetch_local(self, out):
        got = self.predictor.fetch_local(out)
        self.fetched.append(got)
        return got


def test_process_video_roundtrip(pair, tmp_path):
    src = _write_video(str(tmp_path / "in.mp4"))
    pred = Predictor(pair["cfg"], state_dict=pair["sd"], img_size=64,
                     batch_size=4, conf_thre=0.3, nms_thre=0.5, device="cpu")
    transform = Transform(pair["cfg"], keep_uint8=True)
    seen = []
    n, written = detect.process_video(pred, transform, 64, src,
                                      str(tmp_path / "out.mp4"),
                                      progress=seen.append)
    assert n == N_FRAMES
    # the returned path is the annotated copy (may be .avi on fallback)
    assert os.path.exists(written)
    frames = _frames(written)
    assert len(frames) == N_FRAMES
    assert all(f.shape == (80, 100, 3) for f in frames)
    assert seen == [4, 8, 10]


def test_video_frames_match_jax_process_video(pair, tmp_path):
    """Each frame's detections, port against the JAX package, on the same
    weights: the same rows within tests/test_torch_predictor.py's
    tolerance (the two batch the frames alike: 4, 4, 2)."""
    src = _write_video(str(tmp_path / "in.mp4"))
    port = _Recorder(Predictor(pair["cfg"], state_dict=pair["sd"],
                               img_size=64, batch_size=4, conf_thre=0.05,
                               nms_thre=0.45, device="cpu"))
    jax = _Recorder(JaxPredictor(pair["jcfg"], variables=pair["jvars"],
                                 img_size=64, batch_size=4, conf_thre=0.05,
                                 nms_thre=0.45))
    detect.process_video(port, Transform(pair["cfg"], keep_uint8=True), 64,
                         src, str(tmp_path / "port.mp4"))
    jax_detect_cli.process_video(
        jax, JaxTransform(pair["jcfg"], is_train=False, keep_uint8=True), 64,
        src, str(tmp_path / "jax.mp4"))
    # the port fetches (detections, valid) per batch, the JAX package one
    # array at a time; the last batch's padding rows come last
    port_rows = [d[v] for dets, valids, *_ in port.fetched
                 for d, v in zip(dets, valids)][:N_FRAMES]
    jax_rows = [d[v] for dets, valids in zip(jax.fetched[0::2],
                                              jax.fetched[1::2])
                for d, v in zip(dets, valids)][:N_FRAMES]
    assert len(port.fetched) == 3 and len(jax.fetched) == 6
    assert sum(len(r) for r in port_rows) > 0
    for got, want in zip(port_rows, jax_rows):
        assert got.shape == want.shape
        np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=1e-4,
                                   atol=1e-3)
        np.testing.assert_allclose(got[:, 4:6], want[:, 4:6], atol=1e-5)
        np.testing.assert_array_equal(got[:, 6], want[:, 6])


def test_cli_video_mode(tmp_path):
    src = _write_video(str(tmp_path / "clip.mp4"))
    cfg_path = tmp_path / "small.cfg"
    cfg_path.write_text(yaml.safe_dump({
        "MODEL": {"WIDTH": 0.25, "DEPTH": 0.25, "COMPUTE_DTYPE": "float32"},
        "TEST": {"IMGSIZE": 64, "PRE_NMS_TOPK": 64, "MAX_DETS": 10}}))
    dest = detect.main(["--cfg", str(cfg_path), "--source", src, "--dest",
                        str(tmp_path / "out"), "--batch-size", "4",
                        "--device", "cpu"])
    written = sorted(os.listdir(dest))
    assert written in (["clip_det.mp4"], ["clip_det.avi"])
    assert len(_frames(str(dest / written[0]))) == N_FRAMES


def test_video_source_detection():
    assert "clip.mp4".lower().endswith(detect.VIDEO_EXTS)
    assert "CLIP.MKV".lower().endswith(detect.VIDEO_EXTS)
    assert not "img.jpg".lower().endswith(detect.VIDEO_EXTS)
    assert detect.VIDEO_EXTS == jax_detect_cli.VIDEO_EXTS
