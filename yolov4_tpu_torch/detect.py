"""Image and video detection CLI on the port.

Usage:
    python -m yolov4_tpu_torch.detect [--cfg configs/yolov4_Tianxiaomo.cfg] \
        [--ckpt weights.pth.tar] --source ./data/images/ \
        [--dest runs/detect/] [--conf-thre 0.2] [--nms-thre 0.5] \
        [--device cuda]

Images go through the eval transform in batches, one device program
(forward + decode + NMS) per batch, and back to the host to be unmapped to
source pixels, drawn and written under ``<dest>/exp<N>/``. A ``--source``
video file (``VIDEO_EXTS``) is read frame by frame through the same
batches and written annotated as ``<stem>_det.mp4`` (``.avi`` with MJPG
where the mp4v encoder is missing; the JAX package's ``process_video``).
Runs on CUDA unless ``--device`` names another device; a missing card is
an error. Checkpoints are a JAX package ``.ckpt``, reference
``.pth``/``.pth.tar``/``.pt`` or ``.npz`` state dicts; without one the
weights are the reference init from seed 0.
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from pathlib import Path
from typing import List, Optional, Sequence

import cv2
import numpy as np

from yolov4_tpu_torch.config import load_config
from yolov4_tpu_torch.data.transforms import Transform
from yolov4_tpu_torch.engine.predictor import Predictor
from yolov4_tpu_torch.ops.boxes import unmap_to_source_xyxy
from yolov4_tpu_torch.utils.convert import load_weights
from yolov4_tpu_torch.utils.visualize import class_name, draw_detections

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")
VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm")

logger = logging.getLogger("yolov4_tpu_torch.detect")


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description="YOLOv4 detection (PyTorch/CUDA).")
    parser.add_argument("--cfg", type=str, default=None,
                        help="YAML config (default: built-in defaults)")
    parser.add_argument("--ckpt", type=str, default=None,
                        help="weights (.ckpt / .pth / .pth.tar / .pt / .npz)")
    parser.add_argument("--source", type=str, default="./data/images/",
                        help="image file, directory or video file")
    parser.add_argument("--dest", type=str, default="./runs/detect/",
                        help="output directory root")
    parser.add_argument("--conf-thre", type=float, default=-0.1)
    parser.add_argument("--nms-thre", type=float, default=-0.1)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--letterbox", action="store_true",
                        help="aspect-preserving letterbox preprocessing "
                             "(cfg TEST.LETTERBOX)")
    return parser.parse_args(argv)


def increment_path(path: str) -> Path:
    """runs/detect/exp -> exp2 -> exp3 ... (reference detect.py:125-148)."""
    path = Path(path)
    if path.exists():
        for n in range(2, 9999):
            candidate = Path(f"{path}{n}")
            if not candidate.exists():
                path = candidate
                break
        else:  # never reuse (= overwrite) an existing run dir
            raise SystemExit(f"error: {path}2..{path}9998 all exist")
    path.mkdir(parents=True, exist_ok=True)
    return path


def list_images(source: str) -> List[str]:
    if os.path.isfile(source):
        return [source]
    if not os.path.isdir(source):
        raise SystemExit(f"error: --source {source!r} is neither a file nor a directory")
    return sorted(
        os.path.join(source, f) for f in os.listdir(source)
        if f.lower().endswith(IMAGE_EXTS))


def draw_frame(frame: np.ndarray, info, det: np.ndarray) -> np.ndarray:
    """A copy of ``frame`` with ``det`` (the valid rows of one image, in
    model-input pixels) unmapped to it by ``info`` and drawn."""
    src_h, src_w, dst_h, dst_w, off_x, off_y = info[:6]
    boxes = unmap_to_source_xyxy(det[:, :4], (src_h, src_w), (dst_h, dst_w),
                                 (off_x, off_y))
    return draw_detections(frame.copy(), boxes, det[:, 4] * det[:, 5],
                           det[:, 6].astype(int))


def process_video(predictor, transform, img_size: int, src_path: str,
                  out_path: str, progress=None):
    """Batched detection over a video's frames; writes an annotated copy.

    Frames go through the same device program as still images, one batch
    in flight while the previous one is drawn and encoded. Returns
    (frames_written, actual_out_path): the path takes an ``.avi``
    extension when the mp4v encoder is missing and MJPG is used."""
    cap = cv2.VideoCapture(src_path)
    if not cap.isOpened():
        raise SystemExit(f"error: cannot open video {src_path!r}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"),
                             fps, (w, h))
    if not writer.isOpened():  # codec fallback
        out_path = os.path.splitext(out_path)[0] + ".avi"
        writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"MJPG"),
                                 fps, (w, h))
    if not writer.isOpened():
        # write() on an unopened writer is a silent no-op: fail loudly
        # instead of reporting frames that never reached the disk
        cap.release()
        raise SystemExit("error: no usable cv2 video encoder "
                         "(tried mp4v, MJPG)")

    def read_batch():
        frames, canvases, infos = [], [], []
        while len(frames) < predictor.batch_size:
            ok, frame = cap.read()
            if not ok:
                break
            canvas, target = transform([frame], [np.zeros((0, 5))], img_size)
            frames.append(frame)
            canvases.append(canvas)
            infos.append(target["img_info"])
        return frames, canvases, infos

    def draw(frames, infos, out):
        dets, valids = predictor.fetch_local(out)[:2]
        for i, frame in enumerate(frames):
            writer.write(draw_frame(frame, infos[i], dets[i][valids[i]]))

    n_out = 0
    pending = None  # (frames, infos, dispatched batch)
    try:
        while True:
            frames, canvases, infos = read_batch()
            nxt = ((frames, infos, predictor.dispatch(np.stack(canvases)))
                   if frames else None)
            if pending is not None:
                draw(*pending)
                n_out += len(pending[0])
                if progress:
                    progress(n_out)
            pending = nxt
            if pending is None:
                break
    finally:
        cap.release()
        writer.release()
    return n_out, out_path


def main(argv: Optional[Sequence[str]] = None) -> Path:
    """Run detection; returns the directory the drawn images (or the
    annotated video) went to."""
    args = parse_args(argv)
    cfg = load_config(args.cfg)
    if args.letterbox:
        cfg["TEST"]["LETTERBOX"] = True
    conf_thre = cfg["TEST"]["CONFTHRE"] if args.conf_thre < 0 else args.conf_thre
    nms_thre = cfg["TEST"]["NMSTHRE"] if args.nms_thre < 0 else args.nms_thre
    img_size = cfg["TEST"]["IMGSIZE"]

    video_mode = (os.path.isfile(args.source)
                  and args.source.lower().endswith(VIDEO_EXTS))
    paths = [] if video_mode else list_images(args.source)
    if not video_mode:
        if not paths:
            raise FileNotFoundError(
                f"no image files ({'/'.join(IMAGE_EXTS)}) under {args.source}")
        logger.info(f"detecting {len(paths)} image(s) at {img_size}x"
                    f"{img_size}, conf {conf_thre}, nms {nms_thre}, device "
                    f"{args.device}")

    state_dict = None
    if args.ckpt:
        state_dict = load_weights(args.ckpt)
        logger.info(f"loaded weights {args.ckpt}")
    else:
        logger.warning("no --ckpt given: running with the seed-0 random init")

    predictor = Predictor(cfg, state_dict=state_dict, img_size=img_size,
                          batch_size=(args.batch_size if video_mode else
                                      min(args.batch_size, len(paths))),
                          conf_thre=conf_thre, nms_thre=nms_thre,
                          device=args.device)
    transform = Transform(cfg, keep_uint8=True)
    dest = increment_path(os.path.join(args.dest, "exp"))
    t0 = time.time()
    if video_mode:
        stem = os.path.splitext(os.path.basename(args.source))[0]
        logger.info(f"video {args.source} at {img_size}x{img_size}, conf "
                    f"{conf_thre}, nms {nms_thre}, device {args.device}")
        n, out_path = process_video(
            predictor, transform, img_size, args.source,
            os.path.join(str(dest), f"{stem}_det.mp4"),
            progress=lambda k: (k % (args.batch_size * 8) == 0
                                and logger.info(f"  {k} frames...")))
        dt = time.time() - t0
        logger.info(f"done: {n} frames in {dt:.2f}s "
                    f"({n / max(dt, 1e-9):.1f} fps) -> {out_path}")
        return dest

    def load_chunk(start):
        raw_imgs, batch, infos = [], [], []
        for p in paths[start:start + predictor.batch_size]:
            img = cv2.imread(p)
            if img is None:
                raise ValueError(f"cannot read image {p}")
            out, target = transform([img], [np.zeros((0, 5))], img_size)
            raw_imgs.append(img)
            batch.append(out)
            infos.append(target["img_info"])
        return raw_imgs, np.stack(batch), infos

    def draw_chunk(start, raw_imgs, infos, out):
        dets, valids = predictor.fetch_local(out)[:2]
        for i, raw in enumerate(raw_imgs):
            idx = start + i
            det = dets[i][valids[i]]
            cls_idxs = det[:, 6].astype(int)
            summary = {}
            for c in cls_idxs:
                summary[class_name(c)] = summary.get(class_name(c), 0) + 1
            desc = (", ".join(f"{v} {k}" for k, v in summary.items())
                    or "no detections")
            logger.info(f"image {idx + 1}/{len(paths)} "
                        f"{os.path.basename(paths[idx])}: {desc}")
            drawn = draw_frame(raw, infos[i], det)
            out_path = os.path.join(str(dest), os.path.basename(paths[idx]))
            if not cv2.imwrite(out_path, drawn):
                raise OSError(f"cannot write {out_path}")

    # dispatch-ahead: the next chunk's decode/preprocess/upload overlaps the
    # previous chunk's device pass
    pending = None
    for start in range(0, len(paths), predictor.batch_size):
        raw_imgs, chunk, infos = load_chunk(start)
        out = predictor.dispatch(chunk)
        if pending is not None:
            draw_chunk(*pending)
        pending = (start, raw_imgs, infos, out)
    draw_chunk(*pending)

    logger.info(f"done: {len(paths)} image(s) in {time.time() - t0:.2f}s "
                f"-> {dest}")
    return dest


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    main()
