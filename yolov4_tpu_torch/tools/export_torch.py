"""Export a checkpoint to a reference-compatible torch ``.pth.tar``; the
port's copy of the JAX package's tools/export_torch.py.

    python -m yolov4_tpu_torch.tools.export_torch CKPT OUT

CKPT is a port training checkpoint (``{"variables", "meta", ...}``,
utils/checkpoint.py) or a JAX package ``.ckpt`` (read without flax by
utils/convert.load_jax_checkpoint and mapped by state_dict_from_jax).
OUT holds ``{epoch, ap50, ap50_95, best_ap50, best_ap50_95,
state_dict}``, the reference trainer's checkpoint layout: the state_dict
has the reference's keys (the JAX tool's set: BatchNorm's
``num_batches_tracked`` is left out, and a strict load fills it in) and
loads into the reference model, or into the port through ``--ckpt`` /
``utils/convert.load_weights``.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence, Tuple

import torch

from yolov4_tpu_torch.utils.checkpoint import load_checkpoint_raw
from yolov4_tpu_torch.utils.convert import (jax_variables,
                                           load_jax_checkpoint,
                                           state_dict_from_jax)

META_KEYS = ("epoch", "ap50", "ap50_95", "best_ap50", "best_ap50_95")


def read_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """(state_dict, meta) of a port checkpoint or a JAX package ``.ckpt``."""
    if str(path).endswith(".ckpt"):
        raw = load_jax_checkpoint(path)
        return (state_dict_from_jax(jax_variables(raw, path)),
                dict(raw.get("meta", {})))
    raw = load_checkpoint_raw(path)
    if not isinstance(raw, dict) or "variables" not in raw:
        raise ValueError(f"{path} is not a training checkpoint of the port "
                         "(no 'variables') nor a JAX package .ckpt")
    return raw["variables"], dict(raw.get("meta", {}))


def export(ckpt: str, out: str) -> Dict:
    """Write ``out`` from ``ckpt``; returns the blob written."""
    state_dict, meta = read_checkpoint(ckpt)
    state_dict = {k: v.detach().cpu().contiguous()
                  for k, v in state_dict.items()
                  if not k.endswith("num_batches_tracked")}
    blob = {"epoch": meta.get("epoch", 0)}
    blob.update({k: meta.get(k, 0.0) for k in META_KEYS[1:]})
    blob["state_dict"] = state_dict
    torch.save(blob, out)
    return blob


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("ckpt", help="port checkpoint (.pth) or JAX .ckpt")
    parser.add_argument("out", help="output .pth.tar path")
    args = parser.parse_args(argv)
    blob = export(args.ckpt, args.out)
    print(f"wrote {args.out} ({len(blob['state_dict'])} tensors)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
