"""Box geometry, greedy NMS (plain version and Hopper kernel), postprocess.

Importing the package registers the custom ops of both kernels
(``torch.ops.yolov4_tpu_torch.greedy_nms_mask``, ``fused_csp_stage``),
which an exported serving program (utils/export.py) calls.
"""

from typing import Dict

from yolov4_tpu_torch.ops import csp_cuda, nms_cuda


def kernel_launches() -> Dict[str, int]:
    """The launch counts of the NMS kernel (K1) and the fused CSP stage
    kernel (K2) in this process so far."""
    return {"greedy_nms_mask": nms_cuda.greedy_nms_mask_cuda.launches,
            "fused_csp_stage": csp_cuda.fused_csp_stage_cuda.launches}


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """K1's and K2's launches in this process since ``before``."""
    return {k: v - before[k] for k, v in kernel_launches().items()}
