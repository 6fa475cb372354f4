"""Box geometry, greedy NMS (plain version and Hopper kernel), postprocess.

Importing the package registers the custom ops of the three Hopper kernels
(``torch.ops.yolov4_tpu_torch.greedy_nms_mask`` K1, ``fused_csp_stage``
K2, ``batch_norm_act`` the eval BN and activation pass), which an exported
serving program (utils/export.py) calls.
"""

from typing import Dict

from yolov4_tpu_torch.ops import bn_act_cuda, csp_cuda, nms_cuda


def kernel_launches() -> Dict[str, int]:
    """The launch counts of the NMS kernel (K1), the fused CSP stage kernel
    (K2) and the eval BatchNorm and activation kernel (``batch_norm_act``,
    one launch per ConvBNAct it runs) in this process so far."""
    return {"greedy_nms_mask": nms_cuda.greedy_nms_mask_cuda.launches,
            "fused_csp_stage": csp_cuda.fused_csp_stage_cuda.launches,
            "batch_norm_act": bn_act_cuda.batch_norm_act_cuda.launches}


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """Each kernel's launches in this process since ``before``."""
    return {k: v - before[k] for k, v in kernel_launches().items()}
