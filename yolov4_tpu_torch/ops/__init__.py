"""Box geometry, greedy NMS (plain version and Hopper kernel), postprocess.

Importing the package registers the custom ops of both kernels
(``torch.ops.yolov4_tpu_torch.greedy_nms_mask``, ``fused_csp_stage``),
which an exported serving program (utils/export.py) calls.
"""

from yolov4_tpu_torch.ops import csp_cuda, nms_cuda  # noqa: F401
