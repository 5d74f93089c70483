from repro_torch.kernels.lane_superstep.ops import (  # noqa: F401
    fused_lane_step,
    fused_lane_superstep,
)
