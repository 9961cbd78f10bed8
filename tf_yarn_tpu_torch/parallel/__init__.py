from tf_yarn_tpu_torch.parallel.mesh import (
    AXIS_DP,
    AXIS_EP,
    AXIS_FSDP,
    AXIS_PP,
    AXIS_SP,
    AXIS_TP,
    MeshSpec,
    build_mesh,
)

__all__ = [
    "AXIS_DP",
    "AXIS_EP",
    "AXIS_FSDP",
    "AXIS_PP",
    "AXIS_SP",
    "AXIS_TP",
    "MeshSpec",
    "build_mesh",
]
