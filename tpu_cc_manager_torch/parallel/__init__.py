"""Parallelism of the port: meshes, sharding rules, train steps, checkpoint.

Port of ``tpu_cc_manager/parallel``: ``mesh.py`` (``DeviceMesh`` with the
five axes), ``sharding.py`` (the logical-axis rules as DTensor placements),
``distributed.py`` (``torch.distributed`` bootstrap, ``verify_dcn_mesh``),
``tensor.py`` (the tp exchange and Megatron's f and g), ``train.py`` (the
Llama train step, FSDP2 over the data axes, heads over ``tp``) and
``checkpoint.py`` (``torch.distributed.checkpoint``).
"""

from tpu_cc_manager_torch.parallel.mesh import MeshSpec, make_mesh
from tpu_cc_manager_torch.parallel.sharding import (
    LOGICAL_AXIS_RULES,
    mesh_axes_for,
    placements_for,
)

__all__ = [
    "MeshSpec",
    "make_mesh",
    "LOGICAL_AXIS_RULES",
    "mesh_axes_for",
    "placements_for",
]
