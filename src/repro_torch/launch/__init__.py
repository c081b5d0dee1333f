# The serving and training launchers (``python -m repro_torch.launch.serve``,
# ``python -m repro_torch.launch.train``), the roofline on the H100's spec,
# the meshes, the sharding rules and the dry run (``python -m
# repro_torch.launch.dryrun``, which joins a fake process group: run it as
# a process of its own).  Importing this package starts nothing.
from repro_torch.launch.mesh import (data_axes, dp_size, make_host_mesh,
                                     make_production_mesh, tp_size)
from repro_torch.launch.sharding import ShardingRules

__all__ = ["data_axes", "dp_size", "make_host_mesh", "make_production_mesh",
           "tp_size", "ShardingRules"]
