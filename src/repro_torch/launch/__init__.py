# The serving and training launchers are ported (``python -m
# repro_torch.launch.serve``, ``python -m repro_torch.launch.train``, one
# device each); mesh, sharding, roofline and the dry run are ROADMAP.md
# Queue A 6.  Importing this package starts nothing.
