# Only the serving launcher is ported; mesh, sharding, roofline and the
# dry run are ROADMAP.md Queue A 6.  Run ``python -m
# repro_torch.launch.serve``; importing this package starts nothing.
