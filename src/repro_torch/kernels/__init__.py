"""Hand-written Hopper kernels of the port, each beside its plain version.

Importing this package builds nothing; the CUDA library is compiled at the
first kernel launch (``kernels._build``).
"""
